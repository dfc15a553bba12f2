"""Checkpointing with a full train-state round trip, on ``torch.save`` /
``torch.load`` (port of the JAX package's ``training/checkpoint.py``, which
uses orbax; the two formats are not interchangeable).

A checkpoint is one file ``<dir>/step_<n>.pt`` holding the network's
``state_dict``, the optimizer state (Adam moments and count), the step, and
optionally the replay buffer and the trainer's runtime payload. The
``TrainConfig`` is written beside them as ``train_config.json``, in the same
format as the JAX package's sidecar, so that tools can rebuild the exact
configuration a checkpoint was trained with.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import warnings
from typing import Any

import torch

from simulate_2048_tpu_torch.training.config import TrainConfig
from simulate_2048_tpu_torch.training.learner import TrainState

_STEP_FILE = re.compile(r"step_(\d+)\.pt$")


class CheckpointManager:
    """Save / restore {network, optimizer state, step} (+ buffer, runtime); keeps the newest ``max_to_keep``."""

    def __init__(self, checkpoint_dir: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(checkpoint_dir)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def save(self, state: TrainState, step: int | None = None, buffer=None, runtime: dict | None = None) -> None:
        """Persist the full train state. Pass ``buffer`` (a replay
        ``BufferState``) to checkpoint experience too, and ``runtime`` (a small
        dict of trainer-loop state: carried self-play games, cross-segment
        backfill bookkeeping) so that a resume continues the games in flight."""
        step = state.step if step is None else step
        payload: dict[str, Any] = {
            "network": state.network.state_dict(),
            "opt_state": state.opt_state,
            "step": step,
        }
        if buffer is not None:
            payload["buffer"] = buffer._asdict()
        if runtime is not None:
            payload["runtime"] = runtime
        tmp = self._path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))
        for old in self.all_steps()[: -self.max_to_keep]:
            os.remove(self._path(old))

    def _load(self, step: int | None, device) -> dict | None:
        step = self.latest_step() if step is None else step
        if step is None or not os.path.exists(self._path(step)):
            return None
        return torch.load(self._path(step), map_location=device, weights_only=True)

    def restore(self, template: TrainState, step: int | None = None) -> TrainState | None:
        """Load a checkpoint into ``template`` (its network's parameters and
        its optimizer state, on their device); None if there is none.
        The optimizer state is restored, not re-initialised."""
        device = template.params[0].device
        payload = self._load(step, device)
        if payload is None:
            return None
        template.network.load_state_dict(payload["network"])
        opt = payload["opt_state"]
        for name in ("mu", "nu"):
            for dst, src in zip(template.opt_state[name], opt[name], strict=True):
                dst.copy_(src)
        template.opt_state["count"] = int(opt["count"])
        template.step = int(payload["step"])
        return template

    def restore_buffer(self, template, step: int | None = None):
        """Restore a checkpointed replay buffer onto ``template``'s device; None if absent or of another shape."""
        payload = self._load(step, template.length.device)
        if payload is None or "buffer" not in payload:
            return None
        fields = payload["buffer"]
        if any(fields[k].shape != v.shape or fields[k].dtype != v.dtype for k, v in template._asdict().items()):
            return None
        return type(template)(**fields)

    def restore_runtime(self, device: torch.device | str = "cpu", step: int | None = None) -> dict | None:
        """Restore the trainer-runtime payload; None if absent."""
        payload = self._load(step, device)
        return None if payload is None else payload.get("runtime")

    def save_config(self, config: Any) -> None:
        """Persist the TrainConfig as a JSON sidecar (``train_config.json``)."""
        with open(os.path.join(self.directory, "train_config.json"), "w") as f:
            json.dump(dataclasses.asdict(config), f, indent=1, default=str)

    def load_config_dict(self) -> dict[str, Any] | None:
        """The saved config as a plain dict (JSON types), or None if absent."""
        path = os.path.join(self.directory, "train_config.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def all_steps(self) -> list[int]:
        """Every step with a saved checkpoint, ascending."""
        found = (_STEP_FILE.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> int | None:
        """Most recent saved step."""
        steps = self.all_steps()
        return steps[-1] if steps else None


def load_train_config(checkpoint_dir: str) -> TrainConfig | None:
    """Rebuild the ``TrainConfig`` a checkpoint was trained with, or None.

    Reads the ``train_config.json`` sidecar, restoring JSON lists to the
    tuple-typed ``temperature_schedule``. Unknown keys (another config
    schema) are dropped with a warning rather than failing.
    """
    path = os.path.join(os.path.abspath(checkpoint_dir), "train_config.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        raw = json.load(f)
    if "temperature_schedule" in raw:
        raw["temperature_schedule"] = tuple((int(s), float(t)) for s, t in raw["temperature_schedule"])
    known = {f.name for f in dataclasses.fields(TrainConfig)}
    unknown = set(raw) - known
    if unknown:
        warnings.warn(f"train_config.json: dropping unknown fields {sorted(unknown)}")
        raw = {k: v for k, v in raw.items() if k in known}
    return TrainConfig(**raw)
