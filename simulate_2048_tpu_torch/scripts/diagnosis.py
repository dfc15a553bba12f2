"""What the checkpoint diagnoses share (``autopsy_eval``, ``prior_sweep``,
``model_probe``, ``compare_scalar60k``): the ``--set`` overrides as the
repository's ``scripts/prior_sweep.py`` parses them, a checkpoint restored
into a config's template, the search a config's evaluation or self-play
takes on a device, and a seeded evaluation that reports its kernel launches.

The diagnoses change what the search sees by changing the network's
weights (``autopsy_eval.flat_prior``, ``prior_sweep.soften_prior``), never
by wrapping the network's ``prediction``: the whole-search kernel packs its
weights from the network (``ops/search_kernel.py`` ``pack_search_params``)
and would not see a wrapper, while a transformed network is the same
function to the kernel and to the plain search.
"""

from __future__ import annotations

import ast
import dataclasses
import sys
import time
from typing import Any

import torch

from simulate_2048_tpu_torch.ops import search_kernel as sk
from simulate_2048_tpu_torch.ops.rng import prng_key
from simulate_2048_tpu_torch.scripts.benchmark_mcts import KernelRefused, library
from simulate_2048_tpu_torch.training.checkpoint import CheckpointManager
from simulate_2048_tpu_torch.training.config import TrainConfig
from simulate_2048_tpu_torch.training.learner import TrainState, create_train_state
from simulate_2048_tpu_torch.training.self_play import (
    _search_weight_dtype,
    _use_kernel,
    evaluate_games,
    search_config_from,
)


def parse_set(config: TrainConfig, items: list[str]) -> TrainConfig:
    """``config`` with ``FIELD=VALUE`` overrides, each value read as a Python
    literal where it is one and kept as a string otherwise (the JAX
    ``prior_sweep.py``'s parsing, which ``dataclasses.replace`` validates)."""
    fields = {}
    for item in items:
        key, _, raw = item.partition("=")
        try:
            fields[key] = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            fields[key] = raw
    return dataclasses.replace(config, **fields) if fields else config


def template(config: TrainConfig, device: torch.device) -> tuple[TrainState, torch.nn.Module]:
    """The train state a checkpoint is restored into: the fresh weights of
    ``PRNGKey(0)``, as the JAX scripts'."""
    return create_train_state(config, prng_key(0), device)


def restore(state: TrainState, ckpt_dir: str, step: int | None = None) -> TrainState:
    """``state`` with the checkpoint of ``step`` (the latest when None) of
    ``ckpt_dir`` loaded into it; exits with a message when there is none."""
    restored = CheckpointManager(ckpt_dir).restore(state, step=step)
    if restored is None:
        raise SystemExit(f"no checkpoint{'' if step is None else f' at step {step}'} in {ckpt_dir}")
    return restored


def search_route(config: TrainConfig, device: torch.device, eval_mode: bool = True) -> str:
    """The search that ``config``'s evaluation (or, without ``eval_mode``,
    self-play) takes on ``device``: the CUDA library of the whole-search
    kernel, the kernel's plain version for CPU tensors, or ``plain`` (the
    plain search, ``search/mcts.py``)."""
    cfg = search_config_from(config, eval_mode=eval_mode)
    if not _use_kernel(config, cfg, device):
        return "plain"
    try:
        name = library(cfg, config.hidden_size, _search_weight_dtype(config))
    except KernelRefused:  # the CPU's plain version takes shapes the kernel refuses
        return "kernel's plain version"
    return name if device.type == "cuda" else f"{name}'s plain version"


def launches_since(before: dict[str, int]) -> dict[str, int]:
    """Kernel launches by library since ``before`` (a copy of ``search_kernel.LAUNCHES``)."""
    return {k: v - before.get(k, 0) for k, v in sk.LAUNCHES.items() if v != before.get(k, 0)}


def evaluate_seeded(
    network, config: TrainConfig, seed: int, games: int, label: str, include_per_game: bool = False
) -> dict[str, Any]:
    """``evaluate_games`` with a fresh ``torch.Generator`` seeded with
    ``seed``, so that every call plays the same games; prints one line to
    standard error naming the search it took, its launches and its seconds."""
    device = next(network.parameters()).device
    before = dict(sk.LAUNCHES)
    t0 = time.perf_counter()
    stats = evaluate_games(network, torch.Generator().manual_seed(seed), config, games, include_per_game)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    print(
        f"{label}: search {search_route(config, device)}, launches {launches_since(before)}, {seconds:.2f} s",
        file=sys.stderr,
        flush=True,
    )
    return stats
