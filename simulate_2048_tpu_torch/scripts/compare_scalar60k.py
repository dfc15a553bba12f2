"""Seed-matched evaluation of checkpoints: ``python -m simulate_2048_tpu_torch.scripts.compare_scalar60k``.

Port of the repository's ``scripts/compare_scalar60k.py``: evaluates the
categorical-heads arm and its scalar-heads twin (same recipe, seed and
horizon, ``value_bins = reward_bins = 1``) on the same games under the
calibrated greedy evaluation search (prior temperature 4, ``pb_c_init``
0.5). Same flags (``--games --key``, checkpoint directories as positional
arguments) and printed lines (one JSON object a checkpoint: ``ckpt``,
``step`` and the evaluation's statistics, without list values), plus
``--device`` (default ``cuda``; raises when no GPU is present unless given
``--device cpu``). Departures:

- The default directories are the port's runs,
  ``runs/torch_cat60k/ckpt runs/torch_scalar60k/ckpt``.
- Each checkpoint's config comes from its ``train_config.json`` sidecar
  (``training/checkpoint.py`` ``load_train_config``), else from
  ``small_config()`` with the port's copy of :data:`R3_OVERRIDES`; the
  latest checkpoint of the directory is restored.
- Every evaluation draws its games from a fresh ``torch.Generator`` seeded
  with ``--key``, so every checkpoint plays the same games. Before each
  JSON line a line on standard error names the search it took (a CUDA
  library, or ``plain``), its kernel launches and its seconds.

Usage (on the GPU):
    python -m simulate_2048_tpu_torch.scripts.compare_scalar60k [--games 128] [ckpt_dir ...]
"""

from __future__ import annotations

import argparse
import json

from simulate_2048_tpu_torch.scripts import diagnosis
from simulate_2048_tpu_torch.training.checkpoint import load_train_config
from simulate_2048_tpu_torch.training.config import apply_overrides, small_config

# The round-3 champion's recipe (the JAX script's list): the fallback for a directory without a config sidecar.
R3_OVERRIDES = [
    "value_target_mode=td_lambda", "td_lambda=1.0", "cross_segment_backfill=True",
    "afterstate_value_loss_weight=0.25", "value_bins=256", "reward_bins=128",
    "lr_decay_steps=60000", "eval_prior_temperature=4.0", "eval_pb_c_init=0.5",
]  # fmt: skip


def eval_ckpt(ckpt_dir: str, overrides: list[str] | None, games: int, key: int, device) -> dict:
    """``{"ckpt", "step", **evaluation stats}`` of the latest checkpoint in ``ckpt_dir``."""
    config = load_train_config(ckpt_dir)
    if config is None:
        config = apply_overrides(small_config(), overrides or [])
    state, network = diagnosis.template(config, device)
    state = diagnosis.restore(state, ckpt_dir)
    stats = diagnosis.evaluate_seeded(network, config, key, games, f"compare_scalar60k {ckpt_dir}")
    return {"ckpt": ckpt_dir, "step": int(state.step), **stats}


def main(argv: list[str] | None = None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--games", type=int, default=128)
    parser.add_argument("--key", type=int, default=123)
    parser.add_argument(
        "ckpts",
        nargs="*",
        default=["runs/torch_cat60k/ckpt", "runs/torch_scalar60k/ckpt"],
        help="checkpoint dirs to evaluate on the shared game set (config from each dir's sidecar; "
        "R3_OVERRIDES fallback)",
    )
    parser.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' to run on the CPU)")
    args = parser.parse_args(argv)

    from simulate_2048_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    lines = []
    for ckpt in args.ckpts:
        out = eval_ckpt(ckpt, R3_OVERRIDES, args.games, args.key, device)
        lines.append({k: v for k, v in out.items() if not isinstance(v, list)})
        print(json.dumps(lines[-1]), flush=True)
    return lines


if __name__ == "__main__":
    main()
