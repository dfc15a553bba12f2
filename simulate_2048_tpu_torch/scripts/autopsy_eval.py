"""Checkpoint autopsy: ``python -m simulate_2048_tpu_torch.scripts.autopsy_eval``.

Port of the repository's ``scripts/autopsy_eval.py``: re-evaluates saved
checkpoints with the policy prior ablated and/or the simulation budget
raised, to find where a post-peak decline of the evaluation curve lives:

- if ``flat_prior`` (the search ignores the policy head: a uniform prior
  over legal moves) recovers the lost score, the policy prior degrades;
- if ``sims<N>`` recovers it, the prior is recoverable with more search;
- if nothing recovers it, the value/reward/dynamics stack degraded.

Same flags, defaults, variants (``base``, ``flat_prior``, ``sims<N>``,
``flat_sims<N>``, in that order; ``random_init`` first, then each
``--steps`` checkpoint) and JSON keys, plus ``--device`` (default ``cuda``;
raises when no GPU is present unless given ``--device cpu``). Departures:

- ``--ckpt-dir`` defaults to the port's scalar arm,
  ``runs/torch_scalar60k/ckpt`` (the checkpoints are the port's
  ``torch.save`` files, restored with its ``CheckpointManager`` into
  ``small_config()``'s template).
- ``--set FIELD=VALUE`` (``prior_sweep``'s flag and parsing) applies to
  ``small_config()`` before the restore: a categorical checkpoint needs its
  bins, and ``--set search_backend=auto`` runs every variant on the
  whole-search kernel. The default backend stays ``"xla"``, the plain search.
- The JAX script wraps the prediction head's apply function to flatten the
  prior. Here :func:`flat_prior` zeroes the policy layer's weight and bias in
  a copy of the network: its logits are exactly 0, as the wrapper's
  ``zeros_like`` are, and the kernel, which packs its weights from the
  network, searches with them as the plain search does.
- Every evaluation draws its games from a fresh ``torch.Generator`` seeded
  with ``--seed`` (the JAX script reuses one key), so every variant and
  every checkpoint plays the same games. Before each JSON line a line on
  standard error names the search the variant took (a CUDA library, or
  ``plain``), its kernel launches and its seconds.

Usage (on the GPU):
    python -m simulate_2048_tpu_torch.scripts.autopsy_eval --ckpt-dir runs/torch_scalar60k/ckpt \\
        --steps 2500 5000 --set search_backend=auto
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json

import torch

from simulate_2048_tpu_torch.scripts import diagnosis
from simulate_2048_tpu_torch.training.config import TrainConfig, small_config


def flat_prior(network):
    """A copy of ``network`` whose policy logits are exactly 0: the last
    layer of the prediction head with zero weight and zero bias (the JAX
    script's ``flat_prior_fns``, as weights)."""
    flat = copy.deepcopy(network)
    with torch.no_grad():
        flat.prediction.policy_logits.weight.zero_()
        flat.prediction.policy_logits.bias.zero_()
    return flat


def variants(network, config: TrainConfig, sims: int) -> list[tuple[str, torch.nn.Module, TrainConfig]]:
    """The four (name, network, config) variants of one checkpoint, in the JAX script's order."""
    flat = flat_prior(network)
    config_sims = dataclasses.replace(config, num_simulations=sims)
    return [
        ("base", network, config),
        ("flat_prior", flat, config),
        (f"sims{sims}", network, config_sims),
        (f"flat_sims{sims}", flat, config_sims),
    ]


def line(tag: str, name: str, stats: dict) -> dict:
    """The JAX script's JSON line of one variant."""
    return {
        "ckpt": tag,
        "variant": name,
        "mean_reward": round(stats["mean_reward"], 1),
        "sem": round(stats["sem_reward"], 1),
        "max_tile": stats["max_tile"],
        "reached_512": stats["reached_512"],
        "mean_length": round(stats["mean_length"], 1),
        "search_value": round(stats["mean_search_value"], 2),
        "search_entropy": round(stats["mean_search_entropy"], 3),
    }


def report(tag: str, network, config: TrainConfig, sims: int, games: int, seed: int,
           include_per_game: bool = False) -> list[tuple[str, dict]]:  # fmt: skip
    """Evaluate every variant of ``network`` on the same games; prints each
    JSON line and returns (variant, evaluation stats) in order."""
    out = []
    for name, net, cfg in variants(network, config, sims):
        stats = diagnosis.evaluate_seeded(net, cfg, seed, games, f"autopsy_eval {tag} {name}", include_per_game)
        print(json.dumps(line(tag, name, stats)), flush=True)
        out.append((name, stats))
    return out


def autopsy(ckpt_dir: str, steps: list[int], games: int, sims: int, seed: int, overrides: list[str],
            device="cuda", include_per_game: bool = False) -> dict[str, list[tuple[str, dict]]]:  # fmt: skip
    """The JAX script's run: ``random_init``, then each checkpoint of ``steps``."""
    from simulate_2048_tpu_torch.device import resolve_device

    device = resolve_device(device)
    config = diagnosis.parse_set(small_config(), overrides)
    state, network = diagnosis.template(config, device)
    results = {"random_init": report("random_init", network, config, sims, games, seed, include_per_game)}
    for step in steps:
        diagnosis.restore(state, ckpt_dir, step)
        results[f"step{step}"] = report(f"step{step}", network, config, sims, games, seed, include_per_game)
    return results


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ckpt-dir", default="runs/torch_scalar60k/ckpt")
    parser.add_argument("--steps", type=int, nargs="+", default=[5000, 10000, 15000])
    parser.add_argument("--games", type=int, default=32)
    parser.add_argument("--sims", type=int, default=200, help="raised sim budget variant")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument(
        "--set",
        dest="overrides",
        action="append",
        default=[],
        metavar="FIELD=VALUE",
        help="TrainConfig overrides matching the checkpoint's training config (e.g. --set value_bins=256 "
        "--set reward_bins=128 for a categorical checkpoint, --set search_backend=auto for the kernel)",
    )
    parser.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' to run on the CPU)")
    args = parser.parse_args(argv)
    autopsy(args.ckpt_dir, args.steps, args.games, args.sims, args.seed, args.overrides, args.device)


if __name__ == "__main__":
    main()
