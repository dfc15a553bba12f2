"""Prior-influence sweep: ``python -m simulate_2048_tpu_torch.scripts.prior_sweep``.

Port of the repository's ``scripts/prior_sweep.py``: re-evaluates one
checkpoint across (prior temperature, ``pb_c_init``, simulations) without
any training, to see whether a sharpened policy prior throttles the search.
Same flags (``--ckpt-dir --step --games --seed --variants --set``), defaults,
grid (ten entries, in the JAX script's order) and JSON keys, plus
``--device`` (default ``cuda``; raises when no GPU is present unless given
``--device cpu``). Departures:

- ``--ckpt-dir`` defaults to the port's scalar arm,
  ``runs/torch_scalar60k/ckpt`` (a ``torch.save`` checkpoint of the port's
  trainer, restored into ``small_config()``'s template after ``--set``).
- The JAX script divides the logits of the prediction head's apply function
  by the temperature. Here :func:`soften_prior` divides the policy layer's
  weight and bias by it in a copy of the network. The grid's temperatures are
  powers of two, so the division commutes with every rounding (barring
  subnormals) and the copy's logits are the wrapper's bit for bit; the
  whole-search kernel, which packs its weights from the network, searches
  with them as the plain search does.
- Every evaluation draws its games from a fresh ``torch.Generator`` seeded
  with ``--seed``, so every grid entry plays the same games. Before each
  JSON line a line on standard error names the search the entry took (a
  CUDA library, or ``plain``), its kernel launches and its seconds.

Usage (on the GPU):
    python -m simulate_2048_tpu_torch.scripts.prior_sweep --ckpt-dir runs/torch_scalar60k/ckpt \\
        --set search_backend=auto
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math

import torch

from simulate_2048_tpu_torch.scripts import diagnosis
from simulate_2048_tpu_torch.training.config import TrainConfig, small_config


def soften_prior(network, temp: float):
    """A copy of ``network`` whose policy logits are ``logits / temp``: the
    last layer of the prediction head with its weight and bias divided by
    ``temp``. Raises ``ValueError`` unless ``temp`` is a power of two, where
    the division is exact."""
    if not (temp > 0 and math.isfinite(temp) and math.frexp(temp)[0] == 0.5):
        raise ValueError(f"soften_prior takes a power-of-two temperature (exact in every rounding), not {temp}")
    soft = copy.deepcopy(network)
    with torch.no_grad():
        soft.prediction.policy_logits.weight.div_(temp)
        soft.prediction.policy_logits.bias.div_(temp)
    return soft


def grid(config: TrainConfig) -> list[tuple[str, float, float, int]]:
    """(name, prior temperature, pb_c_init, simulations), the JAX script's ten entries in its order."""
    pb, sims = config.pb_c_init, config.num_simulations
    return [
        ("base", 1.0, pb, sims),
        ("prior_T2", 2.0, pb, sims),
        ("prior_T4", 4.0, pb, sims),
        ("pb_c_0.5", 1.0, 0.5, sims),
        ("pb_c_0.8", 1.0, 0.8, sims),
        ("pb_c_1.75", 1.0, 1.75, sims),
        ("pb_c_2.5", 1.0, 2.5, sims),
        ("pb_c_4.0", 1.0, 4.0, sims),
        ("T4_pb_c_2.5", 4.0, 2.5, sims),
        ("T4_pb_c_0.5", 4.0, 0.5, sims),
    ]


def line(name: str, stats: dict) -> dict:
    """The JAX script's JSON line of one grid entry."""
    return {
        "variant": name,
        "mean_reward": round(stats["mean_reward"], 1),
        "sem": round(stats["sem_reward"], 1),
        "max_tile": stats["max_tile"],
        "reached_512": stats["reached_512"],
        "search_entropy": round(stats["mean_search_entropy"], 3),
    }


def sweep(network, config: TrainConfig, games: int, seed: int, wanted: set[str] | None = None,
          include_per_game: bool = False) -> list[tuple[str, dict]]:  # fmt: skip
    """Evaluate ``network`` at each grid entry (those named in ``wanted``
    when given) on the same games; prints each JSON line and returns
    (entry, evaluation stats) in order."""
    out = []
    for name, temp, pb, sims in grid(config):
        if wanted is not None and name not in wanted:
            continue
        cfg = dataclasses.replace(config, pb_c_init=pb, num_simulations=sims)
        net = soften_prior(network, temp) if temp != 1.0 else network
        stats = diagnosis.evaluate_seeded(net, cfg, seed, games, f"prior_sweep {name}", include_per_game)
        print(json.dumps(line(name, stats)), flush=True)
        out.append((name, stats))
    return out


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ckpt-dir", default="runs/torch_scalar60k/ckpt")
    parser.add_argument("--step", type=int, default=None)
    parser.add_argument("--games", type=int, default=16)
    parser.add_argument("--seed", type=int, default=77)
    parser.add_argument("--variants", default=None, help="comma-separated subset of grid names")
    parser.add_argument(
        "--set",
        dest="overrides",
        action="append",
        default=[],
        metavar="FIELD=VALUE",
        help="TrainConfig overrides matching the checkpoint's training config "
        "(e.g. --set observation_onehot=True for nets trained on lifted obs)",
    )
    parser.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' to run on the CPU)")
    args = parser.parse_args(argv)

    from simulate_2048_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    config = diagnosis.parse_set(small_config(), args.overrides)
    state, network = diagnosis.template(config, device)
    diagnosis.restore(state, args.ckpt_dir, args.step)
    wanted = set(args.variants.split(",")) if args.variants else None
    sweep(network, config, args.games, args.seed, wanted)


if __name__ == "__main__":
    main()
