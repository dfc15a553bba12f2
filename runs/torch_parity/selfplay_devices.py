"""Sampled self-play of one network on the GPU and on the CPU: the scalar
recipe's self-play (``run_scalar60k_arm.sh``: temperature 1, Dirichlet root
noise, 64 games, 50 simulations) from the same weights, under the
whole-search kernel and the plain search on the GPU and the plain search on
the CPU, each with its own draws. From the repository root:

    python runs/torch_parity/selfplay_devices.py BACKEND --segments 4 [--ckpt DIR] [--seed N] > out.jsonl

BACKEND is ``cuda_auto``, ``cuda_xla`` or ``cpu_xla``. The weights are the
newest checkpoint in ``--ckpt`` (a port checkpoint directory of the recipe's
config), else fresh weights from ``--seed``. Prints one JSON line a segment
(``finish_gen_stats``'s keys, and the share of moves that follow the most
visited action) and one with the means over the segments.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from simulate_2048_tpu_torch.env import env as envlib
from simulate_2048_tpu_torch.models.network import network_from_config
from simulate_2048_tpu_torch.ops.rng import prng_key
from simulate_2048_tpu_torch.scripts.recipes import recipe_config
from simulate_2048_tpu_torch.training.checkpoint import CheckpointManager
from simulate_2048_tpu_torch.training.self_play import finish_gen_stats, generate_games


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("backend", choices=["cuda_auto", "cuda_xla", "cpu_xla"])
    parser.add_argument("--segments", type=int, default=4)
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    device_name, backend = args.backend.split("_")
    device = torch.device(device_name)
    config = dataclasses.replace(recipe_config("run_scalar60k_arm.sh"), search_backend=backend)
    network = network_from_config(config, prng_key(args.seed), "cpu")
    step = 0
    if args.ckpt:
        payload = torch.load(f"{args.ckpt}/step_{CheckpointManager(args.ckpt).latest_step()}.pt", map_location="cpu",
                             weights_only=True)  # fmt: skip
        network.load_state_dict(payload["network"])
        step = int(payload["step"])
    network = network.to(device)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    state = envlib.reset_batch(args.seed + 7, config.num_parallel_games, device)
    records = []
    for k in range(args.segments):
        state, traj, stats = generate_games(network, gen, config, step, env_state=state)
        record = finish_gen_stats(stats, traj)
        live = torch.arange(traj.actions.shape[1], device=device)[None] < traj.length[:, None]
        follows = (traj.policies.argmax(-1) == traj.actions.long())[live].float().mean()
        record["follows_most_visited"] = float(follows)
        records.append(record)
        print(json.dumps({"backend": args.backend, "weights_step": step, "segment": k, **record}), flush=True)
    means = {key: float(np.mean([r[key] for r in records])) for key in records[0]}
    print(json.dumps({"backend": args.backend, "weights_step": step, "mean_over": args.segments, **means}), flush=True)


if __name__ == "__main__":
    main()
