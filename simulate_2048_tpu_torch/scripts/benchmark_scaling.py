"""Scaling-efficiency benchmark: ``python -m simulate_2048_tpu_torch.scripts.benchmark_scaling``.

Port of the repository's ``scripts/benchmark_scaling.py``: the sharded
rollout (``parallel.make_sharded_rollout``, env-steps/s) and the
data-parallel learner step (``parallel.make_dp_train_step``, samples/s) at
mesh sizes 1, 2, 4, ... up to the mesh's devices, each with its
efficiency = throughput(N) / (N x throughput(1)). Same flags, defaults and
result keys, plus ``--device`` (default ``cuda``; raises when no GPU is
present unless given ``--device cpu``).

- ``--virtual N`` makes the mesh N replicas of the one device: N CPU
  replicas with ``--device cpu`` (the JAX script's virtual CPU devices), N
  replicas of the card with ``--device cuda``, as ``chip_smoke.py``'s
  data-parallel path runs them. Each entry then says
  ``"replicas_of_one_card": true`` on the card: its efficiencies are not
  scaling across cards. Without it the mesh is every visible GPU (one CPU
  device with ``--device cpu``).
- The learner runs the tiny preset at hidden 64 x 2 blocks with a global
  batch of ``--batch-per-device`` x N, on a batch sampled once from a buffer
  of this package's copy of the test suite's dummy trajectories
  (:func:`make_trajectories`, 64 trajectories of 30 steps). Its gradients are
  summed by one ring all-reduce launch a step on a mesh of two or more
  replicas of a card; each entry counts them (``ring_launches_per_step``).
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import replace
from typing import Callable

import numpy as np
import torch

from simulate_2048_tpu_torch.training.config import TrainConfig, tiny_config
from simulate_2048_tpu_torch.training.replay import Trajectory

MESH_SIZES = (1, 2, 4, 8, 16, 32)
ROLLOUT_SEED = 3


def make_trajectories(batch: int, length_each: int, cfg: TrainConfig, seed: int = 0) -> Trajectory:
    """Dummy trajectories of ``length_each`` real steps: the test suite's
    fixture (``tests/test_training.py`` ``make_trajectories``), array for array."""
    t = cfg.max_trajectory_length
    rs = np.random.RandomState(seed)
    arrays = dict(
        boards=rs.randint(0, 6, size=(batch, t + 1, 16)).astype(np.int8),
        actions=rs.randint(0, 4, size=(batch, t)).astype(np.int8),
        rewards=rs.rand(batch, t).astype(np.float32) * 4,
        policies=np.full((batch, t, 4), 0.25, np.float32),
        values=rs.rand(batch, t).astype(np.float32) * 10,
        priorities=rs.rand(batch, t).astype(np.float32) + 0.1,
        length=np.full(batch, length_each, np.int32),
        terminated=np.ones(batch, bool),
        total_reward=rs.rand(batch).astype(np.float32) * 100,
        max_tile=rs.choice([64, 128, 256], batch).astype(np.int32),
    )
    return Trajectory(**{k: torch.from_numpy(v) for k, v in arrays.items()})


def learner_config(n: int, batch_per_device: int) -> TrainConfig:
    """The JAX script's learner config for a mesh of ``n``."""
    return replace(
        tiny_config(), hidden_size=64, num_residual_blocks=2, batch_size=batch_per_device * n, replay_buffer_size=256
    )


def learner_batch(cfg: TrainConfig, device) -> tuple:
    """One batch and its importance weights, sampled from a buffer of :func:`make_trajectories` on ``device``."""
    from simulate_2048_tpu_torch.training.replay import add_trajectories, init_buffer, sample_batch

    traj = Trajectory(*(x.to(device) for x in make_trajectories(64, 30, cfg)))
    buffer = add_trajectories(init_buffer(cfg, device), traj)
    batch, _, weights = sample_batch(buffer, torch.Generator(device=device).manual_seed(1), cfg.batch_size, cfg)
    return batch, weights


def learner_step(mesh, cfg: TrainConfig, network, batch, weights) -> Callable:
    """One data-parallel step over ``mesh`` from a fresh optimizer state on
    ``network``, as a nullary function returning the loss breakdown (the
    state moves on at every call)."""
    from simulate_2048_tpu_torch.parallel import make_dp_train_step
    from simulate_2048_tpu_torch.training.learner import TrainState, create_optimizer

    optimizer = create_optimizer(cfg)
    state = TrainState(network, optimizer.init(list(network.parameters())))
    dp_step = make_dp_train_step(network, cfg, optimizer, mesh)
    return lambda: dp_step(state, batch, weights)[1]


def mesh_devices(device: torch.device, virtual: int) -> list[torch.device]:
    """The devices of the largest mesh (see the module docstring)."""
    if virtual:
        return [device] * virtual
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def benchmark(
    virtual: int = 0,
    envs_per_device: int = 4096,
    steps: int = 64,
    batch_per_device: int = 64,
    device: torch.device | str = "cuda",
) -> list[dict]:
    """The JAX script's run and result entries (see the module docstring)."""
    from simulate_2048_tpu_torch.device import resolve_device
    from simulate_2048_tpu_torch.models.network import network_from_config
    from simulate_2048_tpu_torch.ops.rng import prng_key
    from simulate_2048_tpu_torch.parallel import make_mesh, make_sharded_rollout, ring
    from simulate_2048_tpu_torch.utils.profiling import time_fn

    device = resolve_device(device)
    devices = mesh_devices(device, virtual)
    one_card = device.type == "cuda" and len(set(devices)) == 1
    print(f"devices: {len(devices)} x {devices[0]}" + (" (replicas of one card)" if one_card else ""), file=sys.stderr)

    results = []
    for n in [n for n in MESH_SIZES if n <= len(devices)]:
        mesh = make_mesh(devices[:n])

        # Actor scaling: environments proportional to devices, no traffic between them.
        rollout = make_sharded_rollout(mesh, num_envs=envs_per_device * n, num_steps=steps)
        st = time_fn(lambda: rollout(ROLLOUT_SEED), warmup=1, reps=3)
        env_steps_s = envs_per_device * n * steps / (st["best_ms"] / 1e3)

        # Learner scaling: global batch proportional to devices.
        cfg = learner_config(n, batch_per_device)
        network = network_from_config(cfg, prng_key(0), mesh.devices[0])
        step = learner_step(mesh, cfg, network, *learner_batch(cfg, mesh.devices[0]))
        launches = ring.LAUNCHES["ring_all_reduce"]
        st2 = time_fn(lambda: step().total_loss, warmup=1, reps=3)
        ring_launches = (ring.LAUNCHES["ring_all_reduce"] - launches) / 4  # the warm-up and three timed steps
        samples_s = cfg.batch_size / (st2["best_ms"] / 1e3)

        results.append({
            "devices": n,
            "env_steps_per_s": env_steps_s,
            "learner_samples_per_s": samples_s,
            "device": torch.cuda.get_device_name(mesh.devices[0]) if device.type == "cuda" else str(device),
            "replicas_of_one_card": one_card,
            "ring_launches_per_step": ring_launches,
        })  # fmt: skip
        print(f"N={n}: rollout {env_steps_s / 1e6:.2f}M steps/s, learner {samples_s:.0f} samples/s", file=sys.stderr)

    base = results[0]
    for r in results:
        n = r["devices"]
        r["rollout_efficiency"] = r["env_steps_per_s"] / (n * base["env_steps_per_s"])
        r["learner_efficiency"] = r["learner_samples_per_s"] / (n * base["learner_samples_per_s"])
    return results


def main(argv: list[str] | None = None) -> list[dict]:
    parser = argparse.ArgumentParser(description="Data-parallel scaling efficiency (PyTorch port)")
    parser.add_argument(
        "--virtual",
        type=int,
        default=0,
        help="a mesh of N replicas of the one device (CPU, or the card with --device cuda)",
    )
    parser.add_argument("--envs-per-device", type=int, default=4096)
    parser.add_argument("--steps", type=int, default=64)
    parser.add_argument("--batch-per-device", type=int, default=64)
    parser.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' to run on the CPU)")
    args = parser.parse_args(argv)
    results = benchmark(args.virtual, args.envs_per_device, args.steps, args.batch_per_device, args.device)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
