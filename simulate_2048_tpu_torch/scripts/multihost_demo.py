"""Multi-process data-parallel training demo: ``python -m simulate_2048_tpu_torch.scripts.multihost_demo``.

Port of the repository's ``scripts/multihost_demo.py``. Each process owns a
shard of the global batch; ``parallel.initialize_distributed`` joins the
processes into one ``torch.distributed`` job (gloo on the CPU, NCCL on
CUDA), and the data-parallel step (``parallel/dp.py``) all-reduces the
gradients across them. Launch one process per host:

  python -m simulate_2048_tpu_torch.scripts.multihost_demo --num-processes 2 --process-id 0 --device cpu &
  python -m simulate_2048_tpu_torch.scripts.multihost_demo --num-processes 2 --process-id 1 --device cpu &

Same flags (``--coordinator --num-processes --process-id --steps``) and
printed lines, plus ``--device`` (default ``cuda``; raises when no GPU is
present unless given ``--device cpu``). Without ``--num-processes`` the
rendezvous comes from the environment (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``), where the JAX script lets ``jax.distributed``
detect it. Each process's mesh is its own device, one replica: the step's
``dist.all_reduce`` is the only reduction across processes. NCCL takes one
card a rank, so on one GPU the demo runs as one process (``--num-processes
1``); two or more run over gloo on the CPU, or across cards.

The model is ``tiny_config()`` at hidden 32 with one block, 8 windows a
process; every process builds the same weights (those of ``PRNGKey(0)``,
as JAX's) and draws its shard from ``np.random.RandomState(100 + pid)``.
"""

from __future__ import annotations

import argparse
from dataclasses import replace

import numpy as np
import torch

PER_PROCESS = 8  # windows of the global batch a process holds


def local_batch(pid: int, config):
    """This process's shard of the global batch, and its importance weights (all 1)."""
    from simulate_2048_tpu_torch.training.losses import TrainingTargets

    rs = np.random.RandomState(100 + pid)
    k = config.num_unroll_steps
    batch = TrainingTargets(
        observations=torch.from_numpy(rs.rand(PER_PROCESS, k + 1, 16).astype(np.float32)),
        actions=torch.from_numpy(rs.randint(0, 4, (PER_PROCESS, k))),
        target_policies=torch.full((PER_PROCESS, k + 1, 4), 0.25),
        target_values=torch.from_numpy(rs.rand(PER_PROCESS, k + 1).astype(np.float32)),
        target_rewards=torch.from_numpy(rs.rand(PER_PROCESS, k).astype(np.float32)),
    )
    return batch, torch.ones(PER_PROCESS)


def demo_config(num_processes: int):
    """The demo's model: ``tiny_config()`` at hidden 32, one block, 8 windows a process."""
    from simulate_2048_tpu_torch.training.config import tiny_config

    return replace(tiny_config(), hidden_size=32, num_residual_blocks=1, batch_size=PER_PROCESS * num_processes)


def run(coordinator: str | None, num_processes: int | None, process_id: int | None, steps: int = 3,
        device="cuda", network=None) -> list[float]:  # fmt: skip
    """Join the job, take ``steps`` data-parallel steps on this process's
    shard, print the JAX script's lines; returns the total loss of each step.
    ``network`` (the demo config's architecture) replaces the seeded weights."""
    import torch.distributed as dist

    from simulate_2048_tpu_torch.device import resolve_device
    from simulate_2048_tpu_torch.ops.rng import prng_key
    from simulate_2048_tpu_torch.parallel import initialize_distributed, make_dp_train_step, make_mesh
    from simulate_2048_tpu_torch.training.learner import TrainState, create_optimizer, create_train_state

    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device() if device.index is None else device.index)
        torch.cuda.set_device(device)  # NCCL's rank-to-card binding
    initialize_distributed(coordinator if num_processes is not None else None, num_processes, process_id, device)
    pid, nproc = dist.get_rank(), dist.get_world_size()
    print(f"process {pid}/{nproc}: 1 local / {nproc} global devices", flush=True)

    cfg = demo_config(nproc)
    optimizer = create_optimizer(cfg)
    if network is None:
        # Same seed everywhere: identical initial weights on all processes.
        state, network = create_train_state(cfg, prng_key(0), device)
    else:
        network = network.to(device)
        state = TrainState(network, optimizer.init(list(network.parameters())))
    batch, weights = local_batch(pid, cfg)
    batch = type(batch)(*(x.to(device) for x in batch))
    weights = weights.to(device)

    step = make_dp_train_step(network, cfg, optimizer, make_mesh([device]))
    losses = []
    try:
        for i in range(steps):
            state, loss, _ = step(state, batch, weights)
            losses.append(float(loss.total_loss))
            print(f"process {pid} step {i}: loss {losses[-1]:.6f}", flush=True)
    finally:
        dist.destroy_process_group()
    return losses


def main(argv: list[str] | None = None) -> list[float]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--coordinator", default="localhost:29409")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' to run on the CPU)")
    args = parser.parse_args(argv)
    return run(args.coordinator, args.num_processes, args.process_id, args.steps, args.device)


if __name__ == "__main__":
    main()
