"""Multi-process data parallelism of the PyTorch port: two processes joined by
``parallel.initialize_distributed`` (gloo, on the CPU) each run the
data-parallel step on their half of one batch, over a mesh of two replicas of
their own (the in-process ring, then ``dist.all_reduce`` across the
processes), and must agree on the loss bit for bit and match one process's
single-device step on the whole batch within the loss tolerance of
``tests/test_parallel.py`` (rtol 1e-5). The counterpart of
``tests/test_multiprocess.py``. Run as a script, this file is one worker.
"""

import argparse
import dataclasses
import os
import re
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 2


def worker(rank: int, port: int) -> None:
    import copy

    import numpy as np
    import torch
    import torch.distributed as dist

    from simulate_2048_tpu_torch.ops.rng import prng_key
    from simulate_2048_tpu_torch.parallel import initialize_distributed, make_dp_train_step, make_mesh
    from simulate_2048_tpu_torch.training import learner
    from simulate_2048_tpu_torch.training.config import tiny_config
    from simulate_2048_tpu_torch.training.losses import TrainingTargets

    torch.set_num_threads(1)
    initialize_distributed(f"localhost:{port}", 2, rank, device="cpu")
    cfg = dataclasses.replace(tiny_config(), hidden_size=32, num_residual_blocks=1, batch_size=16, warmup_steps=1,
                              learning_rate=1e-3)  # fmt: skip
    state, network = learner.create_train_state(cfg, prng_key(0))
    optimizer = learner.create_optimizer(cfg)
    single = learner.TrainState(copy.deepcopy(network), optimizer.init(list(state.params)))
    step = make_dp_train_step(network, cfg, optimizer, make_mesh(["cpu"] * 2))
    half = cfg.batch_size // 2
    for s in range(STEPS):
        rs = np.random.RandomState(s)
        b, k = cfg.batch_size, cfg.num_unroll_steps
        batch = TrainingTargets(
            torch.from_numpy(rs.randint(0, 8, size=(b, k + 1, 16)).astype(np.float32) / 16.0),
            torch.from_numpy(rs.randint(0, 4, size=(b, k))),
            torch.from_numpy(rs.dirichlet([1.0] * 4, size=(b, k + 1)).astype(np.float32)),
            torch.from_numpy((rs.rand(b, k + 1) * 100).astype(np.float32)),
            torch.from_numpy((rs.rand(b, k) * 10).astype(np.float32)),
        )
        weights = torch.from_numpy(rs.rand(b).astype(np.float32) + 0.1)
        mine = TrainingTargets(*(x[rank * half : (rank + 1) * half] for x in batch))
        state, loss, priorities = step(state, mine, weights[rank * half : (rank + 1) * half])
        single, single_loss, _ = learner.train_step(single, batch, weights, cfg, optimizer)
        assert priorities.shape == (half,)
        print(f"process {rank} step {s}: loss {float(loss.total_loss).hex()} single {float(single_loss.total_loss)!r}",
              flush=True)  # fmt: skip
    dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.timeout(300)
def test_two_process_dp_train_step_agrees():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    port = free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(rank), "--port", str(port)],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )  # fmt: skip
        for rank in range(2)
    ]
    outputs = []
    for p in procs:
        out, _ = p.communicate(timeout=280)
        outputs.append(out)
        assert p.returncode == 0, out

    losses, singles = {}, {}
    for out in outputs:
        for rank, step, loss, single in re.findall(r"process (\d) step (\d): loss (\S+) single (\S+)", out):
            losses.setdefault(int(step), {})[int(rank)] = float.fromhex(loss)
            singles[int(step)] = float(single)
    assert sorted(losses) == list(range(STEPS)), outputs
    for step, by_rank in losses.items():
        assert len(by_rank) == 2
        assert by_rank[0] == by_rank[1], f"step {step}: {by_rank}"
        assert by_rank[0] == pytest.approx(singles[step], rel=1e-5)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--port", type=int, required=True)
    args = parser.parse_args()
    worker(args.rank, args.port)
