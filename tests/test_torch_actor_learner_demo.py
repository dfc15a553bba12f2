"""The actor/learner entry point of the PyTorch port,
``python -m simulate_2048_tpu_torch.actor_learner_demo``, on the CPU: the
learner and one actor as two processes at the sizes of
``test_torch_actor_learner.micro_config``, and the GPU default without a GPU."""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from test_torch_actor_learner import micro_config

from simulate_2048_tpu_torch import actor_learner_demo
from simulate_2048_tpu_torch.training.config import tiny_config

REPO = Path(__file__).resolve().parent.parent
# micro_config's sizes, as --set overrides of --mode tiny; the learner role's evaluation cut to 2 games of 8 moves.
MICRO = ["--mode", "tiny"]
for field in dataclasses.fields(tiny_config()):
    value = getattr(micro_config(eval_games=2, eval_max_moves=8), field.name)
    if value != getattr(tiny_config(), field.name):
        MICRO += ["--set", f"{field.name}={value!r}"]
STEPS, GENERATIONS = 10, 4


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def counts_line(out: str, role: str) -> dict:
    lines = out.strip().splitlines()
    counts = json.loads(lines[-2])
    assert counts["role"] == role, lines
    return counts


@pytest.mark.timeout(180)
def test_learner_and_actor_run_as_two_processes():
    command = [sys.executable, "-m", "simulate_2048_tpu_torch.actor_learner_demo", "--device", "cpu",
               "--port", str(free_port()), *MICRO]  # fmt: skip
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    roles = {
        "learner": ["--role", "learner", "--steps", str(STEPS)],
        "actor": ["--role", "actor", "--generations", str(GENERATIONS), "--actor-seed", "1"],
    }
    procs = {
        role: subprocess.Popen(command + args, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                               text=True)  # fmt: skip
        for role, args in roles.items()
    }
    outs = {}
    try:
        for role, proc in procs.items():
            outs[role], _ = proc.communicate(timeout=150)
    finally:
        for proc in procs.values():
            proc.kill()
    for role, proc in procs.items():
        assert proc.returncode == 0, outs[role]

    done = outs["learner"].strip().splitlines()[-1]
    assert done.startswith(f"learner done: step {STEPS} ") and f"params_served {GENERATIONS} " in done, done
    learner = counts_line(outs["learner"], "learner")
    assert learner["steps"] == STEPS
    # The buffer fills from two batches (2 games each, min_buffer_size 4); later ones may come after the last step.
    assert 2 <= learner["trajectories_received"] <= GENERATIONS
    assert f"traj_batches {learner['trajectories_received']} " in done
    # The learner kept serving until the actor hung up: one pull a generation.
    assert learner["params_served"] == GENERATIONS
    assert [s for s, _ in learner["step_rates"]] == [5, 10]

    actor = counts_line(outs["actor"], "actor")
    assert actor["generations"] == GENERATIONS and actor["moves"] == GENERATIONS * 12
    assert len(actor["generation_windows"]) == GENERATIONS and actor["learner_steps"] == sorted(actor["learner_steps"])
    # On the CPU the search kernel's wrapper runs its plain version: no launch.
    assert sum(learner["launches"].values()) == sum(actor["launches"].values()) == 0
    assert outs["actor"].strip().splitlines()[-1] == f"actor 1 done: {GENERATIONS} generations"


@pytest.mark.parametrize("role", ["learner", "actor"])
def test_entry_point_needs_a_gpu_or_asks_for_cpu(role, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        actor_learner_demo.main(["--role", role, "--port", str(free_port()), *MICRO])
