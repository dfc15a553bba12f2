"""Actor/learner overlap against the serial trainer: ``python -m simulate_2048_tpu_torch.scripts.measure_overlap``.

Port of the repository's ``scripts/measure_overlap.py``: learner steps a
second in three set-ups of one config (``--mode``, generation every
``generation_interval`` steps, no evaluation or checkpoint in the timed
window):

- **serial**: the ``Trainer`` loop, generation interleaved with training in
  one process (learner steps/s including the generation stalls);
- **solo**: the same loop with generation switched off (the upper bound);
- **overlapped**: a ``LearnerServer`` that never generates, fed by one actor
  process (``python -m simulate_2048_tpu_torch.actor_learner_demo --role
  actor``) streaming trajectories.

``overlap_efficiency_vs_solo`` is overlapped / solo and
``speedup_vs_serial`` overlapped / serial. Each rate is taken over
``--steps`` steps after 10 warm-up steps. Same flags, defaults and JSON keys
(printed with indent 2; ``platform`` is ``"device"`` on the GPU and
``"cpu-shared-cores"`` on the CPU, where the actor shares the learner's
cores), plus ``--device`` (default ``cuda``; raises when no GPU is present
unless given ``--device cpu``; the actor runs on the same device) and
``--set FIELD=VALUE`` (a departure: config overrides as ``train`` and the
actor/learner demo take them, also given to the actor; ``--set
search_backend=auto`` runs self-play on the whole-search kernel, where the
JAX script's compiled search is as fast as the kernel and the port's default
plain search would take most of a run to fill the buffers).

Usage (on the GPU): ``python -m simulate_2048_tpu_torch.scripts.measure_overlap --steps 120
--set search_backend=auto``
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def timed_steps(trainer, n: int, generate: bool) -> float:
    """Steps/s of the serial trainer loop over ``n`` steps, with or without generation."""
    if not generate:
        trainer.config = replace(trainer.config, generation_interval=1 << 30)
    t0 = time.perf_counter()
    trainer.train(n, verbose=False)
    if trainer.device.type == "cuda":
        import torch

        torch.cuda.synchronize(trainer.device)
    return n / (time.perf_counter() - t0)


def measure(steps: int = 120, mode: str = "tiny", overrides: list[str] | None = None, device="cuda") -> dict:
    """The three rates and the JAX script's result keys (see the module docstring)."""
    from simulate_2048_tpu_torch.device import resolve_device
    from simulate_2048_tpu_torch.parallel.actor_learner import LearnerServer
    from simulate_2048_tpu_torch.training.config import apply_overrides, small_config, tiny_config
    from simulate_2048_tpu_torch.training.trainer import Trainer

    device = resolve_device(device)
    overrides = list(overrides or [])
    base = apply_overrides({"tiny": tiny_config, "small": small_config}[mode](), overrides)
    # Frequent generation makes the serial loop pay visible generation stalls (tiny generates every 20 steps).
    config = replace(base, eval_interval=1 << 30, checkpoint_interval=1 << 30)

    # --- serial baseline (with generation) and the solo upper bound (without)
    serial_trainer = Trainer(config, seed=0, device=device)
    serial_trainer.initialize()
    serial_trainer.fill_buffer(verbose=False)
    timed_steps(serial_trainer, 10, True)  # warm-up
    serial_sps = timed_steps(serial_trainer, steps, True)

    solo_trainer = Trainer(config, seed=0, device=device)
    solo_trainer.initialize()
    solo_trainer.fill_buffer(verbose=False)
    timed_steps(solo_trainer, 10, False)
    solo_sps = timed_steps(solo_trainer, steps, False)

    # --- overlapped: the learner server and an actor process
    learner_trainer = Trainer(config, seed=0, device=device)
    learner_trainer.initialize()
    server = LearnerServer(learner_trainer, port=0).start()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)}
    command = [
        sys.executable, "-m", "simulate_2048_tpu_torch.actor_learner_demo",
        "--role", "actor", "--mode", mode,
        "--host", server.address[0], "--port", str(server.address[1]),
        "--generations", "1000000", "--device", str(device),
        *(word for item in overrides for word in ("--set", item)),
    ]  # fmt: skip
    actor = subprocess.Popen(command, env=env, cwd=str(REPO), stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        server.fill_buffer(timeout_s=600.0, verbose=False)
        server.run(10, verbose=False)  # warm-up
        t0 = time.perf_counter()
        server.run(steps, verbose=False)
        if device.type == "cuda":
            import torch

            torch.cuda.synchronize(device)
        overlapped_sps = steps / (time.perf_counter() - t0)
        traj_in = server.trajectories_received
    finally:
        actor.terminate()
        actor.wait(timeout=30)
        server.close()

    return {
        "mode": mode,
        "steps": steps,
        "platform": "cpu-shared-cores" if device.type == "cpu" else "device",
        "serial_steps_per_s": serial_sps,
        "solo_steps_per_s": solo_sps,
        "overlapped_steps_per_s": overlapped_sps,
        "trajectory_batches_streamed": traj_in,
        "overlap_efficiency_vs_solo": overlapped_sps / solo_sps,
        "speedup_vs_serial": overlapped_sps / serial_sps,
    }


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=120)
    parser.add_argument("--mode", choices=["tiny", "small"], default="tiny")
    parser.add_argument(
        "--set",
        dest="overrides",
        action="append",
        default=[],
        metavar="FIELD=VALUE",
        help="override any TrainConfig field (repeatable; given to the actor too)",
    )
    parser.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' to run on the CPU)")
    args = parser.parse_args(argv)
    result = measure(args.steps, args.mode, args.overrides, args.device)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
