"""Rollout benchmark: ``python -m simulate_2048_tpu_torch.bench [--device cpu]``.

Counterpart of the repository's root ``bench.py``: batched uniform-random
auto-reset rollouts on one device, printed as ONE JSON line with the
env-steps per second.

- On the GPU (the default; raises when there is none): 65,536 boards x 128
  steps through the CUDA rollout kernel (``ops/rollout_kernel.py``). A timed
  repetition is everything a caller pays for: one kernel launch, which
  derives the per-board seeds from the run seed itself, the sum of the
  finished episodes, and its fetch to the host, which ends the repetition.
- On the CPU (``--device cpu``): 4,096 boards x 32 steps through the plain
  stepwise rollout (``ops.rollout.random_rollout``).

One warm-up (it also builds the kernel), then the best of five repetitions,
with all five times in the line so that drift can be traced. ``value`` is
what a caller gets, host work included; ``kernel_ms`` (CUDA events around the
launch, the least of the five; null on the CPU) is the kernel's share of
it, so that both layers are read from one run.
"""

from __future__ import annotations

import argparse
import json
import time

REPS = 5


def gpu_repetition(seed: int, num_envs: int, num_steps: int, device) -> tuple[int, float]:
    """One repetition on the card: one kernel launch of ``num_steps`` steps of
    ``num_envs`` boards whose seeds it derives from the run ``seed``, and the
    fetch of the episode count, which waits for the device. Returns
    ``(episodes finished, ms of the kernel alone by CUDA events)``."""
    import torch

    from simulate_2048_tpu_torch.ops.rollout_kernel import rollout_kernel_from_run_seed

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    _, episodes, _, _ = rollout_kernel_from_run_seed(seed, num_envs, num_steps, device)
    end.record()
    finished = int(episodes.sum(dtype=torch.int32))  # in int32: no cast kernel before the sum
    return finished, start.elapsed_time(end)


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description="Random-rollout env throughput on one device (PyTorch port)")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' to run on the CPU)")
    args = parser.parse_args(argv)

    import torch

    from simulate_2048_tpu_torch.device import resolve_device
    from simulate_2048_tpu_torch.ops.rollout import random_rollout
    from simulate_2048_tpu_torch.utils.card import power_limit_w

    device = resolve_device(args.device)
    on_gpu = device.type == "cuda"
    num_envs, num_steps = (65_536, 128) if on_gpu else (4_096, 32)

    def run(seed: int) -> float | None:
        if on_gpu:
            return gpu_repetition(seed, num_envs, num_steps, device)[1]
        int(random_rollout(seed, num_envs, num_steps, device).episodes_finished)
        return None

    run(1)  # warm-up: builds and loads the kernel
    times, kernel_ms = [], []
    for rep in range(REPS):
        t0 = time.perf_counter()
        kernel_ms.append(run(2 + rep))
        times.append(time.perf_counter() - t0)

    result = {
        "metric": "env_steps_per_s_per_chip",
        "value": round(num_envs * num_steps / min(times), 1),
        "unit": "env-steps/s",
        "backend": "cuda_rollout" if on_gpu else "torch_loop",
        "device": torch.cuda.get_device_name(device) if on_gpu else "cpu",
        "power_limit_w": power_limit_w() if on_gpu else None,
        "num_envs": num_envs,
        "num_steps": num_steps,
        "reps": REPS,
        "times_s": [round(t, 6) for t in times],
        "kernel_ms": round(min(kernel_ms), 6) if on_gpu else None,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
