"""Training-pipeline benchmark: ``python -m simulate_2048_tpu_torch.scripts.benchmark_training``.

Port of the repository's ``scripts/benchmark_training.py``: replay sampling
and learner-step timings, steps/s, an fp32-against-bf16 comparison, and the
step's model-FLOPs utilization. Same flags, defaults and result keys, plus
``--device`` (default ``cuda``; raises when no GPU is present unless given
``--device cpu``).

- The fixture is the JAX script's dummy trajectories (``numpy``
  ``RandomState(0)``, ``max(min_buffer_size, 64)`` trajectories of the
  preset's length), made on the host once, moved to the device once and
  inserted into a fresh buffer there.
- ``sample_ms``: ``replay.sample_batch`` of one batch. Each dtype then gets a
  fresh learner (the weights of ``PRNGKey(0)``, as JAX's) and
  ``train_step`` on one sampled batch is timed by
  ``utils.profiling.time_fn(warmup=1, reps=max(steps, 3))``:
  ``train_compile_ms`` is the first call, ``train_step_ms`` the best.
- ``flops_per_step``: PyTorch's own count, ``torch.utils.flop_counter.
  FlopCounterMode`` over one more whole ``train_step`` (forward, backward,
  optimizer), taken outside the timed steps. It counts the dense products
  (matrix multiplies); XLA's cost model, which the JAX script reads, counts
  elementwise work too, so the two are different definitions.
- ``mfu_vs_bf16_peak`` = ``flops_per_step`` / best step time / peak, against
  the card's dense bf16 tensor-core peak for both dtypes, as the JAX script
  does. ``--peak-tflops`` defaults, on the card, to that peak for the SKU the
  card names (``utils/card.py``); on the CPU there is no default and, without
  the flag, no MFU (null).

Beside the JAX script's keys the JSON names the device, the card's name and
power limit (``nvidia-smi``) and the TF32 setting of matrix multiplies, which
stays PyTorch's default (off): fp32 products run in full float32.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import replace

import numpy as np
import torch

from simulate_2048_tpu_torch.training.config import TrainConfig, default_config, small_config, tiny_config
from simulate_2048_tpu_torch.training.replay import Trajectory

PRESETS = {"tiny": tiny_config, "small": small_config, "full": default_config}


def dummy_trajectories(config: TrainConfig, device: torch.device | str = "cpu") -> Trajectory:
    """The JAX script's dummy-trajectory fixture, made with numpy on the host and moved to ``device`` once."""
    rs = np.random.RandomState(0)
    n_traj, t = max(config.min_buffer_size, 64), config.max_trajectory_length
    arrays = dict(
        boards=rs.randint(0, 8, (n_traj, t + 1, 16)).astype(np.int8),
        actions=rs.randint(0, 4, (n_traj, t)).astype(np.int8),
        rewards=(rs.rand(n_traj, t) * 4).astype(np.float32),
        policies=np.full((n_traj, t, 4), 0.25, np.float32),
        values=(rs.rand(n_traj, t) * 10).astype(np.float32),
        priorities=rs.rand(n_traj, t).astype(np.float32),
        length=np.full((n_traj,), t, np.int32),
        terminated=np.ones(n_traj, bool),
        total_reward=(rs.rand(n_traj) * 100).astype(np.float32),
        max_tile=np.full((n_traj,), 256, np.int32),
    )
    return Trajectory(**{k: torch.from_numpy(v).to(device) for k, v in arrays.items()})


def step_flops(state, batch, weights, config: TrainConfig, optimizer) -> int:
    """FLOP of one whole ``train_step`` by ``FlopCounterMode`` (it also takes the step)."""
    from torch.utils.flop_counter import FlopCounterMode

    from simulate_2048_tpu_torch.training.learner import train_step

    with FlopCounterMode(display=False) as counter:
        train_step(state, batch, weights, config, optimizer)
    return counter.get_total_flops()


def benchmark(
    mode: str = "small",
    steps: int = 20,
    dtype: str = "both",
    peak_tflops: float | None = None,
    device: torch.device | str = "cuda",
) -> dict:
    """The JAX script's run and result keys (see the module docstring)."""
    from simulate_2048_tpu_torch.device import resolve_device
    from simulate_2048_tpu_torch.ops.rng import prng_key
    from simulate_2048_tpu_torch.training.learner import create_optimizer, create_train_state, train_step
    from simulate_2048_tpu_torch.training.replay import add_trajectories, init_buffer, sample_batch
    from simulate_2048_tpu_torch.utils.card import BF16_TFLOPS, card_line, sku
    from simulate_2048_tpu_torch.utils.profiling import time_fn

    device = resolve_device(device)
    on_gpu = device.type == "cuda"
    if peak_tflops is None and on_gpu:
        peak_tflops = BF16_TFLOPS[sku(torch.cuda.get_device_name(device))]
    config = PRESETS[mode]()
    print(f"mode={mode} device={device}", file=sys.stderr)

    buffer = add_trajectories(init_buffer(config, device), dummy_trajectories(config, device))
    gen = torch.Generator(device=device).manual_seed(1)
    sample_stats = time_fn(lambda: sample_batch(buffer, gen, config.batch_size, config)[0].observations)
    batch, _, weights = sample_batch(buffer, gen, config.batch_size, config)

    def bench_dtype(use_bf16: bool) -> dict:
        cfg = replace(config, use_bfloat16=use_bf16)
        state, _ = create_train_state(cfg, prng_key(0), device)
        optimizer = create_optimizer(cfg)
        stats = time_fn(lambda: train_step(state, batch, weights, cfg, optimizer)[1].total_loss, warmup=1,
                        reps=max(steps, 3))  # fmt: skip
        flops = step_flops(state, batch, weights, cfg, optimizer)
        steps_per_s = 1000.0 / stats["best_ms"]
        mfu = None if peak_tflops is None else flops / (stats["best_ms"] / 1e3) / (peak_tflops * 1e12)
        return {
            "train_step_ms": stats["best_ms"],
            "train_compile_ms": stats["compile_plus_first_ms"],
            "learner_steps_per_s": steps_per_s,
            "samples_per_s": steps_per_s * cfg.batch_size,
            "flops_per_step": flops,
            # Against the card's bf16 tensor-core peak for both dtypes, as the JAX script does.
            "mfu_vs_bf16_peak": mfu,
        }

    result = {
        "mode": mode,
        "batch_size": config.batch_size,
        "sample_ms": sample_stats["best_ms"],
        "peak_tflops_assumed": peak_tflops,
        "device": torch.cuda.get_device_name(device) if on_gpu else str(device),
        "card": card_line() if on_gpu else None,
        "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
    }
    if dtype in ("fp32", "both"):
        result["fp32"] = bench_dtype(False)
    if dtype in ("bf16", "both"):
        result["bf16"] = bench_dtype(True)
    if dtype == "config":
        result["config_dtype"] = bench_dtype(config.use_bfloat16)
    if "fp32" in result and "bf16" in result:
        result["bf16_speedup"] = result["fp32"]["train_step_ms"] / result["bf16"]["train_step_ms"]
    return result


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description="Training-pipeline benchmark (PyTorch port)")
    parser.add_argument("--mode", choices=["tiny", "small", "full"], default="small")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--dtype", choices=["both", "fp32", "bf16", "config"], default="both")
    parser.add_argument(
        "--peak-tflops",
        type=float,
        default=None,
        help="bf16 peak of the card in TFLOP/s (default on the card: its SKU's dense bf16 tensor-core peak, "
        "989 for an H100 SXM; no default on the CPU)",
    )
    parser.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' to run on the CPU)")
    args = parser.parse_args(argv)
    result = benchmark(args.mode, args.steps, args.dtype, args.peak_tflops, args.device)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
