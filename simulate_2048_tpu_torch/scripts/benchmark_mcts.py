"""Batched MCTS benchmark: ``python -m simulate_2048_tpu_torch.scripts.benchmark_mcts``.

Port of the repository's ``scripts/benchmark_mcts.py`` (``BASELINE.json``
config 3): stochastic search with chance nodes over a batch of boards with an
untrained network, reporting searches/s and simulations/s (one simulation is
one tree expansion). Same flags, defaults and result keys, plus ``--device``
(default ``cuda``; raises when no GPU is present unless given ``--device cpu``).

- The network's weights are those of ``PRNGKey(0)``, as JAX's, its
  towers in float32 (as the JAX script builds it), with ``--value-bins`` /
  ``--reward-bins`` heads; the roots are ``env.reset_batch(0, boards)``; the
  root's Dirichlet noise is drawn once from a generator on the device seeded
  with 1 and feeds every call, as the JAX script feeds the same keys.
- Without ``--pallas``: the plain search, ``search.mcts.batched_run_mcts``.
- With ``--pallas``: the whole-search CUDA kernel, ``ops/search_kernel.py``'s
  ``run_search_kernel`` on a pack of ``--weight-dtype`` in ``search_plan``'s
  layout, built once outside the timed calls. ``--weight-dtype`` and
  ``--hidden`` pick the library: float32 at H <= 256 ``whole_search``
  (scalar heads) or ``whole_search_categorical`` (categorical heads),
  bfloat16 at H <= 256 ``whole_search_bf16``, bfloat16 above
  ``whole_search_bf16_streamed``. Outside the kernel's limits
  (``kernel_limits``) the script prints the reason and exits 2. On CPU
  tensors the kernel's wrapper runs its plain version; on CUDA tensors it
  launches the kernel or raises.

The timing is ``utils.profiling.time_fn(warmup=1, reps=5)``: the best of
five calls, each waiting for the device. ``--trace DIR`` writes a
``torch.profiler`` trace of one more call into DIR. Beside the JAX script's
keys the JSON line names the device, the backend that ran (``plain`` or the
kernel's library) and the kernel launches the run made, by library.

``--phases`` (with ``--pallas``, on the card) then runs the kernel alone on
one search's roots, unclocked and clocked in turns (:func:`kernel_phases`),
and adds ``phases``: the computing warps' cycles by phase, a layer's cycles,
the layer norms a launch took in dense layers' epilogues, the producer's
stall share, the clocked launch's device time over the unclocked one's, and
the warps' cycles over the device time against the SM clock that
``nvidia-smi`` reads.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
from typing import Callable, NamedTuple

import torch

from simulate_2048_tpu_torch.env import env as envlib
from simulate_2048_tpu_torch.models.network import network_from_config
from simulate_2048_tpu_torch.ops import search_kernel as sk
from simulate_2048_tpu_torch.ops.rng import prng_key
from simulate_2048_tpu_torch.search.mcts import (
    PolicyOutput,
    SearchConfig,
    batched_run_mcts,
    draw_root_noise,
    root_inputs,
)
from simulate_2048_tpu_torch.training.config import TrainConfig, default_config, small_config, tiny_config
from simulate_2048_tpu_torch.utils import tracing

PRESETS = {"tiny": tiny_config, "small": small_config, "full": default_config}
WEIGHT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class KernelRefused(ValueError):
    """The whole-search kernel does not take this search config and width (``kernel_limits``' reason)."""


class Setup(NamedTuple):
    config: TrainConfig
    search_config: SearchConfig
    network: torch.nn.Module
    observations: torch.Tensor  # (boards, 16)


def setup(
    boards: int,
    sims: int,
    mode: str,
    max_depth: int | None,
    hidden: int | None,
    blocks: int | None,
    value_bins: int,
    reward_bins: int,
    device: torch.device,
) -> Setup:
    """The JAX script's network, search config and roots, on ``device``."""
    config = PRESETS[mode]()
    config = dataclasses.replace(
        config,
        hidden_size=hidden or config.hidden_size,
        num_residual_blocks=blocks or config.num_residual_blocks,
        use_bfloat16=False,  # the JAX script's create_network keeps its float32 default
        value_bins=value_bins,
        reward_bins=reward_bins,
    )
    network = network_from_config(config, prng_key(0), device)
    search_config = SearchConfig(
        num_simulations=sims,
        codebook_size=config.codebook_size,
        discount=config.discount,
        max_depth=max_depth,
        value_bins=value_bins,
        reward_bins=reward_bins,
    )
    observations = envlib.get_observation(envlib.reset_batch(0, boards, device))
    return Setup(config, search_config, network, observations)


def library(search_config: SearchConfig, hidden: int, weight_dtype: torch.dtype) -> str:
    """The CUDA library that runs these searches: the kernel's plan for the
    width and pack type, the float32 resident one named by its heads. Raises
    :class:`KernelRefused` outside the kernel's limits."""
    refused = sk.kernel_limits(search_config, hidden, weight_dtype)
    if refused is not None:
        raise KernelRefused(refused)
    return sk.launch_key(sk.library_name(weight_dtype, sk.search_plan(search_config, hidden, weight_dtype) > 0),
                         search_config)  # fmt: skip


def search_fn(
    network,
    observations: torch.Tensor,
    search_config: SearchConfig,
    pallas: bool = False,
    weight_dtype: torch.dtype = torch.float32,
    noise: torch.Tensor | None = None,
) -> Callable[[], PolicyOutput]:
    """One batched search of ``observations`` as a nullary function: the plain
    search, or with ``pallas`` the kernel on a pack made here, once (raises
    outside the kernel's limits). ``noise`` is the root's Dirichlet noise
    (B, A), the same every call."""
    if not pallas:
        return lambda: batched_run_mcts(network, observations, search_config, noise=noise)
    packed = sk.pack_for(network, search_config, weight_dtype)
    workspace = sk.SearchWorkspace(packed)
    return lambda: sk.run_search_kernel(network, observations, search_config, noise=noise, packed=packed,
                                        workspace=workspace)  # fmt: skip


def sm_clock_mhz() -> float | None:
    """The card's SM clock now, as ``nvidia-smi`` reads it (None where it cannot)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30, check=True).stdout  # fmt: skip
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def kernel_phases(
    network,
    observations: torch.Tensor,
    search_config: SearchConfig,
    weight_dtype: torch.dtype,
    noise: torch.Tensor | None,
    reps: int = 10,
) -> dict:
    """The kernel on one search's roots, ``reps`` unclocked and ``reps``
    clocked launches in turns after one of each, each timed by CUDA events;
    the clocked ones while a CPU-only ``torch.profiler`` profile records, the
    condition under which the wrapper clocks them. From their counters: each phase's share of
    the computing warps' cycles, a layer's cycles (a warp's cycles over the
    dense layers its block computed) in all and by phase, the layer norms a
    launch took in a dense layer's epilogue, and the producer's stalls over
    its cycles; ``clock_check`` is the warps' mean cycles over
    (the clocked launch's device time × the SM clock read after it), which
    reads about 1 when the phases cover the whole launch."""
    device = observations.device
    packed = sk.pack_for(network, search_config, weight_dtype)
    workspace = sk.SearchWorkspace(packed)
    with torch.no_grad():
        roots = [t.contiguous() for t in root_inputs(network, observations, search_config, None, noise)]
    library = sk.library_name(weight_dtype, packed.stream_chunk > 0)
    k = max(search_config.num_actions, search_config.codebook_size)
    shape = sk.launch_shape(library, observations.shape[0], network.hidden_size, k, search_config.value_bins,
                            search_config.reward_bins)  # fmt: skip
    warps = shape.threads // 32 - (library != "whole_search_streamed")  # the computing warps: all but a producer

    def timed() -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        sk.whole_search(*roots, packed, search_config, workspace)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    timed()  # the libraries' build and load, the tables' allocation
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        timed()  # the clocked kernel's first launch
    tracing.reset()
    unclocked, clocked = [], []
    for _ in range(reps):
        unclocked.append(timed())
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            clocked.append(timed())
    sm_mhz = sm_clock_mhz()
    counts: dict[str, int] = {}
    for named in tracing.snapshot()["counts"].values():
        for name, value in named.items():
            counts[name] = counts.get(name, 0) + value
    tracing.reset()
    cycles, layers = counts["search.kernel.cycles"], counts["search.kernel.layers"]
    producer, stalls = counts["search.kernel.producer_cycles"], counts["search.kernel.producer_stall_cycles"]
    phases = [name.rsplit(".", 1)[1] for name in sk.CLOCK_COUNTERS[:5]]
    warp_cycles = cycles / (warps * shape.blocks)
    out = {
        "library": library,
        "blocks": shape.blocks,
        "computing_warps": warps,
        "clocked_launches": counts["search.kernel.clocked_launches"],
        "layers_per_launch": layers / reps,
        "epilogue_norms_per_launch": counts["search.kernel.epilogue_norms"] / reps,
        "shares_pct": {p: 100.0 * counts[f"search.kernel.cycles.{p}"] / cycles for p in phases},
        "phase_sum_over_cycles": sum(counts[f"search.kernel.cycles.{p}"] for p in phases) / cycles,
        "cycles_per_layer": cycles / (warps * layers),
        "phase_cycles_per_layer": {p: counts[f"search.kernel.cycles.{p}"] / (warps * layers) for p in phases},
        "producer_stall_pct": 100.0 * stalls / producer if producer else None,
        "unclocked_ms": unclocked,
        "clocked_ms": clocked,
        "clocked_over_unclocked": statistics.median(clocked) / statistics.median(unclocked),
        "warp_cycles_per_launch": warp_cycles / reps,
        "effective_sm_mhz": warp_cycles / reps / (statistics.median(clocked) * 1e3),
        "sm_mhz": sm_mhz,
    }
    out["clock_check"] = out["effective_sm_mhz"] / sm_mhz if sm_mhz else None
    return out


def benchmark(
    boards: int = 256,
    sims: int = 64,
    mode: str = "small",
    max_depth: int | None = None,
    hidden: int | None = None,
    blocks: int | None = None,
    pallas: bool = False,
    value_bins: int = 1,
    reward_bins: int = 1,
    weight_dtype: str = "float32",
    trace_dir: str | None = None,
    device: torch.device | str = "cuda",
    phases: bool = False,
) -> dict:
    """The JAX script's run and result keys (see the module docstring)."""
    from simulate_2048_tpu_torch.device import resolve_device
    from simulate_2048_tpu_torch.utils.profiling import time_fn, trace

    device = resolve_device(device)
    s = setup(boards, sims, mode, max_depth, hidden, blocks, value_bins, reward_bins, device)
    cfg = s.config
    print(f"device={device} boards={boards} sims={sims} hidden={cfg.hidden_size}x{cfg.num_residual_blocks}",
          file=sys.stderr)  # fmt: skip
    wdtype = WEIGHT_DTYPES[weight_dtype]
    backend = library(s.search_config, cfg.hidden_size, wdtype) if pallas else "plain"
    if pallas:
        plan = sk.search_plan(s.search_config, cfg.hidden_size, wdtype)
        print(f"kernel plan: {'resident' if not plan else f'stream chunk={plan}'}, library {backend}", file=sys.stderr)
    gen = torch.Generator(device=device).manual_seed(1)
    noise = draw_root_noise(s.search_config, boards, gen, device)
    run = search_fn(s.network, s.observations, s.search_config, pallas, wdtype, noise)

    before = dict(sk.LAUNCHES)
    stats = time_fn(lambda: run().action_weights, warmup=1, reps=5)
    if trace_dir:
        with trace(trace_dir):
            run()
        print(f"trace written to {trace_dir} (view in ui.perfetto.dev)", file=sys.stderr)
    launches = {k: v - before[k] for k, v in sk.LAUNCHES.items() if v != before[k]}

    searches_per_s = boards / (stats["best_ms"] / 1e3)
    result = {
        "boards": boards,
        "hidden": cfg.hidden_size,
        "blocks": cfg.num_residual_blocks,
        "num_simulations": sims,
        "search_ms_per_batch": stats["best_ms"],
        "compile_ms": stats["compile_plus_first_ms"],
        "searches_per_s": searches_per_s,
        "simulations_per_s": searches_per_s * sims,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
        "backend": backend,
        "launches": launches,
    }
    if phases:
        if not (pallas and device.type == "cuda"):
            raise ValueError("--phases clocks the CUDA kernel: it needs --pallas and a CUDA device")
        result["phases"] = kernel_phases(s.network, s.observations, s.search_config, wdtype, noise)
    return result


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description="Batched MCTS benchmark (PyTorch port)")
    parser.add_argument("--boards", type=int, default=256)
    parser.add_argument("--sims", type=int, default=64)
    parser.add_argument("--mode", choices=["tiny", "small", "full"], default="small")
    parser.add_argument(
        "--max-depth",
        type=int,
        default=None,
        help="tree-depth cap (None = unbounded; presets use 32 via search_max_depth)",
    )
    parser.add_argument(
        "--hidden", type=int, default=None, help="override the preset's hidden size (512: the streamed kernel)"
    )
    parser.add_argument("--blocks", type=int, default=None, help="override the preset's residual block count")
    parser.add_argument(
        "--pallas",
        action="store_true",
        help="use the whole-search CUDA kernel (ops/search_kernel.py) instead of the plain search "
        "(the JAX script's flag for its Pallas kernel)",
    )
    parser.add_argument(
        "--value-bins", type=int, default=1, help="categorical value/Q head bins (1 = scalar heads; the recipe: 256)"
    )
    parser.add_argument("--reward-bins", type=int, default=1, help="categorical reward head bins (the recipe: 128)")
    parser.add_argument(
        "--weight-dtype", choices=["float32", "bfloat16"], default="float32", help="the kernel's packed-weight dtype"
    )
    parser.add_argument(
        "--trace", default=None, metavar="DIR", help="write a torch.profiler trace of one search batch into DIR"
    )
    parser.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' to run on the CPU)")
    parser.add_argument(
        "--phases",
        action="store_true",
        help="with --pallas on the card: clock the kernel's phases (unclocked and clocked launches in turns)",
    )
    args = parser.parse_args(argv)
    try:
        result = benchmark(
            args.boards, args.sims, args.mode, args.max_depth, args.hidden, args.blocks, args.pallas,
            args.value_bins, args.reward_bins, args.weight_dtype, args.trace, args.device, args.phases,
        )  # fmt: skip
    except KernelRefused as exc:
        print(f"kernel: config unsupported ({exc})", file=sys.stderr)
        sys.exit(2)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
