"""Profiling harnesses: ``torch.profiler`` traces and wall-clock timing
(port of the JAX package's ``utils/profiling.py``).

``trace`` writes a Chrome trace (viewable in ui.perfetto.dev or
chrome://tracing) with the GPU's kernels when one is in use; ``time_fn``
separates the first calls (builds, allocations, warm-up) from the steady
state.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable

import torch


@contextlib.contextmanager
def trace(log_dir: str = "profiles"):
    """Capture a trace: ``with trace('profiles'): run_workload()`` writes
    ``log_dir/trace-<pid>-<ns>.json``. Yields the ``torch.profiler.profile``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def _sync() -> None:
    """Wait for the work queued on the GPU, if CUDA is in use: ``fn``'s
    kernels run asynchronously, while its CPU work is done when it returns.
    (The JAX package fetches a scalar of the result instead.)"""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable[[], Any], warmup: int = 1, reps: int = 5) -> dict[str, float]:
    """Time a nullary function; returns first-call and steady-state stats in ms."""
    t0 = time.perf_counter()
    for _ in range(max(warmup, 1)):
        fn()
    _sync()
    compile_ms = (time.perf_counter() - t0) * 1e3

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return {
        "compile_plus_first_ms": compile_ms,
        "best_ms": times[0],
        "median_ms": times[len(times) // 2],
        "mean_ms": sum(times) / len(times),
    }
