"""Profiling harnesses: ``torch.profiler`` traces and wall-clock timing
(port of the JAX package's ``utils/profiling.py``).

``trace`` writes a Chrome trace (viewable in ui.perfetto.dev or
chrome://tracing) with the GPU's kernels when one is in use, and the
program's spans (``utils/tracing.py``) on a track of their own; ``time_fn``
separates the first calls (builds, allocations, warm-up) from the steady
state.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Callable

import torch

from simulate_2048_tpu_torch.utils import tracing

SPAN_TRACK = 2**31 - 1  # the thread id of the spans' track in the exported trace


@contextlib.contextmanager
def trace(log_dir: str = "profiles"):
    """Capture a trace: ``with trace('profiles'): run_workload()`` writes
    ``log_dir/trace-<pid>-<ns>.json``, with the spans the program recorded
    meanwhile. Yields the ``torch.profiler.profile``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    t0 = time.time_ns()
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    t1 = time.time_ns()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{t0}.json")
    prof.export_chrome_trace(path)
    recorded = tracing.snapshot()["spans"]
    spans = [{**s, "parent": None if s["parent"] is None else recorded[s["parent"]]["name"]}
             for s in recorded if t0 <= s["start_ns"] and s["end_ns"] <= t1]  # fmt: skip
    with open(path) as f:
        data = json.load(f)
    data["traceEvents"].extend(span_events(spans, data.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(data, f)


def span_events(spans: list[dict], base_ns: int = 0) -> list[dict]:
    """Chrome-trace events of ``tracing.snapshot()`` spans (``parent`` a name), on
    the profiler's clock (microseconds since ``base_ns``), on one track named "program spans"."""
    pid = os.getpid()
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": SPAN_TRACK, "args": {"name": "program spans"}}]
    for s in spans:
        args = {"unit": s["unit"], "parent": s["parent"]}
        if s["stream_ns"] is not None:
            args["stream_ms"] = s["stream_ns"] / 1e6
        events.append({"ph": "X", "cat": "program_span", "name": s["name"], "pid": pid, "tid": SPAN_TRACK,
                       "ts": (s["start_ns"] - base_ns) / 1e3, "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                       "args": args})  # fmt: skip
    return events


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
