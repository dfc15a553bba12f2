"""Arithmetic the metric readers share (``metrics/<name>.py``)."""

from __future__ import annotations

from perfbench.harness import flops

# The search kernels by products' precision: the float32 library's and the tensor-core libraries'.
KERNELS = {"float32": "whole_search_kernel", "bfloat16": "whole_search_mma_kernel"}


def traced_calls(run) -> int:
    first, end = run.units[0].calls
    return end - first


def roofline_percent(run, player: str, precision: str) -> float | None:
    """The search kernel's least time over its device time in the traced unit, in %."""
    config = run.cell.config
    if run.trace is None or run.player != player or config["search_weight_dtype"] != precision:
        return None
    seconds, launches = run.trace.kernel_seconds(KERNELS[precision])
    if launches == 0 or seconds <= 0:
        return None
    bound, _ = flops.kernel_bound_seconds(config, run.units[0].lanes * launches, launches)
    return 100.0 * bound / seconds


def idle_percent(run, player: str) -> float | None:
    if run.trace is None or run.player != player or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)


def mfu_percent(run, player: str) -> float | None:
    """Search and root FLOP of the game-moves played, over the host time of the
    units the profiler did not run over, against the products' peak, in %."""
    if run.player != player:
        return None
    units = run.untraced()
    seconds = sum(u.seconds for u in units)
    moves = sum(u.moves for u in units)
    config = run.cell.config
    peak = flops.PEAK_FLOPS[config["search_weight_dtype"]]
    return 100.0 * flops.move_flops(config, moves) / (seconds * peak) if seconds > 0 else None
