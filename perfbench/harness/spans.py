"""The program's own spans and counters in the traced unit (``simulate_2048_tpu_torch/utils/tracing.py``).

The program records spans only while ``torch.profiler`` records, so with
``--trace 1`` they are the traced unit's: its host start and end on the
clock the trace's device events are stamped with, and the stream time
between two CUDA events. Its counters are kept by unit (a self-play
segment, an evaluation). A program without the tracer gives nothing to read,
and every function here returns None for it.
"""

from __future__ import annotations

import bisect

from perfbench.harness import readers
from perfbench.harness import trace as trace_lib


def snapshot(run) -> dict | None:
    """The program's snapshot, read once a run (None when the program has no tracer)."""
    if not hasattr(run, "_program_snapshot"):
        try:
            from simulate_2048_tpu_torch.utils import tracing
        except ImportError:
            run._program_snapshot = None
        else:
            run._program_snapshot = tracing.snapshot()
    return run._program_snapshot


def window(run) -> tuple[int, int] | None:
    """The traced unit's host interval (ns), from the benchmark's own spans around it."""
    if run.trace is None or not run.trace.spans:
        return None
    return min(s for _, s, _ in run.trace.spans), max(e for _, _, e in run.trace.spans)


def traced_spans(run) -> list[dict] | None:
    """The program's spans inside the traced unit, in the order they started; ``parent`` indexes this list."""
    snap, win = snapshot(run), window(run)
    if snap is None or win is None:
        return None
    keep = [i for i, s in enumerate(snap["spans"]) if win[0] <= s["start_ns"] and s["end_ns"] <= win[1]]
    index = {old: new for new, old in enumerate(keep)}
    return [{**snap["spans"][i], "parent": index.get(snap["spans"][i]["parent"])} for i in keep]


def traced_counts(run) -> dict[str, int] | None:
    """The program's counters summed over the units its spans in the traced unit belong to."""
    spans = traced_spans(run)
    if not spans:
        return None
    counts = snapshot(run)["counts"]
    out: dict[str, int] = {}
    for unit in {s["unit"] for s in spans}:
        for name, value in counts.get(unit, {}).items():
            out[name] = out.get(name, 0) + value
    return out


def stream_ms_per_move(run, player: str, names: tuple[str, ...]) -> float | None:
    """The stream time of the spans named ``names`` in the traced unit, over its lockstep moves, in ms."""
    if run.player != player:
        return None
    spans = traced_spans(run)
    hits = [s["stream_ns"] for s in spans or () if s["name"] in names]
    if not hits or None in hits:
        return None
    return sum(hits) / 1e6 / max(readers.traced_calls(run), 1)


def clocks_agree(run) -> bool:
    """Whether the trace's device events lie on the host clock of the traced unit's window."""
    win = window(run)
    if win is None or not run.trace.events:
        return False
    first = min(s for _, s, _ in run.trace.events)
    return win[0] <= first <= win[1]


def idle_after(busy: list[tuple[int, int]], times: list[int]) -> list[int]:
    """For each host time, the device idle (ns) from it to the next device activity
    (0 when the device is busy then); ``busy`` is :func:`trace.merge`'s cover of the activity."""
    ends = [e for _, e in busy]
    out = []
    for t in times:
        k = bisect.bisect_right(ends, t)
        out.append(max(0, busy[k][0] - t) if k < len(busy) else 0)
    return out


def innermost(spans: list[dict]) -> list[tuple[int, int, int | None]]:
    """The host timeline as (start, end, index of the innermost open span or None), in order."""
    points = []
    for i, s in enumerate(spans):
        points.append((s["start_ns"], 1, i))
        points.append((s["end_ns"], 0, -i))  # at one instant: ends first, the inner span (started later) first
    points.sort()
    out, stack, last = [], [], None
    for t, kind, key in points:
        if last is not None and t > last:
            out.append((last, t, stack[-1] if stack else None))
        last = t
        if kind == 1:
            stack.append(key)
        else:
            stack.remove(-key)
    return out


def table(run) -> dict | None:
    """Where the traced unit's time went, span by span (None without the program's spans): for each span name,
    a lockstep move's self host ms, self stream ms (less what its child spans cover), the device idle while it
    was the innermost span open on the host, and the kernels that started then; the idle outside every span;
    and the clock checks: the k-th search kernel's start against the host's entry into the k-th
    ``search.kernel`` span, and in the deep evaluation the device's next activity after each ``eval.done_read``."""
    from simulate_2048_tpu_torch.utils import tracing

    spans, win = traced_spans(run), window(run)
    if not spans or not run.trace.events:
        return None
    moves = max(readers.traced_calls(run), 1)
    events = run.trace.events
    idle = idle_by_span(spans, events, win)
    timeline = innermost(spans)
    starts = [t0 for t0, _, _ in timeline]
    started: dict = {}
    for _, k0, _ in run.trace.kernels:
        j = bisect.bisect_right(starts, k0) - 1
        label = timeline[j][2] if 0 <= j and k0 < timeline[j][1] else None
        started[label] = started.get(label, 0) + 1
    host, stream = tracing.self_times(spans), tracing.self_times(spans, "stream")
    rows: dict[str, dict] = {}
    for i, s in enumerate(spans):
        row = rows.setdefault(s["name"], {"n": 0, "host_ms": 0.0, "stream_ms": 0.0, "idle_ms": 0.0, "kernels": 0})
        row["n"] += 1
        row["host_ms"] += host[i] / 1e6
        row["stream_ms"] += (stream[i] or 0) / 1e6
        row["idle_ms"] += idle.get(i, 0) / 1e6
        row["kernels"] += started.get(i, 0)
    total_idle = sum(idle.values())
    searches = sorted(s for n, s, _ in run.trace.kernels if any(k in n for k in readers.KERNELS.values()))
    entries = [s["start_ns"] for s in spans if s["name"] == "search.kernel"]
    leads = [k - e for k, e in zip(searches, entries)]
    out = {
        "moves": moves,
        "spans": {name: {k: (v / moves if k != "n" else v) for k, v in row.items()} for name, row in rows.items()},
        "idle_outside_spans_ms_per_move": idle.get(None, 0) / 1e6 / moves,
        "idle_total_ms": total_idle / 1e6,
        "trace_idle_ms": (run.trace.window_s - run.trace.busy_s()) * 1e3,
        "idle_in_spans_share": 1 - idle.get(None, 0) / total_idle if total_idle else None,
        "search_kernels": len(searches),
        "search_kernel_spans": len(entries),
        "kernel_lead_ms": [min(leads) / 1e6, max(leads) / 1e6] if leads else None,
        "kernel_lead_nonnegative_share": sum(x >= 0 for x in leads) / len(leads) if leads else None,
        "span_names_in_device_ops": sorted(set(rows) & {n for n, _, _ in events}),
    }
    reads = [s["end_ns"] for s in spans if s["name"] == "eval.done_read"]
    if reads:
        after = idle_after(trace_lib.merge([(s, e) for _, s, e in events]), reads)
        out["done_read_next_activity_ms"] = [min(after) / 1e6, max(after) / 1e6]
        out["done_read_next_activity_after_end_share"] = sum(x > 0 for x in after) / len(after)
    return out


def idle_by_span(spans: list[dict], events: list[tuple[str, int, int]], win: tuple[int, int]) -> dict:
    """The device idle (ns) inside ``win``, attributed to the innermost span open on the host at each instant.

    Keys are span indices, and None for idle outside every span; the values sum to the window's idle.
    """
    busy = trace_lib.merge([(max(s, win[0]), min(e, win[1])) for _, s, e in events if e > win[0] and s < win[1]])
    idle, cursor = [], win[0]
    for s, e in busy:
        if s > cursor:
            idle.append((cursor, s))
        cursor = max(cursor, e)
    if cursor < win[1]:
        idle.append((cursor, win[1]))
    timeline = [(max(s, win[0]), min(e, win[1]), i) for s, e, i in innermost(spans) if e > win[0] and s < win[1]]
    first, last = (timeline[0][0], timeline[-1][1]) if timeline else (win[1], win[1])
    segments = [(a, b, i) for a, b, i in [(win[0], first, None), *timeline, (last, win[1], None)] if b > a]
    out: dict = {}
    j = 0
    for a, b in idle:
        while j < len(segments) and segments[j][1] <= a:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < b:
            s, e, label = segments[k]
            overlap = min(b, e) - max(a, s)
            if overlap > 0:
                out[label] = out.get(label, 0) + overlap
            k += 1
    return out
