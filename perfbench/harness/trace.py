"""The traced unit: device activity from ``torch.profiler`` (CUPTI).

Only device activity is recorded (no CPU operators), which keeps the
profiler's cost on the host small. From the events come the device's busy
time (the union of the intervals of every kernel, copy and set, so that
overlapping work counts once), kernel counts and time by name, and the idle
gaps, each labelled by the benchmark's span open at the time.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class DeviceTrace:
    events: list[tuple[str, int, int]]  # (name, start ns, end ns), device activity
    window_s: float  # host time of the traced unit
    spans: list[tuple[str, int, int]] = field(default_factory=list)  # (name, start ns, end ns), wall clock

    @property
    def kernels(self) -> list[tuple[str, int, int]]:
        return [e for e in self.events if not e[0].startswith(("Memcpy", "Memset"))]

    def busy_s(self) -> float:
        return union_ns([(s, e) for _, s, e in self.events]) / 1e9

    def kernel_seconds(self, fragment: str) -> tuple[float, int]:
        """Device seconds and count of the kernels whose name holds ``fragment``."""
        hits = [(s, e) for n, s, e in self.kernels if fragment in n]
        return sum(e - s for s, e in hits) / 1e9, len(hits)

    def top_ops(self, n: int = 10) -> list[list]:
        total = defaultdict(int)
        for name, s, e in self.events:
            total[name] += e - s
        return [[short(name), ns / 1e9] for name, ns in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The ``n`` longest gaps between device activity, as [label, seconds]."""
        merged = merge([(s, e) for _, s, e in self.events])
        gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
        gaps.sort(key=lambda g: g[0] - g[1])
        spans = self.spans
        if spans and merged and abs(spans[0][1] - merged[0][0]) > 10**10:
            # The trace keeps another clock than the wall clock: line the first span up with the first event.
            shift = merged[0][0] - spans[0][1]
            spans = [(name, s + shift, e + shift) for name, s, e in spans]
        out = []
        for start, end in gaps[:n]:
            mid = (start + end) // 2
            label = next((name for name, s, e in spans if s <= mid <= e), "outside the spans")
            out.append([f"{label} (at {(start - merged[0][0]) / 1e9:.3f} s)", (end - start) / 1e9])
        return out


def short(name: str, width: int = 120) -> str:
    """A kernel's name cut to ``width`` characters (template arguments make some thousands long)."""
    return name if len(name) <= width else name[: width - 3] + "..."


def merge(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Sorted, non-overlapping cover of ``intervals``."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_ns(intervals: list[tuple[int, int]]) -> int:
    return sum(e - s for s, e in merge(intervals))


def device_events(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of every device event a finished profiler holds."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            start = ev.start_ns()
            out.append((ev.name(), start, start + ev.duration_ns()))
    return out
