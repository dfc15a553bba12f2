"""Spans and counters of the port's loops, on the profiler's clock.

- ``span(name)``: a context manager around one phase of the work. It
  records only while a ``torch.profiler`` profile is recording (PyTorch's
  own "profiler enabled" state, checked once on entry): the benchmark's
  traced unit and ``utils.profiling.trace`` turn spans on, nothing else
  does. When off, a span is that one check and a shared no-op context.
  When on, it keeps its name, its parent span, its unit and the host's
  start and end (``time.time_ns``, the clock the profiler stamps its events
  with); with CUDA in use it also records a timing event on the current
  stream at entry and at exit, whose gap is the span's stream time: its
  kernels, plus any wait for the host to launch them. Spans are not
  ``record_function`` ranges, so they add no event to the profiler's trace.
  ``span(name, unit=True)`` starts a new unit (a self-play segment, an
  evaluation): the spans and counts that follow belong to it.
- ``count(name, value)``: always counts, into the current unit. ``value``
  is a host integer or a device scalar the program already computes, kept
  as a tensor and read by :func:`snapshot`, so a count adds no kernel and
  no host read where it is made.
- ``device_counts(names, device)``: a zeroed int64 buffer on the device,
  one a unit, whose elements a kernel adds to and which are counted under
  ``names``: one device operation a unit (the zeroing), read at
  :func:`snapshot`.
- ``snapshot()``: what was recorded; ``self_times`` gives each span's self
  time.

Spans are kept until :func:`reset`; the counts of the last ``KEEP_UNITS``
units are kept. The state is the process's: one thread records at a time
(the port's loops run on the thread that calls them).
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict

import torch

KEEP_UNITS = 64

# The "on" check: true while a torch.profiler profile records (patchable, to time a traced run without spans).
is_recording = torch._C._autograd._profiler_enabled

_OFF = contextlib.nullcontext()


class _Span:
    """One recorded span; ``parent`` is the index of its parent in ``_spans`` (None at the top)."""

    __slots__ = ("name", "parent", "unit", "start_ns", "end_ns", "events")

    def __init__(self, name: str):
        self.name = name
        self.end_ns = 0
        self.events = None  # (entry, exit) CUDA events, with CUDA in use

    def __enter__(self):
        self.parent, self.unit = (_open[-1] if _open else None), _unit
        _open.append(len(_spans))
        _spans.append(self)
        self.start_ns = time.time_ns()
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        self.end_ns = time.time_ns()
        _open.pop()
        return False


_spans: list[_Span] = []
_open: list[int] = []  # indices of the recorded spans open now, innermost last
_unit = 0
_counts: OrderedDict[int, dict[str, list]] = OrderedDict()
_buffers: dict[tuple, torch.Tensor] = {}  # (unit, names, device) -> the unit's device_counts buffer


def span(name: str, unit: bool = False):
    """``with span("env.step"): ...`` (see the module docstring)."""
    if unit:
        _new_unit()
    if not is_recording():
        return _OFF
    return _Span(name)


def _new_unit() -> None:
    global _unit
    _unit += 1
    _counts[_unit] = {}
    while len(_counts) > KEEP_UNITS:
        _counts.popitem(last=False)
    for key in [key for key in _buffers if key[0] not in _counts]:
        del _buffers[key]


def count(name: str, value) -> None:
    """Add ``value`` (an int, or a device scalar read at :func:`snapshot`) to counter ``name`` of the current unit.
    Host ints are summed as they come (a count made every move keeps one int), device scalars kept."""
    values = _counts.setdefault(_unit, {}).setdefault(name, [0])
    if isinstance(value, int):
        values[0] += value
    else:
        values.append(value)


def device_counts(names: tuple[str, ...], device) -> torch.Tensor:
    """The current unit's int64 buffer of ``len(names)`` counts on ``device``:
    zeroed and counted under ``names`` (element i under ``names[i]``, read at
    :func:`snapshot`) at the unit's first call, the same buffer after."""
    key = (_unit, names, torch.device(device))
    buf = _buffers.get(key)
    if buf is None:
        buf = _buffers[key] = torch.zeros(len(names), dtype=torch.int64, device=device)
        for i, name in enumerate(names):
            count(name, buf[i])
    return buf


def reset() -> None:
    """Forget every span and count."""
    global _unit
    _spans.clear()
    _open.clear()
    _counts.clear()
    _buffers.clear()
    _unit = 0


def snapshot() -> dict:
    """What was recorded: ``spans`` (dicts of name, parent index, unit, host
    start and end ns, and stream ns or None) and ``counts`` ({unit: {name:
    total}}). Reads the device scalars and the stream times, so it waits
    for the work they belong to."""
    spans = []
    for rec in _spans:
        stream_ns = None
        if rec.events is not None and rec.end_ns:
            rec.events[1].synchronize()
            stream_ns = int(rec.events[0].elapsed_time(rec.events[1]) * 1e6)
        spans.append({"name": rec.name, "parent": rec.parent, "unit": rec.unit, "start_ns": rec.start_ns,
                      "end_ns": rec.end_ns, "stream_ns": stream_ns})  # fmt: skip
    counts = {unit: {name: int(sum(int(v) for v in values)) for name, values in named.items()}
              for unit, named in _counts.items()}  # fmt: skip
    return {"spans": spans, "counts": counts}


def self_times(spans: list[dict], key: str = "host") -> list[int | None]:
    """Each span's self time in ns: its duration (``host``: end − start;
    ``stream``: its stream time) minus the part its child spans cover."""

    def duration(s: dict) -> int | None:
        return s["end_ns"] - s["start_ns"] if key == "host" else s["stream_ns"]

    out = [duration(s) for s in spans]
    for s in spans:
        d = duration(s)
        if s["parent"] is not None and d is not None and out[s["parent"]] is not None:
            out[s["parent"]] -= d
    return out
