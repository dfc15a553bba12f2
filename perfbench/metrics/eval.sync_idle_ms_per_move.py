"""eval.sync_idle_ms_per_move: for each of the program's ``eval.done_read`` spans (the host read of
``done``) in the traced evaluation, the device idle from the span's end to the next device activity,
summed over its lockstep moves, in ms."""

from perfbench.harness import readers, spans
from perfbench.harness import trace as trace_lib


def read(run):
    if run.player != "deep_eval" or not spans.clocks_agree(run):
        return None
    reads = [s["end_ns"] for s in spans.traced_spans(run) or () if s["name"] == "eval.done_read"]
    if not reads:
        return None
    busy = trace_lib.merge([(s, e) for _, s, e in run.trace.events])
    return sum(spans.idle_after(busy, reads)) / 1e6 / max(readers.traced_calls(run), 1)
