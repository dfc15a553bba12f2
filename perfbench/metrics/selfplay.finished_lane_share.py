"""selfplay.finished_lane_share: searches of finished games over all searches of the traced segment, in %,
from the program's counters (``selfplay.lanes_active`` of ``selfplay.lanes_searched``)."""

from perfbench.harness import spans


def read(run):
    if run.player != "selfplay":
        return None
    counts = spans.traced_counts(run)
    searched = (counts or {}).get("selfplay.lanes_searched")
    if not searched:
        return None
    return 100.0 * (1.0 - counts.get("selfplay.lanes_active", 0) / searched)
