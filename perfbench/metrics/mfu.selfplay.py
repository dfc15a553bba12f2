"""mfu.selfplay: search and root FLOP of the self-play moves over the untraced time, against the peak, in %."""

from perfbench.harness import readers


def read(run):
    return readers.mfu_percent(run, "selfplay")
