"""mfu.eval: search and root FLOP of the evaluation's game-moves over the untraced time, against the peak, in %."""

from perfbench.harness import readers


def read(run):
    return readers.mfu_percent(run, "deep_eval")
