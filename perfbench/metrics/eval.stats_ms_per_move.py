"""eval.stats_ms_per_move: stream time of the program's ``eval.stats`` spans (entropy, value sums, encoder
codes) in the traced evaluation, over its lockstep moves, in ms."""

from perfbench.harness import spans


def read(run):
    return spans.stream_ms_per_move(run, "deep_eval", ("eval.stats",))
