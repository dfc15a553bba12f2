"""selfplay.root_ms_per_move: stream time of the program's ``search.root`` spans (the root's h/f and noise
mixing) in the traced segment, over its lockstep moves, in ms."""

from perfbench.harness import spans


def read(run):
    return spans.stream_ms_per_move(run, "selfplay", ("search.root",))
