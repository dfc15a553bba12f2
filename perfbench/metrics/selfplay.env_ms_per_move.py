"""selfplay.env_ms_per_move: stream time of the program's ``move.observe`` and ``env.step`` spans in the
traced segment, over its lockstep moves, in ms."""

from perfbench.harness import spans


def read(run):
    return spans.stream_ms_per_move(run, "selfplay", ("move.observe", "env.step"))
