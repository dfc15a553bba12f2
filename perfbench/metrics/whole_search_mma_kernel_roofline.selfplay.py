"""The tensor-core search kernel's roofline share in the traced self-play segment, in %."""

from perfbench.harness import readers


def read(run):
    return readers.roofline_percent(run, "selfplay", "bfloat16")
