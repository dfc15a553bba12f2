"""The float32 search kernel's roofline share in the traced self-play segment, in %."""

from perfbench.harness import readers


def read(run):
    return readers.roofline_percent(run, "selfplay", "float32")
