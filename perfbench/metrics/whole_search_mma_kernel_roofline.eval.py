"""The tensor-core search kernel's roofline share in the traced deep evaluation, in %."""

from perfbench.harness import readers


def read(run):
    return readers.roofline_percent(run, "deep_eval", "bfloat16")
