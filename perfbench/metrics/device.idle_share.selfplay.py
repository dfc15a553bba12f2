"""The device's idle share of the traced self-play segment (1 - union of device activity / window), in %."""

from perfbench.harness import readers


def read(run):
    return readers.idle_percent(run, "selfplay")
