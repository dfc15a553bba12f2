"""selfplay.kernels_per_move: device kernels in the traced segment over its lockstep moves."""

from perfbench.harness import readers


def read(run):
    if run.trace is None or run.player != "selfplay":
        return None
    return len(run.trace.kernels) / max(readers.traced_calls(run), 1)
