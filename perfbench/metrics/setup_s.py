"""setup_s: process start to the first timed move, host clock."""


def read(run):
    return run.setup_s
