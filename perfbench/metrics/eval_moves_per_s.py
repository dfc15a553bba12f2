"""eval_moves_per_s: moves of games not yet finished over the window, host clock."""


def read(run):
    return run.moves / run.window_s if run.player == "deep_eval" else None
