"""selfplay_moves_per_s: positions stored (moves of unfinished games) over the window, host clock."""


def read(run):
    return run.moves / run.window_s if run.player == "selfplay" else None
