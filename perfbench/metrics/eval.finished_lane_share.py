"""eval.finished_lane_share: searches of finished games over all searches of the window, in %."""


def read(run):
    if run.player != "deep_eval":
        return None
    searched = sum(u.lanes * (u.calls[1] - u.calls[0]) for u in run.units)
    return 100.0 * (1.0 - run.moves / searched) if searched else None
