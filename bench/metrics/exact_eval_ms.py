"""The window's time over the exact evaluations completed in it."""


def read(run):
    return run.window_s * 1e3 / run.completed if run.completed else None
