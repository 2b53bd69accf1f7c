"""The window's time over the search steps that its completed calls
ran, in ms."""


def read(run):
    return run.window_s * 1e3 / run.units if run.units else None
