"""Layouts scored in the window over the window's time."""


def read(run):
    return run.units / run.window_s if run.units else None
