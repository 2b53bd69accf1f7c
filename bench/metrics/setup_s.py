"""Set-up: process start to the first measured call (imports, inputs,
plan, kernel loading or building, warm-up calls)."""


def read(run):
    return run.setup_s
