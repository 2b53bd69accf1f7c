"""1 - (union of device-busy intervals) / (traced window)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 1.0 - t.busy_s() / t.window_s
