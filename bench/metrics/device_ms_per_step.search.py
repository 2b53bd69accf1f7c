"""Device-busy time of the traced window (the union of its device
intervals) over the search steps run in it, in ms."""


def read(run):
    t = run.trace
    if t is None or not run.units or not t.device:
        return None
    return t.busy_s() * 1e3 / run.units
