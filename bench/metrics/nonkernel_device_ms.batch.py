"""Device-busy time per call outside the program's hand-written kernels
(sorts, gathers, elementwise ops, copies), in ms: the union of the
intervals of every other device event, over the calls of the window."""

import re


def read(run):
    t = run.trace
    if t is None or not run.completed or not t.device:
        return None
    own = re.compile(r"\b(" + "|".join(map(re.escape, run.kernels))
                     + r")\b") if run.kernels else None
    busy = t.busy_s(lambda name: own is None or not own.search(name))
    return busy * 1e3 / run.completed
