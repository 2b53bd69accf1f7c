"""Rank 0's device-busy time per call in the program's hand-written
kernels (its share of the all-pairs sweeps), in ms."""

import re


def read(run):
    t = run.trace
    if t is None or not run.completed or not t.device or not run.kernels:
        return None
    own = re.compile(r"\b(" + "|".join(map(re.escape, run.kernels))
                     + r")\b")
    if not any(own.search(name) for name, _, _ in t.device):
        return None
    return t.busy_s(lambda name: own.search(name) is not None) * 1e3 \
        / run.completed
