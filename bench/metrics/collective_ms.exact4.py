"""Rank 0's device-busy time per call in NCCL's kernels (names starting
``nccl``): the collectives that combine the ranks' partials, with any
wait in them for a slower rank, in ms."""

import re

NCCL = re.compile(r"^(?:void\s+)?nccl")


def read(run):
    t = run.trace
    if t is None or not run.completed or not t.device:
        return None
    if not any(NCCL.match(name) for name, _, _ in t.device):
        return None
    return t.busy_s(lambda name: NCCL.match(name) is not None) * 1e3 \
        / run.completed
