"""95th percentile of the latencies of all calls in the window (failed
calls included), linear between order statistics."""

import numpy as np


def read(run):
    if not run.latencies:
        return None
    return float(np.percentile(np.asarray(run.latencies) * 1e3, 95))
