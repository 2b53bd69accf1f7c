"""Least time of one exact evaluation's all-pairs work (``_work``) over
the device-busy time per evaluation of the traced window, in %."""

from bench.metrics import _work


def read(run):
    t = run.trace
    if t is None or not run.completed or run.work is None:
        return None
    busy = t.busy_s() / run.completed
    if busy <= 0:
        return None
    g = run.cell.config["graph"]
    ops, nbytes = _work.exact_work(g["n_vertices"], g["n_edges"], run.work)
    return 100.0 * _work.least_seconds(ops, nbytes) / busy
