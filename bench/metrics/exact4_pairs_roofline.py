"""Least time of rank 0's share of one exact evaluation's all-pairs work
(``_work``) over rank 0's device-busy time a call in the hand-written
kernels (``sweep_device_ms.exact4``), in %: how near its bound rank 0
sweeps its own pairs, whatever share of them the row split gives it.

Rank 0's share of the edge pairs (of the vertex pairs) is the pair slots
its row-range launches of kernel 4 (kernel 2) swept in one call, from
the program's ``TILES`` counters (``rank_edge_pairs``,
``rank_vertex_pairs`` in the work the call's check returns), over all
the pairs; the straddles, crossings and occlusions of the call are
taken in the same shares.  A tile on the diagonal and the padding hold
slots that are no pairs, so the share is at most a tile row too high
(0.07% at soc-Epinions1 over 4 ranks); it is capped at the whole."""

from bench import find
from bench.metrics import _work


def read(run):
    w = run.work
    if run.trace is None or w is None or "rank_edge_pairs" not in w:
        return None
    sweep_ms = find.module("metrics", "sweep_device_ms.exact4").read(run)
    if not sweep_ms:
        return None
    g = run.cell.config["graph"]
    e_pairs, v_pairs = _work.pairs(g["n_edges"]), _work.pairs(g["n_vertices"])
    f_e = min(1.0, w["rank_edge_pairs"] / e_pairs)
    f_v = min(1.0, w["rank_vertex_pairs"] / v_pairs)
    ops = (f_e * (_work.CROSS_PER_PAIR * e_pairs
                  + _work.CROSS_PER_STRADDLE * w["straddles"]
                  + _work.CROSS_PER_CROSSING * w["crossings"])
           + f_v * (_work.OCC_PER_PAIR * v_pairs
                    + _work.OCC_PER_OCCLUSION * w["occlusions"]))
    nbytes = 8 * g["n_vertices"] + 8 * g["n_edges"]
    return 100.0 * _work.least_seconds(ops, nbytes) / (sweep_ms * 1e-3)
