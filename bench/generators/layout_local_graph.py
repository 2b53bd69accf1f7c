"""``benchmarks/engine_bench.py`` ``make_graph``, which
``benchmarks/fig4_scaling.py`` runs at its sizes, frozen: a jittered
lattice, lattice-neighbour edges and a fraction of long edges."""

from __future__ import annotations

import numpy as np


def layout_local_graph(n_v: int, seed: int = 0, frac_long: float = 0.02):
    """Jittered lattice positions ``(V, 2)`` float32 in ``[0, 100]^2``,
    right and down lattice-neighbour edges, and ``frac_long`` of that
    many long edges between uniform random vertices (self loops dropped).
    Returns ``(pos, edges int32 (E, 2))``."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n_v)))
    iy, ix = np.divmod(np.arange(n_v), side)
    pos = np.stack([ix, iy], axis=1) * (100.0 / side)
    pos = (pos + rng.normal(0, 0.15 * 100.0 / side,
                            size=pos.shape)).astype(np.float32)
    right = np.stack([np.arange(n_v), np.arange(n_v) + 1], axis=1)
    right = right[(right[:, 1] < n_v) & (ix[: right.shape[0]] + 1 < side)]
    down = np.stack([np.arange(n_v), np.arange(n_v) + side], axis=1)
    down = down[down[:, 1] < n_v]
    edges = np.concatenate([right, down])
    n_long = int(frac_long * edges.shape[0])
    long_e = rng.integers(0, n_v, size=(2 * n_long, 2))
    long_e = long_e[long_e[:, 0] != long_e[:, 1]][:n_long]
    edges = np.concatenate([edges, long_e]).astype(np.int32)
    return pos, edges


def make(graph: dict):
    """The configuration's ``graph``: ``n_vertices``, ``frac_long``,
    ``seed``.  Its own layout comes with it."""
    pos, edges = layout_local_graph(graph["n_vertices"], seed=graph["seed"],
                                    frac_long=graph["frac_long"])
    return edges, pos
