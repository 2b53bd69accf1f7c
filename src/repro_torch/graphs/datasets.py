"""Synthetic graphs sized to the paper's SNAP datasets (Table 1); numpy copy
of :mod:`repro.graphs.datasets`, plus the layout-local benchmark graph.

The evaluation container has no network access, so SNAP graphs are
replaced by synthetic graphs with matching |V| / |E| (random layouts make
the metric workload statistically equivalent: the paper itself evaluates
on random layouts, S4.1). Generators: Erdos-Renyi-style random edge sets
(fast, any size) and a preferential-attachment option for degree skew.
"""

from __future__ import annotations

import numpy as np
import torch

# name -> (|V|, |E|)  (paper Table 1)
PAPER_DATASETS = {
    "ego-Facebook": (4_039, 88_234),
    "musae-facebook": (22_470, 171_002),
    "musae-github": (37_700, 289_003),
    "soc-RedditHyperlinks": (35_776, 286_561),
    "cit-HepTh": (27_770, 352_807),
    "soc-Epinions1": (75_879, 508_837),
}


def random_edges(n_vertices: int, n_edges: int, seed: int = 0,
                 skew: float = 0.0) -> np.ndarray:
    """Simple random graph: ``n_edges`` distinct undirected edges, no self
    loops. ``skew > 0`` draws endpoints from a Zipf-ish distribution for
    SNAP-like degree tails."""
    rng = np.random.default_rng(seed)
    if skew > 0:
        w = (np.arange(1, n_vertices + 1) ** (-skew)).astype(np.float64)
        p = w / w.sum()
    else:
        p = None
    edges = set()
    batch = max(n_edges, 1024)
    while len(edges) < n_edges:
        if p is None:
            pairs = rng.integers(0, n_vertices, size=(batch, 2))
        else:
            pairs = rng.choice(n_vertices, size=(batch, 2), p=p)
        for v, u in pairs:
            if v == u:
                continue
            edges.add((min(v, u), max(v, u)))
            if len(edges) >= n_edges:
                break
    out = np.array(sorted(edges), dtype=np.int32)
    perm = rng.permutation(len(out))
    return out[perm]


def paper_graph(name: str, seed: int = 0, scale: float = 1.0):
    """Synthetic stand-in for a paper dataset (optionally size-scaled so
    CPU benchmarks stay tractable; the scale is reported in outputs)."""
    n_v, n_e = PAPER_DATASETS[name]
    n_v = max(int(n_v * scale), 16)
    n_e = max(int(n_e * scale), 32)
    return random_edges(n_v, n_e, seed=seed, skew=0.6), n_v


def layout_local_graph(n_v: int, seed: int = 0, frac_long: float = 0.02):
    """Layout-local graph (numpy copy of ``benchmarks/engine_bench.py``'s
    ``make_graph``): jittered lattice positions, lattice-neighbour edges
    plus a sprinkle of long-range ones.  Short edges span few strips, so
    per-strip capacities stay proportionate, as in a mostly readable
    layout from an optimization loop.  Returns ``(pos float32 (V, 2),
    edges int32 (E, 2))``."""
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


def to_csr(edges: np.ndarray, n_vertices: int):
    """Undirected CSR (both directions) for the neighbor sampler: the
    reference's arrays, byte for byte.  The ordering is a stable argsort
    of the sources, as the reference's, here ``torch.sort(stable=True)``
    on the host's cores (numpy's is a one-core timsort), and the degrees
    are counted with ``np.bincount``, which builds what the reference's
    ``np.add.at`` builds in one pass (Reddit's graph has 1.1e8 directed
    entries)."""
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    order = torch.sort(torch.from_numpy(src), stable=True).indices.numpy()
    indptr = np.zeros(n_vertices + 1, dtype=np.int64)
    indptr[1:] = np.bincount(src, minlength=n_vertices)
    indptr = np.cumsum(indptr)
    return indptr.astype(np.int32), dst[order].astype(np.int32)
