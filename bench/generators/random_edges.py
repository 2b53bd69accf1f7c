"""``repro_torch.graphs.datasets.random_edges``, frozen and vectorized:
distinct undirected edges, no self loops, Zipf-like endpoints for
``skew > 0``.  It draws the same batches from the same generator and
keeps the same edges in the same order."""

from __future__ import annotations

import numpy as np


def random_edges(n_vertices: int, n_edges: int, seed: int = 0,
                 skew: float = 0.0) -> np.ndarray:
    """``n_edges`` distinct undirected edges ``(E, 2)`` int32 in a random
    order.  The pairs are drawn in batches of ``max(n_edges, 1024)``;
    walking them in order, self loops are skipped and a pair is kept the
    first time its unordered form appears, until ``n_edges`` are kept."""
    rng = np.random.default_rng(seed)
    if skew > 0:
        w = (np.arange(1, n_vertices + 1) ** (-skew)).astype(np.float64)
        p = w / w.sum()
    else:
        p = None
    batch = max(n_edges, 1024)
    kept = np.zeros(0, np.int64)
    while kept.size < n_edges:
        if p is None:
            pairs = rng.integers(0, n_vertices, size=(batch, 2))
        else:
            pairs = rng.choice(n_vertices, size=(batch, 2), p=p)
        lo = np.minimum(pairs[:, 0], pairs[:, 1]).astype(np.int64)
        hi = np.maximum(pairs[:, 0], pairs[:, 1]).astype(np.int64)
        keys = (lo * n_vertices + hi)[lo != hi]
        # first occurrence of each key within the batch, in batch order,
        # and not kept by an earlier batch
        _, first = np.unique(keys, return_index=True)
        fresh = keys[np.sort(first)]
        fresh = fresh[~np.isin(fresh, kept)]
        kept = np.concatenate([kept, fresh[:n_edges - kept.size]])
    kept.sort()
    out = np.stack([kept // n_vertices, kept % n_vertices],
                   axis=1).astype(np.int32)
    perm = rng.permutation(len(out))
    return out[perm]


def make(graph: dict):
    """The configuration's ``graph``: ``n_vertices``, ``n_edges``,
    ``skew``, ``seed``.  No layout of its own."""
    return random_edges(graph["n_vertices"], graph["n_edges"],
                        seed=graph["seed"], skew=graph["skew"]), None
