"""Adversarial layouts for the exact crossing sweeps.

Each fixture is a ``(pos float32 (V, 2), edges int32 (E, 2), valid bool
(E,))`` layout built from a fixed seed in the degenerate regimes where a
straddle test goes wrong: an endpoint exactly on another segment, exact
collinear overlaps, shared endpoints, duplicate edges, zero-length
edges, float32 endpoints so nearly collinear that the cross products are
decided by rounding, and invalid slots.  The tests hold the plain
PyTorch versions to the JAX reference on them, and ``chip_smoke.py``
holds the CUDA kernels to the plain versions on the same layouts.
"""

from __future__ import annotations

import numpy as np


def _layout(points, segs, valid=None):
    """Vertices ``points`` and edges ``segs`` (index pairs)."""
    pos = np.asarray(points, np.float32).reshape(-1, 2)
    edges = np.asarray(segs, np.int32).reshape(-1, 2)
    if valid is None:
        valid = np.ones(edges.shape[0], bool)
    return pos, edges, np.asarray(valid, bool)


def _segments(rng, starts, ends):
    """One vertex per endpoint, one edge per (start, end) pair."""
    pts = np.concatenate([starts, ends])
    n = len(starts)
    segs = np.stack([np.arange(n), np.arange(n) + n], axis=1)
    perm = rng.permutation(n)
    return pts, segs[perm]


def t_junctions(seed=0, n=60):
    """Segments on integer lattice lines, each with a second segment that
    starts exactly on its interior (every cross product exact in float32,
    the T's cross product exactly 0)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 50, (n, 2)).astype(np.float64)
    d = rng.integers(-3, 4, (n, 2)).astype(np.float64)
    d[(d == 0).all(axis=1)] = (1, 2)
    length = rng.integers(4, 12, n)[:, None]
    t = rng.integers(1, 4, n)[:, None]
    on = a + t * d                                 # on the first segment
    off = on + rng.integers(-6, 7, (n, 2))
    off[(off == on).all(axis=1)] += (3, -1)
    pts, segs = _segments(rng, np.concatenate([a, on]),
                          np.concatenate([a + length * d, off]))
    return _layout(pts, segs)


def collinear_overlaps(seed=1, n=48):
    """Segments along a few lattice lines: overlapping, touching end to
    end, nested and disjoint (all four cross products 0, which the
    non-strict test counts)."""
    rng = np.random.default_rng(seed)
    lines = [((0, 0), (1, 0)), ((0, 5), (1, 1)), ((40, 0), (-2, 3)),
             ((7, 7), (0, 1))]
    starts, ends = [], []
    for k in range(n):
        (ox, oy), (dx, dy) = lines[k % len(lines)]
        s = int(rng.integers(0, 12))
        e = s + int(rng.integers(1, 8))
        starts.append((ox + s * dx, oy + s * dy))
        ends.append((ox + e * dx, oy + e * dy))
    pts, segs = _segments(rng, np.array(starts, np.float64),
                          np.array(ends, np.float64))
    return _layout(pts, segs)


def shared_endpoints(seed=2, n_v=40, degree=12):
    """Stars: many edges meet at a few hub vertices and cross each other's
    spokes, some edges listed in both orientations."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 50, (n_v, 2))
    hubs = rng.choice(n_v, 4, replace=False)
    segs = []
    for h in hubs:
        for w in rng.choice(n_v, degree, replace=False):
            if w != h:
                segs.append((h, w))
    segs += [(w, h) for h, w in segs[::7]]         # reversed twins
    segs += [tuple(rng.choice(n_v, 2, replace=False)) for _ in range(40)]
    return _layout(pos, segs)


def duplicate_edges(seed=3, n_v=30, n_e=50):
    """Each edge twice over the same vertex ids, plus copies of some edges
    over distinct vertices at the same positions."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, 20, (n_v, 2)).astype(np.float64)
    base = []
    while len(base) < n_e:
        v, u = rng.integers(0, n_v, 2)
        if v != u:
            base.append((v, u))
    twins = np.concatenate([pos, pos[:10]])        # vertices n_v.. copy 0..9
    copies = [(v + n_v, u + n_v) for v, u in base if v < 10 and u < 10]
    return _layout(twins, base + base + copies)


def zero_length_edges(seed=4, n=50):
    """Edges whose two distinct endpoint vertices share one position,
    among ordinary edges, some on the same lattice lines."""
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 30, (n, 2)).astype(np.float64)
    q = p.copy()
    long_q = rng.integers(0, 30, (n, 2)).astype(np.float64)
    q[n // 2:] = long_q[n // 2:]
    pts, segs = _segments(rng, p, q)
    return _layout(pts, segs)


def near_collinear(seed=5, n=120):
    """Endpoints on one long line, rounded to float32: every cross
    product of a near-collinear triple is decided by its rounding, so an
    FMA (one rounding for a product and the difference) changes counts."""
    rng = np.random.default_rng(seed)
    p0 = np.array([3.7, 11.3])
    p1 = np.array([97.1, 83.9])
    t = rng.uniform(0, 1, (2 * n, 1))
    pts = (p0 + t * (p1 - p0)).astype(np.float32).astype(np.float64)
    segs = np.arange(2 * n).reshape(n, 2)
    return _layout(pts, segs)


def invalid_slots(seed=6, n=80):
    """Random long segments (many crossings), about a third of them
    invalid, including whole runs of invalid slots."""
    rng = np.random.default_rng(seed)
    pts, segs = _segments(rng, rng.uniform(0, 40, (n, 2)),
                          rng.uniform(0, 40, (n, 2)))
    valid = rng.random(n) < 0.7
    valid[10:25] = False
    return _layout(pts, segs, valid)


FIXTURES = {
    "t_junctions": t_junctions,
    "collinear_overlaps": collinear_overlaps,
    "shared_endpoints": shared_endpoints,
    "duplicate_edges": duplicate_edges,
    "zero_length_edges": zero_length_edges,
    "near_collinear": near_collinear,
    "invalid_slots": invalid_slots,
}


def random_segments(n_e, seed=0):
    """A random layout of ``n_e`` long edges over ``n_e / 4`` vertices
    (about a quarter of the pairs cross) with some invalid slots: the
    kernels' bulk case."""
    rng = np.random.default_rng(seed)
    n_v = max(n_e // 4, 8)
    pos = rng.uniform(0, 100, (n_v, 2))
    edges = rng.integers(0, n_v, (n_e, 2))
    edges[:, 1] = np.where(edges[:, 0] == edges[:, 1],
                           (edges[:, 1] + 1) % n_v, edges[:, 1])
    return _layout(pos, edges, rng.random(n_e) < 0.95)
