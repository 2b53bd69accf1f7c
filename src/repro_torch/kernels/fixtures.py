"""Fixtures for the kernels, built from fixed seeds with numpy.  The
tests hold the plain PyTorch versions to the JAX reference on them, and
the card tests and ``chip_smoke.py`` hold the CUDA kernels to the plain
versions on the same inputs.

* :data:`FIXTURES` -- adversarial layouts for the exact crossing sweeps,
  each a ``(pos float32 (V, 2), edges int32 (E, 2), valid bool (E,))``
  layout in a degenerate regime where a straddle test goes wrong: an
  endpoint exactly on another segment, exact collinear overlaps, shared
  endpoints, duplicate edges, zero-length edges, float32 endpoints so
  nearly collinear that the cross products are decided by rounding, and
  invalid slots.
* :data:`TILE_LAYOUTS` -- crossing layouts laid out against the crossing
  kernels' tiles and warps, and with segment angles near 0 and pi.
* :func:`strip_slab` / :data:`STRIP_SLABS` -- strip-bucket slabs for the
  strip-reversal kernel, some with validity masks whose valid slots are
  no prefix (:func:`mask_pattern`).
* :func:`occlusion_case` / :data:`OCCLUSION_CASES` -- vertex layouts
  against the occlusion kernel's tiles; :func:`boundary_points` -- pairs
  at exactly ``d2 == (2r)^2``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.kernels.occlusion_pairs import TILE as VERTEX_TILE
from repro_torch.kernels.segment_crossing import TILE as EDGE_TILE


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


def tile_pattern(n_tiles, pattern, seed):
    """:func:`random_segments` over exactly ``n_tiles`` crossing-kernel
    tiles, valid only in the ``"first"`` tile, the ``"last"`` one, or the
    ``"alternate"`` (even-numbered) ones."""
    pos, edges, valid = random_segments(n_tiles * EDGE_TILE, seed=seed)
    tile = np.arange(edges.shape[0]) // EDGE_TILE
    keep = {"first": tile == 0, "last": tile == n_tiles - 1,
            "alternate": tile % 2 == 0}[pattern]
    return pos, edges, valid & keep


def warp_rows(seed=20):
    """Two tiles in which only edges 32-63 of each tile cross anything
    (long segments in one box, crossing within and across the two
    groups); every other edge is a short segment on its own far away.
    Every crossing pair then has its i among the rows of one warp."""
    rng = np.random.default_rng(seed)
    n_e = 2 * EDGE_TILE
    k = np.arange(n_e)
    starts = np.stack([100.0 + 3.0 * (k % 40), 100.0 + 3.0 * (k // 40)], 1)
    ends = starts + (1.0, 0.37)     # parallel, no two on one line
    group = (k % EDGE_TILE >= 32) & (k % EDGE_TILE < 64)
    starts[group] = rng.uniform(0, 10, (int(group.sum()), 2))
    ends[group] = rng.uniform(0, 10, (int(group.sum()), 2))
    pts = np.concatenate([starts, ends])
    return _layout(pts, np.stack([k, k + n_e], axis=1))


def theta_near_0_and_pi(seed=21, n=EDGE_TILE + 100):
    """Long near-horizontal segments sloping slightly up (angle just above
    0) or down (just below pi), half of them drawn right to left, with
    intercepts close enough that most pairs cross: for a pair of opposite
    slopes d = |theta_i - theta_j| is near pi and ``pi - d`` decides the
    crossing angle."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(0, 10, n)
    y0 = rng.uniform(0, 0.05, n)
    rise = rng.uniform(1e-3, 0.1, n) * rng.choice([-1.0, 1.0], n)
    starts = np.stack([x0, y0], 1)
    ends = np.stack([x0 + 100.0, y0 + rise], 1)
    flip = rng.random(n) < 0.5
    starts[flip], ends[flip] = ends[flip].copy(), starts[flip].copy()
    pts, segs = _segments(rng, starts, ends)
    return _layout(pts, segs)


TILE_LAYOUTS = {
    "tiles1": lambda: tile_pattern(1, "first", 22),
    "tiles2_first": lambda: tile_pattern(2, "first", 23),
    "tiles2_last": lambda: tile_pattern(2, "last", 24),
    "tiles3_first": lambda: tile_pattern(3, "first", 25),
    "tiles3_last": lambda: tile_pattern(3, "last", 26),
    "tiles3_alternate": lambda: tile_pattern(3, "alternate", 27),
    "warp_rows": warp_rows,
    "theta_near_0_and_pi": theta_near_0_and_pi,
}


# ---------------------------------------------------------------------------
# strip-reversal slabs
# ---------------------------------------------------------------------------

def mask_pattern(name, rows, cap, rng):
    """Validity masks whose valid slots do not form a prefix, or whose
    extents differ from row to row (the strip-reversal kernel finds each
    row's extent on the device)."""
    ok = np.zeros((rows, cap), bool)
    if name == "last_only":         # only the last slot, or first + last
        ok[0::3, -1] = True
        ok[1::3, [0, -1]] = True
        ok[2::3] = True
    elif name == "interior_gaps":   # a prefix of random length, holed
        for r in range(rows):
            n = int(rng.integers(2, cap + 1))
            ok[r, :n] = rng.random(n) < 0.5
    elif name == "one_slot_rows":   # full, empty, one slot, empty, ...
        for r in range(rows):
            kind = r % 4
            if kind == 0:
                ok[r] = True
            elif kind == 2:
                ok[r, int(rng.integers(0, cap))] = True
    elif name == "mixed_lengths":   # short and full rows in one slab
        lengths = [0, 1, 2, 31, 32, 33, 127, 128, 129, 200, 255, 256]
        for r in range(rows):
            ok[r, :min(cap, lengths[r % len(lengths)])] = True
    else:
        raise ValueError(name)
    return ok


def strip_slab(rows, cap, seed, *, ties=False, shared=False,
               invalid_rows=(), p_valid=0.85, mask=None):
    """A ``(rows, cap)`` slab of strip buckets ``(yl, yr, theta, v, u,
    valid)`` as numpy arrays (``mask`` names a :func:`mask_pattern`; the
    default scatters invalid slots)."""
    rng = np.random.default_rng(seed)
    yl = rng.uniform(0, 10, (rows, cap)).astype(np.float32)
    yr = rng.uniform(0, 10, (rows, cap)).astype(np.float32)
    if ties:                        # quantized ordinates: many exact ties
        yl = np.round(yl).astype(np.float32)
        yr = np.round(yr).astype(np.float32)
    th = rng.uniform(0, np.pi, (rows, cap)).astype(np.float32)
    hi = 6 if shared else 10 * cap
    v = rng.integers(0, hi, (rows, cap)).astype(np.int32)
    u = rng.integers(0, hi, (rows, cap)).astype(np.int32)
    ok = (rng.random((rows, cap)) < p_valid if mask is None
          else mask_pattern(mask, rows, cap, rng))
    for r in invalid_rows:
        ok[r] = False
    return yl, yr, th, v, u, ok


STRIP_SLABS = {
    "cap45": dict(rows=7, cap=45, seed=0),
    "cap200_ties": dict(rows=5, cap=200, seed=1, ties=True),
    "cap128_shared": dict(rows=6, cap=128, seed=2, shared=True),
    "invalid_rows": dict(rows=4, cap=33, seed=3, invalid_rows=(0, 2)),
    "one_row": dict(rows=1, cap=97, seed=4),
    "cap300_ties_shared": dict(rows=3, cap=300, seed=5, ties=True,
                               shared=True),
    "last_only": dict(rows=6, cap=300, seed=6, ties=True, mask="last_only"),
    "interior_gaps": dict(rows=5, cap=200, seed=7, mask="interior_gaps"),
    "one_slot_rows": dict(rows=8, cap=150, seed=8, ties=True,
                          mask="one_slot_rows"),
    "mixed_cap256": dict(rows=24, cap=256, seed=9, shared=True,
                         mask="mixed_lengths"),
}
# rows longer than one 1024-slot staging window of the kernel
WIDE_STRIP_SLABS = {
    "cap1100_wide": dict(rows=3, cap=1100, seed=9, ties=True),
    "cap2500_windows": dict(rows=2, cap=2500, seed=10, ties=True,
                            mask="interior_gaps"),
}


# ---------------------------------------------------------------------------
# occlusion layouts
# ---------------------------------------------------------------------------

def boundary_points(radius):
    """Points whose pairs sit exactly at, just inside and just outside
    ``d2 == (2r)^2``: axis-aligned at distance 2r and 3-4-5 triangles
    (every coordinate and product exact in float32)."""
    d = 2.0 * radius
    pts = [(0.0, 0.0), (d, 0.0), (0.0, d), (-d, 0.0),            # exactly 2r
           (10.0, 10.0), (10.0 + 0.6 * d, 10.0 + 0.8 * d),          # 3-4-5
           (0.0, 20.0), (np.nextafter(np.float32(d), 0), 20.0),     # inside
           (0.0, 30.0), (np.nextafter(np.float32(d), 99), 30.0),    # outside
           (40.0, 40.0), (40.0, 40.0)]                               # d = 0
    return np.array(pts, np.float32)


def occlusion_case(name, radius):
    """``(pos, ok)`` padded to the occlusion kernel's tile: dense points
    (many occluding pairs) with the validity laid out to hit the kernel's
    tile skipping and diagonal handling."""
    t = VERTEX_TILE
    rng = np.random.default_rng(len(name))
    n = t if name == "one_tile" else 3 * t
    pos = rng.uniform(0, 12, (n, 2)).astype(np.float32)
    ok = np.ones(n, bool)
    if name == "one_tile":          # n of exactly one tile, with ties
        pts = boundary_points(radius)
        pos[:len(pts)] = pts
    elif name == "middle_tile_invalid":
        ok[t:2 * t] = False
    elif name == "last_tile_single":
        ok[2 * t:] = False
        ok[-1] = True               # one valid vertex, on top of vertex 0
        pos[-1] = pos[0]
    else:
        raise ValueError(name)
    return pos, ok


OCCLUSION_CASES = ["last_tile_single", "middle_tile_invalid", "one_tile"]
