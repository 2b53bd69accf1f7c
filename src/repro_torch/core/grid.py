"""Spatial decomposition utilities: the paper's 'grid method' (S3.2).

Counterpart of :mod:`repro.core.grid`.  Spark's ``groupBy`` becomes
sort-by-key + dense capacity-padded buckets, so every per-cell or
per-strip computation downstream is a fixed-shape dense block:

* node occlusion: a cell grid of side >= 2r, each vertex in the one cell
  holding its centre, cells paired with a *half neighbourhood*
  (self + E, N, NE, SE) so every candidate pair is generated once;
* edge crossing / crossing angle: strips of width ``l``, each edge cut
  into the strips it fully spans.

Where the reference leans on JAX's clamped gathers and dropped
scatters, this module clamps or routes out-of-range indices explicitly
(PyTorch raises, or asserts on the device).  Any stable sort reproduces
the reference's keep-first-``cap`` drop rule, so bucket contents are
equal.  The host-side planners at the bottom are numpy copies.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Half-neighbourhood offsets (dx, dy) covering all adjacent unordered cell
# pairs exactly once: same-cell pairs use i<j ordering, cross-cell pairs
# use these four directed offsets.
HALF_NEIGHBOURHOOD = ((1, 0), (0, 1), (1, 1), (1, -1))

# Work counters, bumped at the reference's bump points (once per call
# here: nothing is traced).  The metric-subset tests use them to prove
# pruned configs never build the decompositions they do not need.
CALL_COUNTS = {"strip_builds": 0, "reversal_sweeps": 0, "cell_builds": 0,
               "vertex_sorts": 0, "halo_exchanges": 0}


def reset_call_counts():
    for k in CALL_COUNTS:
        CALL_COUNTS[k] = 0


def count_dtype():
    """Integer dtype for pair-count accumulators.  The reference counts in
    int32 unless x64 is on; the port always counts in int64 (values are
    equal wherever the reference does not wrap)."""
    return torch.int64


class CellBuckets(NamedTuple):
    """Dense capacity-padded buckets of vertices binned into grid cells."""

    x: torch.Tensor        # (n_cells, cap) float
    y: torch.Tensor        # (n_cells, cap) float
    valid: torch.Tensor    # (n_cells, cap) bool
    counts: torch.Tensor   # (n_cells,) true occupancy (pre-capacity-clip)
    overflow: torch.Tensor  # () number of vertices dropped by the cap
    nx: int
    ny: int


class StripSegments(NamedTuple):
    """Per-strip 'comparable' line segments (paper S3.2.2): an edge cut to
    one fully spanned strip; ``yl``/``yr`` are its ordinates on the
    strip's two boundary lines, ``theta`` the parent edge's undirected
    angle, ``v``/``u`` its endpoints, ``eid`` the parent edge id (clipped
    to ``[0, E-1]``; meaningful only where ``valid``)."""

    strip: torch.Tensor    # (S,) strip index (n_strips = trash)
    yl: torch.Tensor       # (S,) float
    yr: torch.Tensor       # (S,) float
    theta: torch.Tensor    # (S,) float, in [0, pi)
    v: torch.Tensor        # (S,) int32
    u: torch.Tensor        # (S,) int32
    valid: torch.Tensor    # (S,) bool
    overflow: torch.Tensor  # () segments dropped by max_segments budget
    eid: torch.Tensor = None


class SegmentBuckets(NamedTuple):
    """Strip segments regrouped into dense per-strip buckets."""

    yl: torch.Tensor       # (n_strips, cap)
    yr: torch.Tensor       # (n_strips, cap)
    theta: torch.Tensor    # (n_strips, cap)
    v: torch.Tensor        # (n_strips, cap) int32
    u: torch.Tensor        # (n_strips, cap) int32
    valid: torch.Tensor    # (n_strips, cap) bool
    overflow: torch.Tensor  # ()


def _full(shape, value, like):
    return torch.full(shape, value, dtype=like.dtype, device=like.device)


def _scalar(value, like):
    """``value`` as a 0-dim tensor of ``like``'s dtype on its device.

    Used for every divisor: CUDA turns division by a host scalar into a
    reciprocal multiply, which is not the reference's true division."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _index(x):
    """Float -> int32 as the reference's ``astype(jnp.int32)`` converts
    under XLA: NaN to 0, out-of-range values saturated.  PyTorch leaves
    both undefined (the CPU gives INT64_MIN, and a later ``- 1`` wraps),
    so a non-finite coordinate would bucket differently.  Returns int32:
    arithmetic on the result wraps as the reference's does."""
    x = torch.clamp(torch.where(torch.isnan(x), 0.0, x), -2.0 ** 31,
                    2.0 ** 31)
    return torch.clamp(x.to(torch.int64), -2 ** 31,
                       2 ** 31 - 1).to(torch.int32)


# ---------------------------------------------------------------------------
# generic bucketing (the 'groupBy')
# ---------------------------------------------------------------------------

def rank_within_group(keys: torch.Tensor) -> torch.Tensor:
    """For *sorted* integer ``keys``, the 0-based rank of each element
    within its run of equal keys."""
    idx = torch.arange(keys.shape[0], device=keys.device)
    return idx - torch.searchsorted(keys, keys, right=False)


def scatter_to_buckets(keys, n_buckets: int, cap: int, *values, valid=None):
    """Group ``values`` by integer ``keys`` into dense ``(n_buckets, cap)``
    arrays; elements beyond ``cap`` per bucket are dropped (counted as
    overflow).  Returns ``(bucketed_values..., valid, counts, overflow)``.
    """
    dev = keys.device
    if valid is None:
        valid = torch.ones(keys.shape, dtype=torch.bool, device=dev)
    keys = torch.where(valid, keys.long(), n_buckets)
    skeys, order = torch.sort(keys, stable=True)
    ranks = rank_within_group(skeys)
    in_cap = (ranks < cap) & (skeys < n_buckets)
    # ONE scatter routes the source index to its slot (out-of-cap entries
    # land in the trash slot n_buckets*cap, cut off afterwards); the
    # value arrays follow by gathers
    dest = torch.where(in_cap, skeys * cap + ranks, n_buckets * cap)
    src = torch.zeros(n_buckets * cap + 1, dtype=torch.int64, device=dev)
    src[dest] = order
    src = src[:-1]
    bvalid = torch.zeros(n_buckets * cap + 1, dtype=torch.bool, device=dev)
    bvalid[dest] = in_cap
    bvalid = bvalid[:-1]
    out_values = []
    for val in values:
        flat = torch.where(bvalid, val[src], torch.zeros((), dtype=val.dtype,
                                                         device=dev))
        out_values.append(flat.reshape(n_buckets, cap))
    bounds = torch.searchsorted(
        skeys, torch.arange(n_buckets + 1, device=dev))
    counts = bounds[1:] - bounds[:-1]
    overflow = counts.sum() - bvalid.sum()
    return (*out_values, bvalid.reshape(n_buckets, cap), counts, overflow)


def gather_ragged_buckets(keys, n_buckets: int, bucket_offset, bucket_cap,
                          *values, valid=None):
    """Group ``(B, M)`` ``values`` by ``(B, M)`` integer ``keys`` into a
    *ragged-dense* layout: bucket ``k`` owns slots ``[bucket_offset[k],
    bucket_offset[k] + bucket_cap[k])`` of a ``(B, total)`` row buffer.

    One stable sort per row groups the batch; each bucket's content is
    then a contiguous run of the sorted row, so buckets materialize by
    gathers alone.  ``bucket_offset`` / ``bucket_cap`` are host-side
    plan data.  Elements beyond a bucket's capacity are dropped and
    counted.  Returns ``(bucketed_values..., valid, counts, overflow)``
    with values/valid ``(B, total)``, counts ``(B, n_buckets)`` and
    overflow ``(B,)``.
    """
    dev = keys.device
    bucket_offset = np.asarray(bucket_offset, np.int64)
    bucket_cap = np.asarray(bucket_cap, np.int64)
    total = int((bucket_offset + bucket_cap).max()) if len(bucket_cap) else 0
    # host-side slot maps: owning bucket and within-bucket position of
    # every flat slot, walked in offset order (tiered layouts permute
    # the buckets)
    by_off = np.argsort(bucket_offset)
    slot_bucket = np.repeat(by_off, bucket_cap[by_off])
    starts = np.repeat(bucket_offset[by_off], bucket_cap[by_off])
    slot_j = np.arange(total, dtype=np.int64) - starts
    slot_bucket = torch.from_numpy(slot_bucket).to(dev)
    slot_j = torch.from_numpy(slot_j).to(dev)

    B, M = keys.shape
    if valid is None:
        valid = torch.ones(keys.shape, dtype=torch.bool, device=dev)
    keys = torch.where(valid, keys.long(), n_buckets)
    skeys, idx = torch.sort(keys, dim=1, stable=True)
    probe = torch.arange(n_buckets + 1, device=dev).expand(B, -1)
    bounds = torch.searchsorted(skeys, probe.contiguous())
    counts = bounds[:, 1:] - bounds[:, :-1]                      # (B, K)
    routed = bounds[:, n_buckets]                                # (B,)

    start = bounds[:, :-1][:, slot_bucket]                       # (B, total)
    in_cap = slot_j[None, :] < counts[:, slot_bucket]
    src_sorted = torch.clamp(start + slot_j[None, :], max=M - 1)
    src = torch.gather(idx, 1, src_sorted)
    out_values = []
    for val in values:
        out_values.append(torch.where(
            in_cap, torch.gather(val, 1, src),
            torch.zeros((), dtype=val.dtype, device=dev)))
    overflow = routed - in_cap.sum(dim=1)
    return (*out_values, in_cap, counts, overflow)


# ---------------------------------------------------------------------------
# occlusion grid
# ---------------------------------------------------------------------------

def cell_indices(pos, radius, origin, nx: int, ny: int, cell_size=None):
    """Cell (ix, iy) and flat id for each vertex centre (any leading
    shape).  ``cell_size`` defaults to the paper's 2r; any size >= 2r
    keeps the half-neighbourhood sweep exact."""
    size = _scalar(2.0 * radius if cell_size is None else cell_size,
                   pos)
    ix = torch.clamp(_index(torch.floor((pos[..., 0] - origin[0]) / size)),
                     0, nx - 1).to(torch.int64)
    iy = torch.clamp(_index(torch.floor((pos[..., 1] - origin[1]) / size)),
                     0, ny - 1).to(torch.int64)
    return ix, iy, iy * nx + ix


def build_cell_buckets(pos, radius, origin, nx: int, ny: int, cap: int,
                       valid=None, cell_size=None) -> CellBuckets:
    """Bin vertices into the occlusion grid (paper fig 1 A-1/A-2)."""
    CALL_COUNTS["cell_builds"] += 1
    _, _, cid = cell_indices(pos, radius, origin, nx, ny,
                             cell_size=cell_size)
    x, y, bvalid, counts, overflow = scatter_to_buckets(
        cid, nx * ny, cap, pos[:, 0], pos[:, 1], valid=valid)
    return CellBuckets(x=x, y=y, valid=bvalid, counts=counts,
                       overflow=overflow, nx=nx, ny=ny)


def neighbour_bucket_ids(nx: int, ny: int, device=None):
    """For each cell, the flat ids of its half-neighbourhood cells:
    ``(n_cells, 4)`` with -1 where the neighbour falls outside the grid."""
    c = torch.arange(nx * ny, device=device)
    cx, cy = c % nx, c // nx
    ids = []
    for dx, dy in HALF_NEIGHBOURHOOD:
        ox, oy = cx + dx, cy + dy
        ok = (ox >= 0) & (ox < nx) & (oy >= 0) & (oy < ny)
        ids.append(torch.where(ok, oy * nx + ox, -1))
    return torch.stack(ids, dim=1)


# ---------------------------------------------------------------------------
# strips for edge crossing (paper S3.2.2)
# ---------------------------------------------------------------------------

def build_strip_segments(pos, edges, n_strips: int, max_segments: int, *,
                         axis: int = 0, domain=None,
                         edge_valid=None) -> StripSegments:
    """Clip edges into per-strip comparable segments.

    An edge contributes a segment to strip ``s`` iff it crosses *both* of
    the strip's boundary lines; ``yl``/``yr`` are the crossing
    ordinates.  ``axis=0``: vertical strips over x; ``axis=1``:
    horizontal strips (x and y swap roles).  Each formula is written as
    separate elementwise ops, as the reference's are.
    """
    from repro_torch.core.geometry import segment_theta

    CALL_COUNTS["strip_builds"] += 1
    dev = pos.device
    E = edges.shape[0]
    e0, e1 = edges[:, 0].long(), edges[:, 1].long()
    p = pos[e0]
    q = pos[e1]
    x1, y1 = p[:, axis], p[:, 1 - axis]
    x2, y2 = q[:, axis], q[:, 1 - axis]
    theta = segment_theta(p[:, 0], p[:, 1], q[:, 0], q[:, 1])
    if edge_valid is None:
        edge_valid = torch.ones(E, dtype=torch.bool, device=dev)

    if domain is None:
        lo = torch.where(edge_valid, torch.minimum(x1, x2), np.inf).min()
        hi = torch.where(edge_valid, torch.maximum(x1, x2), -np.inf).max()
    else:
        lo, hi = (_scalar(d, pos) for d in domain)
    width = torch.clamp_min((hi - lo) / _scalar(n_strips, pos), 1e-30)

    xa = torch.minimum(x1, x2)
    xb = torch.maximum(x1, x2)
    # strips fully spanned: s in [ceil((xa-lo)/w), floor((xb-lo)/w) - 1]
    s_first = _index(torch.ceil((xa - lo) / width))
    s_last = _index(torch.floor((xb - lo) / width)) - 1
    s_first = torch.clamp(s_first, 0, n_strips - 1).to(torch.int64)
    s_last = torch.clamp(s_last, -1, n_strips - 1).to(torch.int64)
    n_seg = torch.where(edge_valid, torch.clamp_min(s_last - s_first + 1, 0),
                        0)

    offsets = torch.cumsum(n_seg, 0)                  # inclusive
    total = offsets[-1]
    starts = offsets - n_seg                          # exclusive
    slot = torch.arange(max_segments, device=dev)
    eid = torch.searchsorted(offsets, slot, right=True)
    eid = torch.clamp(eid, max=E - 1)
    valid = slot < total
    s_local = slot - starts[eid]
    strip = s_first[eid] + s_local

    ex1, ey1, ex2, ey2 = x1[eid], y1[eid], x2[eid], y2[eid]
    dx = ex2 - ex1
    slope = (ey2 - ey1) / torch.where(torch.abs(dx) < 1e-30, 1e-30, dx)
    bl = lo + strip.to(pos.dtype) * width
    br = bl + width
    yl = ey1 + (bl - ex1) * slope
    yr = ey1 + (br - ex1) * slope

    return StripSegments(
        strip=torch.where(valid, strip, n_strips),
        yl=yl, yr=yr, theta=theta[eid],
        v=edges[eid, 0], u=edges[eid, 1],
        valid=valid,
        overflow=torch.clamp_min(total - max_segments, 0),
        eid=eid,
    )


def build_strip_segments_batched(pos, edges, n_strips: int,
                                 max_segments: int, *, axis: int = 0,
                                 edge_valid=None) -> StripSegments:
    """Batched :func:`build_strip_segments`: ``(B, V, 2)`` layouts of one
    graph -> fields ``(B, max_segments)``, overflow ``(B,)``.  Same
    elementwise op sequence as the single-layout build, plus the
    reference's empty-extent pin (zero valid edges -> domain [0, 1])."""
    from repro_torch.core.geometry import segment_theta

    CALL_COUNTS["strip_builds"] += 1
    dev = pos.device
    E = edges.shape[0]
    e0, e1 = edges[:, 0].long(), edges[:, 1].long()
    p = pos[:, e0]                                    # (B, E, 2)
    q = pos[:, e1]
    x1, y1 = p[..., axis], p[..., 1 - axis]
    x2, y2 = q[..., axis], q[..., 1 - axis]
    theta = segment_theta(p[..., 0], p[..., 1], q[..., 0], q[..., 1])
    if edge_valid is None:
        edge_valid = torch.ones(E, dtype=torch.bool, device=dev)
    ev = edge_valid.expand(x1.shape)

    lo = torch.where(ev, torch.minimum(x1, x2), np.inf).amin(
        dim=1, keepdim=True)
    hi = torch.where(ev, torch.maximum(x1, x2), -np.inf).amax(
        dim=1, keepdim=True)
    some = torch.isfinite(lo)
    lo = torch.where(some, lo, 0.0)
    hi = torch.where(some, hi, 1.0)
    width = torch.clamp_min((hi - lo) / _scalar(n_strips, pos), 1e-30)

    xa = torch.minimum(x1, x2)
    xb = torch.maximum(x1, x2)
    s_first = _index(torch.ceil((xa - lo) / width))
    s_last = _index(torch.floor((xb - lo) / width)) - 1
    s_first = torch.clamp(s_first, 0, n_strips - 1).to(torch.int64)
    s_last = torch.clamp(s_last, -1, n_strips - 1).to(torch.int64)
    n_seg = torch.where(ev, torch.clamp_min(s_last - s_first + 1, 0), 0)

    offsets = torch.cumsum(n_seg, 1)                  # (B, E) inclusive
    total = offsets[:, -1:]                           # (B, 1)
    starts = offsets - n_seg
    slot = torch.arange(max_segments, device=dev)
    eid = torch.searchsorted(
        offsets, slot.expand(offsets.shape[0], -1).contiguous(), right=True)
    eid = torch.clamp(eid, max=E - 1)
    valid = slot[None, :] < total
    s_local = slot[None, :] - torch.gather(starts, 1, eid)
    strip = torch.gather(s_first, 1, eid) + s_local

    ga = lambda a: torch.gather(a, 1, eid)  # noqa: E731
    ex1, ey1, ex2, ey2 = ga(x1), ga(y1), ga(x2), ga(y2)
    dx = ex2 - ex1
    slope = (ey2 - ey1) / torch.where(torch.abs(dx) < 1e-30, 1e-30, dx)
    bl = lo + strip.to(pos.dtype) * width
    br = bl + width
    yl = ey1 + (bl - ex1) * slope
    yr = ey1 + (br - ex1) * slope

    return StripSegments(
        strip=torch.where(valid, strip, n_strips),
        yl=yl, yr=yr, theta=ga(theta),
        v=edges[:, 0][eid], u=edges[:, 1][eid],
        valid=valid,
        overflow=torch.clamp_min(total[:, 0] - max_segments, 0),
        eid=eid,
    )


def bucketize_segments(segs: StripSegments, n_strips: int,
                       cap: int) -> SegmentBuckets:
    """Group comparable segments into dense per-strip buckets (the
    per-strip groupBy, paper fig 1 B-3)."""
    yl, yr, theta, v, u, bvalid, _, overflow = scatter_to_buckets(
        segs.strip, n_strips, cap, segs.yl, segs.yr, segs.theta,
        segs.v, segs.u, valid=segs.valid)
    return SegmentBuckets(yl=yl, yr=yr, theta=theta, v=v, u=u,
                          valid=bvalid, overflow=overflow + segs.overflow)


# ---------------------------------------------------------------------------
# host-side capacity planning (numpy copies of the reference planners)
# ---------------------------------------------------------------------------

def _round_up(n: int, multiple: int) -> int:
    return int(-(-n // multiple) * multiple)


def occlusion_cell_size(lo, hi, radius, n_points,
                        target_occupancy: float = 8.0) -> float:
    """Occlusion cell size: at least the paper's 2r (exactness), but
    coarse enough that cells average ~``target_occupancy`` vertices."""
    size = 2.0 * float(radius)
    area = float(hi[0] - lo[0]) * float(hi[1] - lo[1])
    if n_points > 0 and area > 0 and target_occupancy > 0:
        size = max(size, (area * target_occupancy / n_points) ** 0.5)
    return size


def plan_occlusion_grid(pos, radius, pad: int = 8, cap_multiple: int = 8,
                        target_occupancy: float = 8.0):
    """Grid geometry / capacity from concrete ``(V, 2)`` or ``(B, V, 2)``
    data.  Returns ``(origin, nx, ny, cap, cell_size)``."""
    pos_b = np.asarray(pos)
    if pos_b.ndim == 2:
        pos_b = pos_b[None]
    if pos_b.shape[1] == 0:
        return (0.0, 0.0), 1, 1, _round_up(pad, cap_multiple), \
            2.0 * float(radius)
    lo = pos_b.reshape(-1, 2).min(axis=0) - 1e-6
    hi = pos_b.reshape(-1, 2).max(axis=0) + 1e-6
    size = occlusion_cell_size(lo, hi, radius, pos_b.shape[1],
                               target_occupancy)
    nx = max(1, int(np.ceil((hi[0] - lo[0]) / size)))
    ny = max(1, int(np.ceil((hi[1] - lo[1]) / size)))
    occ_max = 0
    for p in pos_b:
        ix = np.clip(((p[:, 0] - lo[0]) / size).astype(np.int64), 0, nx - 1)
        iy = np.clip(((p[:, 1] - lo[1]) / size).astype(np.int64), 0, ny - 1)
        occ_max = max(occ_max, int(np.bincount(iy * nx + ix,
                                               minlength=nx * ny).max()))
    cap = _round_up(occ_max + pad, cap_multiple)
    return (float(lo[0]), float(lo[1])), nx, ny, cap, size


def plan_strip_occupancy(pos, edges, n_strips: int, pad: float = 1.25,
                         axis: int = 0):
    """Segment budget + exact per-strip occupancy from concrete data:
    ``(max_segments, per_strip)`` with ``per_strip`` the ``(n_strips,)``
    int64 true occupancy."""
    pos = np.asarray(pos)
    edges = np.asarray(edges)
    if edges.shape[0] == 0:
        return _round_up(1 + 64, 128), np.zeros(n_strips, np.int64)
    x = pos[:, axis]
    x1, x2 = x[edges[:, 0]], x[edges[:, 1]]
    lo, hi = x1.min(), x2.max()
    lo = min(lo, x2.min())
    hi = max(hi, x1.max())
    width = max((hi - lo) / n_strips, 1e-30)
    xa, xb = np.minimum(x1, x2), np.maximum(x1, x2)
    s_first = np.clip(np.ceil((xa - lo) / width).astype(np.int64), 0,
                      n_strips - 1)
    s_last = np.clip(np.floor((xb - lo) / width).astype(np.int64) - 1, -1,
                     n_strips - 1)
    n_seg = np.maximum(0, s_last - s_first + 1)
    total = int(n_seg.sum())
    max_segments = _round_up(max(int(total * pad), 1) + 64, 128)
    first = s_first[n_seg > 0]
    last = s_last[n_seg > 0]
    diff = np.zeros(n_strips + 1, dtype=np.int64)
    np.add.at(diff, first, 1)
    np.add.at(diff, last + 1, -1)
    per_strip = np.cumsum(diff[:-1])
    return max_segments, per_strip


def plan_strips(pos, edges, n_strips: int, pad: float = 1.25,
                cap_multiple: int = 8, axis: int = 0):
    """Pick ``(max_segments, cap)`` from concrete data (host side; tensors
    are fetched).  Both the segment budget and the per-strip capacity
    carry the ``pad`` headroom, so a plan made from one layout keeps
    serving perturbed siblings without tripping the overflow counter."""
    if isinstance(pos, torch.Tensor):
        pos = pos.detach().cpu().numpy()
    if isinstance(edges, torch.Tensor):
        edges = edges.detach().cpu().numpy()
    max_segments, per_strip = plan_strip_occupancy(pos, edges, n_strips,
                                                   pad=pad, axis=axis)
    cap = _round_up(int(per_strip.max() * pad) + 8, cap_multiple)
    return max_segments, cap


def _next_pow2(n: int, floor: int = 8) -> int:
    v = int(floor)
    while v < n:
        v *= 2
    return v


def tiers_from_caps(cap_per_strip, max_tiers: int = 3,
                    cap_multiple: int = 8):
    """Collapse per-strip capacities into <= ``max_tiers`` tiers at pow2
    boundaries.  Returns ``(caps, counts, order)``: tier capacities
    descending, strips per tier, strip ids sorted by (tier, strip id) --
    plain int tuples, hashable plan data."""
    need = np.maximum(np.asarray(cap_per_strip, np.int64), 1)
    levels = np.array([_next_pow2(int(c)) for c in need], dtype=np.int64)
    kept = sorted(set(levels.tolist()), reverse=True)[:max_tiers]
    kept_asc = sorted(kept)
    level_s = np.array([min(k for k in kept_asc if k >= lv) for lv in levels],
                       dtype=np.int64)
    order = np.argsort(-level_s, kind="stable")
    caps, counts = [], []
    for lev in sorted(set(level_s.tolist()), reverse=True):
        member = level_s == lev
        caps.append(_round_up(int(need[member].max()), cap_multiple))
        counts.append(int(member.sum()))
    return tuple(caps), tuple(counts), tuple(int(i) for i in order)


def plan_strip_tiers(per_strip_occupancy, pad: float = 1.25,
                     pad_add: int = 8, max_tiers: int = 3):
    """Occupancy tiers from true per-strip occupancy (host side): each
    strip's need carries the ``pad`` headroom, then strips collapse into
    <= ``max_tiers`` pow2 capacity tiers."""
    occ = np.asarray(per_strip_occupancy, np.int64)
    need = np.maximum((occ * pad).astype(np.int64) + pad_add, 8)
    return tiers_from_caps(need, max_tiers=max_tiers)
