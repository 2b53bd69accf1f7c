"""Minimum angle ``M_a`` (paper S3.1.2); counterpart of
:mod:`repro.core.min_angle`.

For every vertex v with incident edges, sort the directed angles of its
incident edges and find the minimum gap phi_min(v) between circularly
adjacent angles.  With the ideal angle phi(v) = 2*pi/deg(v):

    d_v = (phi(v) - phi_min(v)) / phi(v)
    M_a = 1 - mean_{v: deg(v) >= 1} d_v

One sort of all 2|E| directed half-edges by (vertex, angle) plus segment
reductions -- no ragged per-vertex arrays.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import grid as gridlib
from repro_torch.core.geometry import (TWO_PI, directed_angle,
                                       directed_angle_safe, scalar_like)


def _half_edges(pos, edges, edge_valid, V, angle_fn=directed_angle):
    """Directed half-edges, invalid ones routed to trash vertex ``V``:
    ``(src (2E,), angles)`` with the angles over the leading batch dims
    of ``pos``."""
    src = torch.cat([edges[:, 0], edges[:, 1]]).long()
    dst = torch.cat([edges[:, 1], edges[:, 0]]).long()
    ok = torch.cat([edge_valid, edge_valid])
    src = torch.where(ok, src, V)
    srcc = torch.clamp(src, 0, V - 1)
    px, py = pos[..., 0], pos[..., 1]
    sx = torch.where(ok, px[..., srcc], 0.0)
    sy = torch.where(ok, py[..., srcc], 0.0)
    dx = torch.where(ok, px[..., dst], 1.0)
    dy = torch.where(ok, py[..., dst], 0.0)
    return src, angle_fn(sx, sy, dx, dy)


def ideal_gap(deg, dtype):
    """``2 pi / max(deg, 1)``, the ideal angle per vertex, in float32 and
    then in ``dtype``: the reference's quotient of an integer array by a
    Python float is weakly typed and takes the angles' dtype where it
    meets them."""
    return (scalar_like(TWO_PI, deg.float())
            / torch.clamp_min(deg, 1).float()).to(dtype)


def _m_a(deg, phi_min, dim):
    counted = deg >= 1
    ideal = ideal_gap(deg, phi_min.dtype)
    dev = torch.where(counted, (ideal - phi_min) / ideal, 0.0)
    # the count in the deviations' dtype, as the reference converts it
    n_counted = torch.clamp_min(counted.sum(), 1).to(dev.dtype)
    return 1.0 - dev.sum(dim=dim) / n_counted, counted


def minimum_angle(pos, edges, *, n_vertices=None, edge_valid=None):
    """Returns (M_a, per-vertex mask of counted vertices)."""
    gridlib.CALL_COUNTS["vertex_sorts"] += 1
    V = pos.shape[0] if n_vertices is None else n_vertices
    dev_ = pos.device
    if edge_valid is None:
        edge_valid = torch.ones(edges.shape[0], dtype=torch.bool,
                                device=dev_)
    src, ang = _half_edges(pos, edges, edge_valid, V)

    # lexicographic (vertex, angle) order: stable sort by angle, then by
    # vertex
    order = torch.sort(ang, stable=True)[1]
    order = order[torch.sort(src[order], stable=True)[1]]
    s = src[order]
    a = ang[order]

    n_seg = V + 1
    inf = torch.full((n_seg,), math.inf, dtype=a.dtype, device=dev_)
    amin = inf.scatter_reduce(0, s, a, "amin")
    amax = (-inf).scatter_reduce(0, s, a, "amax")
    # a scatter and not bincount, which reads the keys' range back to
    # the host and so waits for the device
    deg = torch.zeros(n_seg, dtype=torch.int64,
                      device=dev_).scatter_add_(0, s, torch.ones_like(s))

    same = s[1:] == s[:-1]
    gaps = torch.where(same, a[1:] - a[:-1], math.inf)
    gap_min = inf.scatter_reduce(0, s[1:], gaps, "amin")
    wrap = scalar_like(TWO_PI, a) - (amax - amin)
    phi_min = torch.minimum(gap_min, wrap)[:V]
    return _m_a(deg[:V], phi_min, None)


def minimum_angle_batched(pos, edges, *, edge_valid=None,
                          safe_grad: bool = False):
    """Batched M_a: ``(B, V, 2)`` layouts of one graph -> ``(B,)``.

    The vertex keys are layout-invariant, so the run layout of the
    sorted half-edges (degrees, run starts) is computed once; each row
    sorts its angles within runs, per-vertex min/max angles are the run's
    first/last element, and the min gap within each run comes from a
    doubling segmented min (log2(2E) elementwise passes).  Returns
    ``(m_a (B,), counted (B, V))``.

    ``safe_grad=True`` takes the half-edge angles from
    :func:`~repro_torch.core.geometry.directed_angle_safe` (identical
    forward values, finite gradients on zero-length edges): the soft
    path's option.  The exact paths keep the default.
    """
    gridlib.CALL_COUNTS["vertex_sorts"] += 1
    B, V = pos.shape[0], pos.shape[1]
    dev_ = pos.device
    if edge_valid is None:
        edge_valid = torch.ones(edges.shape[0], dtype=torch.bool,
                                device=dev_)
    src, ang = _half_edges(pos, edges, edge_valid, V,
                           directed_angle_safe if safe_grad
                           else directed_angle)         # ang: (B, 2E)
    n = ang.shape[1]

    # per-row (vertex, angle) order: sort angles, then stable-sort the
    # vertex keys they carry
    a1, i1 = torch.sort(ang, dim=1)
    i2 = torch.sort(src[i1], dim=1, stable=True)[1]
    a = torch.gather(a1, 1, i2)                          # (B, n)

    # batch-invariant run layout from the shared keys
    s = torch.sort(src)[0]
    bounds = torch.searchsorted(s, torch.arange(V + 1, device=dev_))
    deg = bounds[1:] - bounds[:-1]                       # (V,)
    start = bounds[:V]
    first = torch.clamp(start, 0, n - 1)
    last = torch.clamp(start + deg - 1, 0, n - 1)
    amin = a[:, first]
    amax = a[:, last]

    # doubling segmented min over the adjacent differences (gap i is
    # in-run iff s[i+1] == s[i]; cross-run gaps start at +inf and the
    # s[i + 2^k] == s[i] guard keeps them out)
    same = s[1:] == s[:-1]
    m = torch.where(same, a[:, 1:] - a[:, :-1], math.inf)   # (B, n-1)
    L = n - 1
    shift = 1
    while shift < L:
        reach = s[shift:L] == s[:L - shift]
        head = torch.where(reach, torch.minimum(m[:, :L - shift],
                                                m[:, shift:]),
                           m[:, :L - shift])
        m = torch.cat([head, m[:, L - shift:]], dim=1)
        shift *= 2
    gap_min = torch.where(deg >= 2, m[:, torch.clamp(first, 0, L - 1)],
                          math.inf)
    wrap = scalar_like(TWO_PI, a) - (amax - amin)
    phi_min = torch.minimum(gap_min, wrap)
    m_a, counted = _m_a(deg, phi_min, 1)
    return m_a, counted.expand(B, V)
