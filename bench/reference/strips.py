"""The strip decomposition of the enhanced crossing count (paper
S3.2.2), plainly.

An edge gives a segment to each strip whose two boundary lines it
crosses; the strips are ``n_strips`` equal slices of the extent of the
layout's edges along the axis.  Two segments of a strip cross iff the
order of their ordinates on the strip's left line reverses on its right
line; pairs sharing an endpoint are excluded.  The segment ordinates
are formed one rounding per operation in the working dtype.
"""

from __future__ import annotations

import math

import torch

from bench.reference.pairs import const, segment_theta


def _extent(pos, edges, n_strips, axis):
    v, u = edges[:, 0].long(), edges[:, 1].long()
    x1, x2 = pos[v, axis], pos[u, axis]
    xa, xb = torch.minimum(x1, x2), torch.maximum(x1, x2)
    lo, hi = xa.amin(), xb.amax()
    width = torch.maximum((hi - lo) / const(n_strips, pos),
                          const(1e-30, pos))
    return xa, xb, lo, width


def strip_segments(pos, edges, n_strips: int, axis: int, index_pos=None):
    """Segments of one orientation: ``(strip, yl, yr, theta, v, u)``,
    one entry per (edge, fully spanned strip).  Which strips an edge
    spans is decided on ``index_pos`` (default ``pos``): the soft loss
    decides it in float32, as the configuration states, and forms the
    ordinates in its own dtype."""
    v, u = edges[:, 0].long(), edges[:, 1].long()
    p, q = pos[v], pos[u]
    x1, y1 = p[:, axis], p[:, 1 - axis]
    x2, y2 = q[:, axis], q[:, 1 - axis]
    theta = segment_theta(p[:, 0], p[:, 1], q[:, 0], q[:, 1])
    _, _, lo, width = _extent(pos, edges, n_strips, axis)
    with torch.no_grad():
        xa, xb, lo_i, w_i = _extent(pos if index_pos is None else index_pos,
                                    edges, n_strips, axis)
        first = torch.ceil((xa - lo_i) / w_i).long().clamp(0, n_strips - 1)
        last = (torch.floor((xb - lo_i) / w_i).long() - 1).clamp(
            -1, n_strips - 1)
    count = (last - first + 1).clamp_min(0)
    eid = torch.repeat_interleave(torch.arange(edges.shape[0],
                                               device=pos.device), count)
    start = torch.cumsum(count, 0) - count
    strip = first[eid] + torch.arange(eid.shape[0],
                                      device=pos.device) - start[eid]
    ex1, ey1, ex2, ey2 = x1[eid], y1[eid], x2[eid], y2[eid]
    dx = ex2 - ex1
    slope = (ey2 - ey1) / torch.where(torch.abs(dx) < 1e-30, 1e-30, dx)
    bl = lo + strip.to(pos.dtype) * width
    br = bl + width
    yl = ey1 + (bl - ex1) * slope
    yr = ey1 + (br - ex1) * slope
    return strip, yl, yr, theta[eid], edges[eid, 0], edges[eid, 1]


def strip_stats(pos, edges, n_strips: int, axis: int, ideal, *,
                pair_budget: int = 1 << 27):
    """Crossings of one orientation: ``dict(pairs, reversals, crossings,
    dev_sum)``, with ``pairs`` the unordered segment pairs of the strips
    and ``reversals`` the pairs whose order reverses (shared endpoints
    included)."""
    strip, yl, yr, theta, v, u = strip_segments(pos, edges, n_strips, axis)
    dev_ = pos.device
    order = torch.sort(strip, stable=True).indices
    strip, yl, yr, theta, v, u = (t[order] for t in
                                  (strip, yl, yr, theta, v, u))
    occ = torch.bincount(strip, minlength=n_strips)
    cap = max(int(occ.max()), 1)
    slot = torch.arange(strip.shape[0], device=dev_) - (
        torch.cumsum(occ, 0) - occ)[strip]
    flat = strip * cap + slot

    def dense(t, fill):
        out = torch.full((n_strips * cap,), fill, dtype=t.dtype,
                         device=dev_)
        out[flat] = t
        return out.reshape(n_strips, cap)

    # empty slots: NaN ordinates never compare, so they never reverse
    yl_d, yr_d = dense(yl, math.nan), dense(yr, math.nan)
    th_d, v_d, u_d = dense(theta, 0.0), dense(v, -1), dense(u, -2)
    ideal_t = const(float(ideal), th_d)
    pi = const(math.pi, th_d)
    reversals = crossings = 0
    dev_sum = torch.zeros((), dtype=torch.float64, device=dev_)
    block = max(1, pair_budget // (cap * cap))
    for s0 in range(0, n_strips, block):
        sl = slice(s0, s0 + block)
        a = lambda t: t[sl, :, None]             # noqa: E731
        b = lambda t: t[sl, None, :]             # noqa: E731
        rev = (a(yl_d) < b(yl_d)) & (a(yr_d) > b(yr_d))
        reversals += int(rev.sum())
        rev &= ~((a(v_d) == b(v_d)) | (a(v_d) == b(u_d))
                 | (a(u_d) == b(v_d)) | (a(u_d) == b(u_d)))
        crossings += int(rev.sum())
        d = torch.abs(a(th_d) - b(th_d))
        a_c = torch.minimum(d, pi - d)
        dev = torch.abs(ideal_t - a_c) / ideal_t
        dev_sum += torch.where(rev, dev, 0.0).sum(dtype=torch.float64)
    pairs_ = int((occ * (occ - 1) // 2).sum())
    return dict(pairs=pairs_, reversals=reversals, crossings=crossings,
                dev_sum=float(dev_sum))
