"""All-pairs tests of the exact scores (paper S3.1), in row blocks.

* :func:`occlusion_count` -- vertex pairs closer than ``2r``.
* :func:`crossing_stats` -- edge pairs that cross by the paper's CCW
  straddle test (not strict; pairs sharing an endpoint excluded), and
  the sum of their crossing-angle deviations.
* :func:`segment_theta` -- undirected angle of a segment, in ``[0, pi)``.
"""

from __future__ import annotations

import math

import torch


def const(value, like):
    """``value`` as a 0-dim tensor of ``like``'s dtype and device."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def safe_sqrt(x):
    """``sqrt(x)``, whose gradient at 0 is 0 instead of infinite."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def safe_atan2(y, x):
    """``atan2(y, x)``, whose gradient at (0, 0) is 0 instead of NaN;
    the value there is ``atan2(0, 1) = 0``, as ``atan2(0, 0)``."""
    zero = (x == 0) & (y == 0)
    return torch.atan2(torch.where(zero, 0.0, y), torch.where(zero, 1.0, x))


def segment_theta(x1, y1, x2, y2):
    theta = safe_atan2(y2 - y1, x2 - x1)
    pi = const(math.pi, theta)
    return torch.remainder(torch.where(theta < 0, theta + pi, theta), pi)


def occlusion_count(x, y, radius, *, block: int = 4096):
    """Unordered vertex pairs with ``dx*dx + dy*dy < (2r)^2`` (int).

    The vertices are sorted by x, and each block of sorted rows is
    compared with the sorted columns after it up to ``x + 1.01 * 2r``:
    a pair beyond that has ``|dx| > 2r`` exactly, so its rounded
    ``d2`` is at least ``(2r)^2`` and it cannot count."""
    thresh = torch.tensor((2.0 * float(radius)) ** 2,
                          dtype=torch.float32).to(x.dtype).to(x.device)
    reach = 1.01 * 2.0 * float(radius)
    order = torch.argsort(x)
    xs, ys = x[order], y[order]
    xs64 = xs.double()
    n = xs.shape[0]
    total = 0
    for i0 in range(0, n, block):
        i1 = min(i0 + block, n)
        j1 = int(torch.searchsorted(xs64, xs64[i1 - 1] + reach,
                                    right=True))
        dx = xs[i0:i1, None] - xs[None, i0:j1]
        dy = ys[i0:i1, None] - ys[None, i0:j1]
        d2 = dx * dx + dy * dy
        upper = torch.triu(torch.ones(i1 - i0, j1 - i0, dtype=torch.bool,
                                      device=x.device), diagonal=1)
        total += int(((d2 < thresh) & upper).sum())
    return total


def crossing_stats(pos, edges, ideal, *, block: int = 1024):
    """Exact crossing statistics of one layout ``pos (V, 2)`` (its dtype
    is the working precision) and ``edges (E, 2)``.

    For every unordered edge pair: the four cross products
    ``(q - p) x (r - p)``, each a difference of two rounded products;
    the straddle test ``sign(d1) sign(d2) <= 0 and sign(d3) sign(d4) <=
    0``, decided by comparing the two products of each cross product
    (their rounded difference has the sign of the comparison); pairs
    sharing an endpoint excluded.  For each crossing pair, the deviation
    ``|ideal - a_c| / ideal`` of its acute angle ``a_c``.

    Returns ``dict(straddles, crossings, dev_sum)``: ints and a float64
    sum."""
    dev_ = pos.device
    v, u = edges[:, 0].long(), edges[:, 1].long()
    px, py = pos[v, 0], pos[v, 1]
    qx, qy = pos[u, 0], pos[u, 1]
    ddx, ddy = qx - px, qy - py                  # q - p of each edge
    theta = segment_theta(px, py, qx, qy)
    ideal_t = const(float(ideal), theta)
    pi = const(math.pi, theta)
    vi, ui = edges[:, 0].int(), edges[:, 1].int()
    n = edges.shape[0]
    straddles = crossings = 0
    dev_sum = torch.zeros((), dtype=torch.float64, device=dev_)
    for i0 in range(0, n, block):
        i1 = min(i0 + block, n)
        a = lambda t: t[i0:i1, None]             # noqa: E731  rows i
        b = lambda t: t[None, i0:]               # noqa: E731  columns j
        # p2 - p1, q2 - p1, q1 - p2 (p1 - p2 is -(p2 - p1) exactly)
        t1x, t1y = b(px) - a(px), b(py) - a(py)
        t2x, t2y = b(qx) - a(px), b(qy) - a(py)
        t3x, t3y = a(qx) - b(px), a(qy) - b(py)
        # d1 = D1 x (p2 - p1), d2 = D1 x (q2 - p1): compare P, Q of P - Q
        p_, q_ = a(ddx) * t1y, a(ddy) * t1x
        pos1, neg1 = p_ > q_, p_ < q_
        p_, q_ = a(ddx) * t2y, a(ddy) * t2x
        pos2, neg2 = p_ > q_, p_ < q_
        s12 = ~((pos1 & pos2) | (neg1 & neg2))
        del pos1, neg1, pos2, neg2, t2x, t2y
        # d3 = D2 x (p1 - p2) = -(D2 x (p2 - p1)); d4 = D2 x (q1 - p2)
        p_, q_ = b(ddx) * t1y, b(ddy) * t1x
        pos3, neg3 = p_ < q_, p_ > q_
        p_, q_ = b(ddx) * t3y, b(ddy) * t3x
        pos4, neg4 = p_ > q_, p_ < q_
        del p_, q_, t1x, t1y, t3x, t3y
        s = s12 & ~((pos3 & pos4) | (neg3 & neg4))
        del s12, pos3, neg3, pos4, neg4
        # the diagonal block holds j <= i: keep j > i
        s[:, :i1 - i0] &= torch.triu(torch.ones(
            i1 - i0, i1 - i0, dtype=torch.bool, device=dev_), diagonal=1)
        straddles += int(s.sum())
        s &= ~((a(vi) == b(vi)) | (a(vi) == b(ui)) | (a(ui) == b(vi))
               | (a(ui) == b(ui)))
        crossings += int(s.sum())
        d = torch.abs(a(theta) - b(theta))
        a_c = torch.minimum(d, pi - d)
        dev = torch.abs(ideal_t - a_c) / ideal_t
        dev_sum += torch.where(s, dev, 0.0).sum(dtype=torch.float64)
        del s, d, a_c, dev
    return dict(straddles=straddles, crossings=crossings,
                dev_sum=float(dev_sum))
