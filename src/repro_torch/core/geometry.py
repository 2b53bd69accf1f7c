"""2-D geometric primitives (counterpart of :mod:`repro.core.geometry`).

Conventions follow the reference: positions ``(V, 2)`` float32, edges
``(E, 2)`` integer vertex ids, undirected segment angles in ``[0, pi)``
and directed angles in ``[0, 2*pi)``.  Every function is one elementwise
op per step, so CPU and CUDA round identically (no fused helpers such as
``torch.addcmul``, which would round a product and a sum once).

Degenerate configurations follow the paper's convention: collinear
touching is not special-cased (the straddle test is non-strict), and edge
pairs sharing an endpoint are excluded from crossing counts by the
callers (:func:`share_endpoint`).
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def segment_theta(x1, y1, x2, y2):
    """Undirected angle of segment with the x-axis, folded into [0, pi)."""
    theta = torch.atan2(y2 - y1, x2 - x1)
    return torch.remainder(torch.where(theta < 0, theta + math.pi, theta),
                           math.pi)


def directed_angle(x1, y1, x2, y2):
    """Directed angle of the ray (x1,y1) -> (x2,y2) in [0, 2*pi)."""
    a = torch.atan2(y2 - y1, x2 - x1)
    return torch.where(a < 0, a + TWO_PI, a)


def edge_lengths(pos, edges):
    """Euclidean length of every edge. pos (V,2), edges (E,2) -> (E,)."""
    d = pos[edges[:, 0].long()] - pos[edges[:, 1].long()]
    return torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])


def edge_endpoints(pos, edges):
    """Gather endpoint coordinates: returns (x1, y1, x2, y2), each (E,)."""
    p = pos[edges[:, 0].long()]
    q = pos[edges[:, 1].long()]
    return p[:, 0], p[:, 1], q[:, 0], q[:, 1]


def ccw(ax, ay, bx, by, cx, cy):
    """Orientation of the triple (A, B, C): the sign of the cross product
    ``(B - A) x (C - A)``, +1 counter-clockwise, -1 clockwise, 0
    collinear, NaN where the product is NaN.  Broadcasts."""
    cross = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    # torch.sign maps NaN to 0 (collinear); the reference keeps NaN, so
    # a NaN coordinate never crosses
    return torch.where(torch.isnan(cross), cross, torch.sign(cross))


def segments_cross(p1x, p1y, q1x, q1y, p2x, p2y, q2x, q2y):
    """The paper's CCW test (Algorithm 4) between segments (p1, q1) and
    (p2, q2): ``CCW(p1,q1,p2) * CCW(p1,q1,q2) <= 0`` and
    ``CCW(p2,q2,p1) * CCW(p2,q2,q1) <= 0``.  Collinear overlaps are not
    special-cased.  Broadcasts; returns bool."""
    d1 = ccw(p1x, p1y, q1x, q1y, p2x, p2y)
    d2 = ccw(p1x, p1y, q1x, q1y, q2x, q2y)
    d3 = ccw(p2x, p2y, q2x, q2y, p1x, p1y)
    d4 = ccw(p2x, p2y, q2x, q2y, q1x, q1y)
    return (d1 * d2 <= 0) & (d3 * d4 <= 0)


def _cross(px, py, qx, qy, rx, ry):
    return (qx - px) * (ry - py) - (qy - py) * (rx - px)


def segments_cross_bool(p1x, p1y, q1x, q1y, p2x, p2y, q2x, q2y):
    """Same predicate as :func:`segments_cross` with no sign products:
    ``sign(a) * sign(b) <= 0`` is ``(a <= 0 & b >= 0) | (a >= 0 & b <= 0)``
    (for a NaN both forms are False)."""
    d1 = _cross(p1x, p1y, q1x, q1y, p2x, p2y)
    d2 = _cross(p1x, p1y, q1x, q1y, q2x, q2y)
    d3 = _cross(p2x, p2y, q2x, q2y, p1x, p1y)
    d4 = _cross(p2x, p2y, q2x, q2y, q1x, q1y)
    s12 = ((d1 <= 0) & (d2 >= 0)) | ((d1 >= 0) & (d2 <= 0))
    s34 = ((d3 <= 0) & (d4 >= 0)) | ((d3 >= 0) & (d4 <= 0))
    return s12 & s34


def line_crossing_angle(theta_a, theta_b):
    """Acute crossing angle between two undirected lines, in [0, pi/2]."""
    d = torch.abs(theta_a - theta_b)
    return torch.minimum(d, math.pi - d)


def crossing_angle_deviation(theta_a, theta_b, ideal):
    """``|ideal - a_c| / ideal`` where a_c is the acute crossing angle.
    ``ideal`` becomes a tensor first: CUDA divides by a Python scalar as
    a multiply by its reciprocal, which rounds differently."""
    a_c = line_crossing_angle(theta_a, theta_b)
    ideal = torch.as_tensor(ideal, dtype=a_c.dtype, device=a_c.device)
    return torch.abs(ideal - a_c) / ideal


def pair_dist_sq(ax, ay, bx, by):
    """Squared distances between two point sets: (I,),(I,) x (J,),(J,) ->
    (I, J)."""
    dx = ax[:, None] - bx[None, :]
    dy = ay[:, None] - by[None, :]
    return dx * dx + dy * dy


def share_endpoint(v1, u1, v2, u2):
    """True where edge pairs (v1, u1) x (v2, u2) share at least one
    vertex.  Broadcasts (``v1[:, None]`` against ``v2[None, :]``) or
    works elementwise on equal shapes."""
    return (v1 == v2) | (v1 == u2) | (u1 == v2) | (u1 == u2)
