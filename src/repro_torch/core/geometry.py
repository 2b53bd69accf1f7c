"""2-D geometric primitives (counterpart of :mod:`repro.core.geometry`).

Conventions follow the reference: positions ``(V, 2)`` float32, edges
``(E, 2)`` integer vertex ids, undirected segment angles in ``[0, pi)``
and directed angles in ``[0, 2*pi)``.  Every function is one elementwise
op per step, so CPU and CUDA round identically (no fused helpers).
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
