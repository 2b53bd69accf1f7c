"""The five readability scores of a layout, plainly (paper S3.1, S3.2).

* :func:`minimum_angle` -- ``M_a = 1 - mean_v (phi(v) - phi_min(v)) /
  phi(v)`` over vertices with edges, ``phi(v) = 2 pi / deg(v)``.
* :func:`edge_length_variation` -- ``M_l = sqrt(sum (l - mean)^2 / (E
  mean^2)) / sqrt(E - 1)``.
* :func:`exact_scores` -- the exact scores (all pairs).
* :func:`enhanced_scores` -- the scores of the enhanced algorithms: the
  grid count of occlusions (exact, as the grid is) and the strip counts
  of crossings, ``orientation="both"`` taking the larger count.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bench.reference import pairs, strips
from bench.reference.pairs import safe_atan2, safe_sqrt

# the ideal crossing angle, 70 degrees, as float32 rounds it
IDEAL_70 = float(np.float32(np.deg2rad(np.float32(70.0))))


def _float_dtype(dtype):
    """Per-layout scores run in float64 for the float32 reference and in
    the working dtype for a control below float32."""
    return torch.float64 if dtype == torch.float32 else dtype


def minimum_angle_t(pos, edges):
    """``M_a`` of ``pos (V, 2)`` in its dtype, as a (differentiable)
    0-d tensor."""
    V = pos.shape[0]
    src = torch.cat([edges[:, 0], edges[:, 1]]).long()
    dst = torch.cat([edges[:, 1], edges[:, 0]]).long()
    ang = safe_atan2(pos[dst, 1] - pos[src, 1], pos[dst, 0] - pos[src, 0])
    ang = torch.where(ang < 0, ang + 2 * math.pi, ang)
    with torch.no_grad():
        order = torch.sort(ang, stable=True).indices
        order = order[torch.sort(src[order], stable=True).indices]
    s, a = src[order], ang[order]
    deg = torch.bincount(s, minlength=V)
    inf = torch.full((V,), math.inf, dtype=pos.dtype, device=pos.device)
    amin = inf.scatter_reduce(0, s, a, "amin")
    amax = (-inf).scatter_reduce(0, s, a, "amax")
    same = s[1:] == s[:-1]
    gaps = torch.where(same, a[1:] - a[:-1], math.inf)
    gap_min = inf.scatter_reduce(0, s[1:], gaps, "amin")
    phi_min = torch.minimum(gap_min, 2 * math.pi - (amax - amin))
    has = deg >= 1
    ideal = 2 * math.pi / deg[has].to(pos.dtype)
    d = (ideal - phi_min[has]) / ideal
    return 1.0 - d.sum() / has.sum()


def edge_length_variation_t(pos, edges):
    """``M_l`` of ``pos (V, 2)`` in its dtype, as a (differentiable)
    0-d tensor."""
    d = pos[edges[:, 0].long()] - pos[edges[:, 1].long()]
    length = safe_sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    n = length.shape[0]
    mu = length.mean()
    l_a = safe_sqrt(((length - mu) ** 2).sum() / (n * mu * mu))
    return l_a / math.sqrt(n - 1)


def minimum_angle(pos, edges, dtype=torch.float32):
    return float(minimum_angle_t(pos.to(dtype).to(_float_dtype(dtype)),
                                 edges))


def edge_length_variation(pos, edges, dtype=torch.float32):
    return float(edge_length_variation_t(
        pos.to(dtype).to(_float_dtype(dtype)), edges))


def exact_scores(pos, edges, *, radius, ideal=IDEAL_70,
                 dtype=torch.float32):
    """Exact scores of one layout ``pos (V, 2)`` (a tensor on the device
    the reference runs on).  Returns the scores and the pair classes the
    roofline counts."""
    p = pos.to(dtype)
    nc = pairs.occlusion_count(p[:, 0], p[:, 1], radius)
    cs = pairs.crossing_stats(p, edges, ideal)
    n = cs["crossings"]
    return dict(
        node_occlusion=nc,
        minimum_angle=minimum_angle(pos, edges, dtype),
        edge_length_variation=edge_length_variation(pos, edges, dtype),
        edge_crossing=n,
        edge_crossing_angle=1.0 - cs["dev_sum"] / n if n else 1.0,
        crossing_count_for_angle=n,
        work=dict(straddles=cs["straddles"], crossings=n, occlusions=nc))


def enhanced_scores(pos, edges, *, radius, n_strips, ideal=IDEAL_70,
                    dtype=torch.float32):
    """Enhanced scores of one layout ``pos (V, 2)``, both strip
    orientations.  Returns the scores and the pair classes the roofline
    counts."""
    p = pos.to(dtype)
    nc = pairs.occlusion_count(p[:, 0], p[:, 1], radius)
    per_axis = [strips.strip_stats(p, edges, n_strips, axis, ideal)
                for axis in (0, 1)]
    # the orientation that saw more crossings; a tie keeps axis 0
    best = per_axis[1] if per_axis[1]["crossings"] > \
        per_axis[0]["crossings"] else per_axis[0]
    n = best["crossings"]
    return dict(
        node_occlusion=nc,
        minimum_angle=minimum_angle(pos, edges, dtype),
        edge_length_variation=edge_length_variation(pos, edges, dtype),
        edge_crossing=n,
        edge_crossing_angle=1.0 - best["dev_sum"] / n if n else 1.0,
        crossing_count_for_angle=n,
        work=dict(occlusions=nc,
                  strip_pairs=sum(s["pairs"] for s in per_axis),
                  reversals=sum(s["reversals"] for s in per_axis),
                  crossings=sum(s["crossings"] for s in per_axis)))
