"""Engine-facing wrappers around the kernels (counterpart of
:mod:`repro.kernels.ops`): padding and layout plumbing, so callers pass
positions or strip buckets.  There is no interpret mode: a tensor's
device picks the route (CUDA -> kernel, CPU -> plain version).
"""

from __future__ import annotations

import torch

from repro_torch.core.geometry import edge_endpoints, segment_theta
from repro_torch.kernels.crossing_angle_sum import crossing_angle_stats
from repro_torch.kernels.occlusion_pairs import TILE, occlusion_pairs
from repro_torch.kernels.segment_crossing import TILE as EDGE_TILE
from repro_torch.kernels.segment_crossing import crossing_count
from repro_torch.kernels.strip_reversal import strip_reversal_rows


def _pad1(a, n, fill):
    pad = n - a.shape[0]
    if pad <= 0:
        return a.contiguous()
    return torch.cat([a, torch.full((pad,), fill, dtype=a.dtype,
                                    device=a.device)])


def occlusion_count_op(pos, radius, *, valid=None):
    """Exact N_c of a ``(V, 2)`` layout via the all-pairs occlusion kernel;
    padded vertices (to a multiple of the kernel's tile) are invalid."""
    pos = pos.to(torch.float32)
    n = pos.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=pos.device)
    n_pad = -(-n // TILE) * TILE
    return occlusion_pairs(_pad1(pos[:, 0], n_pad, 0.0),
                           _pad1(pos[:, 1], n_pad, 0.0),
                           _pad1(valid.to(torch.bool), n_pad, False),
                           radius)


def strip_reversal_op(buckets, *, ideal: float = 1.0, with_angle=False):
    """Flat-bucket reversal sweep, summed over every strip: ``buckets`` is
    a :class:`repro_torch.core.grid.SegmentBuckets`.  The kernel takes
    any ``cap``, so the buckets go in unpadded.  Returns ``(count,
    deviation_sum)`` scalars."""
    cnt, dev = strip_reversal_rows(
        buckets.yl.to(torch.float32).contiguous(),
        buckets.yr.to(torch.float32).contiguous(),
        buckets.theta.to(torch.float32).contiguous(),
        buckets.v.to(torch.int32).contiguous(),
        buckets.u.to(torch.int32).contiguous(),
        buckets.valid.contiguous(), ideal=float(ideal),
        with_angle=with_angle)
    return cnt.sum(), dev.sum()


def _edge_arrays(pos, edges, valid):
    """Endpoint coordinates, segment angles, vertex ids and validity of
    every edge, padded to a multiple of the crossing kernels' tile:
    coordinates and angles with 0, ``v`` with -1, ``u`` with -2 (so a
    padded pair never shares an endpoint), ``valid`` with False."""
    pos = pos.to(torch.float32)
    edges = edges.to(torch.int32)
    e = edges.shape[0]
    if valid is None:
        valid = torch.ones(e, dtype=torch.bool, device=pos.device)
    x1, y1, x2, y2 = edge_endpoints(pos, edges)
    theta = segment_theta(x1, y1, x2, y2)
    e_pad = -(-e // EDGE_TILE) * EDGE_TILE
    return (_pad1(x1, e_pad, 0.0), _pad1(y1, e_pad, 0.0),
            _pad1(x2, e_pad, 0.0), _pad1(y2, e_pad, 0.0),
            _pad1(theta, e_pad, 0.0),
            _pad1(edges[:, 0], e_pad, -1), _pad1(edges[:, 1], e_pad, -2),
            _pad1(valid.to(torch.bool), e_pad, False))


def crossing_count_op(pos, edges, *, valid=None, row_block: int = 512):
    """Exact E_c of a ``(V, 2)`` layout via the segment-crossing kernel
    (int64 scalar tensor).  ``row_block`` is the CPU route's row block."""
    x1, y1, x2, y2, _, v, u, ok = _edge_arrays(pos, edges, valid)
    return crossing_count(x1, y1, x2, y2, v, u, ok, row_block=row_block)


def crossing_angle_op(pos, edges, *, ideal, valid=None,
                      row_block: int = 512):
    """``(count, deviation sum)`` of the crossing pairs via the
    crossing-angle kernel (int64 / float64 scalar tensors)."""
    x1, y1, x2, y2, theta, v, u, ok = _edge_arrays(pos, edges, valid)
    return crossing_angle_stats(x1, y1, x2, y2, theta, v, u, ok,
                                ideal=ideal, row_block=row_block)
