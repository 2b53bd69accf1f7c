"""Engine-facing wrappers around the kernels (counterpart of
:mod:`repro.kernels.ops`): padding and layout plumbing, so callers pass
positions or strip buckets.  There is no interpret mode: a tensor's
device picks the route (CUDA -> kernel, CPU -> plain version).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.occlusion_pairs import TILE, occlusion_pairs
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
