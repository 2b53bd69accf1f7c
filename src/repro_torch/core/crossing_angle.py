"""Edge crossing angle ``E_ca`` (paper S3.1.5); counterpart of
:mod:`repro.core.crossing_angle`.

``E_ca = 1 - mean over crossing pairs of |ideal - a_c| / ideal``, where
``a_c`` is the acute angle between the two crossing edges and ``ideal``
defaults to 70 degrees (Huang et al. 2008).

* :data:`DEFAULT_IDEAL` -- the ideal angle as the float32 rounding the
  reference computes, so plans and digests agree bit for bit.
* :func:`crossing_angle_exact` -- the exact all-pairs E_ca, finished in
  float32 by :func:`finish_exact` from the sweep's count and deviation
  sum.
* :func:`crossing_angle_enhanced` -- the strip decomposition of
  :mod:`repro_torch.core.crossing`: the reversal sweep that counts the
  crossings sums their deviations on the same pair mask (the paper's 2-D
  segment tree collapses to one masked reduction per strip).  On 'both'
  it keeps the orientation that saw the most crossings, picked on the
  device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import grid as gridlib
from repro_torch.core.crossing import bucket_reversal_stats
from repro_torch.kernels import ops

DEFAULT_IDEAL = np.float32(np.deg2rad(np.float32(70.0)))


def crossing_angle_exact(pos, edges, *, ideal=DEFAULT_IDEAL, block: int = 512,
                         edge_valid=None):
    """Exact E_ca plus the crossing count it is normalized by.

    Returns ``(e_ca, count, dev_sum)`` scalar tensors (float32, int64,
    float32): ``e_ca = 1 - dev_sum / max(count, 1)`` in float32, 1.0 when
    there are no crossings.  Each deviation multiplies by the float32
    ``1 / ideal`` (the kernel's form; the reference divides, an ulp apart
    per deviation).  On CUDA tensors the crossing-angle kernel sweeps the
    pairs; on CPU tensors its plain version, in row blocks of ``block``.
    The deviation sum is taken in float64 and rounded to float32 once.
    """
    count, dev = ops.crossing_angle_op(pos, edges, ideal=ideal,
                                       valid=edge_valid, row_block=block)
    e_ca, dev_sum = finish_exact(count, dev)
    return e_ca, count, dev_sum


def finish_exact(count, dev):
    """E_ca in float32 from an exact sweep's ``(count, deviation sum)``
    (int64 / float64 scalar tensors): ``(e_ca, dev_sum)``, the sum
    rounded to float32 once and ``e_ca = 1 - dev_sum / max(count, 1)``,
    1.0 when there are no crossings."""
    dev_sum = dev.to(torch.float32)
    mean = dev_sum / torch.clamp_min(count, 1).to(torch.float32)
    return torch.where(count > 0, 1.0 - mean, 1.0), dev_sum


def crossing_angle_strips(pos, edges, n_strips: int, max_segments: int,
                          cap: int, *, ideal=DEFAULT_IDEAL, axis: int = 0,
                          edge_valid=None, strip_block: int = 256,
                          domain=None):
    """Enhanced E_ca for one orientation under given capacities:
    ``(e_ca, count, dev_sum, overflow)`` tensors, ``e_ca = 1 - dev_sum /
    max(count, 1)`` in float32 (1.0 without crossings)."""
    segs = gridlib.build_strip_segments(pos, edges, n_strips, max_segments,
                                        axis=axis, domain=domain,
                                        edge_valid=edge_valid)
    buckets = gridlib.bucketize_segments(segs, n_strips, cap)
    count, dev_sum = bucket_reversal_stats(buckets, strip_block=strip_block,
                                           ideal_angle=ideal)
    e_ca = torch.where(count > 0,
                       1.0 - dev_sum / torch.clamp_min(count, 1), 1.0)
    return e_ca, count, dev_sum, buckets.overflow


def crossing_angle_enhanced(pos, edges, *, n_strips: int = 64,
                            ideal=DEFAULT_IDEAL, orientation: str = "both",
                            edge_valid=None, strip_block: int = 256,
                            device=None):
    """Host-facing enhanced E_ca: ``(e_ca, count, dev_sum, overflow)`` of
    the orientation that saw the most crossings (the better-covered
    estimate), picked on the device; a tie keeps the earlier axis.  Runs
    on CUDA unless ``device`` says otherwise (tensors stay on their
    device), and raises when no CUDA device exists."""
    from repro_torch.core.engine import _AXES, device_inputs
    pos, edges = device_inputs(pos, edges, device)
    results = []
    for axis in _AXES[orientation]:
        max_segments, cap = gridlib.plan_strips(pos, edges, n_strips,
                                                axis=axis)
        results.append(crossing_angle_strips(
            pos, edges, n_strips, max_segments, cap, ideal=ideal, axis=axis,
            edge_valid=edge_valid, strip_block=min(strip_block, n_strips)))
    best = results[0]
    for cand in results[1:]:
        take = cand[1] > best[1]
        best = tuple(torch.where(take, c, b) for c, b in zip(cand, best))
    return best
