"""Edge crossing ``E_c`` (paper S3.1.4 exact, S3.2.2 enhanced);
counterpart of :mod:`repro.core.crossing`.

* :func:`count_crossings_exact` -- every pair of edges ``i < j`` through
  the paper's CCW straddle test; pairs sharing an endpoint are excluded
  (a shared endpoint is a touch, not a crossing), and collinear overlaps
  count as crossings (the test is not strict).
* :func:`count_crossings_enhanced` -- the strip decomposition.  Within a
  strip every comparable segment spans the full strip, and two segments
  cross iff their boundary-ordinate order *reverses* between the strip's
  left and right lines: ``(yl_i < yl_j) & (yr_i > yr_j)`` over ordered
  pairs tallies each unordered crossing once.  ``orientation='both'``
  evaluates vertical and horizontal strips and takes the max.  The sweep
  over flat ``(n_strips, cap)`` buckets is the strip-reversal kernel on a
  CUDA device (:func:`bucket_reversal_stats`), its plain formula on the
  CPU.  These standalone wrappers plan per call; the engine
  (:mod:`repro_torch.core.engine`) is the plan-once path.
"""

from __future__ import annotations

import torch

from repro_torch.core import grid as gridlib
from repro_torch.kernels import ops


def count_crossings_exact(pos, edges, *, block: int = 512, edge_valid=None):
    """Exact E_c: edge pairs (i < j), both valid, no shared endpoint, CCW
    straddle.  On CUDA tensors the segment-crossing kernel sweeps the
    pairs; on CPU tensors its plain version, in row blocks of ``block``
    (the count does not depend on it).  Returns an int64 scalar tensor."""
    return ops.crossing_count_op(pos, edges, valid=edge_valid,
                                 row_block=block)


def bucket_reversal_stats(buckets: gridlib.SegmentBuckets, *,
                          strip_block: int = 256, ideal_angle=None):
    """Count order reversals (crossings) across all strip buckets.

    Returns ``(count,)``, or ``(count, deviation_sum)`` when
    ``ideal_angle`` is given (the crossing-angle variant, fused on the
    same pair mask).  A thin shim over the engine's sweep
    (:func:`repro_torch.core.engine.fused_reversal_stats`): one formula
    for every reversal consumer.  ``strip_block`` is the reference's
    blocking of its dense sweep; the kernel needs none, and the counts do
    not depend on it."""
    from repro_torch.core import engine
    want_angle = ideal_angle is not None
    count, dev_sum = engine.fused_reversal_stats(
        buckets, ideal=ideal_angle if want_angle else 1.0,
        with_angle=want_angle)
    if want_angle:
        return count, dev_sum
    return (count,)


def count_crossings_strips(pos, edges, n_strips: int, max_segments: int,
                           cap: int, *, axis: int = 0, edge_valid=None,
                           strip_block: int = 256, domain=None):
    """Enhanced E_c for one strip orientation under given capacities:
    ``(count, overflow)`` tensors."""
    segs = gridlib.build_strip_segments(pos, edges, n_strips, max_segments,
                                        axis=axis, domain=domain,
                                        edge_valid=edge_valid)
    buckets = gridlib.bucketize_segments(segs, n_strips, cap)
    (count,) = bucket_reversal_stats(buckets, strip_block=strip_block)
    return count, buckets.overflow


def count_crossings_enhanced(pos, edges, *, n_strips: int = 64,
                             orientation: str = "both", edge_valid=None,
                             strip_block: int = 256, device=None):
    """Host-facing enhanced E_c: plans the capacities from the data, runs
    one or both orientations, returns ``(count, overflow)`` (the max over
    orientations).  Runs on CUDA unless ``device`` says otherwise (tensors
    stay on their device), and raises when no CUDA device exists."""
    from repro_torch.core.engine import _AXES, device_inputs
    pos, edges = device_inputs(pos, edges, device)
    counts, overflows = [], []
    for axis in _AXES[orientation]:
        max_segments, cap = gridlib.plan_strips(pos, edges, n_strips,
                                                axis=axis)
        c, ov = count_crossings_strips(
            pos, edges, n_strips, max_segments, cap, axis=axis,
            edge_valid=edge_valid, strip_block=min(strip_block, n_strips))
        counts.append(c)
        overflows.append(ov)
    return torch.stack(counts).max(), torch.stack(overflows).max()
