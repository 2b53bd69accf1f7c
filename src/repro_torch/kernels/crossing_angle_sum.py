"""Tiled all-pairs crossing count and crossing-angle deviation sum: exact
``E_ca`` (paper S3.1.5).

Replaces the Pallas TPU kernel ``repro/kernels/crossing_angle_sum.py``
(``_angle_kernel`` / ``crossing_angle_stats``): over the crossing pairs
of :mod:`repro_torch.kernels.segment_crossing`, the count and the sum of
``|ideal - a_c| / ideal``, with ``a_c`` the acute angle between the two
segments, as one partial pair per ``(TILE, TILE)`` tile on or above the
diagonal, summed afterwards in int64 / float64.  Deviations multiply by
the float32 rounding of ``1 / ideal``, as the Pallas kernel does; the
reference's exact jnp sweep divides by ``ideal`` instead, which differs
by at most an ulp per deviation.

* :func:`crossing_angle_plain` -- the plain PyTorch version, blocked
  all-pairs, one rounding per op.
* :func:`crossing_angle_stats` -- the wrapper.  CUDA inputs launch the
  hand-written kernel ``csrc/crossing_angle_sum.cu`` (counted in
  ``crossing_angle_stats.LAUNCHES``); CPU inputs run the plain version;
  any other device raises.

What bounds the kernel on an H100, and its design: as for the crossing
count (``csrc/segment_pairs.cuh``), plus the deviation, formed on every
pair (a warp meets a crossing on nearly every j, so a branch around it
would be taken anyway) and added under the crossing predicate: three
adds, with ``a_c = pi/2 - |pi/2 - d|``, and a predicated add per pair.
Theta is staged beside the j tile; each thread sums ``|ideal - a_c|``
and multiplies by ``1 / ideal`` once before the block reduction.  Both
forms move the sum by ulps against the plain version's, far inside the
rtol 1e-5 parity bar.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.geometry import line_crossing_angle
from repro_torch.kernels.occlusion_pairs import row_tile_count
from repro_torch.kernels.segment_crossing import (TILE, check_edge_arrays,
                                                  crossing_mask, row_blocks)


def _ideal_and_recip(ideal):
    """``ideal`` rounded to float32, and the float32 rounding of the
    double ``1 / ideal`` (the Pallas kernel's ``(1.0 / ideal)``)."""
    return np.float32(ideal), np.float32(1.0 / float(ideal))


def crossing_angle_plain(x1, y1, x2, y2, theta, v, u, valid, *, ideal,
                         row_block: int = 512):
    """Count the crossing pairs ``i < j`` (both valid, no shared endpoint)
    and sum their deviations ``|ideal - a_c| / ideal`` by blocked
    all-pairs PyTorch.  Returns ``(int64 count, float64 deviation sum)``
    scalar tensors; each deviation is float32, the sums are float64."""
    dev_ = x1.device
    ideal32, recip32 = _ideal_and_recip(ideal)
    ideal_t = torch.tensor(ideal32, device=dev_)
    recip_t = torch.tensor(recip32, device=dev_)
    count = torch.zeros((), dtype=torch.int64, device=dev_)
    dev_sum = torch.zeros((), dtype=torch.float64, device=dev_)
    for i0, i1 in row_blocks(x1.shape[0], row_block):
        mask = crossing_mask(x1, y1, x2, y2, v, u, valid, i0, i1)
        a_c = line_crossing_angle(theta[i0:i1, None], theta[None, i0:])
        t = torch.abs(ideal_t - a_c)
        dev = t * recip_t
        count = count + mask.sum()
        dev_sum = dev_sum + torch.where(mask, dev, 0.0).sum(
            dtype=torch.float64)
    return count, dev_sum


def _launch(x1, y1, x2, y2, theta, v, u, valid, ideal):
    from repro_torch.kernels._build import entry

    n = x1.shape[0]
    dev = x1.device
    f32, i32 = torch.float32, torch.int32
    check_edge_arrays(n, TILE, [
        ("x1", x1, f32), ("y1", y1, f32), ("x2", x2, f32), ("y2", y2, f32),
        ("theta", theta, f32), ("v", v, i32), ("u", u, i32),
        ("valid", valid, torch.bool)])
    n_tiles = n // TILE
    if n_tiles == 0:
        return (torch.zeros((), dtype=torch.int64, device=dev),
                torch.zeros((), dtype=torch.float64, device=dev))
    n_parts = row_tile_count(n_tiles, 0, n_tiles)
    cnt = torch.empty(n_parts, dtype=torch.int32, device=dev)
    dsum = torch.empty(n_parts, dtype=torch.float32, device=dev)
    ideal32, recip32 = _ideal_and_recip(ideal)
    fn = entry("crossing_angle_sum")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x1.data_ptr(), y1.data_ptr(), x2.data_ptr(), y2.data_ptr(),
                 theta.data_ptr(), v.data_ptr(), u.data_ptr(),
                 valid.data_ptr(), n, float(ideal32), float(recip32),
                 cnt.data_ptr(), dsum.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"crossing_angle_sum kernel launch failed: "
                           f"cudaError {err}")
    crossing_angle_stats.LAUNCHES += 1
    return cnt.sum(dtype=torch.int64), dsum.sum(dtype=torch.float64)


def crossing_angle_stats(x1, y1, x2, y2, theta, v, u, valid, *, ideal,
                         row_block: int = 512):
    """``(count, deviation sum)`` of the crossing pairs of ``(n,)`` edge
    arrays: endpoint coordinates and segment angles ``theta`` (float32),
    vertex ids ``v`` / ``u`` (int32), a bool validity mask.  CUDA inputs
    (contiguous, ``n`` a multiple of :data:`TILE`) launch the kernel; CPU
    inputs run :func:`crossing_angle_plain` in blocks of ``row_block``
    rows.  Returns ``(int64, float64)`` scalar tensors."""
    if x1.device.type == "cpu":
        return crossing_angle_plain(x1, y1, x2, y2, theta, v, u, valid,
                                    ideal=ideal, row_block=row_block)
    if x1.device.type != "cuda":
        raise ValueError(f"crossing_angle_stats runs on cuda or cpu, "
                         f"got {x1.device}")
    return _launch(x1, y1, x2, y2, theta, v, u, valid, ideal)


crossing_angle_stats.LAUNCHES = 0
