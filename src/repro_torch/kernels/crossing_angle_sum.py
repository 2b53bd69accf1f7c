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
* :func:`crossing_angle_stats_rows` -- the same count and sum over the
  pairs whose ``i`` lies in a row range ``[row0, row1)`` (``j > i``
  anywhere): one rank's share in the row-sharded driver
  (:func:`repro_torch.distributed.pairwise.sharded_crossing_angle_stats`).
  The same kernel on the range's tiles only (counted in
  ``crossing_angle_stats_rows.LAUNCHES``, its tiles in ``.TILES``).

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
                         row_block: int = 512, rows=None):
    """Count the crossing pairs ``i < j`` (both valid, no shared endpoint)
    and sum their deviations ``|ideal - a_c| / ideal`` by blocked
    all-pairs PyTorch, ``i`` in the row range ``rows = (row0, row1)``
    (default: every row).  Returns ``(int64 count, float64 deviation
    sum)`` scalar tensors; each deviation is float32, the sums are
    float64."""
    dev_ = x1.device
    ideal32, recip32 = _ideal_and_recip(ideal)
    ideal_t = torch.tensor(ideal32, device=dev_)
    recip_t = torch.tensor(recip32, device=dev_)
    count = torch.zeros((), dtype=torch.int64, device=dev_)
    dev_sum = torch.zeros((), dtype=torch.float64, device=dev_)
    for i0, i1 in row_blocks(x1.shape[0], row_block, rows):
        mask = crossing_mask(x1, y1, x2, y2, v, u, valid, i0, i1)
        a_c = line_crossing_angle(theta[i0:i1, None], theta[None, i0:])
        t = torch.abs(ideal_t - a_c)
        dev = t * recip_t
        count = count + mask.sum()
        dev_sum = dev_sum + torch.where(mask, dev, 0.0).sum(
            dtype=torch.float64)
    return count, dev_sum


def _launch(x1, y1, x2, y2, theta, v, u, valid, ideal, rows=None):
    """The kernel over every tile (``rows=None``: the whole-matrix entry),
    or over the tiles of the row range ``rows`` (the row entry).  Returns
    ``(count, deviation sum, tiles swept)``."""
    from repro_torch.kernels._build import entry

    n = x1.shape[0]
    dev = x1.device
    f32, i32 = torch.float32, torch.int32
    check_edge_arrays(n, TILE, [
        ("x1", x1, f32), ("y1", y1, f32), ("x2", x2, f32), ("y2", y2, f32),
        ("theta", theta, f32), ("v", v, i32), ("u", u, i32),
        ("valid", valid, torch.bool)])
    row0, row1 = (0, n) if rows is None else rows
    if not (0 <= row0 <= row1 <= n and row0 % TILE == 0
            and row1 % TILE == 0):
        raise ValueError(f"row range [{row0}, {row1}) must lie in [0, {n}) "
                         f"with both ends multiples of {TILE}")
    n_parts = row_tile_count(n // TILE, row0 // TILE, (row1 - row0) // TILE)
    if n_parts == 0:
        return (torch.zeros((), dtype=torch.int64, device=dev),
                torch.zeros((), dtype=torch.float64, device=dev), 0)
    cnt = torch.empty(n_parts, dtype=torch.int32, device=dev)
    dsum = torch.empty(n_parts, dtype=torch.float32, device=dev)
    ideal32, recip32 = _ideal_and_recip(ideal)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [t.data_ptr() for t in (x1, y1, x2, y2, theta, v, u, valid)]
        if rows is None:
            err = entry("crossing_angle_sum")(
                *ptrs, n, float(ideal32), float(recip32), cnt.data_ptr(),
                dsum.data_ptr(), stream)
        else:
            err = entry("crossing_angle_sum_rows")(
                *ptrs, n, row0, row1, float(ideal32), float(recip32),
                cnt.data_ptr(), dsum.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"crossing_angle_sum kernel launch failed: "
                           f"cudaError {err}")
    return cnt.sum(dtype=torch.int64), dsum.sum(dtype=torch.float64), n_parts


def _check_device(x1):
    if x1.device.type not in ("cpu", "cuda"):
        raise ValueError(f"crossing_angle_stats runs on cuda or cpu, "
                         f"got {x1.device}")


def crossing_angle_stats(x1, y1, x2, y2, theta, v, u, valid, *, ideal,
                         row_block: int = 512):
    """``(count, deviation sum)`` of the crossing pairs of ``(n,)`` edge
    arrays: endpoint coordinates and segment angles ``theta`` (float32),
    vertex ids ``v`` / ``u`` (int32), a bool validity mask.  CUDA inputs
    (contiguous, ``n`` a multiple of :data:`TILE`) launch the kernel; CPU
    inputs run :func:`crossing_angle_plain` in blocks of ``row_block``
    rows.  Returns ``(int64, float64)`` scalar tensors."""
    _check_device(x1)
    if x1.device.type == "cpu":
        return crossing_angle_plain(x1, y1, x2, y2, theta, v, u, valid,
                                    ideal=ideal, row_block=row_block)
    count, dev_sum, tiles = _launch(x1, y1, x2, y2, theta, v, u, valid,
                                    ideal)
    if tiles:
        crossing_angle_stats.LAUNCHES += 1
    return count, dev_sum


def crossing_angle_stats_rows(x1, y1, x2, y2, theta, v, u, valid, row0,
                              row1, *, ideal, row_block: int = 512):
    """The ``(count, deviation sum)`` of :func:`crossing_angle_stats` over
    the pairs ``i < j`` with ``i`` in ``[row0, row1)``; on CUDA both ends
    are multiples of :data:`TILE`.  Summed over a partition of the rows,
    the counts are the whole count and the sums the whole sum (up to the
    order of the float64 additions)."""
    _check_device(x1)
    rows = (int(row0), int(row1))
    if x1.device.type == "cpu":
        return crossing_angle_plain(x1, y1, x2, y2, theta, v, u, valid,
                                    ideal=ideal, row_block=row_block,
                                    rows=rows)
    count, dev_sum, tiles = _launch(x1, y1, x2, y2, theta, v, u, valid,
                                    ideal, rows)
    if tiles:
        crossing_angle_stats_rows.LAUNCHES += 1
        crossing_angle_stats_rows.TILES += tiles
    return count, dev_sum


crossing_angle_stats.LAUNCHES = 0
crossing_angle_stats_rows.LAUNCHES = 0
crossing_angle_stats_rows.TILES = 0
