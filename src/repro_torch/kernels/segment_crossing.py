"""Tiled all-pairs edge-crossing count: exact ``E_c`` (paper S3.1.4).

Replaces the Pallas TPU kernel ``repro/kernels/segment_crossing.py``
(``_crossing_kernel`` / ``_cross_tile`` / ``crossing_count``): count the
edge pairs with global ``i < j``, both valid, no shared endpoint, and the
CCW straddle test, as one partial per ``(TILE, TILE)`` tile on or above
the diagonal of the pair matrix, summed afterwards.

* :func:`crossing_count_plain` -- the plain PyTorch version, blocked
  all-pairs, one rounding per op.
* :func:`crossing_count` -- the wrapper.  CUDA inputs launch the
  hand-written kernel ``csrc/segment_crossing.cu`` (counted in
  ``crossing_count.LAUNCHES``); CPU inputs run the plain version; any
  other device raises.
* :func:`crossing_count_rows` -- the same count restricted to the pairs
  whose ``i`` lies in a row range ``[row0, row1)`` (``j > i`` anywhere):
  one rank's share in the row-sharded driver
  (:func:`repro_torch.distributed.pairwise.sharded_crossing_count`).  The
  same kernel on the range's tiles only (counted in
  ``crossing_count_rows.LAUNCHES``, its tiles in ``.TILES``).

What bounds the kernel on an H100: per-pair ALU work on the CUDA cores
(about 31 issued instructions: the cross products rounded op by op, the
straddle tests, the shared-endpoint compares, the count); the input is
25 bytes per edge.  Its design (``csrc/segment_pairs.cuh``, shared with
the crossing-angle kernel): a 1-D grid of the tiles on or above the
diagonal, tiles without a valid edge returning at once, the j tile in
shared memory, several i segments per thread in registers, the order
test on the diagonal tiles only, products and differences through
``__fmul_rn`` / ``__fsub_rn`` so no FMA flips a collinear pair,
fixed-order reductions, no atomics.
"""

from __future__ import annotations

import torch

from repro_torch.core.geometry import segments_cross_bool, share_endpoint
from repro_torch.kernels.occlusion_pairs import row_tile_count
from repro_torch.kernels.strip_reversal import _check

TILE = 256
# elements of the (rows, n) pair tiles one plain block may hold
_PAIR_BUDGET = 1 << 25


def row_blocks(n, row_block, rows=None):
    """``(i0, i1)`` row ranges of a blocked upper-triangle sweep over
    ``n`` edges, covering the row range ``rows = (row0, row1)`` (default:
    every row), each at most ``row_block`` rows and within the pair
    budget."""
    row0, row1 = (0, n) if rows is None else rows
    block = max(1, min(row_block, _PAIR_BUDGET // max(n, 1)))
    return [(i0, min(i0 + block, row1)) for i0 in range(row0, row1, block)]


def crossing_mask(x1, y1, x2, y2, v, u, valid, i0, i1):
    """``(i1 - i0, n - i0)`` bool: row ``i`` in ``[i0, i1)`` against column
    ``j`` in ``[i0, n)`` crosses, with ``i < j``, both valid and no shared
    endpoint."""
    a = lambda t: t[i0:i1, None]
    b = lambda t: t[None, i0:]
    cross = segments_cross_bool(a(x1), a(y1), a(x2), a(y2),
                                b(x1), b(y1), b(x2), b(y2))
    shared = share_endpoint(a(v), a(u), b(v), b(u))
    idx = torch.arange(i0, x1.shape[0], device=x1.device)
    upper = idx[:i1 - i0, None] < idx[None, :]
    return cross & ~shared & upper & a(valid) & b(valid)


def crossing_count_plain(x1, y1, x2, y2, v, u, valid, *,
                         row_block: int = 512, rows=None):
    """Count crossing pairs ``i < j`` (both valid, no shared endpoint) by
    blocked all-pairs PyTorch over the upper triangle, ``i`` in the row
    range ``rows = (row0, row1)`` (default: every row).  Returns an int64
    scalar tensor."""
    total = torch.zeros((), dtype=torch.int64, device=x1.device)
    for i0, i1 in row_blocks(x1.shape[0], row_block, rows):
        total = total + crossing_mask(x1, y1, x2, y2, v, u, valid,
                                      i0, i1).sum()
    return total


def check_edge_arrays(n, tile, named):
    """Raise unless every ``(name, tensor, dtype)`` is ``(n,)``, of its
    dtype, contiguous and on one device, and ``n`` is a multiple of the
    kernel's tile."""
    dev = named[0][1].device
    for name, t, dtype in named:
        _check(name, t, dtype, (n,), dev)
    if n % tile:
        raise ValueError(f"n={n} must be a multiple of {tile} "
                         "(the ops wrappers pad)")
    if n // tile > 65535:
        raise ValueError(f"n={n} exceeds the kernel's tile grid")


def _launch(x1, y1, x2, y2, v, u, valid, row0, row1):
    from repro_torch.kernels._build import entry

    n = x1.shape[0]
    dev = x1.device
    f32, i32 = torch.float32, torch.int32
    check_edge_arrays(n, TILE, [
        ("x1", x1, f32), ("y1", y1, f32), ("x2", x2, f32), ("y2", y2, f32),
        ("v", v, i32), ("u", u, i32), ("valid", valid, torch.bool)])
    if not (0 <= row0 <= row1 <= n and row0 % TILE == 0
            and row1 % TILE == 0):
        raise ValueError(f"row range [{row0}, {row1}) must lie in [0, {n}) "
                         f"with both ends multiples of {TILE}")
    if row0 == row1:
        return torch.zeros((), dtype=torch.int64, device=dev)
    partial = torch.empty(row_tile_count(n // TILE, row0 // TILE,
                                         (row1 - row0) // TILE),
                          dtype=torch.int32, device=dev)
    fn = entry("segment_crossing")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x1.data_ptr(), y1.data_ptr(), x2.data_ptr(), y2.data_ptr(),
                 v.data_ptr(), u.data_ptr(), valid.data_ptr(), n, row0, row1,
                 partial.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"segment_crossing kernel launch failed: "
                           f"cudaError {err}")
    return partial.sum(dtype=torch.int64)


def _route(args, row_block, rows, counter):
    x1 = args[0]
    if x1.device.type == "cpu":
        return crossing_count_plain(*args, row_block=row_block, rows=rows)
    if x1.device.type != "cuda":
        raise ValueError(f"crossing_count runs on cuda or cpu, "
                         f"got {x1.device}")
    out = _launch(*args, *rows)
    if rows[0] < rows[1]:
        counter.LAUNCHES += 1
    return out


def crossing_count(x1, y1, x2, y2, v, u, valid, *, row_block: int = 512):
    """Exact crossing count of ``(n,)`` edge arrays: endpoint coordinates
    (float32), vertex ids ``v`` / ``u`` (int32) and a bool validity mask.
    CUDA inputs (contiguous, ``n`` a multiple of :data:`TILE`) launch the
    kernel; CPU inputs run :func:`crossing_count_plain` in blocks of
    ``row_block`` rows.  Returns an int64 scalar tensor."""
    return _route((x1, y1, x2, y2, v, u, valid), row_block,
                  (0, x1.shape[0]), crossing_count)


def crossing_count_rows(x1, y1, x2, y2, v, u, valid, row0, row1, *,
                        row_block: int = 512):
    """The crossing pairs ``i < j`` of :func:`crossing_count` with ``i`` in
    ``[row0, row1)``; on CUDA both ends are multiples of :data:`TILE`.
    Summed over a partition of the rows, this is the whole count."""
    rows = (int(row0), int(row1))
    out = _route((x1, y1, x2, y2, v, u, valid), row_block, rows,
                 crossing_count_rows)
    if x1.device.type == "cuda":
        crossing_count_rows.TILES += row_tile_count(
            x1.shape[0] // TILE, rows[0] // TILE, (rows[1] - rows[0]) // TILE)
    return out


crossing_count.LAUNCHES = 0
crossing_count_rows.LAUNCHES = 0
crossing_count_rows.TILES = 0
