"""Tiled all-pairs node-occlusion count: exact ``N_c`` (paper S3.1.1).

Replaces the Pallas TPU kernel ``repro/kernels/occlusion_pairs.py``
(``_occlusion_kernel`` / ``occlusion_count``): count the vertex pairs
with global ``i < j``, both valid, and ``dx*dx + dy*dy < (2r)^2``, as one
partial per ``(TILE, TILE)`` tile of the pair matrix, summed afterwards.

* :func:`occlusion_pairs_plain` -- the plain PyTorch version, blocked
  all-pairs.
* :func:`occlusion_pairs` -- the wrapper.  CUDA inputs launch the
  hand-written kernel ``csrc/occlusion_pairs.cu`` (counted in
  ``occlusion_pairs.LAUNCHES``); CPU inputs run the plain version; any
  other device raises.
* :func:`occlusion_pairs_rows` -- the same count restricted to the pairs
  whose ``i`` lies in a row range ``[row0, row1)`` (``j > i`` anywhere):
  one rank's share in the row-sharded driver
  (:func:`repro_torch.distributed.pairwise.sharded_occlusion_count`).
  The same kernel, launched on the range's tiles only (counted in
  ``occlusion_pairs_rows.LAUNCHES``, its tiles in ``.TILES``).

What bounds the kernel on an H100: per-pair ALU instructions on the CUDA
cores (two subtracts, two multiplies, one add, the compare, the
predicated count); the input is 9 bytes per vertex.  Its design
(``csrc/occlusion_pairs.cu``): a 1-D grid of the tiles on or above the
diagonal only, a tile with no valid vertex on either side returns 0 at
once, invalid vertices loaded as NaN so that no pair needs a mask, the
``i < j`` order tested on diagonal tiles only, the j tile as ``float2``
in shared memory against eight i's per thread in registers, and ``d2``
rounded product by product with ``__fmul_rn``/``__fadd_rn`` so that no
FMA flips a pair sitting exactly at the threshold.
"""

from __future__ import annotations

import torch

TILE = 512
# elements of the (rows, n) pair tiles one plain block may hold
_PAIR_BUDGET = 1 << 26


def _threshold(radius, like):
    # (2r)^2 in double, rounded once to float32 (as the reference does)
    return torch.tensor((2.0 * float(radius)) ** 2, dtype=torch.float32,
                        device=like.device)


def occlusion_pairs_plain(x, y, valid, radius, rows=None):
    """Count pairs ``i < j`` with both valid and ``d2 < (2r)^2`` by blocked
    all-pairs PyTorch, ``i`` in the row range ``rows = (row0, row1)``
    (default: every row).  bfloat16 coordinates are widened to float32
    first, as the reference's wrapper widens them.  Returns an int64
    scalar tensor."""
    x, y = x.float(), y.float()
    n = x.shape[0]
    row0, row1 = (0, n) if rows is None else rows
    thresh = _threshold(radius, x)
    idx = torch.arange(n, device=x.device)
    block = max(1, min(n, _PAIR_BUDGET // max(n, 1)))
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    for i0 in range(row0, row1, block):
        sl = slice(i0, min(i0 + block, row1))
        dx = x[sl, None] - x[None, :]
        dy = y[sl, None] - y[None, :]
        d2 = dx * dx + dy * dy
        mask = ((idx[sl, None] < idx[None, :]) & valid[sl, None]
                & valid[None, :])
        total = total + (mask & (d2 < thresh)).sum()
    return total


def _launch(x, y, valid, radius, row0, row1):
    from repro_torch.kernels._build import entry

    n = x.shape[0]
    dev = x.device
    fdt = x.dtype
    if fdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x: want float32 or bfloat16, got {fdt}")
    for name, t, dtype in (("x", x, fdt), ("y", y, fdt),
                           ("valid", valid, torch.bool)):
        if t.dtype != dtype:
            raise TypeError(f"{name}: want {dtype}, got {t.dtype}")
        if tuple(t.shape) != (n,):
            raise ValueError(f"{name}: want shape ({n},), "
                             f"got {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, want {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    if n % TILE:
        raise ValueError(f"n={n} must be a multiple of {TILE} "
                         "(ops.occlusion_count_op pads)")
    if not (0 <= row0 <= row1 <= n and row0 % TILE == 0
            and row1 % TILE == 0):
        raise ValueError(f"row range [{row0}, {row1}) must lie in [0, {n}) "
                         f"with both ends multiples of {TILE}")
    n_tiles = n // TILE
    if row0 == row1:
        return torch.zeros((), dtype=torch.int64, device=dev)
    if n_tiles > 65535:
        raise ValueError(f"n={n} exceeds the kernel's tile grid")
    partial = torch.empty(row_tile_count(n_tiles, row0 // TILE,
                                         (row1 - row0) // TILE),
                          dtype=torch.int32, device=dev)
    fn = entry("occlusion_pairs_bf16" if fdt == torch.bfloat16
               else "occlusion_pairs")
    thresh = float(_threshold(radius, torch.empty(0)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), valid.data_ptr(), n, row0, row1,
                 thresh, partial.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"occlusion_pairs kernel launch failed: "
                           f"cudaError {err}")
    return partial.sum(dtype=torch.int64)


def row_tile_count(n_tiles, t0, m):
    """Tiles (bi, bj), bi <= bj, of the ``m`` row tiles from ``t0`` of an
    ``n_tiles``-square tile grid: the partials a launch of this kernel or
    of the crossing kernels writes (``csrc/row_tiles.cuh``);
    ``n_tiles (n_tiles + 1) / 2`` for the whole grid."""
    return m * (m + 1) // 2 + (n_tiles - t0 - m) * m


def _route(x, y, valid, radius, rows, counter):
    if x.device.type == "cpu":
        return occlusion_pairs_plain(x, y, valid, radius, rows=rows)
    if x.device.type != "cuda":
        raise ValueError(f"occlusion_pairs runs on cuda or cpu, "
                         f"got {x.device}")
    out = _launch(x, y, valid, radius, *rows)
    if rows[0] < rows[1]:
        if x.dtype == torch.bfloat16:
            counter.LAUNCHES_BF16 += 1
        else:
            counter.LAUNCHES += 1
    return out


def occlusion_pairs(x, y, valid, radius):
    """Exact occluded-pair count of ``(n,)`` coordinates and a bool
    validity mask.  CUDA inputs (coordinates both float32 or both
    bfloat16, contiguous, ``n`` a multiple of :data:`TILE`) launch the
    kernel, counted in ``LAUNCHES`` or, for the bfloat16 instantiation,
    ``LAUNCHES_BF16``; CPU inputs run :func:`occlusion_pairs_plain`.
    Either widens bfloat16 coordinates to float32 and forms the distance
    in float32, as the reference's route does.  Returns an int64 scalar
    tensor."""
    return _route(x, y, valid, radius, (0, x.shape[0]), occlusion_pairs)


def occlusion_pairs_rows(x, y, valid, radius, row0, row1):
    """The occluded pairs ``i < j`` of :func:`occlusion_pairs` with ``i`` in
    ``[row0, row1)``; on CUDA both ends are multiples of :data:`TILE`.
    Summed over a partition of the rows, this is the whole count."""
    rows = (int(row0), int(row1))
    out = _route(x, y, valid, radius, rows, occlusion_pairs_rows)
    if x.device.type == "cuda":
        occlusion_pairs_rows.TILES += row_tile_count(
            x.shape[0] // TILE, rows[0] // TILE, (rows[1] - rows[0]) // TILE)
    return out


occlusion_pairs.LAUNCHES = 0
occlusion_pairs.LAUNCHES_BF16 = 0
occlusion_pairs_rows.LAUNCHES = 0
occlusion_pairs_rows.LAUNCHES_BF16 = 0
occlusion_pairs_rows.TILES = 0
