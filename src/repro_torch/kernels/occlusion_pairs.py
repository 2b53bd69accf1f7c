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


def occlusion_pairs_plain(x, y, valid, radius):
    """Count pairs ``i < j`` with both valid and ``d2 < (2r)^2`` by blocked
    all-pairs PyTorch.  Returns an int64 scalar tensor."""
    n = x.shape[0]
    thresh = _threshold(radius, x)
    idx = torch.arange(n, device=x.device)
    block = max(1, min(n, _PAIR_BUDGET // max(n, 1)))
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    for i0 in range(0, n, block):
        sl = slice(i0, i0 + block)
        dx = x[sl, None] - x[None, :]
        dy = y[sl, None] - y[None, :]
        d2 = dx * dx + dy * dy
        mask = ((idx[sl, None] < idx[None, :]) & valid[sl, None]
                & valid[None, :])
        total = total + (mask & (d2 < thresh)).sum()
    return total


def _launch(x, y, valid, radius):
    from repro_torch.kernels._build import entry

    n = x.shape[0]
    dev = x.device
    for name, t, dtype in (("x", x, torch.float32), ("y", y, torch.float32),
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
    n_tiles = n // TILE
    if n_tiles == 0:
        return torch.zeros((), dtype=torch.int64, device=dev)
    if n_tiles > 65535:
        raise ValueError(f"n={n} exceeds the kernel's tile grid")
    # one partial per tile on or above the diagonal
    partial = torch.empty(n_tiles * (n_tiles + 1) // 2, dtype=torch.int32,
                          device=dev)
    fn = entry("occlusion_pairs")
    thresh = float(_threshold(radius, torch.empty(0)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), valid.data_ptr(), n, thresh,
                 partial.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"occlusion_pairs kernel launch failed: "
                           f"cudaError {err}")
    occlusion_pairs.LAUNCHES += 1
    return partial.sum(dtype=torch.int64)


def occlusion_pairs(x, y, valid, radius):
    """Exact occluded-pair count of ``(n,)`` coordinates and a bool
    validity mask.  CUDA inputs (float32 / bool, contiguous, ``n`` a
    multiple of :data:`TILE`) launch the kernel; CPU inputs run
    :func:`occlusion_pairs_plain`.  Returns an int64 scalar tensor."""
    if x.device.type == "cpu":
        return occlusion_pairs_plain(x, y, valid, radius)
    if x.device.type != "cuda":
        raise ValueError(f"occlusion_pairs runs on cuda or cpu, "
                         f"got {x.device}")
    return _launch(x, y, valid, radius)


occlusion_pairs.LAUNCHES = 0
