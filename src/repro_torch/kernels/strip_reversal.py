"""Per-row strip-reversal sweep: the edge-crossing count and the fused
crossing-angle deviation sum of every strip bucket (paper S3.2.2/3).

Replaces the Pallas TPU kernel ``repro/kernels/strip_reversal.py``
(``_reversal_kernel`` / ``strip_reversal_stats``).  Crossings inside a
strip are order reversals ``(yl_i < yl_j) & (yr_i > yr_j)`` between the
boundary ordinates of its segments, pairs sharing an endpoint excluded;
with ``with_angle`` the same pair mask sums ``|ideal - a_c| / ideal``.

* :func:`fused_reversal_block` -- the plain PyTorch formula, the single
  source of truth shared by the engine (as
  ``repro_torch.core.engine.fused_reversal_block``) and the CPU route.
* :func:`strip_reversal_rows` -- the wrapper.  For a CUDA slab it
  launches the hand-written kernel ``csrc/strip_reversal.cu`` and counts
  the launch in ``strip_reversal_rows.LAUNCHES``; for a CPU slab it runs
  the plain formula in row blocks.  It raises on any other device.

What bounds the function on an H100: per-pair ALU instructions on the
CUDA cores (four float compares and a join decide a reversal in either
order; the function needs the shared-endpoint test only on reversing
pairs and the count and deviation only on crossings); the input bytes
are negligible.  Its design (``csrc/strip_reversal.cu``): each row swept
only up to its extent (last valid slot + 1, found on the device),
unordered pairs ``i < j`` tested in both orientations, the row staged
once in shared memory with invalid slots as NaN (no per-pair mask), two
i's per lane against 32-slot j tiles with the triangle split evenly over
the warps, the endpoint test, count and deviation under a branch on
reversal, short rows packed several to a block and 1024-slot windows
for long rows; fixed-order reductions to one int64 count and one f32
deviation per row -- no atomics on the sums, so the deviation sum is
reproducible.
"""

from __future__ import annotations

import math

import torch

# elements of the (rows, cap, cap) pair tiles one plain block may hold
_PAIR_BUDGET = 1 << 26


def fused_reversal_block(yl, yr, theta, v, u, valid, *, ideal,
                         with_angle: bool = True, reduce: str = "all"):
    """Dense reversal sweep over a ``(B, cap)`` block of strip buckets.

    Returns ``(count, deviation_sum)``: the crossing count (order
    reversals between the strip's boundary ordinates, shared endpoints
    excluded) and, on the same pair mask, ``sum |ideal - a_c| / ideal``.
    ``reduce='rows'`` returns per-row ``(B,)`` sums instead of scalars.
    """
    dims = (1, 2) if reduce == "rows" else None
    rev = (yl[:, :, None] < yl[:, None, :]) & (yr[:, :, None] > yr[:, None, :])
    shared = ((v[:, :, None] == v[:, None, :]) |
              (v[:, :, None] == u[:, None, :]) |
              (u[:, :, None] == v[:, None, :]) |
              (u[:, :, None] == u[:, None, :]))
    mask = rev & ~shared & valid[:, :, None] & valid[:, None, :]
    cnt = mask.sum(dim=dims)
    if not with_angle:
        shape = (yl.shape[0],) if reduce == "rows" else ()
        return cnt, torch.zeros(shape, dtype=yl.dtype, device=yl.device)
    ideal_t = torch.tensor(ideal, dtype=yl.dtype, device=yl.device)
    d = torch.abs(theta[:, :, None] - theta[:, None, :])
    a_c = torch.minimum(d, math.pi - d)
    dev = torch.abs(ideal_t - a_c) / ideal_t
    return cnt, torch.where(mask, dev, 0.0).sum(dim=dims)


def strip_reversal_rows_plain(yl, yr, theta, v, u, valid, *, ideal,
                              with_angle: bool = True,
                              row_block: int = 256):
    """The plain version of the kernel: :func:`fused_reversal_block` per
    row over a ``(rows, cap)`` slab, in row blocks that keep the pair
    tiles within a fixed element budget.  Returns ``((rows,) int64
    count, (rows,) dev)``."""
    rows, cap = yl.shape
    block = max(1, min(row_block, _PAIR_BUDGET // max(cap * cap, 1),
                       max(rows, 1)))
    counts, devs = [], []
    for b0 in range(0, rows, block):
        sl = slice(b0, b0 + block)
        c, d = fused_reversal_block(yl[sl], yr[sl], theta[sl], v[sl], u[sl],
                                    valid[sl], ideal=ideal,
                                    with_angle=with_angle, reduce="rows")
        counts.append(c)
        devs.append(d)
    if not counts:
        return (torch.zeros(0, dtype=torch.int64, device=yl.device),
                torch.zeros(0, dtype=yl.dtype, device=yl.device))
    return torch.cat(counts), torch.cat(devs)


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: want {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, want {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch(yl, yr, theta, v, u, valid, ideal, with_angle):
    from repro_torch.kernels._build import entry

    rows, cap = yl.shape
    dev = yl.device
    for name, t, dtype in (("yl", yl, torch.float32),
                           ("yr", yr, torch.float32),
                           ("theta", theta, torch.float32),
                           ("v", v, torch.int32), ("u", u, torch.int32),
                           ("valid", valid, torch.bool)):
        _check(name, t, dtype, (rows, cap), dev)
    if rows == 0 or cap == 0:
        return (torch.zeros(rows, dtype=torch.int64, device=dev),
                torch.zeros(rows, dtype=torch.float32, device=dev))
    if rows >= 2 ** 31:
        raise ValueError(f"too many rows for one launch: {rows}")
    cnt = torch.empty(rows, dtype=torch.int64, device=dev)
    dsum = torch.empty(rows, dtype=torch.float32, device=dev)
    fn = entry("strip_reversal")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(yl.data_ptr(), yr.data_ptr(), theta.data_ptr(),
                 v.data_ptr(), u.data_ptr(), valid.data_ptr(), rows, cap,
                 float(ideal), int(bool(with_angle)),
                 cnt.data_ptr(), dsum.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"strip_reversal kernel launch failed: "
                           f"cudaError {err}")
    strip_reversal_rows.LAUNCHES += 1
    return cnt, dsum


def strip_reversal_rows(yl, yr, theta, v, u, valid, *, ideal,
                        with_angle: bool = True, row_block: int = 256):
    """Per-row ``(count, dev)`` of a ``(rows, cap)`` slab of strip
    buckets (any ``cap``).

    A CUDA slab launches the hand-written kernel (``yl``/``yr``/``theta``
    float32, ``v``/``u`` int32, ``valid`` bool, all contiguous); a CPU
    slab runs :func:`strip_reversal_rows_plain`.  Returns ``((rows,)
    int64, (rows,) float32)``."""
    if yl.device.type == "cpu":
        return strip_reversal_rows_plain(yl, yr, theta, v, u, valid,
                                         ideal=ideal, with_angle=with_angle,
                                         row_block=row_block)
    if yl.device.type != "cuda":
        raise ValueError(f"strip_reversal_rows runs on cuda or cpu, "
                         f"got {yl.device}")
    return _launch(yl, yr, theta, v, u, valid, ideal, with_angle)


strip_reversal_rows.LAUNCHES = 0
