"""Node occlusion ``N_c`` on the pre-planned grid (paper S3.2.1);
counterpart of the gridded counters of :mod:`repro.core.occlusion`.

Two vertices are occluded when their centre distance is below the disc
diameter ``2r``; ``N_c`` counts occluded unordered pairs.  Vertices are
bucketed per cell and each cell is compared densely with itself (i < j)
and with its half neighbourhood: exact, because the cell size is >= 2r.
The exact all-pairs count (:func:`count_occlusions_exact`) is the
occlusion-pair kernel (:mod:`repro_torch.kernels.occlusion_pairs`), also
used by ``backend="kernels"``.  :func:`count_occlusions_enhanced` plans
the grid from the data and counts on it (no kernel: the reference uses
no Pallas there either).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import grid as gridlib
from repro_torch.kernels import ops

# elements of the (rows, cap, 5*cap) pair tiles one sweep block may hold
_PAIR_BUDGET = 1 << 24


def count_occlusions_exact(pos, radius, *, valid=None):
    """Exact N_c: all vertex pairs (i < j), both valid, with
    ``dist^2 < (2r)^2``.  On CUDA tensors the occlusion-pair kernel
    sweeps the pairs; on CPU tensors its plain version.  Returns an int64
    scalar tensor."""
    return ops.occlusion_count_op(pos, radius, valid=valid)


def _d2(ax, ay, bx, by):
    dx = ax - bx
    dy = ay - by
    return dx * dx + dy * dy


def _cross_count(bx, by, bv, cx, cy, cv, thresh):
    """Per-row count of (bucket, neighbour-slab) pairs closer than
    ``sqrt(thresh)``: ``(rows, cap)`` x ``(rows, 4*cap)`` -> ``(rows,)``."""
    d2 = _d2(bx[:, :, None], by[:, :, None], cx[:, None, :], cy[:, None, :])
    mask = bv[:, :, None] & cv[:, None, :]
    return (mask & (d2 < thresh)).sum(dim=(1, 2))


def _sweep_rows(x, y, bval, nbr_idx, nbr_ok, thresh):
    """Per-row occluded-pair counts of the first ``rows`` of ``(n, cap)``
    buckets, ``rows = nbr_idx.shape[0]``: same-cell pairs (i < j) plus the
    four neighbour buckets ``nbr_idx`` names (rows of the same table; a
    graph shard's table ends with its halo rows, which it does not
    sweep)."""
    rows, cap = nbr_idx.shape[0], x.shape[1]
    tri = torch.triu(torch.ones(cap, cap, dtype=torch.bool,
                                device=x.device), diagonal=1)
    block = max(1, min(rows, _PAIR_BUDGET // max(5 * cap * cap, 1)))
    out = []
    for b0 in range(0, rows, block):
        sl = slice(b0, min(b0 + block, rows))
        bx, by, bv = x[sl], y[sl], bval[sl]
        ni, no = nbr_idx[sl], nbr_ok[sl]
        n = bx.shape[0]
        d2 = _d2(bx[:, :, None], by[:, :, None], bx[:, None, :],
                 by[:, None, :])
        smask = bv[:, :, None] & bv[:, None, :] & tri[None]
        same = (smask & (d2 < thresh)).sum(dim=(1, 2))
        cx = x[ni].reshape(n, -1)                          # (n, 4*cap)
        cy = y[ni].reshape(n, -1)
        cv = (bval[ni] & no[:, :, None]).reshape(n, -1)
        out.append(same + _cross_count(bx, by, bv, cx, cy, cv, thresh))
    return torch.cat(out)


def count_occlusions_gridded(pos, radius, origin, nx: int, ny: int,
                             cap: int, *, valid=None, cell_size=None):
    """Enhanced N_c of one ``(V, 2)`` layout on a planned grid.  Returns
    ``(count, overflow)``.  The sweep blocks rows by a pair-element
    budget (the reference's ``cell_block``), which changes no count."""
    buckets = gridlib.build_cell_buckets(pos, radius, origin, nx, ny, cap,
                                         valid=valid, cell_size=cell_size)
    nbr = gridlib.neighbour_bucket_ids(nx, ny, device=pos.device)
    thresh = torch.tensor((2.0 * radius) ** 2, dtype=pos.dtype,
                          device=pos.device)
    per_row = _sweep_rows(buckets.x, buckets.y, buckets.valid,
                          torch.clamp_min(nbr, 0), nbr >= 0, thresh)
    return per_row.sum(), buckets.overflow


def count_occlusions_gridded_batched(pos, radius, origin, nx: int, ny: int,
                                     cap: int, *, valid=None,
                                     cell_size=None):
    """Natively batched enhanced N_c: ``(B, V, 2)`` -> ``((B,), (B,))``.

    The whole batch is grouped by one sort per row into ``(B * n_cells,
    cap)`` bucket rows (:func:`~repro_torch.core.grid.gather_ragged_buckets`
    with uniform caps) and swept with per-row counts; counts equal the
    single-layout counter's under the same grid.  ``valid`` may be
    ``(V,)`` or ``(B, V)``.
    """
    B, V = pos.shape[0], pos.shape[1]
    n_cells = nx * ny
    gridlib.CALL_COUNTS["cell_builds"] += 1
    _, _, cid = gridlib.cell_indices(pos, radius, origin, nx, ny,
                                     cell_size=cell_size)     # (B, V)
    vmask = None if valid is None else valid.expand(B, V)
    x, y, bval, _, overflow = gridlib.gather_ragged_buckets(
        cid, n_cells, np.arange(n_cells, dtype=np.int64) * cap,
        np.full(n_cells, cap, np.int64), pos[..., 0], pos[..., 1],
        valid=vmask)
    x = x.reshape(B * n_cells, cap)
    y = y.reshape(B * n_cells, cap)
    bval = bval.reshape(B * n_cells, cap)

    # per-layout neighbour ids: the half neighbourhood never crosses the
    # batch boundary, so row b*n_cells + c pairs with b*n_cells + nbr
    nbr = gridlib.neighbour_bucket_ids(nx, ny, device=pos.device)
    base = torch.arange(B, device=pos.device)[:, None, None] * n_cells
    nbr_f = torch.where(nbr[None] >= 0, nbr[None] + base,
                        -1).reshape(B * n_cells, 4)
    thresh = torch.tensor((2.0 * radius) ** 2, dtype=pos.dtype,
                          device=pos.device)
    per_row = _sweep_rows(x, y, bval, torch.clamp_min(nbr_f, 0),
                          nbr_f >= 0, thresh)
    return per_row.reshape(B, n_cells).sum(dim=1), overflow


def count_occlusions_enhanced(pos, radius, *, valid=None,
                              cell_block: int = 512, device=None):
    """Host-facing enhanced N_c: plans the grid from the data, then runs
    the gridded counter; returns ``(count, overflow)``.  ``cell_block`` is
    the reference's row blocking (the sweep here blocks by a pair-element
    budget; counts do not depend on it).  Runs on CUDA unless ``device``
    says otherwise (tensors stay on their device), and raises when no
    CUDA device exists."""
    from repro_torch.core.engine import device_inputs
    pos, _ = device_inputs(pos, None, device)
    origin, nx, ny, cap, size = gridlib.plan_occlusion_grid(
        pos.detach().cpu().numpy(), radius)
    return count_occlusions_gridded(pos, radius, origin, nx, ny, cap,
                                    valid=valid, cell_size=size)
