"""The work the rooflines count, and the card's peaks.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet): 3.35e12 B/s of HBM3,
and 33.5e12 simple FP32 operations per second on the CUDA cores
(132 SMs x 128 lanes x 1.98 GHz; the sheet's 67 TFLOP/s counts an FMA as
two).  A roofline share is the least time of the work -- the larger of
its operations over the operation peak and its bytes over the byte
peak -- over the device-busy time the work took.

Operations are the least each pair test needs, counted from the cell's
inputs by the pairs the paper's algorithm defines, whatever implements
them (so no fusion or rename of a kernel moves the count):

* exact crossing test, per unordered edge pair: the differences p2 - p1,
  q2 - p1, q1 - p2 (6 sub; q - p of each edge is per edge, not per
  pair), four cross products (8 mul, 4 sub), two straddle tests (3
  each: a min, a max, a compare pair folded into one predicate op), one
  op joining them: 25.  Per straddling pair, the shared-endpoint test:
  4 integer compares.  Per crossing: the count's add, and the angle's
  deviation (sub, sub, min, sub, mul, add): 7.  E_c and E_ca share the
  one test per pair.
* occlusion test, per unordered vertex pair: 2 sub, 2 mul, 1 add, 1
  compare: 6; per occluded pair, the count's add: 1.  The exact cell
  tests every vertex pair; the batch cell the pairs of each grid cell of
  side 2r with itself and its half neighbourhood (E, N, NE, SE).
* strip reversal, per unordered segment pair of a strip: 4 float
  compares and one op joining the two orders: 5.  Per reversing pair,
  the shared-endpoint test: 4.  Per crossing, the count's add and the
  deviation (sub, sub, min, sub, div, add): 7.  Both orientations.

Bytes: the inputs read once (coordinates, 8 B a vertex a layout; edges,
8 B) and the outputs written once (a few scalars a layout).

The straddle, reversal, crossing and occlusion counts depend on the
layout: they are the reference's counts of the calls it checked, which
stand for every call of the window (the layouts of a cell are drawn
alike).  A kernel that rejects pairs by a cheaper test than these
makes the count stale; only a benchmark change corrects it.
"""

from __future__ import annotations

import torch

PEAK_OPS = 33.5e12
PEAK_BYTES = 3.35e12

CROSS_PER_PAIR, CROSS_PER_STRADDLE, CROSS_PER_CROSSING = 25, 4, 7
OCC_PER_PAIR, OCC_PER_OCCLUSION = 6, 1
REV_PER_PAIR, REV_PER_REVERSAL, REV_PER_CROSSING = 5, 4, 7


def least_seconds(ops, nbytes):
    return max(ops / PEAK_OPS, nbytes / PEAK_BYTES)


def pairs(n):
    return n * (n - 1) // 2


def exact_work(n_vertices, n_edges, work):
    """``(ops, bytes)`` of one exact evaluation."""
    ops = (CROSS_PER_PAIR * pairs(n_edges)
           + CROSS_PER_STRADDLE * work["straddles"]
           + CROSS_PER_CROSSING * work["crossings"]
           + OCC_PER_PAIR * pairs(n_vertices)
           + OCC_PER_OCCLUSION * work["occlusions"])
    return ops, 8 * n_vertices + 8 * n_edges


def strip_work(n_layouts, n_vertices, n_edges, work):
    """``(ops, bytes)`` of one batch of enhanced evaluations; ``work``
    sums the batch's pair classes."""
    ops = (REV_PER_PAIR * work["strip_pairs"]
           + REV_PER_REVERSAL * work["reversals"]
           + REV_PER_CROSSING * work["crossings"]
           + OCC_PER_PAIR * work["cell_pairs"]
           + OCC_PER_OCCLUSION * work["occlusions"])
    return ops, 8 * n_layouts * n_vertices + 8 * n_edges


def cell_pairs(pos, radius):
    """Candidate vertex pairs of the occlusion grid: cells of side
    ``2r`` from the layout's lower corner, each cell with itself
    (unordered pairs) and with its half neighbourhood."""
    side = 2.0 * float(radius)
    p = pos.double()
    ij = torch.floor((p - p.min(dim=0).values) / side).long()
    nx, ny = int(ij[:, 0].max()) + 1, int(ij[:, 1].max()) + 1
    occ = torch.bincount(ij[:, 1] * nx + ij[:, 0],
                         minlength=nx * ny).reshape(ny, nx)
    total = int((occ * (occ - 1) // 2).sum())
    pad = torch.zeros(ny + 2, nx + 2, dtype=occ.dtype, device=occ.device)
    pad[1:-1, 1:-1] = occ
    for dx, dy in ((1, 0), (0, 1), (1, 1), (1, -1)):
        nb = pad[1 + dy:1 + dy + ny, 1 + dx:1 + dx + nx]
        total += int((occ * nb).sum())
    return total
