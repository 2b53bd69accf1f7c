"""Inversion counting, the sequential-sweep alternative vectorized
(counterpart of :mod:`repro.core.inversions`).

The paper's enhanced edge-crossing sweep is a balanced-BST inversion
count (O(n log n), sequential).  Two data-parallel counters:

* :func:`count_inversions_dense` -- the O(n^2) blocked compare;
* :func:`count_inversions_merge` -- the O(n log^2 n) bottom-up merge with
  one batched ``torch.searchsorted`` over the rows of each level.

Both count pairs ``i < j`` with ``a[i] > a[j]`` (strict) among valid
entries, as int64 scalar tensors.
"""

from __future__ import annotations

import torch

from repro_torch.core.grid import count_dtype

# the sentinel the merge counter pads with (the reference's +3e38)
_BIG = 3.0e38


def count_inversions_dense(a, valid=None, *, block: int = 1024):
    """Dense O(n^2) count, ``block`` rows at a time (the count does not
    depend on it)."""
    n = a.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=a.device)
    idx = torch.arange(n, device=a.device)
    total = torch.zeros((), dtype=count_dtype(), device=a.device)
    for i0 in range(0, n, block):
        i1 = min(i0 + block, n)
        mask = ((idx[i0:i1, None] < idx[None, :])
                & (a[i0:i1, None] > a[None, :])
                & valid[i0:i1, None] & valid[None, :])
        total = total + mask.sum(dtype=count_dtype())
    return total


def count_inversions_merge(a, valid=None):
    """Bottom-up merge inversion count; pads to the next power of two.

    Valid entries are compacted to the front in order (stable), and the
    tail is padded with the +3e38 sentinel: under the strict ``>`` a
    sentinel never inverts with another sentinel, and it never sits left
    of a real element."""
    n = a.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=a.device)
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    big = torch.tensor(_BIG, dtype=torch.float32, device=a.device)
    x = torch.where(valid[order], a[order].to(torch.float32), big)
    size = 1
    while size < x.shape[0]:
        size *= 2
    if size > x.shape[0]:
        x = torch.cat([x, big.expand(size - x.shape[0])])

    total = torch.zeros((), dtype=count_dtype(), device=a.device)
    width = 1
    while width < size:
        rows = x.reshape(-1, 2 * width)
        left = rows[:, :width].contiguous()
        right = rows[:, width:].contiguous()
        # inversions across the boundary: for each b in the right half,
        # the elements of the (sorted) left half strictly greater than b
        counts = width - torch.searchsorted(left, right, right=True)
        total = total + counts.sum(dtype=count_dtype())
        x = torch.sort(rows, dim=1).values.reshape(-1)
        width *= 2
    return total
