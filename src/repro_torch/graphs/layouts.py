"""Graph layouts (counterpart of :mod:`repro.graphs.layouts`): random
placement (a numpy copy) and a Fruchterman-Reingold layout on PyTorch.

The paper evaluates readability on random layouts (S4.1) and on FR layouts
(S4.2, Table 4); ``examples/layout_optimization.py`` drives FR with the
readability engine as the monitor and then searches from the winner.
"""

from __future__ import annotations

import numpy as np
import torch


def random_layout(n_vertices: int, seed: int = 0, scale: float = 100.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, scale, size=(n_vertices, 2)).astype(np.float32)


def fruchterman_reingold(pos0, edges, *, n_iter: int = 100,
                         block: int = 512, device=None):
    """Force-directed layout (Fruchterman & Reingold 1991): blocked O(V^2)
    repulsion over ``block``-row tiles, the vertex set padded to a
    multiple of ``block`` with points at ``1e6`` that repel nothing, and
    the reference's cooling ``t = 10 (1 - i / n_iter) + 0.01``.

    Returns the ``(V, 2)`` float32 layout as a tensor on ``pos0``'s device
    (host arrays go to ``device``, CUDA unless the caller passes another).
    The attraction is accumulated with ``index_add_``, which on CUDA adds
    with atomics in no fixed order, so FR is not bitwise reproducible
    there (nor equal bit for bit to the reference's scatter-add)."""
    from repro_torch.core.engine import device_inputs
    pos, edges = device_inputs(pos0, edges, device)
    dev = pos.device
    n = pos.shape[0]

    def scalar(v):
        return torch.full((), v, dtype=torch.float32, device=dev)

    k = torch.sqrt(scalar(100.0 * 100.0 / n))
    n_pad = -(-n // block) * block
    pad = n_pad - n
    if pad:
        pos = torch.cat([pos, torch.full((pad, 2), 1e6, dtype=pos.dtype,
                                         device=dev)])
    valid = torch.arange(n_pad, device=dev) < n
    e0, e1 = edges[:, 0].long(), edges[:, 1].long()
    floor_r, floor_a = scalar(1e-4), scalar(1e-8)

    def repulsion(pos):
        out = []
        for i0 in range(0, n_pad, block):
            d = pos[i0:i0 + block, None, :] - pos[None, :, :]
            dist2 = torch.maximum((d * d).sum(-1), floor_r)
            f = (k * k / dist2)[:, :, None] * d / torch.sqrt(dist2)[:, :, None]
            f = torch.where(valid[None, :, None], f, 0.0)
            out.append(f.sum(dim=1))
        return torch.cat(out)

    with torch.no_grad():
        for i in range(n_iter):
            t = scalar(np.float32(10.0) * (np.float32(1.0) - np.float32(i)
                                           / np.float32(n_iter))
                       + np.float32(0.01))
            disp = repulsion(pos)
            d = pos[e0] - pos[e1]
            dist = torch.sqrt(torch.maximum((d * d).sum(-1), floor_a))
            fa = (dist / k)[:, None] * d
            disp.index_add_(0, e0, -fa)
            disp.index_add_(0, e1, fa)
            norm = torch.sqrt(torch.maximum((disp * disp).sum(-1), floor_a))
            lim = torch.minimum(norm, t) / norm
            pos = pos + disp * lim[:, None]
            pos = torch.where(valid[:, None], pos, 1e6)
    return pos[:n]
