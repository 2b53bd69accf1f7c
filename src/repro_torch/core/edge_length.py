"""Edge length variation ``M_l`` (paper S3.1.3); counterpart of
:mod:`repro.core.edge_length`.

    l_a = sqrt( sum_e (l_e - l_mu)^2 / (N_e * l_mu^2) )
    M_l = l_a / sqrt(N_e - 1)
"""

from __future__ import annotations

import torch

from repro_torch.core.geometry import edge_lengths


def _ml(lengths, ev, n_e, dim):
    l_mu = torch.where(ev, lengths, 0.0).sum(dim=dim) / n_e
    mu = l_mu if dim is None else l_mu[:, None]
    diff = lengths - mu
    sq = torch.where(ev, diff * diff, 0.0)
    # all-duplicate-position guard: the squared clamp underflows to 0, so
    # 0/0 = NaN is selected away as M_l = 0 (as the reference does)
    mu_c = torch.clamp_min(l_mu, 1e-30)
    denom = n_e * (mu_c * mu_c)
    l_a = torch.where(denom > 0, torch.sqrt(sq.sum(dim=dim) / denom), 0.0)
    return torch.where(n_e > 1,
                       l_a / torch.sqrt(torch.clamp_min(n_e - 1, 1)), 0.0)


def edge_length_variation(pos, edges, *, edge_valid=None):
    lengths = edge_lengths(pos, edges)
    if edge_valid is None:
        edge_valid = torch.ones(lengths.shape, dtype=torch.bool,
                                device=lengths.device)
    n_e = torch.clamp_min(edge_valid.sum(), 1)
    return _ml(lengths, edge_valid, n_e, None)


def edge_length_variation_batched(pos, edges, *, edge_valid=None):
    """Batched M_l: ``(B, V, 2)`` layouts of one graph -> ``(B,)``."""
    d = pos[:, edges[:, 0].long()] - pos[:, edges[:, 1].long()]
    lengths = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    if edge_valid is None:
        edge_valid = torch.ones(edges.shape[0], dtype=torch.bool,
                                device=pos.device)
    ev = edge_valid.expand(lengths.shape)
    n_e = torch.clamp_min(ev.sum(dim=1), 1)
    return _ml(lengths, ev, n_e, 1)
