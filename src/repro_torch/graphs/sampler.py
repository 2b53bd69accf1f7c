"""Device-side uniform neighbour sampler for GraphSAGE fanout batches
(counterpart of :mod:`repro.graphs.sampler`).

The CSR adjacency (:func:`repro_torch.graphs.datasets.to_csr`) lives on
the device; sampling is ``torch.randint`` from an explicit
``torch.Generator`` on that device plus gathers, with the reference's
formula: a draw in ``[0, 2^30)`` taken modulo the seed's degree
(at least 1), zero-degree seeds fully masked, and a second hop masked
where its first hop is.  Torch cannot reproduce ``jax.random``'s draws,
so the sampler is held to validity (every unmasked neighbour adjacent
to its seed), not to the reference's ids.
"""

from __future__ import annotations

import torch


def sample_neighbors(indptr, indices, seeds, fanout: int,
                     generator: torch.Generator):
    """Uniform-with-replacement neighbour sampling.

    Returns (neighbour ids ``(B, fanout)`` of ``indices``' dtype, mask
    ``(B, fanout)`` bool).  Zero-degree seeds get a fully masked row of
    id 0."""
    seeds = seeds.long()
    start = indptr[seeds].long()
    deg = indptr[seeds + 1].long() - start
    r = torch.randint(0, 1 << 30, (seeds.shape[0], fanout),
                      generator=generator, device=indices.device)
    offs = r % torch.clamp_min(deg, 1)[:, None]
    mask = (deg > 0)[:, None].expand(-1, fanout)
    # a zero-degree seed's start may be one past the last entry (jnp.take
    # clamps it): such rows read entry 0 and are masked
    nbr = indices[torch.where(mask, start[:, None] + offs, 0)]
    return torch.where(mask, nbr, torch.zeros_like(nbr)), mask


def sample_fanout_batch(indptr, indices, feats, labels, seeds,
                        generator: torch.Generator, fanouts: tuple):
    """Two-hop dense fanout batch for GraphSAGE: ``dict(x0 (B, d), x1 (B,
    f1, d), x2 (B, f1, f2, d), m1, m2, labels (B,))``, the features
    gathered on the device from ``feats``.  The first hop draws from
    ``generator`` first, then the second."""
    f1, f2 = fanouts
    B = seeds.shape[0]
    n1, m1 = sample_neighbors(indptr, indices, seeds, f1, generator)
    n2, m2 = sample_neighbors(indptr, indices, n1.reshape(-1), f2, generator)
    n2 = n2.reshape(B, f1, f2)
    m2 = m2.reshape(B, f1, f2) & m1[:, :, None]
    seeds = seeds.long()
    return {
        "x0": feats[seeds],
        "x1": feats[n1.long()],
        "x2": feats[n2.long()],
        "m1": m1,
        "m2": m2,
        "labels": labels[seeds],
    }
