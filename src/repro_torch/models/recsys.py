"""xDeepFM (arXiv:1803.05170): sparse embeddings + CIN + DNN
(counterpart of :mod:`repro.models.recsys`).

The lookup substrate is a gather plus a scatter-add (or scatter-max),
as the reference builds it from ``jnp.take`` and ``jax.ops.segment_*``:
:func:`embedding_bag` is ``torch.nn.EmbeddingBag``'s function in those
terms.  One flat embedding table (per-field vocabularies concatenated
with offsets) holds every field.

Heads:
  * :func:`xdeepfm_logits` -- the CTR logit: linear + CIN + DNN
    (train_batch, serve_p99, serve_bulk).
  * :func:`retrieval_scores` -- the two-tower retrieval head: the
    xDeepFM user tower against the item-embedding matrix, one ``(B, d) x
    (d, n_items)`` product (retrieval_cand).

The CIN (:func:`_cin`) contracts ``X^k`` and ``X^0`` with ``W^k`` in a
fixed order: the outer product ``X^k_j o X^0_i`` first, then one matrix
product with ``W^k`` reshaped to ``(H_k, H_{k-1} m)``.  The outer
product has ``H_{k-1} m D`` elements per row (312,000 at the published
width, 8.2e10 for serve_bulk's 262,144 rows), so it runs in row chunks
of at most :data:`CIN_CHUNK_BYTES`, each chunk recomputed in the
backward instead of saved.  Per row it is the same function.  It is
laid out ``(j, i, row, d)`` so that the product is one matrix product
with ``rows x D`` columns.

Parameters are the reference's pytree of float32 tensors, cast to
``cfg.dtype`` at each use; :func:`init_xdeepfm_params` draws them from a
``torch.Generator`` on its device and :func:`numpy_params` draws the
reference's layout in numpy for both packages
(:func:`params_from_reference`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.common import params_from_reference  # noqa: F401

# the most bytes of one chunk's CIN outer product (1 GiB)
CIN_CHUNK_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class XDeepFMConfig:
    """The reference's :class:`repro.models.recsys.XDeepFMConfig`, field
    for field; ``dtype`` is a torch dtype."""

    name: str
    field_vocabs: Sequence[int]          # per-field vocabulary sizes
    embed_dim: int = 10
    cin_layers: Sequence[int] = (200, 200, 200)
    mlp_dims: Sequence[int] = (400, 400)
    retrieval_dim: int = 128
    n_items: int = 1_000_000
    dtype: Any = torch.float32

    @property
    def n_fields(self):
        return len(self.field_vocabs)

    @property
    def total_vocab(self):
        return int(sum(self.field_vocabs))

    @property
    def field_offsets(self):
        return np.concatenate([[0], np.cumsum(self.field_vocabs)[:-1]])


def embedding_bag(table, ids, bag_ids, n_bags: int, *, weights=None,
                  combine: str = "mean"):
    """EmbeddingBag from a gather and a scatter (``sum``, ``mean`` or
    ``max``).  ``ids`` / ``bag_ids``: ``(nnz,)``; returns ``(n_bags, d)``.
    ``weights`` scale each row first; ``mean`` divides the (weighted)
    sum by the bag's size; an empty bag is 0 (``sum``, ``mean``) or
    ``-inf`` (``max``), as ``jax.ops.segment_max`` leaves it."""
    rows = table[ids.long()]
    if weights is not None:
        rows = rows * weights[:, None]
    out = rows.new_zeros((n_bags, rows.shape[1]))
    bag_ids = bag_ids.long()
    if combine == "max":
        return out.fill_(float("-inf")).index_reduce(
            0, bag_ids, rows, "amax", include_self=False)
    s = out.index_add(0, bag_ids, rows)
    if combine == "sum":
        return s
    cnt = rows.new_zeros(n_bags).index_add(0, bag_ids,
                                           torch.ones_like(rows[:, 0]))
    return s / torch.clamp_min(cnt, 1.0)[:, None]


def _build(cfg: XDeepFMConfig, normal, zeros):
    """The reference's parameter tree in its draw order; ``normal(shape,
    scale)`` draws a truncated normal, ``zeros(shape)`` a zero array."""
    def dense(d_in, d_out):
        return normal((d_in, d_out), (1.0 / d_in) ** 0.5)

    m, D = cfg.n_fields, cfg.embed_dim
    params = {"embed": normal((cfg.total_vocab, D), 0.01),
              "linear": normal((cfg.total_vocab,), 0.01),
              "bias": zeros(())}
    # CIN: W^k (H_k, H_{k-1}, m)
    h_prev, cin = m, []
    for h in cfg.cin_layers:
        cin.append(normal((h, h_prev, m), (h_prev * m) ** -0.5))
        h_prev = h
    params["cin"] = cin
    params["cin_out"] = dense(int(sum(cfg.cin_layers)), 1)
    dims = [m * D] + list(cfg.mlp_dims)
    params["mlp"] = [{"w": dense(dims[i], dims[i + 1]),
                      "b": zeros((dims[i + 1],))}
                     for i in range(len(cfg.mlp_dims))]
    params["mlp_out"] = dense(dims[-1], 1)
    # retrieval two-tower head
    params["user_proj"] = dense(dims[-1], cfg.retrieval_dim)
    params["item_embed"] = normal((cfg.n_items, cfg.retrieval_dim), 0.02)
    return params


def init_xdeepfm_params(cfg: XDeepFMConfig, generator: torch.Generator):
    """xDeepFM parameters drawn from ``generator`` on its device, float32;
    each table is drawn in place, with no second copy."""
    dev = generator.device
    return _build(
        cfg, lambda shape, scale: common.truncated_normal(generator, shape,
                                                          scale),
        lambda shape: torch.zeros(shape, device=dev))


def numpy_params(cfg: XDeepFMConfig, seed: int) -> dict:
    """Parameters in the reference's pytree layout as numpy float32
    arrays from ``numpy.random.default_rng(seed)``, at the reference's
    scales (normals clipped to +-2, zero biases): one set of numbers both
    packages load."""
    rng = np.random.default_rng(seed)
    return _build(cfg,
                  lambda shape, scale: common.numpy_truncated(rng, shape,
                                                              scale),
                  lambda shape: np.zeros(shape, np.float32))


def _lookup(params, ids, cfg: XDeepFMConfig):
    """ids: (B, n_fields) global (offset) ids -> (B, n_fields, D)."""
    return common.settle_partial(
        F.embedding(ids, params["embed"])).to(cfg.dtype)


def _cin_rows(x0, cin_out, *cin):
    """The CIN of one chunk of rows: ``x0`` is ``(m, rows, D)``, each
    ``W^k`` ``(H_k, H_{k-1}, m)``, all in one dtype; returns ``(rows,)``."""
    m, rows, D = x0.shape
    outs, xk = [], x0
    for w in cin:
        h, j, i = w.shape
        # X^{k+1}_h = sum_{i,j} W_{h,j,i} (X^k_j o X^0_i)
        z = (xk[:, None] * x0[None]).reshape(j * i, rows * D)
        xk = (w.reshape(h, j * i) @ z).reshape(h, rows, D)
        outs.append(xk.sum(dim=-1))                       # sum-pool over D
    p = torch.cat(outs, dim=0)                            # (sum H_k, rows)
    return (p.T @ cin_out)[:, 0]


def cin_chunk_rows(cfg: XDeepFMConfig) -> int:
    """The CIN's default rows per chunk: as many as keep the widest outer
    product (``H_{k-1} m D`` elements a row) within
    :data:`CIN_CHUNK_BYTES` (3,441 at the published width in
    float32)."""
    m = cfg.n_fields
    widest = max([m] + list(cfg.cin_layers[:-1])) * m * cfg.embed_dim \
        * torch.empty((), dtype=cfg.dtype).element_size()
    return max(1, CIN_CHUNK_BYTES // widest)


def _cin(x0, params, cfg: XDeepFMConfig):
    """Compressed Interaction Network.  ``x0``: ``(B, m, D)``; returns
    ``(B,)``.  Rows go :func:`cin_chunk_rows` at a time (on a sharded
    batch, each rank's own rows: :func:`~repro_torch.models.common.
    per_rank`); under autograd each chunk keeps only its inputs and is
    recomputed in the backward."""
    cin = [w.to(cfg.dtype) for w in params["cin"]]
    cin_out = params["cin_out"].to(cfg.dtype)
    rows = cin_chunk_rows(cfg)

    def chunks(x0, cin_out, *cin):
        x0t = x0.transpose(0, 1)                          # (m, B, D)
        pieces = [common._recorded(_cin_rows,
                                   x0t[:, s:s + rows].contiguous(),
                                   cin_out, *cin)
                  for s in range(0, x0.shape[0], rows)]
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces)
    return common.per_rank(chunks, (x0,), (cin_out, *cin))


def _dnn(x0, params, cfg: XDeepFMConfig):
    h = x0.reshape(x0.shape[0], -1)
    for lp in params["mlp"]:
        h = torch.relu(h @ lp["w"].to(cfg.dtype) + lp["b"].to(cfg.dtype))
    return h


def xdeepfm_logits(params, ids, cfg: XDeepFMConfig):
    """ids: (B, n_fields) int offset ids -> CTR logits (B,), float32."""
    x0 = _lookup(params, ids, cfg)
    linear = common.settle_partial(
        params["linear"][ids.long()]).sum(dim=-1)
    cin = _cin(x0, params, cfg)
    h = _dnn(x0, params, cfg)
    dnn = (h @ params["mlp_out"].to(cfg.dtype))[:, 0]
    return linear.float() + cin.float() + dnn.float() + params["bias"]


def retrieval_scores(params, ids, cfg: XDeepFMConfig):
    """Score a few query rows against the whole item matrix: ids ``(B,
    n_fields)`` -> ``(B, n_items)`` scores, one matrix product (never a
    loop over candidates)."""
    x0 = _lookup(params, ids, cfg)
    h = _dnn(x0, params, cfg)
    u = h @ params["user_proj"].to(cfg.dtype)             # (B, dr)
    return u @ params["item_embed"].to(cfg.dtype).T


def bce_loss(logits, labels):
    """Mean binary cross entropy of ``logits`` (computed in float32)."""
    logits = logits.float()
    return torch.mean(torch.maximum(logits, torch.zeros_like(logits))
                      - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))
