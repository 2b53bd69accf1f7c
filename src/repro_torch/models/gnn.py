"""Message-passing GNNs: GCN (gcn-cora) and GraphSAGE (graphsage-reddit)
(counterpart of :mod:`repro.models.gnn`).

Message passing is a gather (``h[src]``) and a scatter-add
(``index_add``) over an edge index, as the reference builds it from
``jnp.take`` and ``jax.ops.segment_sum``.  Two execution modes:

  * ``full`` -- full-graph edge-list aggregation (full_graph_sm,
    ogb_products): edge lists with an edge mask, stored edges treated as
    undirected (both directions aggregated).
  * ``sampled`` -- GraphSAGE fanout mini-batches as dense ``(B, f1, f2,
    d)`` neighbour tensors from :mod:`repro_torch.graphs.sampler`
    (minibatch_lg).

Parameters are the reference's pytree (``{"layers": [{...}, ...]}``) of
float32 tensors, cast to ``cfg.dtype`` at each use; models are plain
functions ``f(params, batch, cfg)`` of tensors.  :func:`init_gcn_params`
and :func:`init_sage_params` draw from a ``torch.Generator`` (other
numbers than the reference's ``jax.random`` key); :func:`numpy_params`
draws the reference's layout from ``numpy.random.default_rng(seed)``,
which both packages load (:func:`params_from_reference`).  Graph
batches are dicts of tensors (:mod:`repro_torch.graphs.format` makes
them in numpy).

CUDA's ``index_add`` sums with atomics in no fixed order, so on the
card a node's aggregate may differ from the CPU's in the last bits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.models import common
from repro_torch.models.common import params_from_reference  # noqa: F401


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    """The reference's :class:`repro.models.gnn.GNNConfig`, field for
    field; ``dtype`` is a torch dtype."""

    name: str
    kind: str                    # 'gcn' | 'graphsage'
    n_layers: int
    d_in: int
    d_hidden: int
    n_classes: int
    aggregator: str = "mean"
    norm: str = "sym"            # gcn: symmetric degree normalization
    sample_sizes: Sequence[int] = ()
    dtype: Any = torch.float32


def _dims(cfg: GNNConfig):
    return [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]


_WEIGHTS = {"gcn": ("w",), "graphsage": ("w_self", "w_nbr")}


def _init(cfg: GNNConfig, generator: torch.Generator, names):
    dims = _dims(cfg)
    return {"layers": [
        {**{w: common.dense_init(generator, dims[i], dims[i + 1])
            for w in names},
         "b": torch.zeros(dims[i + 1], device=generator.device)}
        for i in range(cfg.n_layers)]}


def init_gcn_params(cfg: GNNConfig, generator: torch.Generator):
    """GCN parameters drawn from ``generator`` on its device: per layer
    ``w`` (``dense_init``) and a zero ``b``."""
    return _init(cfg, generator, _WEIGHTS["gcn"])


def init_sage_params(cfg: GNNConfig, generator: torch.Generator):
    """GraphSAGE parameters drawn from ``generator`` on its device: per
    layer ``w_self`` and ``w_nbr`` (``dense_init``) and a zero ``b``."""
    return _init(cfg, generator, _WEIGHTS["graphsage"])


def numpy_params(cfg: GNNConfig, seed: int) -> dict:
    """Parameters of ``cfg.kind`` in the reference's pytree layout as
    numpy float32 arrays from ``numpy.random.default_rng(seed)``, at the
    reference's scales (``(1 / d_in) ** 0.5``, normals clipped to +-2;
    zero biases): one set of numbers both packages load."""
    rng = np.random.default_rng(seed)
    dims = _dims(cfg)
    return {"layers": [
        {**{w: common.numpy_truncated(rng, (dims[i], dims[i + 1]),
                                      (1.0 / dims[i]) ** 0.5)
            for w in _WEIGHTS[cfg.kind]},
         "b": np.zeros(dims[i + 1], np.float32)}
        for i in range(cfg.n_layers)]}


# ---------------------------------------------------------------------------
# full-graph execution (edge lists + scatter-adds)
# ---------------------------------------------------------------------------

def _segment_sum(vals, seg, n: int):
    """``jax.ops.segment_sum(vals, seg, num_segments=n)``."""
    return vals.new_zeros((n, *vals.shape[1:])).index_add(0, seg, vals)


def _degrees(edge_dst, edge_mask, n_nodes: int):
    return _segment_sum(edge_mask.to(torch.float32), edge_dst, n_nodes)


def _edges(batch):
    return (batch["edge_src"].long(), batch["edge_dst"].long(),
            batch["edge_mask"])


def gcn_forward(params, batch, cfg: GNNConfig):
    """Full-graph GCN: ``h' = act(D^-1/2 (A + I) D^-1/2 h W)`` over the
    stored edges taken as undirected (``0.5 * deg`` for ``norm="sym"``,
    as the reference has it)."""
    x = batch["node_feat"].to(cfg.dtype)
    src, dst, emask = _edges(batch)
    n = x.shape[0]
    deg = _degrees(dst, emask, n) + _degrees(src, emask, n)
    deg = 0.5 * deg if cfg.norm == "sym" else deg
    inv_sqrt = torch.rsqrt(torch.clamp_min(deg, 0.0) + 1.0)
    coef = (inv_sqrt[src] * inv_sqrt[dst])[:, None]
    coef = torch.where(emask[:, None], coef, 0.0)
    layers = params["layers"]
    for i, layer in enumerate(layers):
        h = x @ layer["w"].to(cfg.dtype)
        fwd = _segment_sum(h[src] * coef, dst, n)
        bwd = _segment_sum(h[dst] * coef, src, n)
        agg = fwd + bwd + h * (inv_sqrt * inv_sqrt)[:, None]  # self loop
        agg = agg + layer["b"].to(cfg.dtype)
        x = torch.relu(agg) if i < len(layers) - 1 else agg
    return x


def sage_forward_full(params, batch, cfg: GNNConfig):
    """Full-graph GraphSAGE with mean aggregation over undirected edges."""
    x = batch["node_feat"].to(cfg.dtype)
    src, dst, emask = _edges(batch)
    n = x.shape[0]
    deg = _degrees(dst, emask, n) + _degrees(src, emask, n)
    inv_deg = torch.where(deg > 0, 1.0 / torch.clamp_min(deg, 1.0), 0.0)
    m = emask.to(torch.float32)[:, None]
    layers = params["layers"]
    for i, layer in enumerate(layers):
        mean_nbr = (_segment_sum(x[src] * m, dst, n)
                    + _segment_sum(x[dst] * m, src, n)) * inv_deg[:, None]
        h = (x @ layer["w_self"].to(cfg.dtype)
             + mean_nbr @ layer["w_nbr"].to(cfg.dtype)
             + layer["b"].to(cfg.dtype))
        x = torch.relu(h) if i < len(layers) - 1 else h
    return x


# ---------------------------------------------------------------------------
# sampled execution (dense fanout tensors)
# ---------------------------------------------------------------------------

def sage_forward_sampled(params, batch, cfg: GNNConfig):
    """Two-layer GraphSAGE on a sampled fanout block.

    batch: x0 (B, d), x1 (B, f1, d), x2 (B, f1, f2, d) + masks m1 (B, f1),
    m2 (B, f1, f2).  Returns seed logits (B, n_classes).
    """
    if cfg.n_layers != 2:
        raise ValueError(f"sampled mode implements the 2-layer config; "
                         f"{cfg.name} has {cfg.n_layers}")
    l1, l2 = params["layers"]
    x0, x1, x2, m1, m2 = (batch[k].to(cfg.dtype)
                          for k in ("x0", "x1", "x2", "m1", "m2"))

    def mean_nbr(xn, mask):
        s = (xn * mask[..., None]).sum(dim=-2)
        c = torch.clamp_min(mask.sum(dim=-1, keepdim=True), 1.0)
        return s / c

    def layer(lp, x_self, x_nbr_mean, act=True):
        h = (x_self @ lp["w_self"].to(cfg.dtype)
             + x_nbr_mean @ lp["w_nbr"].to(cfg.dtype)
             + lp["b"].to(cfg.dtype))
        return torch.relu(h) if act else h

    h0 = layer(l1, x0, mean_nbr(x1, m1))              # (B, d_h)
    h1 = layer(l1, x1, mean_nbr(x2, m2))              # (B, f1, d_h)
    return layer(l2, h0, mean_nbr(h1, m1), act=False)  # (B, n_classes)


def node_classification_loss(logits, labels, mask):
    """Masked softmax cross entropy and accuracy (the prediction is the
    first maximal logit, as ``jnp.argmax`` takes it)."""
    mask = mask.to(torch.float32)
    loss = common.softmax_xent(logits, torch.clamp_min(labels, 0), mask)
    pred = torch.argmax(logits, dim=-1)
    acc = ((pred == labels) * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return loss, acc
