"""Cell construction: one (architecture x input-shape) dry-run unit
(counterpart of :mod:`repro.launch.cells`).

A :class:`Cell` bundles a step function, abstract arguments (meta
tensors of the global shapes, so building a cell allocates nothing and
runs no initializer) and their partition specs
(:class:`~repro_torch.distributed.sharding.P`) on a mesh: everything
:func:`trace_cell` needs to run the step once on fake ``DTensor`` shards
over fake ranks, and everything :mod:`repro_torch.roofline.analysis`
needs for the three roofline terms.  The same cell runs for real on one
card (:func:`real_args` on a one-rank mesh), where its specs change
nothing.

Each cell's step is the port's own: ``build_lm_trainer``'s step for
``train_4k``, ``Transformer.prefill`` / ``decode_step`` for serving, the
GNN, recsys and equivariant forward plus loss then the in-place AdamW
step (``adamw.apply_updates_``) for training.  Compute dtypes are those
``chip_smoke.py`` runs: bfloat16 products for the LM cells, float32 with
TF32 off for the rest.

Of the reference's keywords, ``roofline_variant`` is gone: it built
single-trip loops so that XLA, which counts a loop body once, would count
them; a trace counts every trip.  ``layer_override``,
``edge_chunk_override``, ``edges_override`` and ``config_patch`` remain:
each changes the traced program.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.configs import get_arch
from repro_torch.distributed.sharding import (P, axis_names, batch_axes,
                                              local_shape, mesh_size,
                                              model_axis_size, placements)
from repro_torch.models import equivariant as eqv
from repro_torch.models import gnn as gnnlib
from repro_torch.models import recsys as rslib
from repro_torch.models import transformer as tflib
from repro_torch.optim import adamw

OPT_CFG = adamw.AdamWConfig()


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_id: str
    kind: str                       # train | prefill | decode | serve | eval
    fn: Callable
    abstract_args: tuple            # meta tensors (global shapes)
    in_shardings: Any               # specs congruent with abstract_args
    out_shardings: Any
    meta: dict
    # name of an integer input -> its values' bound (random real inputs)
    int_high: dict = dataclasses.field(default_factory=dict)


def _sds(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _round_up(n, m):
    return -(-n // m) * m


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _opt_shape(params_shape):
    return {"m": _tree_map(lambda t: _sds(t.shape, t.dtype), params_shape),
            "v": _tree_map(lambda t: _sds(t.shape, t.dtype), params_shape),
            "step": _sds((), torch.int32)}


def _opt_spec(pspec):
    return {"m": pspec, "v": pspec, "step": P()}


def _replicated(tree):
    return _tree_map(lambda _: P(), tree)


def _train_step(forward, loss_of):
    """forward + loss, the gradients of every parameter (zeros for a leaf
    the loss does not reach, as JAX gives), then the in-place AdamW
    step."""
    def train_step(params, opt_state, batch):
        leaves = adamw._leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_of(forward(params, batch), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        by_id = {id(p): torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)}
        metrics = adamw.apply_updates_(
            params, adamw._map(lambda p: by_id[id(p)], params), opt_state,
            OPT_CFG)
        return params, opt_state, {"loss": loss.detach(), **metrics}
    return train_step


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

LM_SHAPE_DEFS = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


def _lm_param_spec(name):
    last = name.split(".")[-1]
    if last == "embed":
        return P("model", None)
    if last == "unembed":
        return P(None, "model")
    if last in ("wq", "w_gate", "w_up", "ws_gate", "ws_up"):
        return P(None, None, "model")
    if last in ("wo", "w_down", "ws_down"):
        return P(None, "model", None)
    if last == "bq":
        return P(None, "model")
    if last in ("we_gate", "we_up", "we_down"):
        return P(None, "model", None, None)      # expert-parallel
    return P()       # ln/bias/kv (replicated kv: Megatron GQA convention)


def _lm_params(cfg):
    """The parameter tree in the reference's layout (meta tensors) and its
    specs."""
    tree, spec = {"layers": {}}, {"layers": {}}
    for name, (shape, _) in tflib.param_shapes(cfg).items():
        if name.startswith("layers."):
            key = name[len("layers."):]
            tree["layers"][key] = _sds(shape, torch.float32)
            spec["layers"][key] = _lm_param_spec(name)
        else:
            tree[name] = _sds(shape, torch.float32)
            spec[name] = _lm_param_spec(name)
    return tree, spec


def _lm_cell(arch_id: str, shape_id: str, mesh, *,
             layer_override: Optional[int] = None,
             config_patch: Optional[dict] = None) -> Cell:
    from repro_torch.launch.train import build_lm_trainer

    spec = get_arch(arch_id)
    cfg = spec.config.with_mesh(model_axis_size(mesh))
    if config_patch:
        cfg = dataclasses.replace(cfg, **config_patch)
    if layer_override is not None:
        cfg = dataclasses.replace(cfg, n_layers=layer_override)
    cfg = cfg.ensure_padded()
    sd = LM_SHAPE_DEFS[shape_id]
    seq, gb, kind = sd["seq_len"], sd["global_batch"], sd["kind"]
    bax = batch_axes(mesh)
    params_shape, pspec = _lm_params(cfg)
    n_active = cfg.active_param_count()
    meta = dict(model_params=cfg.param_count(), active_params=n_active,
                scan_axis="layers", n_layers=cfg.n_layers,
                compute_dtype=cfg.dtype)
    high = {"tokens": cfg.vocab_size, "labels": cfg.vocab_size}

    if kind == "train":
        batch_shape = {"tokens": _sds((gb, seq), torch.int32),
                       "labels": _sds((gb, seq), torch.int32)}
        bspec = {"tokens": P(bax, None), "labels": P(bax, None)}

        def train_step(params, opt_state, batch):
            model = tflib.Transformer.from_params(cfg, params)
            metrics = build_lm_trainer(model, OPT_CFG)(opt_state, batch)
            return params, opt_state, metrics

        meta["model_flops"] = 6.0 * n_active * gb * seq
        meta["tokens"] = gb * seq
        return Cell(arch_id, shape_id, kind, train_step,
                    (params_shape, _opt_shape(params_shape), batch_shape),
                    (pspec, _opt_spec(pspec), bspec),
                    (pspec, _opt_spec(pspec), None), meta, high)

    # serving cells share the cache layout: batch->data, seq->model
    kv = (cfg.n_layers, gb, seq, cfg.n_kv_heads, cfg.d_head)
    cache_shape = {"k": _sds(kv, cfg.dtype), "v": _sds(kv, cfg.dtype),
                   "pos": _sds((), torch.int32)}
    if gb == 1:
        # long context: the sequence shards over every axis
        kv_spec = P(None, None, axis_names(mesh), None, None)
    else:
        kv_spec = P(None, bax, "model", None, None)
    cspec = {"k": kv_spec, "v": kv_spec, "pos": P()}

    if kind == "prefill":
        def prefill_step(params, tokens, cache):
            model = tflib.Transformer.from_params(cfg, params)
            return model.prefill(tokens, {"k": cache["k"],
                                          "v": cache["v"], "pos": 0})

        meta["model_flops"] = 2.0 * n_active * gb * seq
        meta["tokens"] = gb * seq
        return Cell(arch_id, shape_id, kind, prefill_step,
                    (params_shape, _sds((gb, seq), torch.int32),
                     cache_shape),
                    (pspec, P(bax, None), cspec), (cspec, None), meta, high)

    tspec = P(bax) if gb > 1 else P()

    def decode(params, tokens, cache):
        # the trace cannot read the cache's position: decode the last one,
        # the attention over the whole cache that the cell sizes
        model = tflib.Transformer.from_params(cfg, params)
        return model.decode_step(tokens, {"k": cache["k"], "v": cache["v"],
                                          "pos": seq - 1})

    meta["model_flops"] = 2.0 * n_active * gb \
        + 2.0 * gb * seq * cfg.n_heads * cfg.d_head * 2  # attn vs cache
    meta["tokens"] = gb
    return Cell(arch_id, shape_id, kind, decode,
                (params_shape, _sds((gb,), torch.int32), cache_shape),
                (pspec, tspec, cspec), (tspec, None, cspec), meta, high)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

GNN_SHAPE_DEFS = {
    # n_nodes/n_edges padded to multiples of 512 (shards over 32 and 128)
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433,
                          n_classes=7, kind="train"),
    "minibatch_lg": dict(batch_nodes=1024, fanout=(15, 10), d_feat=602,
                         n_classes=41, kind="train"),
    "ogb_products": dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100,
                         n_classes=47, kind="train"),
    "molecule": dict(n_graphs=128, nodes_per=30, edges_per=64, d_feat=16,
                     n_classes=8, kind="train"),
}


def _gnn_graph_dims(shape_id):
    sd = GNN_SHAPE_DEFS[shape_id]
    if shape_id == "minibatch_lg":
        b = sd["batch_nodes"]
        f1, f2 = sd["fanout"]
        n_nodes = b * (1 + f1 + f1 * f2)
        n_edges = b * f1 + b * f1 * f2
    elif shape_id == "molecule":
        n_nodes = sd["n_graphs"] * sd["nodes_per"]
        n_edges = sd["n_graphs"] * sd["edges_per"]
    else:
        n_nodes, n_edges = sd["n_nodes"], sd["n_edges"]
    return _round_up(n_nodes, 512), _round_up(n_edges, 512), sd


def _batch_spec(mesh, batch_shape, lead=None):
    """Each batch array sharded on its leading dim over the batch axes
    (only those whose leading dim is in ``lead`` when given)."""
    bax = batch_axes(mesh)
    return {k: (P(bax, *((None,) * (v.dim() - 1)))
                if v.dim() and (lead is None or v.shape[0] in lead)
                else P())
            for k, v in batch_shape.items()}


def _gnn_layer_shapes(cfg, names):
    dims = gnnlib._dims(cfg)
    return {"layers": [
        {**{w: _sds((dims[i], dims[i + 1]), torch.float32) for w in names},
         "b": _sds((dims[i + 1],), torch.float32)}
        for i in range(cfg.n_layers)]}


def _gnn_cell(arch_id: str, shape_id: str, mesh, *,
              layer_override: Optional[int] = None,
              edge_chunk_override: Optional[int] = None,
              edges_override: Optional[int] = None,
              config_patch: Optional[dict] = None) -> Cell:
    spec = get_arch(arch_id)
    if config_patch:
        spec = dataclasses.replace(
            spec, config=dataclasses.replace(spec.config, **config_patch))
    n_nodes, n_edges, sd = _gnn_graph_dims(shape_id)
    equivariant = arch_id in ("nequip", "equiformer-v2")
    sage_sampled = (arch_id == "graphsage-reddit"
                    and shape_id == "minibatch_lg")

    if equivariant:
        cfg = spec.config
        # edge buffers rounded to the chunk size so chunking divides evenly
        n_edges = _round_up(n_edges, 16384)
        if edges_override is not None:
            n_edges = edges_override
        if edge_chunk_override is not None:
            cfg = dataclasses.replace(cfg, edge_chunk=edge_chunk_override)
        if layer_override is not None:
            cfg = dataclasses.replace(cfg, n_layers=layer_override)
        n_graphs = sd.get("n_graphs", 1)
        i32 = torch.int32
        batch_shape = {
            "positions": _sds((n_nodes, 3), torch.float32),
            "species": _sds((n_nodes,), i32),
            "edge_src": _sds((n_edges,), i32),
            "edge_dst": _sds((n_edges,), i32),
            "edge_mask": _sds((n_edges,), torch.bool),
            "node_mask": _sds((n_nodes,), torch.bool),
            "graph_id": _sds((n_nodes,), i32),
            "targets": _sds((n_graphs,), torch.float32),
        }
        bspec = _batch_spec(mesh, batch_shape, lead=(n_nodes, n_edges))
        params_shape = eqv._draw(eqv._layout(cfg),
                                 lambda shape, _: _sds(shape, torch.float32))
        fwd = (eqv.nequip_forward if arch_id == "nequip"
               else eqv.equiformer_forward)
        pspec = _replicated(params_shape)
        step = _train_step(
            lambda p, batch: fwd(p, batch, cfg, n_graphs=n_graphs),
            lambda out, batch: eqv.energy_loss(out, batch["targets"]))
        meta = dict(n_layers=cfg.n_layers, scan_axis=None,
                    model_flops=_equivariant_flops(arch_id, cfg, n_edges,
                                                   n_nodes),
                    tokens=n_nodes, compute_dtype=cfg.dtype)
        high = {"species": cfg.n_species, "edge_src": n_nodes,
                "edge_dst": n_nodes, "graph_id": n_graphs}
        return Cell(arch_id, shape_id, "train", step,
                    (params_shape, _opt_shape(params_shape), batch_shape),
                    (pspec, _opt_spec(pspec), bspec),
                    (pspec, _opt_spec(pspec), None), meta, high)

    # gcn / graphsage
    cfg = dataclasses.replace(spec.config, d_in=sd["d_feat"],
                              n_classes=sd["n_classes"])
    if layer_override is not None:
        cfg = dataclasses.replace(cfg, n_layers=max(layer_override, 2))

    if sage_sampled:
        b = sd["batch_nodes"]
        f1, f2 = sd["fanout"]
        d = sd["d_feat"]
        f32 = torch.float32
        batch_shape = {
            "x0": _sds((b, d), f32),
            "x1": _sds((b, f1, d), f32),
            "x2": _sds((b, f1, f2, d), f32),
            "m1": _sds((b, f1), torch.bool),
            "m2": _sds((b, f1, f2), torch.bool),
            "labels": _sds((b,), torch.int32),
        }
        params_shape = _gnn_layer_shapes(cfg, gnnlib._WEIGHTS["graphsage"])

        def forward(p, batch):
            return gnnlib.sage_forward_sampled(p, batch, cfg)

        def loss_of(out, batch):
            ones = torch.ones_like(batch["labels"], dtype=torch.bool)
            return gnnlib.node_classification_loss(out, batch["labels"],
                                                   ones)[0]

        flops = 6.0 * (b * (1 + f1) * 2 * d * cfg.d_hidden
                       + b * 2 * cfg.d_hidden * cfg.n_classes)
        high = {"labels": cfg.n_classes}
    else:
        batch_shape = {
            "node_feat": _sds((n_nodes, sd["d_feat"]), torch.float32),
            "edge_src": _sds((n_edges,), torch.int32),
            "edge_dst": _sds((n_edges,), torch.int32),
            "edge_mask": _sds((n_edges,), torch.bool),
            "node_mask": _sds((n_nodes,), torch.bool),
            "labels": _sds((n_nodes,), torch.int32),
        }
        kind = "gcn" if arch_id == "gcn-cora" else "graphsage"
        params_shape = _gnn_layer_shapes(cfg, gnnlib._WEIGHTS[kind])
        fwd = (gnnlib.gcn_forward if kind == "gcn"
               else gnnlib.sage_forward_full)

        def forward(p, batch):
            return fwd(p, batch, cfg)

        def loss_of(out, batch):
            return gnnlib.node_classification_loss(out, batch["labels"],
                                                   batch["node_mask"])[0]

        dims = [sd["d_feat"]] + [cfg.d_hidden] * (cfg.n_layers - 1) \
            + [sd["n_classes"]]
        flops = 6.0 * sum(n_nodes * dims[i] * dims[i + 1]
                          for i in range(cfg.n_layers)) \
            + 6.0 * sum(2 * n_edges * dims[i + 1]
                        for i in range(cfg.n_layers))
        high = {"edge_src": n_nodes, "edge_dst": n_nodes,
                "labels": cfg.n_classes}

    bspec = _batch_spec(mesh, batch_shape)
    pspec = _replicated(params_shape)
    meta = dict(n_layers=cfg.n_layers, scan_axis=None, model_flops=flops,
                tokens=n_nodes, compute_dtype=cfg.dtype)
    return Cell(arch_id, shape_id, "train", _train_step(forward, loss_of),
                (params_shape, _opt_shape(params_shape), batch_shape),
                (pspec, _opt_spec(pspec), bspec),
                (pspec, _opt_spec(pspec), None), meta, high)


def _equivariant_flops(arch_id, cfg, n_edges, n_nodes):
    C = cfg.d_hidden
    if arch_id == "nequip":
        paths = len(cfg.paths)
        per_edge = sum(2 * (2 * l1 + 1) * (2 * l2 + 1) * (2 * l3 + 1) * C
                       for (l1, l2, l3) in cfg.paths) \
            + 2 * cfg.n_rbf * cfg.radial_hidden \
            + 2 * cfg.radial_hidden * paths * C
        per_node = 2 * ((cfg.l_max + 1) ** 2) * C * C * 2
        return 3.0 * cfg.n_layers * (n_edges * per_edge + n_nodes * per_node)
    # equiformer: wigner rotate (2x block-diag matmuls) + SO(2) mixes
    rot = 2 * sum((2 * l + 1) ** 2 for l in range(cfg.l_max + 1)) * C * 2
    so2 = 2 * ((cfg.l_max + 1) * C) ** 2 \
        + sum(4 * 2 * ((cfg.l_max + 1 - m) * C) ** 2
              for m in range(1, cfg.m_max + 1))
    per_node = 2 * ((cfg.l_max + 1) ** 2) * C * C * 6
    return 3.0 * cfg.n_layers * (n_edges * (rot + so2) + n_nodes * per_node)


# ---------------------------------------------------------------------------
# recsys cells
# ---------------------------------------------------------------------------

RECSYS_SHAPE_DEFS = {
    "train_batch": dict(batch=65536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262144, kind="serve"),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000,
                           kind="retrieval"),
}


def _recsys_spec(path, leaf):
    if path in ("embed", "item_embed"):
        return P("model", None)
    if path == "linear":
        return P("model")
    return P()


def _recsys_cell(arch_id: str, shape_id: str, mesh, *,
                 layer_override: Optional[int] = None,
                 config_patch: Optional[dict] = None) -> Cell:
    spec = get_arch(arch_id)
    cfg = spec.config
    if config_patch:
        cfg = dataclasses.replace(cfg, **config_patch)
    sd = RECSYS_SHAPE_DEFS[shape_id]
    b = sd["batch"]
    bax = batch_axes(mesh)
    params_shape = rslib._build(cfg, lambda shape, _: _sds(shape,
                                                          torch.float32),
                                lambda shape: _sds(shape, torch.float32))
    pspec = {k: (_tree_map(lambda _: P(), v) if isinstance(v, (list, dict))
                 else _recsys_spec(k, v))
             for k, v in params_shape.items()}
    m, D = cfg.n_fields, cfg.embed_dim
    cin_flops = 0
    h_prev = m
    for h in cfg.cin_layers:
        cin_flops += 2 * b * h * h_prev * m * D
        h_prev = h
    mlp_flops = 2 * b * m * D * cfg.mlp_dims[0] \
        + 2 * b * cfg.mlp_dims[0] * cfg.mlp_dims[1]
    fwd_flops = cin_flops + mlp_flops

    ids_shape = _sds((b, cfg.n_fields), torch.int32)
    ids_spec = P(bax, None) if b > 1 else P()
    high = {"ids": cfg.total_vocab}
    base = dict(scan_axis=None, n_layers=len(cfg.cin_layers),
                compute_dtype=cfg.dtype)

    if sd["kind"] == "train":
        batch_shape = {"ids": ids_shape,
                       "labels": _sds((b,), torch.float32)}
        bspec = {"ids": ids_spec, "labels": P(bax)}
        step = _train_step(
            lambda p, batch: rslib.xdeepfm_logits(p, batch["ids"], cfg),
            lambda out, batch: rslib.bce_loss(out, batch["labels"]))
        meta = dict(model_flops=3.0 * fwd_flops, tokens=b, **base)
        return Cell(arch_id, shape_id, "train", step,
                    (params_shape, _opt_shape(params_shape), batch_shape),
                    (pspec, _opt_spec(pspec), bspec),
                    (pspec, _opt_spec(pspec), None), meta, high)

    if sd["kind"] == "retrieval":
        def retrieve(params, ids):
            with torch.no_grad():
                return rslib.retrieval_scores(params, ids, cfg)

        meta = dict(model_flops=fwd_flops + 2.0 * b * sd["n_candidates"]
                    * cfg.retrieval_dim,
                    tokens=b * sd["n_candidates"], **base)
        return Cell(arch_id, shape_id, "retrieval", retrieve,
                    (params_shape, ids_shape), (pspec, ids_spec),
                    P(None, "model"), meta, high)

    def serve(params, ids):
        with torch.no_grad():
            return rslib.xdeepfm_logits(params, ids, cfg)

    meta = dict(model_flops=fwd_flops, tokens=b, **base)
    return Cell(arch_id, shape_id, "serve", serve,
                (params_shape, ids_shape), (pspec, ids_spec),
                P(bax) if b > 1 else P(), meta, high)


# ---------------------------------------------------------------------------
# readability (the paper's own workload) cells
# ---------------------------------------------------------------------------

def readability_cell(shape_id: str, mesh,
                     dataset: str = "soc-Epinions1", *,
                     predicate: str = "sign"):
    """The paper's technique as one rank's program on the mesh: the
    row-sharded exact sweeps and the strip-sharded reversal count at a
    paper dataset's size."""
    from repro_torch.configs.readability import dataset_dims
    from repro_torch.distributed.gridded import lower_sharded_reversal
    from repro_torch.distributed.pairwise import (lower_sharded_crossing,
                                                  lower_sharded_occlusion)
    n_v, n_e = dataset_dims(dataset)
    n_dev = mesh_size(mesh)
    if shape_id == "exact_occlusion":
        fn, args = lower_sharded_occlusion(mesh, n_v, 0.5, block=1024)
        flops = 4.0 * n_v * n_v        # dx,dy,squares,cmp per pair
        tokens = n_v
    elif shape_id == "exact_crossing":
        fn, args = lower_sharded_crossing(mesh, n_e, block=256,
                                          predicate=predicate)
        flops = 30.0 * n_e * n_e       # 4 CCW x ~7 flops + predicates
        tokens = n_e
    elif shape_id == "enhanced_crossing":
        # paper-scale strips: width ~0.05 on [0,100] -> 2048 strips;
        # segments ~ E x mean-span; cap ~ max per-strip occupancy
        n_strips, cap = 2048, _round_up(int(3.0 * n_e / 2048) + 64, 128)
        per = _round_up(n_strips, n_dev) // n_dev
        fn, args = lower_sharded_reversal(mesh, n_strips, cap,
                                          strip_block=min(64, per))
        flops = 6.0 * n_strips * cap * cap
        tokens = n_e
    else:
        raise KeyError(shape_id)
    meta = dict(model_flops=flops, tokens=tokens, scan_axis=None,
                n_layers=1, dataset=dataset, compute_dtype=torch.float32)
    return Cell("readability", shape_id, "eval", fn, args, None, None, meta)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def make_cell(arch_id: str, shape_id: str, mesh, *,
              layer_override: Optional[int] = None,
              edge_chunk_override: Optional[int] = None,
              edges_override: Optional[int] = None,
              config_patch: Optional[dict] = None) -> Cell:
    """The cell of ``arch_id`` x ``shape_id`` on ``mesh`` (a
    ``DeviceMesh`` or a compat ``Mesh``).  For ``"readability"``,
    ``config_patch`` holds :func:`readability_cell`'s keywords."""
    if arch_id == "readability":
        return readability_cell(shape_id, mesh, **dict(config_patch or {}))
    family = get_arch(arch_id).family
    maker = {"lm": _lm_cell, "gnn": _gnn_cell, "recsys": _recsys_cell}[family]
    kw = dict(layer_override=layer_override, config_patch=config_patch)
    if family == "gnn":
        kw["edge_chunk_override"] = edge_chunk_override
        kw["edges_override"] = edges_override
    return maker(arch_id, shape_id, mesh, **kw)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _zip_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, None if specs is None else specs[k])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, None if specs is None else s)
                          for v, s in zip(tree, specs if specs is not None
                                          else [None] * len(tree)))
    return fn(tree, specs)


def fake_args(cell: Cell, mesh, device):
    """The cell's arguments as fake tensors (call under a
    ``FakeTensorMode``): ``DTensor`` s of rank 0's shards on a
    ``DeviceMesh``, plain tensors where a cell has no specs."""
    from torch.distributed.tensor import DTensor

    def leaf(t, spec):
        shape = tuple(t.shape)
        if spec is None:
            return torch.empty(shape, dtype=t.dtype, device=device)
        local = torch.empty(local_shape(mesh, shape, spec), dtype=t.dtype,
                            device=device)
        stride = [1] * len(shape)
        for d in range(len(shape) - 2, -1, -1):
            stride[d] = stride[d + 1] * shape[d + 1]
        return DTensor.from_local(local, mesh, placements(mesh, spec),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=tuple(stride))
    return _zip_map(leaf, cell.abstract_args, cell.in_shardings)


def real_args(cell: Cell, device, generator: torch.Generator):
    """The cell's arguments as real tensors on ``device`` for a one-rank
    run, drawn from ``generator`` (a CPU generator): floats normal with
    scale 0.02, the AdamW moments zero, masks all True, integers uniform
    below their bound in ``cell.int_high``."""
    def leaf(t, name):
        shape, dtype = tuple(t.shape), t.dtype
        if dtype == torch.bool:
            return torch.ones(shape, dtype=dtype, device=device)
        if dtype.is_floating_point:
            if name in ("m", "v"):
                return torch.zeros(shape, dtype=dtype, device=device)
            x = torch.randn(shape, generator=generator) * 0.02
            return x.to(device, dtype)
        high = cell.int_high.get(name, 1)
        return torch.randint(0, max(high, 1), shape, generator=generator,
                             dtype=torch.int64).to(device, dtype)

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k if name not in ("m", "v") else name)
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, name) for v in tree)
        return leaf(tree, name)
    return walk(cell.abstract_args, None)


def trace_cell(cell: Cell, mesh) -> dict:
    """Run the cell's step once on fake shards over the mesh's (fake)
    ranks under :class:`~repro_torch.roofline.analysis.CostRecorder`:
    nothing is allocated.  Returns rank 0's ``flops``, ``bytes
    accessed``, ``argument_bytes``, ``output_bytes``, ``peak_bytes``,
    ``collectives`` (ring bytes by kind, their ``total`` and ``seconds``
    at the links' rates), ``replicated`` (ops run on replicated inputs
    for want of a DTensor rule) and ``trace_s``."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.roofline.analysis import (CostRecorder,
                                               ReplicatingCalls,
                                               ReplicatingOps,
                                               collective_bytes,
                                               collective_seconds)

    def local(tree):
        return [t._local_tensor if isinstance(t, DTensor) else t
                for t in _leaves(tree)]

    t0 = time.perf_counter()
    rec = CostRecorder()
    with rec:
        args = fake_args(cell, mesh, mesh.device_type)
        arg_locals = local(args)
        arg_bytes = rec.storage_bytes(arg_locals)
        for t in arg_locals:
            rec.track(t)
        with ReplicatingCalls(rec), ReplicatingOps(rec), \
                implicit_replication():
            out = cell.fn(*args)
        trips = rec.trip_cache
        trips.check()
        out_bytes = rec.storage_bytes(local(out))
    coll = collective_bytes(rec.collectives)
    coll["seconds"] = collective_seconds(rec.collectives)
    return {"flops": rec.flops, "bytes accessed": rec.bytes,
            "argument_bytes": arg_bytes, "output_bytes": out_bytes,
            "peak_bytes": rec.peak, "collectives": coll,
            "n_collectives": len(rec.collectives),
            "replicated": sorted(rec.replicated),
            "trips": {"run": trips.ran, "replayed": trips.replayed},
            "trace_s": time.perf_counter() - t0}


def argument_bytes(cell: Cell) -> int:
    """Global bytes of the cell's arguments (every leaf counted once)."""
    return sum(t.numel() * t.element_size()
               for t in _leaves(cell.abstract_args))


def readability_args(cell: Cell, mesh, device, generator: torch.Generator,
                     *, extent: float = 100.0):
    """Real arguments of a readability cell for this rank of ``mesh``: a
    uniform random layout of the dataset's size on ``[0, extent)^2`` with
    random edges (exact cells; padding invalid) or random strip buckets
    (``enhanced_crossing``: ordinates and angles uniform, endpoint ids
    below ``|V|``, nine slots in ten valid), from ``generator`` (CPU)."""
    from repro_torch.configs.readability import dataset_dims
    from repro_torch.distributed.sharding import mesh_rank

    n_v, n_e = dataset_dims(cell.meta["dataset"])
    g = generator

    def put(t):
        return t.to(device)

    if cell.shape_id == "enhanced_crossing":
        shape = tuple(cell.abstract_args[0].shape)
        yl, yr = (torch.rand(shape, generator=g) * extent for _ in "lr")
        theta = torch.rand(shape, generator=g) * math.pi
        v, u = (torch.randint(0, n_v, shape, generator=g,
                              dtype=torch.int32) for _ in "vu")
        valid = torch.rand(shape, generator=g) < 0.9
        return tuple(map(put, (yl, yr, theta, v, u, valid)))
    pos = torch.rand((n_v, 2), generator=g) * extent
    if cell.shape_id == "exact_occlusion":
        rows_per, n_pad = cell.abstract_args[0].shape[1], \
            cell.abstract_args[3].shape[0]
        x, y = (torch.zeros(n_pad) for _ in "xy")
        ok = torch.zeros(n_pad, dtype=torch.bool)
        x[:n_v], y[:n_v], ok[:n_v] = pos[:, 0], pos[:, 1], True
        r0 = mesh_rank(mesh) * rows_per
        rows = slice(r0, r0 + rows_per)
        # a rank's shards are tensors of their own, as on a real rank
        return tuple(put(t[rows][None].clone()) for t in (x, y, ok)) \
            + tuple(map(put, (x, y, ok)))
    sh_meta, rep_meta = cell.abstract_args
    per, e_pad = sh_meta[0].shape[1], rep_meta[0].shape[0]
    v = torch.randint(0, n_v, (n_e,), generator=g)
    u = (v + torch.randint(1, n_v, (n_e,), generator=g)) % n_v
    rep = [torch.zeros(e_pad) for _ in range(4)]
    for k, (ends, col) in enumerate(((v, 0), (v, 1), (u, 0), (u, 1))):
        rep[k][:n_e] = pos[ends, col]
    vv = torch.full((e_pad,), -1, dtype=torch.int32)
    uu = torch.full((e_pad,), -2, dtype=torch.int32)
    vv[:n_e], uu[:n_e] = v.to(torch.int32), u.to(torch.int32)
    ok = torch.zeros(e_pad, dtype=torch.bool)
    ok[:n_e] = True
    rep += [vv, uu, ok]
    r0 = mesh_rank(mesh) * per
    sh = tuple(put(a[r0:r0 + per][None].clone()) for a in rep)
    return sh, tuple(map(put, rep))
