"""E(3)-equivariant GNNs: NequIP and EquiformerV2 (eSCN), self-contained
(counterpart of :mod:`repro.models.equivariant`).

* NequIP (arXiv:2101.03164): irrep node features (l <= l_max, C channels),
  interaction = CG tensor product of source features with edge spherical
  harmonics, per-path radial weights from an RBF MLP, gated nonlinearity.

* EquiformerV2 (arXiv:2306.12059): replaces the CG contraction with the
  eSCN trick — rotate each edge's features into the edge-aligned frame
  (Wigner-D from :mod:`repro_torch.models.so3`), apply an SO(2) linear
  mixing that is block-diagonal in |m| and truncated at m_max, rotate
  back.  Attention weights come from the m=0 (scalar) channel via a
  segment softmax over incoming edges.  ``compact_escn`` rotates only
  the |m| <= m_max rows the SO(2) mixing sees: the same values.

The reference's simplifications are kept: single parity per degree,
per-channel radial gates in eSCN, gated activations.

Models are plain functions of a parameter dict of tensors, as
:mod:`repro_torch.models.gnn`'s.  :func:`init_nequip_params` and
:func:`init_equiformer_params` draw from a ``torch.Generator`` on its
device; :func:`numpy_params` draws the reference's layout from
``numpy.random.default_rng(seed)``, which both packages load
(``common.params_from_reference``).  The batch is a dict of tensors:
positions (N, 3), species (N,), edge_src / edge_dst (E,), edge_mask,
node_mask, graph_id (N,).

Gathers along edges are ``index_select`` (its backward is an
``index_add``, where an indexing gather's is a sort).  Edges run in
``_pick_chunks(E, cfg.edge_chunk)`` chunks in the reference's order.
Under autograd each chunk's message function keeps only its inputs and
is recomputed in the backward
(:func:`repro_torch.models.common._recorded`), so a training step's
memory grows with the node state and the per-layer messages, not with
every chunk's Wigner blocks and rotated features.  CUDA's ``index_add``
sums with atomics in no fixed order, so on the card an aggregate may
differ from the CPU's in the last bits.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.models import common, so3


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def _ipow(x, n: int):
    """``x ** n`` by square-and-multiply, the products XLA's
    ``integer_pow`` takes."""
    acc = None
    while n:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n:
            x = x * x
    return acc


def radial_basis(r, n_rbf: int, cutoff: float):
    """Gaussian RBF with a smooth polynomial cutoff envelope."""
    # jnp.linspace's centers may differ from these in the last bit
    centers = torch.linspace(0.0, cutoff, n_rbf, dtype=r.dtype,
                             device=r.device)
    width = r.new_full((), cutoff / n_rbf)
    rb = torch.exp(-_ipow((r[..., None] - centers) / width, 2))
    x = torch.minimum(torch.maximum(r / r.new_full((), cutoff),
                                    r.new_zeros(())), r.new_ones(()))
    env = (1.0 - 10.0 * _ipow(x, 3) + 15.0 * _ipow(x, 4)
           - 6.0 * _ipow(x, 5))  # poly cutoff
    return rb * env[..., None]


def _segment_sum(vals, seg, n: int):
    """``jax.ops.segment_sum(vals, seg, num_segments=n)``."""
    return vals.new_zeros((n, *vals.shape[1:])).index_add(0, seg, vals)


def segment_softmax(logits, segment_ids, num_segments):
    """Numerically-stable softmax over variable-size segments (fp32
    internals) of ``logits`` (E, ...) along dim 0.  An empty segment's
    maximum is ``-inf`` (``scatter_reduce`` without the base), taken as 0
    as in JAX; a segment of masked ``-1e30`` logits gets equal weights."""
    in_dtype = logits.dtype
    logits = logits.to(torch.float32)
    seg = segment_ids.reshape(-1, *([1] * (logits.dim() - 1))).expand_as(
        logits)
    seg_max = logits.new_full((num_segments, *logits.shape[1:]),
                              -torch.inf).scatter_reduce(
        0, seg, logits, "amax", include_self=False)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    ex = torch.exp(logits - seg_max.index_select(0, segment_ids))
    denom = _segment_sum(ex, segment_ids, num_segments)
    return (ex / torch.maximum(denom.index_select(0, segment_ids),
                               ex.new_full((), 1e-9))).to(in_dtype)


def _pick_chunks(n_edges: int, target_chunk: int) -> int:
    """Largest chunk count <= n_edges/target that divides n_edges (static)."""
    n_desired = max(n_edges // max(target_chunk, 1), 1)
    for n in range(n_desired, 0, -1):
        if n_edges % n == 0:
            return n
    return 1


def _mlp2(d_in, d_hidden, d_out):
    """The layout of a two-layer MLP: ``dense_init`` weights, zero
    biases."""
    return {"w1": (d_in, d_hidden), "b1": (d_hidden,),
            "w2": (d_hidden, d_out), "b2": (d_out,)}


def _mlp2_apply(p, x):
    h = F.silu(x @ p["w1"] + p["b1"])
    return h @ p["w2"] + p["b2"]


def energy_loss(energies, targets):
    return torch.mean((energies - targets) ** 2)


def _gated(h, gates, l: int, C: int):
    """silu for the scalars (l = 0), else the l-th block of ``C`` scalar
    gates."""
    if l == 0:
        return F.silu(h)
    return h * gates[:, (l - 1) * C:l * C][:, None, :]


def _with_scalars(scalars, irrep: int):
    """(N, irrep, C) features: ``scalars`` (N, C) at l = 0, zeros
    elsewhere."""
    rest = scalars.new_zeros((scalars.shape[0], irrep - 1, scalars.shape[1]))
    return torch.cat([scalars[:, None, :], rest], dim=1)


def _edge_geometry(pos, src, dst, emask):
    """Edge vectors' length ``r``, unit vectors and the mask without
    degenerate (self / zero-length) edges, which have no direction."""
    vec = pos.index_select(0, src) - pos.index_select(0, dst)
    r = torch.sqrt(torch.maximum(torch.sum(vec * vec, -1),
                                 vec.new_full((), 1e-12)))
    unit = vec / r[:, None]
    return r, unit, emask & (r > 1e-5)


# ---------------------------------------------------------------------------
# NequIP
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    """The reference's :class:`repro.models.equivariant.NequIPConfig`,
    field for field; ``dtype`` is a torch dtype."""

    name: str
    n_layers: int = 5
    d_hidden: int = 32           # channels per degree
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 16
    radial_hidden: int = 64
    edge_chunk: int = 16384
    dtype: Any = torch.float32

    @property
    def irrep_dim(self):
        return (self.l_max + 1) ** 2

    @property
    def paths(self):
        return so3.tp_paths(self.l_max, self.l_max, self.l_max)


def _nequip_layout(cfg: NequIPConfig):
    C = cfg.d_hidden
    deg = (cfg.l_max + 1, C, C)
    return {
        "species_embed": ((cfg.n_species, C), 0.5),
        "layers": [{
            "radial": _mlp2(cfg.n_rbf, cfg.radial_hidden,
                            len(cfg.paths) * C),
            # per-degree channel mixes for self + message
            "w_self": (deg, C ** -0.5),
            "w_msg": (deg, C ** -0.5),
            "gate": (C, cfg.l_max * C),
        } for _ in range(cfg.n_layers)],
        "readout": _mlp2(C, cfg.radial_hidden, 1),
    }


def _nequip_messages(src_feat, Y, radial_w, cfg: NequIPConfig):
    """CG tensor-product messages for one edge chunk.

    src_feat: (E, irrep, C); Y: (E, irrep_filter); radial_w: (E, n_paths*C).
    Returns (E, irrep, C).
    """
    C = cfg.d_hidden
    sl = so3.irrep_slices(cfg.l_max)
    out = [None] * (cfg.l_max + 1)
    for p_idx, (l1, l2, l3) in enumerate(cfg.paths):
        cg = so3.cg_real(l1, l2, l3, device=Y.device, dtype=Y.dtype)
        w = radial_w[:, p_idx * C:(p_idx + 1) * C]
        # einsum("ijk,eic,ej->ekc", cg, x1, y2): the filter first
        t = torch.einsum("ej,ijk->eki", Y[:, sl[l2]], cg)
        m = torch.bmm(t, src_feat[:, sl[l1], :]) * w[:, None, :]
        out[l3] = m if out[l3] is None else out[l3] + m
    return torch.cat(out, dim=1)


def _nequip_chunk(f, s, d, Yc, wc, cfg: NequIPConfig):
    return _segment_sum(_nequip_messages(f.index_select(0, s), Yc, wc, cfg),
                        d, f.shape[0])


def nequip_forward(params, batch, cfg: NequIPConfig, *, n_graphs: int = 1):
    """Per-graph energies (n_graphs,) of ``batch``."""
    pos = batch["positions"].to(cfg.dtype)
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    N = pos.shape[0]
    C = cfg.d_hidden
    sl = so3.irrep_slices(cfg.l_max)

    f = _with_scalars(params["species_embed"].index_select(
        0, batch["species"].long()), cfg.irrep_dim)
    r, unit, emask = _edge_geometry(pos, src, dst, batch["edge_mask"])
    Y = so3.real_sph_harm(unit, cfg.l_max).to(cfg.dtype)     # (E, irrep)
    rbf = radial_basis(r, cfg.n_rbf, cfg.cutoff).to(cfg.dtype)
    w_edge = torch.where(emask[:, None], 1.0, 0.0)

    def messages(src, dst, Y, radial_w, f):
        E = src.shape[0]
        Ec = E // _pick_chunks(E, cfg.edge_chunk)
        agg = None
        for c0 in range(0, E, Ec):
            part = common._recorded(
                _nequip_chunk, f, src[c0:c0 + Ec], dst[c0:c0 + Ec],
                Y[c0:c0 + Ec], radial_w[c0:c0 + Ec], cfg)
            agg = part if agg is None else agg + part
        return agg

    for layer in params["layers"]:
        radial_w = _mlp2_apply(layer["radial"], rbf) * w_edge
        # on sharded edges, each rank sums its own edges' messages
        agg = common.per_rank(messages, (src, dst, Y, radial_w), (f,),
                              out="sum")

        # per-degree self-interaction + message mix, gated nonlinearity
        gates = torch.sigmoid(f[:, 0, :] @ layer["gate"])
        new = [_gated(f[:, sl[l], :] @ layer["w_self"][l]
                      + agg[:, sl[l], :] @ layer["w_msg"][l], gates, l, C)
               for l in range(cfg.l_max + 1)]
        f = f + torch.cat(new, dim=1)

    node_e = _mlp2_apply(params["readout"], f[:, 0, :])[:, 0]
    node_e = torch.where(batch["node_mask"], node_e, 0.0)
    return _segment_sum(node_e, batch["graph_id"].long(), n_graphs)


# ---------------------------------------------------------------------------
# EquiformerV2 (eSCN SO(2) convolutions)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EquiformerConfig:
    """The reference's :class:`repro.models.equivariant.EquiformerConfig`,
    field for field; ``dtype`` is a torch dtype.  ``shard_channels``
    asks the reference to shard the channel dim over a mesh's model
    axis, a layout hint that changes no value: on one device the port
    accepts it and runs the same code."""

    name: str
    n_layers: int = 12
    d_hidden: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_rbf: int = 16
    cutoff: float = 8.0
    n_species: int = 16
    radial_hidden: int = 128
    edge_chunk: int = 4096
    dtype: Any = torch.float32
    # rotate only the |m| <= m_max Wigner rows the SO(2) conv can see:
    # the same output, ~(2l+1)/(2m_max+1) less rotation work per degree
    compact_escn: bool = False
    shard_channels: bool = False

    @property
    def irrep_dim(self):
        return (self.l_max + 1) ** 2


def _m_component_ids(l_max: int, m: int):
    """Flat irrep indices of the (+m) and (-m) components for all l >= |m|."""
    pos = [l * l + l + m for l in range(abs(m), l_max + 1)]
    neg = [l * l + l - m for l in range(abs(m), l_max + 1)]
    return pos, neg


def _compact_layout(l_max: int, m_max: int):
    """Compact eSCN layout: for each l, only components with |m| <= m_max.

    Returns (per-l flat-irrep index lists, per-l compact slices, total)."""
    per_l_ids = []
    per_l_slices = []
    off = 0
    for l in range(l_max + 1):
        mm = min(l, m_max)
        ids = [l * l + l + m for m in range(-mm, mm + 1)]
        per_l_ids.append(ids)
        per_l_slices.append(slice(off, off + len(ids)))
        off += len(ids)
    return per_l_ids, per_l_slices, off


def _compact_m_ids(l_max: int, m_max: int, m: int):
    """Indices of (+m, -m) component pairs within the compact layout."""
    _, slices, _ = _compact_layout(l_max, m_max)
    pos, neg = [], []
    for l in range(abs(m), l_max + 1):
        mm = min(l, m_max)
        base = slices[l].start
        pos.append(base + mm + m)
        neg.append(base + mm - m)
    return pos, neg


def _equiformer_layout(cfg: EquiformerConfig):
    C = cfg.d_hidden
    deg = (cfg.l_max + 1, C, C)

    def so2():
        d0 = (cfg.l_max + 1) * C
        out = {"w0": ((d0, d0), d0 ** -0.5)}
        for m in range(1, cfg.m_max + 1):
            d = (cfg.l_max + 1 - m) * C
            out[f"w1_{m}"] = ((d, d), d ** -0.5)
            out[f"w2_{m}"] = ((d, d), d ** -0.5)
        return out

    return {
        "species_embed": ((cfg.n_species, C), 0.5),
        "layers": [{
            "so2": so2(),
            "radial": _mlp2(cfg.n_rbf, cfg.radial_hidden, C),
            "attn": (2 * C, cfg.n_heads),
            "w_out": (deg, C ** -0.5),
            "gate": (C, cfg.l_max * C),
            "ffn_w1": (deg, C ** -0.5),
            "ffn_w2": (deg, C ** -0.5),
            "ffn_gate": (C, cfg.l_max * C),
        } for _ in range(cfg.n_layers)],
        "readout": _mlp2(C, cfg.radial_hidden, 1),
    }


@functools.lru_cache(maxsize=None)
def _index(ids: tuple, device):
    """``ids`` as an int64 tensor on ``device``, made once."""
    return torch.tensor(ids, device=device)


def _so2_mix(x, so2, cfg: EquiformerConfig, m_ids):
    """The eSCN SO(2) mixing of ``x`` (E, K, C) whose components
    ``m_ids(m)`` are the (+m, -m) rows: ``w0`` across (l, C) at m = 0,
    ``(w1_m, w2_m)`` as a complex product on each (+m, -m) pair, every
    other row zero."""
    Ecount, _, C = x.shape

    def rows(ids):
        return x.index_select(1, _index(tuple(ids), x.device)).reshape(
            Ecount, -1)

    ids0, _ = m_ids(0)
    outs = [(ids0, rows(ids0) @ so2["w0"])]
    for m in range(1, cfg.m_max + 1):
        idp, idn = m_ids(m)
        xp, xn = rows(idp), rows(idn)
        w1, w2 = so2[f"w1_{m}"], so2[f"w2_{m}"]
        outs.append((idp, xp @ w1 - xn @ w2))
        outs.append((idn, xp @ w2 + xn @ w1))
    ids = _index(tuple(i for ids_, _ in outs for i in ids_), x.device)
    vals = torch.cat([v.reshape(Ecount, -1, C) for _, v in outs], dim=1)
    return torch.zeros_like(x).index_copy(1, ids, vals)


def _so2_conv_compact(x_c, so2, cfg: EquiformerConfig):
    """eSCN SO(2) mixing on the compact |m| <= m_max layout.

    x_c: (E, compact, C); same weights as :func:`_so2_conv`; exactly the
    same output values on the surviving components."""
    return _so2_mix(x_c, so2, cfg,
                    lambda m: _compact_m_ids(cfg.l_max, cfg.m_max, m))


def _so2_conv(x_rot, so2, cfg: EquiformerConfig):
    """eSCN SO(2) mixing in the edge-aligned frame.

    x_rot: (E, irrep, C). Components with |m| > m_max are dropped (the
    eSCN truncation). Returns (E, irrep, C).
    """
    return _so2_mix(x_rot, so2, cfg,
                    lambda m: _m_component_ids(cfg.l_max, m))


def _rotate(x, Ds, rows, cols, *, transpose=False):
    """Per degree l, ``D_l[rows(l)]`` (or its transpose) times the ``cols(l)``
    slice of ``x`` (E, ., C), concatenated over l."""
    outs = []
    for l, D in enumerate(Ds):
        D = D[:, rows(l), :]
        if transpose:
            D = D.transpose(1, 2)
        outs.append(torch.bmm(D, x[:, cols(l), :]))
    return torch.cat(outs, dim=1)


def _shard_channels(f, cfg: EquiformerConfig):
    """The node state ``(N, irrep, C)`` with its channels split over the
    mesh's ``model`` axis (``Shard(2)``; ``Replicate()`` on the other
    axes) where ``cfg.shard_channels`` asks for it and ``f`` is a
    ``DTensor``: the reference's sharding constraint ``P(None, None,
    "model")``.  A plain tensor is returned as it is."""
    places = getattr(f, "placements", None)
    if not cfg.shard_channels or places is None:
        return f
    from torch.distributed.tensor import Replicate, Shard
    names = f.device_mesh.mesh_dim_names
    return f.redistribute(f.device_mesh, [Shard(2) if n == "model"
                                          else Replicate() for n in names])


def _equiformer_chunk(f, s, d, al, be, rg, wm, layer, cfg: EquiformerConfig):
    """One edge chunk's messages (Ec, irrep, C) and attention logits
    (Ec, H); the per-degree Wigner blocks are made here, per chunk."""
    sl = so3.irrep_slices(cfg.l_max)
    Ds = [so3.wigner_align_to_z(l, al, be).to(cfg.dtype)
          for l in range(cfg.l_max + 1)]
    x = f.index_select(0, s)                              # (Ec, irrep, C)
    if cfg.compact_escn:
        # only the |m| <= m_max rows ever reach the SO(2) conv, and only
        # they return: the rotation is sliced to those rows
        csl = _compact_layout(cfg.l_max, cfg.m_max)[1]

        def rows(l):
            mm = min(l, cfg.m_max)
            return slice(l - mm, l + mm + 1)

        x_c = _rotate(x, Ds, rows, lambda l: sl[l])
        y = _so2_conv_compact(x_c, layer["so2"], cfg)
        back = dict(rows=rows, cols=lambda l: csl[l])
    else:
        full = slice(None)
        x = _rotate(x, Ds, lambda l: full, lambda l: sl[l])
        y = _so2_conv(x, layer["so2"], cfg)
        back = dict(rows=lambda l: full, cols=lambda l: sl[l])
    y = y * rg[:, None, :] * wm[:, None, None]
    # attention logits from scalar channels of src/dst
    sc = torch.cat([f[:, 0, :].index_select(0, d), y[:, 0, :]], dim=-1)
    logit = F.leaky_relu(sc @ layer["attn"], 0.2)        # (Ec, H)
    logit = torch.where(wm[:, None] > 0, logit, -1e30)
    return _rotate(y, Ds, transpose=True, **back), logit


def equiformer_forward(params, batch, cfg: EquiformerConfig, *,
                       n_graphs: int = 1):
    """Same batch contract as :func:`nequip_forward`.  Returns per-graph
    energies."""
    pos = batch["positions"].to(cfg.dtype)
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    N = pos.shape[0]
    C = cfg.d_hidden
    sl = so3.irrep_slices(cfg.l_max)

    f = _shard_channels(_with_scalars(params["species_embed"].index_select(
        0, batch["species"].long()).to(cfg.dtype), cfg.irrep_dim), cfg)
    r, unit, emask = _edge_geometry(pos, src, dst, batch["edge_mask"])
    alpha, beta = so3.edge_alignment_angles(unit)
    rbf = radial_basis(r, cfg.n_rbf, cfg.cutoff).to(cfg.dtype)
    w_edge = torch.where(emask, 1.0, 0.0)

    def messages(src, dst, alpha, beta, radial_g, w_edge, f, *leaves):
        layer = tree_unflatten(list(leaves), spec)
        E = src.shape[0]
        Ec = E // _pick_chunks(E, cfg.edge_chunk)
        msgs, logits = [], []
        for c0 in range(0, E, Ec):
            cut = slice(c0, c0 + Ec)
            y, logit = common._recorded(
                _equiformer_chunk, f, src[cut], dst[cut], alpha[cut],
                beta[cut], radial_g[cut], w_edge[cut], layer, cfg)
            msgs.append(y)
            logits.append(logit)
        return torch.cat(msgs), torch.cat(logits)

    for layer in params["layers"]:
        layer = _cast(layer, cfg.dtype)
        radial_g = _mlp2_apply(layer["radial"], rbf)       # (E, C)
        # on sharded edges, each rank makes its own edges' messages
        leaves, spec = tree_flatten(layer)
        msgs, logits = common.per_rank(
            messages, (src, dst, alpha, beta, radial_g, w_edge),
            (f, *leaves))
        attn = segment_softmax(logits, dst, N)             # (E, H)
        attn = attn.repeat_interleave(C // cfg.n_heads, dim=1)  # (E, C)
        agg = _segment_sum(msgs * attn[:, None, :], dst, N)

        # node update: per-degree mix + gated activation, residual
        gates = torch.sigmoid(f[:, 0, :] @ layer["gate"])
        upd = [_gated(agg[:, sl[l], :] @ layer["w_out"][l], gates, l, C)
               for l in range(cfg.l_max + 1)]
        f = f + torch.cat(upd, dim=1)

        # equivariant FFN: two per-degree mixes with scalar gating
        gates2 = torch.sigmoid(f[:, 0, :] @ layer["ffn_gate"])
        ffn = [_gated(f[:, sl[l], :] @ layer["ffn_w1"][l], gates2, l, C)
               @ layer["ffn_w2"][l] for l in range(cfg.l_max + 1)]
        f = _shard_channels(f + torch.cat(ffn, dim=1), cfg)

    readout = _cast(params["readout"], torch.float32)
    node_e = _mlp2_apply(readout, f[:, 0, :].to(torch.float32))[:, 0]
    node_e = torch.where(batch["node_mask"], node_e, 0.0)
    return _segment_sum(node_e, batch["graph_id"].long(), n_graphs)


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _layout(cfg):
    """The reference's parameter pytree of ``cfg`` with ``(shape, scale)``
    at each truncated-normal leaf, a ``dense_init`` ``(d_in, d_out)`` at
    each weight (scale ``d_in ** -0.5``) and a ``(d,)`` at each zero
    bias."""
    return (_nequip_layout(cfg) if isinstance(cfg, NequIPConfig)
            else _equiformer_layout(cfg))


def _draw(layout, leaf):
    if isinstance(layout, dict):
        return {k: _draw(v, leaf) for k, v in layout.items()}
    if isinstance(layout, list):
        return [_draw(v, leaf) for v in layout]
    if isinstance(layout[0], tuple):                      # (shape, scale)
        return leaf(*layout)
    if len(layout) == 1:                                   # a zero bias
        return leaf(layout, None)
    return leaf(layout, (1.0 / layout[0]) ** 0.5)          # dense_init


def _init(cfg, generator: torch.Generator):
    def leaf(shape, scale):
        if scale is None:
            return torch.zeros(shape, device=generator.device)
        return common.truncated_normal(generator, shape, scale)
    return _draw(_layout(cfg), leaf)


def init_nequip_params(cfg: NequIPConfig, generator: torch.Generator):
    """NequIP parameters in the reference's layout, float32, drawn from
    ``generator`` on its device at the reference's scales."""
    return _init(cfg, generator)


def init_equiformer_params(cfg: EquiformerConfig,
                           generator: torch.Generator):
    """EquiformerV2 parameters in the reference's layout, float32, drawn
    from ``generator`` on its device at the reference's scales."""
    return _init(cfg, generator)


def numpy_params(cfg, seed: int) -> dict:
    """Parameters of ``cfg`` (a :class:`NequIPConfig` or
    :class:`EquiformerConfig`) in the reference's pytree layout as numpy
    float32 arrays from ``numpy.random.default_rng(seed)``, at the
    reference's scales (normals clipped to +-2; zero biases): one set of
    numbers both packages load."""
    rng = np.random.default_rng(seed)

    def leaf(shape, scale):
        if scale is None:
            return np.zeros(shape, np.float32)
        return common.numpy_truncated(rng, shape, scale)
    return _draw(_layout(cfg), leaf)
