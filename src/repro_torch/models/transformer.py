"""Decoder-only transformer LM family, dense and MoE (counterpart of
:mod:`repro.models.transformer`): serving and training.

Covers the five LM architectures of :mod:`repro_torch.configs`: GQA
(query heads padded to the model axis), optional qk-norm (qwen3), qkv
bias (the qwen1.5 family), RoPE with a per-architecture theta, the
SwiGLU FFN, GShard-style top-k MoE with capacity and shared experts
(qwen2-moe, llama4-scout), and llama4's iRoPE: chunked-local attention
with every ``global_interval``-th layer global and without RoPE.

:class:`Transformer` is an ``nn.Module`` whose parameters keep the
reference's pytree layout: ``embed``, ``unembed``, ``ln_f`` and the
``layers`` dict of tensors stacked over the layers on dim 0, all
float32 and cast to ``cfg.dtype`` at each use, as in the reference.
:func:`params_from_reference` turns the reference's parameter pytree
into the module's state, :meth:`Transformer.param_tree` gives the
module's parameters in that pytree's layout.  The serving methods
(:meth:`init_cache`, :meth:`prefill`, :meth:`decode_step`) run without
autograd; layers run as a Python loop, attention query-chunked
(``q_chunk``) so the score tile is ``(B, H, q_chunk, S)``.

Training: :meth:`Transformer.forward` runs under autograd with one
recomputed block per layer when ``cfg.remat`` is set (the reference's
``jax.checkpoint`` per layer), and :func:`loss_fn` chunks the LM head's
loss by ``cfg.loss_chunks``.  By default each layer's weights are
slices of the stacked parameters, so autograd reaches the stacks as any
module's parameters (``torch.autograd.grad``, hooks); the backward of
each slice then makes a zero tensor of the whole stack.  With
:attr:`Transformer.stacked_grads` set (as ``build_lm_trainer`` sets it)
they are instead leaf views whose ``.grad`` is a view of the stack's
``.grad``, which the caller allocates: the backward adds each layer's
gradient into its slice in place, and the stacks' ``.grad`` is the only
route to their gradients (no autograd edge or parameter hook reaches
the stacks).

Differences from the reference, none of them in a value:

* the KV cache is updated in place (the reference returns a new one,
  since JAX arrays are immutable): at full width a copy per decode step
  would move the whole cache; ``cache["pos"]`` is a Python int;
* parameters come from a ``torch.Generator`` (:meth:`init_params`), so
  a seed gives other numbers than the reference's ``jax.random`` key;
  tests and the card's smoke hand both packages the same numpy
  parameters instead;
* layers always run as a loop (``scan_layers`` changes nothing), and
  the sharding hints ``sp_activations`` / ``moe_hints`` are kept so
  that configs copy field for field: on one device they change no
  value, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.engine import resolve_device
from repro_torch.distributed.sharding import pad_heads, round_up
from repro_torch.models import common

# the reference's additive mask value
NEG = -1e30


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's :class:`repro.models.transformer.TransformerConfig`,
    field for field; ``dtype`` is a torch dtype."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    # MoE (n_experts == 0 -> dense FFN)
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 1
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_group: int = 512
    router_aux_weight: float = 0.01
    # attention variants
    attn_chunk: int = 0          # >0: iRoPE chunked-local attention
    global_interval: int = 0     # every k-th layer global (0 = all local)
    nope_on_global: bool = True  # llama4: global layers skip RoPE
    # numerics / training
    dtype: Any = torch.bfloat16
    z_loss: float = 1e-4
    loss_chunks: int = 16
    q_chunk: int = 1024          # attention query chunk
    remat: bool = True
    scan_layers: bool = True
    sp_activations: bool = False
    moe_hints: bool = False
    # TP-derived padded sizes (filled by `with_mesh`)
    n_heads_p: int = 0
    vocab_p: int = 0
    n_experts_p: int = 0

    @property
    def moe(self) -> bool:
        return self.n_experts > 0

    def with_mesh(self, model_axis: int) -> "TransformerConfig":
        return dataclasses.replace(
            self,
            n_heads_p=pad_heads(self.n_heads, model_axis),
            vocab_p=round_up(self.vocab_size, model_axis),
            n_experts_p=round_up(self.n_experts, model_axis)
            if self.moe else 0,
        )

    def ensure_padded(self) -> "TransformerConfig":
        return self if self.n_heads_p else self.with_mesh(1)

    def _attn_params(self) -> int:
        d, dh = self.d_model, self.d_head
        return d * (self.n_heads * dh + 2 * self.n_kv_heads * dh) \
            + self.n_heads * dh * d

    def param_count(self) -> int:
        cfg = self.ensure_padded()
        d = cfg.d_model
        if cfg.moe:
            ffn = 3 * cfg.n_experts * d * cfg.expert_d_ff \
                + 3 * d * cfg.expert_d_ff * cfg.n_shared_experts \
                + d * cfg.n_experts
        else:
            ffn = 3 * d * cfg.d_ff
        return cfg.n_layers * (cfg._attn_params() + ffn) \
            + 2 * cfg.vocab_size * d

    def active_param_count(self) -> int:
        cfg = self.ensure_padded()
        if not cfg.moe:
            return cfg.param_count()
        d = cfg.d_model
        ffn = 3 * cfg.top_k * d * cfg.expert_d_ff \
            + 3 * d * cfg.expert_d_ff * cfg.n_shared_experts \
            + d * cfg.n_experts
        return cfg.n_layers * (cfg._attn_params() + ffn) \
            + 2 * cfg.vocab_size * d


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_shapes(cfg: TransformerConfig) -> dict:
    """``{name: (shape, init)}`` of every parameter in the reference's
    pytree layout (``layers.<name>`` stacked over the layers), ``init``
    the reference's: ``0`` zeros, ``("dense", d_in)`` a truncated normal
    scaled by ``d_in ** -0.5``, ``("normal", scale)`` a truncated normal
    scaled by ``scale`` with the padded vocabulary zero."""
    cfg = cfg.ensure_padded()
    d, dh, L = cfg.d_model, cfg.d_head, cfg.n_layers
    Hp, Kv = cfg.n_heads_p, cfg.n_kv_heads
    shapes = {
        "layers.ln1": ((L, d), 0), "layers.ln2": ((L, d), 0),
        "layers.wq": ((L, d, Hp * dh), ("dense", d)),
        "layers.wk": ((L, d, Kv * dh), ("dense", d)),
        "layers.wv": ((L, d, Kv * dh), ("dense", d)),
        "layers.wo": ((L, Hp * dh, d), ("dense", Hp * dh)),
    }
    if cfg.qkv_bias:
        shapes.update({"layers.bq": ((L, Hp * dh), 0),
                       "layers.bk": ((L, Kv * dh), 0),
                       "layers.bv": ((L, Kv * dh), 0)})
    if cfg.qk_norm:
        shapes.update({"layers.q_norm": ((L, dh), 0),
                       "layers.k_norm": ((L, dh), 0)})
    if cfg.moe:
        Ep, ffe = cfg.n_experts_p, cfg.expert_d_ff
        shapes.update({
            "layers.router": ((L, d, Ep), ("dense", d)),
            "layers.we_gate": ((L, Ep, d, ffe), ("dense", d)),
            "layers.we_up": ((L, Ep, d, ffe), ("dense", d)),
            "layers.we_down": ((L, Ep, ffe, d), ("dense", ffe))})
        if cfg.n_shared_experts:
            ffs = cfg.n_shared_experts * ffe
            shapes.update({
                "layers.ws_gate": ((L, d, ffs), ("dense", d)),
                "layers.ws_up": ((L, d, ffs), ("dense", d)),
                "layers.ws_down": ((L, ffs, d), ("dense", ffs))})
    else:
        shapes.update({
            "layers.w_gate": ((L, d, cfg.d_ff), ("dense", d)),
            "layers.w_up": ((L, d, cfg.d_ff), ("dense", d)),
            "layers.w_down": ((L, cfg.d_ff, d), ("dense", cfg.d_ff))})
    shapes.update({"embed": ((cfg.vocab_p, d), ("normal", 0.02)),
                   "ln_f": ((d,), 0),
                   "unembed": ((d, cfg.vocab_p), ("normal", d ** -0.5))})
    return shapes


def params_from_reference(tree) -> dict:
    """The module's state (``state_dict`` keys, float32 CPU tensors) from
    the reference's parameter pytree: ``{"embed", "layers": {...},
    "ln_f", "unembed"}`` of arrays, layers stacked on axis 0."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    state = {f"layers.{k}": t(v) for k, v in tree["layers"].items()}
    state.update({k: t(tree[k]) for k in ("embed", "ln_f", "unembed")})
    return state


def numpy_params(cfg: TransformerConfig, seed: int) -> dict:
    """Parameters in the reference's pytree layout as numpy float32 arrays,
    drawn from ``numpy.random.default_rng(seed)`` with the reference's
    scales (normals clipped to +-2, zeros where it has zeros, the padded
    vocabulary zero): one set of numbers that both packages can load."""
    cfg = cfg.ensure_padded()
    rng = np.random.default_rng(seed)
    tree = {"layers": {}}
    for name, (shape, init) in param_shapes(cfg).items():
        if init == 0:
            a = np.zeros(shape, np.float32)
        else:
            kind, arg = init
            scale = arg ** -0.5 if kind == "dense" else arg
            a = common.numpy_truncated(rng, shape, scale)
            if name == "embed":
                a[cfg.vocab_size:] = 0.0
            elif name == "unembed":
                a[:, cfg.vocab_size:] = 0.0
        if name.startswith("layers."):
            tree["layers"][name[len("layers."):]] = a
        else:
            tree[name] = a
    return tree


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def _layer_flags(cfg: TransformerConfig) -> list:
    """Per layer, whether it attends globally (llama4 iRoPE)."""
    L = cfg.n_layers
    if cfg.attn_chunk and cfg.global_interval:
        return [i % cfg.global_interval == cfg.global_interval - 1
                for i in range(L)]
    if cfg.attn_chunk:
        return [False] * L
    return [True] * L


def _uses_rope(cfg: TransformerConfig, is_global: bool) -> bool:
    if cfg.attn_chunk and cfg.nope_on_global:
        return not is_global
    return True


def _scale(scores, d_head):
    # dh^-0.5 in the scores' dtype, as the reference's weakly typed scalar
    return scores * torch.full((), d_head ** -0.5, dtype=scores.dtype,
                               device=scores.device)


def _local_mask(cfg, kv_positions, q_positions, is_global):
    """Causal mask ``(Sq, T)``, cut to each query's attention chunk on a
    local iRoPE layer."""
    mask = kv_positions[None, :] <= q_positions[:, None]
    if cfg.attn_chunk and not is_global:
        mask = mask & ((kv_positions[None, :] // cfg.attn_chunk)
                       == (q_positions[:, None] // cfg.attn_chunk))
    return mask


def _attend_chunked(q, k, v, cfg, *, q_positions, kv_positions, is_global):
    """Query-chunked masked attention: q ``(B, S, Hp, dh)``, k / v ``(B, T,
    Kv, dh)`` -> ``(B, S, Hp, dh)``; scores softmaxed in float32."""
    B, S, Hp, dh = q.shape
    Kv = k.shape[2]
    qg = q.reshape(B, S, Kv, Hp // Kv, dh)
    n_chunks = max(S // cfg.q_chunk, 1)
    chunk = -(-S // n_chunks)
    outs = []
    for c0 in range(0, S, chunk):
        qc = qg[:, c0:c0 + chunk]
        scores = _scale(torch.einsum("bckgd,btkd->bkgct", qc, k), dh)
        mask = _local_mask(cfg, kv_positions, q_positions[c0:c0 + chunk],
                           is_global)
        scores = torch.where(mask, scores.float(), NEG)
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        outs.append(torch.einsum("bkgct,btkd->bckgd", probs, v))
    return torch.cat(outs, dim=1).reshape(B, S, Hp, dh)


def _model_split(x, dim: int):
    """``(mesh dim of the model axis, its size, this rank's coordinate
    on it)`` when ``x`` is a ``DTensor`` split on ``dim`` over the
    ``model`` axis alone, else ``None``."""
    places = getattr(x, "placements", None)
    if places is None:
        return None
    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    split = [i for i, p in enumerate(places) if p.is_shard(dim)]
    if len(split) != 1 or names[split[0]] != "model":
        return None
    d = split[0]
    return d, mesh.size(d), mesh.get_coordinate()[d]


def _split_heads(x, n_heads: int, d_head: int):
    """``(B, S, n_heads * d_head) -> (B, S, n_heads, d_head)``.  A
    ``DTensor`` whose last dim is split over ``model`` by whole heads is
    reshaped shard by shard (the split moves to the heads), a view that
    DTensor's own rules may refuse."""
    B, S = x.shape[:2]
    ms = _model_split(x, 2)
    if ms is None or n_heads % ms[1]:
        return x.reshape(B, S, n_heads, d_head)
    from torch.distributed.tensor import DTensor
    loc = x.to_local()
    loc = loc.reshape(*loc.shape[:2], n_heads // ms[1], d_head)
    shape = (B, S, n_heads, d_head)
    return DTensor.from_local(loc, x.device_mesh, x.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=(S * n_heads * d_head,
                                      n_heads * d_head, d_head, 1))


def _attend(q, k, v, cfg, **kw):
    """:func:`_attend_chunked`; on ``DTensor`` s whose query heads split
    over the ``model`` axis (keys and values replicated over it, the
    Megatron GQA layout), each rank attends its own heads with the kv
    heads they read, as a tensor-parallel rank does."""
    ms = _model_split(q, 2)
    if ms is None or _model_split(k, 2) is not None:
        return _attend_chunked(q, k, v, cfg, **kw)
    from torch.distributed.tensor import DTensor, Partial
    d, n, r = ms
    Hp, Kv = q.shape[2], k.shape[2]
    Hl, G = Hp // n, Hp // Kv
    if Hl % G and G % Hl:
        return _attend_chunked(q, k, v, cfg, **kw)
    kv0, nkv = r * Hl // G, max(Hl // G, 1)
    mesh = q.device_mesh
    kv_places = list(q.placements)
    kv_places[d] = k.placements[d]
    grad = list(kv_places)
    grad[d] = Partial()          # each rank's slice: a sum over the ranks
    kl, vl = (t.redistribute(mesh, kv_places).to_local(
        grad_placements=grad)[:, :, kv0:kv0 + nkv] for t in (k, v))
    out = _attend_chunked(q.to_local(), kl, vl, cfg, **kw)
    return DTensor.from_local(out, mesh, q.placements, run_check=False,
                              shape=q.shape, stride=q.stride())


def _attend_decode(q, k_cache, v_cache, cfg, *, pos: int, is_global):
    """One token against the cache: q ``(B, 1, Hp, dh)``, caches ``(B,
    Smax, Kv, dh)`` -> ``(B, 1, Hp * dh)``."""
    B, _, Hp, dh = q.shape
    Smax, Kv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, Kv, Hp // Kv, dh)
    scores = _scale(torch.einsum("bkgd,btkd->bkgt", qg, k_cache), dh)
    t = torch.arange(Smax, device=q.device)
    mask = _local_mask(cfg, t, torch.full((1,), pos, device=q.device),
                       is_global)[0]
    scores = torch.where(mask, scores.float(), NEG)
    probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v_cache)
    return out.reshape(B, 1, Hp * dh)


def _one_hot(idx, n):
    """``jax.nn.one_hot``: float32, all zeros where ``idx`` is out of
    range."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _moe_ffn(x, layer, cfg):
    """GShard-style top-k capacity MoE: x ``(B, S, d)`` -> ``(out,
    aux_loss)``.  Routes, capacity ranks (slot 0 first) and the dispatch
    and combine tensors as the reference builds them."""
    c = lambda a: a.to(cfg.dtype)  # noqa: E731
    B, S, d = x.shape
    T = B * S
    group = min(cfg.moe_group, T)
    G = T // group
    if G * group != T:
        raise ValueError(f"{T} tokens do not split into groups of {group}")
    E, k = cfg.n_experts_p, cfg.top_k
    cap = round_up(max(int(group * k * cfg.capacity_factor / E), 1), 4)

    xg = x.reshape(G, group, d)
    logits = (xg @ c(layer["router"])).float()
    eids = torch.arange(E, device=x.device)
    logits = torch.where(eids < cfg.n_experts, logits, NEG)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, top_idx = torch.topk(probs, k, dim=-1)        # (G, S, k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)

    oh = _one_hot(top_idx, E)                                 # (G, S, k, E)
    flat = oh.movedim(2, 1).reshape(G, k * group, E)
    ranks = ((torch.cumsum(flat, dim=1) - flat) * flat).sum(dim=-1)
    ranks = ranks.reshape(G, k, group).movedim(1, 2)          # (G, S, k)
    keep = ranks < cap

    dispatch = torch.zeros(G, group, E, cap, dtype=cfg.dtype,
                           device=x.device)
    combine = torch.zeros(G, group, E, cap, dtype=torch.float32,
                          device=x.device)
    for slot in range(k):
        oh_e = oh[:, :, slot, :] * keep[:, :, slot, None]
        oh_c = _one_hot(ranks[:, :, slot], cap)
        d4 = torch.einsum("gse,gsc->gsec", oh_e, oh_c)
        dispatch = dispatch + d4.to(cfg.dtype)
        combine = combine + d4 * gate_vals[:, :, slot, None, None]

    expert_in = torch.einsum("gsec,gsd->egcd", dispatch, xg)
    h_gate = torch.einsum("egcd,edf->egcf", expert_in, c(layer["we_gate"]))
    h_up = torch.einsum("egcd,edf->egcf", expert_in, c(layer["we_up"]))
    expert_out = torch.einsum("egcf,efd->egcd", F.silu(h_gate) * h_up,
                              c(layer["we_down"]))
    y = torch.einsum("egcd,gsec->gsd", expert_out,
                     combine.to(cfg.dtype)).reshape(B, S, d)
    if cfg.n_shared_experts:
        y = y + common.swiglu(x, c(layer["ws_gate"]), c(layer["ws_up"]),
                              c(layer["ws_down"]))
    # Switch-style load-balance aux loss over the real experts
    me = probs.mean(dim=(0, 1))
    fe = oh[:, :, 0, :].mean(dim=(0, 1))
    return y, cfg.n_experts * (me * fe).sum()


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class Transformer(nn.Module):
    """The decoder-only LM of ``cfg`` (padded by ``ensure_padded``) on
    ``device`` (CUDA unless the caller passes another).  Parameters are
    allocated, not initialized: call :meth:`init_params` or load a state
    (:func:`params_from_reference`).

    ``stacked_grads`` (off by default) makes the layers' gradients
    accumulate in place into the stacked parameters' ``.grad``, which
    must then be allocated, and only there (see :meth:`_layer_weights`):
    the memory a full-width trainer needs, but no hook or
    ``torch.autograd.grad`` sees those gradients."""

    stacked_grads = False

    def __init__(self, cfg: TransformerConfig, *, device=None):
        super().__init__()
        self.cfg = cfg.ensure_padded()
        dev = resolve_device(device)
        layers = {}
        for name, (shape, _) in param_shapes(self.cfg).items():
            p = nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                         device=dev))
            if name.startswith("layers."):
                layers[name[len("layers."):]] = p
            else:
                setattr(self, name, p)
        self.layers = nn.ParameterDict(layers)

    @classmethod
    def from_params(cls, cfg: TransformerConfig, tree: dict) -> "Transformer":
        """The model of ``cfg`` around the tensors of ``tree`` (the
        reference's pytree layout, :meth:`param_tree`'s), shared, not
        copied: nothing is allocated (the dry run's cells pass ``DTensor``
        shards)."""
        model = cls.__new__(cls)
        nn.Module.__init__(model)
        model.cfg = cfg.ensure_padded()
        for name in ("embed", "ln_f", "unembed"):
            setattr(model, name, nn.Parameter(tree[name]))
        model.layers = nn.ParameterDict(
            {k: nn.Parameter(v) for k, v in tree["layers"].items()})
        return model

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "Transformer":
        """Fill the parameters as the reference's ``init_params`` does
        (truncated normals at its scales, zeros, a zero padded
        vocabulary), drawing from ``generator`` (on the parameters'
        device)."""
        cfg = self.cfg
        for name, (_, init) in param_shapes(cfg).items():
            p = self.get_parameter(name)
            if init == 0:
                p.zero_()
                continue
            kind, arg = init
            nn.init.trunc_normal_(p, 0.0, 1.0, -2.0, 2.0,
                                  generator=generator)
            p.mul_(arg ** -0.5 if kind == "dense" else arg)
        self.embed[cfg.vocab_size:] = 0.0
        self.unembed[:, cfg.vocab_size:] = 0.0
        return self

    # -- pieces ------------------------------------------------------------

    def _layer(self, i: int) -> dict:
        return {name: p[i] for name, p in self.layers.items()}

    def _layer_weights(self) -> list:
        """Each layer's weights ``{name: tensor}``: slices of the stacks,
        or, with :attr:`stacked_grads` while autograd records, leaf views
        of the slices of a stack that requires grad whose ``.grad`` are
        views of the stack's ``.grad``, so the backward adds into it in
        place."""
        L = self.cfg.n_layers
        out = [{} for _ in range(L)]
        for name, p in self.layers.items():
            if not (self.stacked_grads and torch.is_grad_enabled()
                    and p.requires_grad):
                for i in range(L):
                    out[i][name] = p[i]
                continue
            if p.grad is None:
                raise RuntimeError(f"stacked_grads needs layers.{name}.grad "
                                   f"allocated")
            base = p.detach()
            for i in range(L):
                leaf = base[i].requires_grad_()
                leaf.grad = p.grad[i]
                out[i][name] = leaf
        return out

    def param_tree(self) -> dict:
        """The parameters in the reference's pytree layout: ``{"embed",
        "layers": {name: stacked}, "ln_f", "unembed"}`` (the module's own
        tensors, not copies)."""
        return {"embed": self.embed, "layers": dict(self.layers.items()),
                "ln_f": self.ln_f, "unembed": self.unembed}

    def _embed(self, tokens):
        if hasattr(self.embed, "placements"):
            # a row-split table: the lookup's own rule (masked partial
            # sums), not indexing's, which replicates the table
            return common.settle_partial(F.embedding(
                tokens.long(), self.embed)).to(self.cfg.dtype)
        return self.embed[tokens.long()].to(self.cfg.dtype)

    def _lm_logits(self, x):
        cfg = self.cfg
        logits = x @ self.unembed.to(cfg.dtype)
        vmask = torch.arange(cfg.vocab_p, device=x.device) < cfg.vocab_size
        return torch.where(vmask, logits, NEG)

    def _qkv(self, x, layer):
        cfg = self.cfg
        c = lambda a: a.to(cfg.dtype)  # noqa: E731
        B, S, _ = x.shape
        dh, Hp, Kv = cfg.d_head, cfg.n_heads_p, cfg.n_kv_heads
        q = x @ c(layer["wq"])
        k = x @ c(layer["wk"])
        v = x @ c(layer["wv"])
        if cfg.qkv_bias:
            q = q + c(layer["bq"])
            k = k + c(layer["bk"])
            v = v + c(layer["bv"])
        q = _split_heads(q, Hp, dh)
        k = k.reshape(B, S, Kv, dh)
        v = v.reshape(B, S, Kv, dh)
        if cfg.qk_norm:
            q = common.rms_norm(q, layer["q_norm"])
            k = common.rms_norm(k, layer["k_norm"])
        return q, k, v

    def _rope(self, q, k, positions, is_global):
        if not _uses_rope(self.cfg, is_global):
            return q, k
        theta = self.cfg.rope_theta
        return (common.apply_rope(q, positions, theta),
                common.apply_rope(k, positions, theta))

    def _ffn(self, x, layer):
        cfg = self.cfg
        h = common.rms_norm(x, layer["ln2"])
        if cfg.moe:
            return _moe_ffn(h, layer, cfg)
        c = lambda a: a.to(cfg.dtype)  # noqa: E731
        return (common.swiglu(h, c(layer["w_gate"]), c(layer["w_up"]),
                              c(layer["w_down"])),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def _block(self, x, i, is_global, positions, cache=None, layer=None):
        """Layer ``i`` (its weights ``layer``, by default slices of the
        stacks) over the whole sequence; with ``cache`` its keys and
        values are written to the cache's first positions."""
        cfg = self.cfg
        if layer is None:
            layer = self._layer(i)
        B, S, _ = x.shape
        h = common.rms_norm(x, layer["ln1"])
        q, k, v = self._qkv(h, layer)
        q, k = self._rope(q, k, positions[None], is_global)
        if cache is not None:
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
        attn = _attend(q, k, v, cfg, q_positions=positions,
                               kv_positions=positions, is_global=is_global)
        x = x + attn.reshape(B, S, -1) @ layer["wo"].to(cfg.dtype)
        ffn, aux = self._ffn(x, layer)
        return x + ffn, aux

    # -- entry points ------------------------------------------------------

    def forward(self, tokens):
        """Final hidden states ``(B, S, d)`` (after ``ln_f``) and the summed
        MoE aux loss, of tokens ``(B, S)``.  Under autograd with
        ``cfg.remat`` each block keeps only its input and is recomputed in
        the backward."""
        cfg = self.cfg
        x = self._embed(tokens)
        positions = torch.arange(tokens.shape[1], device=x.device)
        aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)

        def body(carry, item):
            x, aux_sum = carry
            i, is_global, layer = item
            x, aux = self._block(x, i, is_global, positions, layer=layer)
            return x, aux_sum + aux

        layers = zip(range(cfg.n_layers), _layer_flags(cfg),
                     self._layer_weights())
        x, aux_sum = common.scan_layers(body, (x, aux_sum), layers,
                                        remat=cfg.remat)
        return common.rms_norm(x, self.ln_f), aux_sum

    def init_cache(self, batch: int, max_len: int) -> dict:
        """An empty KV cache: ``k`` / ``v`` ``(L, batch, max_len, Kv, dh)``
        in ``cfg.dtype`` and ``pos`` 0."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                "pos": 0}

    @torch.no_grad()
    def prefill(self, tokens, cache: dict):
        """Run the prompt ``(B, S)`` through the model, writing its keys and
        values to ``cache`` (in place).  Returns ``(cache, last-position
        logits (B, vocab_p))``."""
        cfg = self.cfg
        x = self._embed(tokens)
        S = tokens.shape[1]
        if S > cache["k"].shape[2]:
            raise ValueError(f"a prompt of {S} tokens does not fit a cache "
                             f"of {cache['k'].shape[2]}")
        positions = torch.arange(S, device=x.device)
        for i, is_global in enumerate(_layer_flags(cfg)):
            x, _ = self._block(x, i, is_global, positions, cache)
        x = common.rms_norm(x, self.ln_f)
        cache["pos"] = S
        return cache, self._lm_logits(x[:, -1])

    @torch.no_grad()
    def decode_step(self, tokens, cache: dict):
        """One decode step from the last ids ``tokens`` ``(B,)``: writes
        the new position's keys and values to ``cache`` (in place) and
        advances ``cache["pos"]``.  Returns ``(next ids (B,) int32,
        logits (B, vocab_p), cache)``."""
        cfg = self.cfg
        pos = int(cache["pos"])
        if pos >= cache["k"].shape[2]:
            raise ValueError(f"the cache holds {cache['k'].shape[2]} "
                             "positions and is full")
        x = self._embed(tokens[:, None])                      # (B, 1, d)
        posb = torch.full((tokens.shape[0], 1), pos, device=x.device)
        for i, is_global in enumerate(_layer_flags(cfg)):
            layer = self._layer(i)
            h = common.rms_norm(x, layer["ln1"])
            q, k, v = self._qkv(h, layer)
            q, k = self._rope(q, k, posb, is_global)
            cache["k"][i, :, pos] = k[:, 0]
            cache["v"][i, :, pos] = v[:, 0]
            attn = _attend_decode(q, cache["k"][i], cache["v"][i], cfg,
                                  pos=pos, is_global=is_global)
            x = x + attn @ layer["wo"].to(cfg.dtype)
            ffn, _ = self._ffn(x, layer)
            x = x + ffn
        x = common.rms_norm(x, self.ln_f)
        logits = self._lm_logits(x[:, 0])
        cache["pos"] = pos + 1
        return torch.argmax(logits, dim=-1).to(torch.int32), logits, cache


def loss_fn(model: Transformer, batch: dict):
    """Causal LM loss of ``batch`` ``{"tokens": (B, S), "labels": (B, S)}``
    (int tensors on the model's device; a label of -1 is masked): the
    chunked cross entropy with z-loss (``cfg.loss_chunks`` chunks) plus
    ``router_aux_weight`` times the mean MoE aux loss per layer.  Returns
    ``(total, {"xent", "aux", "tokens"})``, float32 0-d tensors."""
    cfg = model.cfg
    x, aux = model(batch["tokens"])
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    raw = batch["labels"].reshape(-1)
    labels = torch.clamp_min(raw, 0)
    mask = (raw >= 0).float()
    loss, count = common.chunked_softmax_xent(
        model._lm_logits, xt, labels, mask, n_chunks=cfg.loss_chunks,
        z_loss=cfg.z_loss)
    layers = torch.full((), max(cfg.n_layers, 1), dtype=torch.float32,
                        device=x.device)
    total = loss + cfg.router_aux_weight * aux / layers
    return total, {"xent": loss, "aux": aux, "tokens": count}


def kv_cache_bytes(cfg: TransformerConfig, batch: int, max_len: int) -> int:
    """Bytes of one :meth:`Transformer.init_cache` of ``cfg``."""
    elem = torch.tensor([], dtype=cfg.dtype).element_size()
    return 2 * cfg.n_layers * batch * max_len * cfg.n_kv_heads \
        * cfg.d_head * elem
