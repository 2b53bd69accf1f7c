"""Shared model building blocks (counterpart of
:mod:`repro.models.common`): parameter draws from a ``torch.Generator``
(:func:`truncated_normal`, :func:`dense_init`), RMS norm, SwiGLU, rotary
embeddings and the softmax cross entropy, as plain PyTorch functions of
tensors.

Each keeps the reference's numerics: the norm and the rotary
embedding compute in float32 and return the input's dtype, the loss
computes in float32.  Training adds :func:`chunked_softmax_xent` (the
LM head's loss in sequence chunks, each chunk's logits recomputed in the
backward) and :func:`scan_layers` (the layer loop, each layer
recomputed in the backward under ``remat``): both through non-reentrant
``torch.utils.checkpoint``, the counterpart of the reference's
``jax.checkpoint`` under ``lax.scan``.
"""

from __future__ import annotations

import contextlib

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.engine import resolve_device


def truncated_normal(generator: torch.Generator, shape, scale):
    """A float32 ``shape`` tensor: ``scale`` times a standard normal
    truncated to [-2, 2] (no variance rescaling), drawn from ``generator``
    on its device -- the distribution of the reference's
    ``truncated_normal``, drawn as :meth:`Transformer.init_params` draws
    its weights.  In place, so a table of ``n`` elements costs ``4 n``
    bytes."""
    x = torch.empty(shape, dtype=torch.float32, device=generator.device)
    nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return x.mul_(scale)


def dense_init(generator: torch.Generator, d_in, d_out):
    """A float32 ``(d_in, d_out)`` weight: :func:`truncated_normal` at
    scale ``(1 / d_in) ** 0.5``."""
    return truncated_normal(generator, (d_in, d_out), (1.0 / d_in) ** 0.5)


def numpy_truncated(rng: np.random.Generator, shape, scale):
    """The numpy counterpart of :func:`truncated_normal` that the models'
    ``numpy_params`` draw (one set of numbers for both packages): a
    float32 standard normal clipped to [-2, 2], times ``scale``."""
    return (np.clip(rng.standard_normal(shape, np.float32), -2.0, 2.0)
            * np.float32(scale)).astype(np.float32)


def params_from_reference(tree, *, device=None):
    """A parameter pytree of the reference (dicts and lists of arrays, as
    its GNN and recsys models keep them) as the same tree of float32
    tensors on ``device`` (CUDA unless the caller passes another)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device=dev)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_from_reference(v, device=dev) for v in tree]
    return torch.tensor(np.asarray(tree, np.float32), device=dev)


def settle_partial(x):
    """A ``DTensor`` whose placements hold a pending reduction (the
    row-sharded embedding lookup's masked partial sums) reduced right
    away, while the reduction still has what it needs; any other tensor
    as it is."""
    places = getattr(x, "placements", None)
    if places is None or not any(p.is_partial() for p in places):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in places])


def per_rank(fn, sharded, replicated=(), *, out: str = "rows"):
    """``fn(*sharded, *replicated)`` on each rank's rows.

    On plain tensors it is that call.  On ``DTensor`` s, ``sharded``
    (tensors of one leading dim, split over the batch axes) become each
    rank's own rows, ``replicated`` (tensors) whole copies, and ``fn``
    runs on those local tensors, as a data-parallel rank runs its share:
    a loop inside ``fn`` over chunks of rows walks the local rows only,
    never slicing across shards.  Its result (a tensor or a tuple) comes
    back as ``DTensor`` s: ``out="rows"`` rows of the same split,
    ``out="sum"`` a sum over the rows (a pending sum over the batch axes).
    A replicated input's gradient is summed over the batch axes."""
    lead = sharded[0]
    if not hasattr(lead, "placements"):
        return fn(*sharded, *replicated)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = lead.device_mesh
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in lead.placements]
    split = [isinstance(p, Shard) for p in rows]
    whole = [Replicate()] * mesh.ndim
    grad = [Partial() if s else Replicate() for s in split]
    # this rank's rows of the split: [r * per, (r + 1) * per)
    n_split, r = 1, 0
    for d, (s, c) in enumerate(zip(split, mesh.get_coordinate())):
        if s:
            n_split, r = n_split * mesh.size(d), r * mesh.size(d) + c
    per = -(-lead.shape[0] // n_split)

    def own_rows(t):
        # any other split goes through a whole copy first (a layout the
        # data axes do not split as ``rows`` has no cheaper way there)
        if tuple(t.placements) != tuple(rows):
            t = t.redistribute(mesh, whole)
        loc = t.redistribute(mesh, rows).to_local()
        if loc.shape[0] != min(per, max(lead.shape[0] - r * per, 0)):
            # a DTensor that splits these rows otherwise: cut them here
            loc = t.redistribute(mesh, whole).to_local()[r * per:
                                                         (r + 1) * per]
        return loc
    local = [own_rows(t) for t in sharded]
    shared = [t.redistribute(mesh, whole).to_local(grad_placements=grad)
              if hasattr(t, "placements") else t for t in replicated]
    res = fn(*local, *shared)

    def wrap(o):
        if out == "sum":
            return DTensor.from_local(o, mesh, [Partial() if s else
                                                Replicate() for s in split],
                                      run_check=False)
        shape = (lead.shape[0],) + tuple(o.shape[1:])
        stride = [1] * len(shape)
        for d in range(len(shape) - 2, -1, -1):
            stride[d] = stride[d + 1] * shape[d + 1]
        return DTensor.from_local(o, mesh, rows, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=tuple(stride))
    return tuple(map(wrap, res)) if isinstance(res, tuple) else wrap(res)


def row_chunks(n_chunks: int, *tensors):
    """``tensors`` (one leading dim) in ``n_chunks`` chunks of rows: of a
    plain tensor, consecutive slices; of ``DTensor`` s split on dim 0,
    each rank's own rows in consecutive slices, each chunk again a
    ``DTensor`` of that split (so a chunk never cuts across shards and a
    sum over the chunks is the sum over every row)."""
    lead = tensors[0]
    if not hasattr(lead, "placements"):
        T = lead.shape[0]
        chunk = -(-T // n_chunks)
        return [tuple(t[c0:c0 + chunk] for t in tensors)
                for c0 in range(0, T, chunk)]
    from torch.distributed.tensor import DTensor

    mesh, places = lead.device_mesh, lead.placements
    local = [t.redistribute(mesh, places).to_local() for t in tensors]
    T = local[0].shape[0]
    chunk = -(-T // n_chunks)
    return [tuple(DTensor.from_local(t[c0:c0 + chunk], mesh, places,
                                     run_check=False) for t in local)
            for c0 in range(0, T, chunk)]


def rms_norm(x, scale, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` over the last dim, in
    float32, returned in ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dtype)


def swiglu(x, w_gate, w_up, w_down):
    """``(silu(x W_gate) * x W_up) W_down``."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def rope_freqs(d_head: int, theta: float, device=None):
    """The ``d_head / 2`` rotary frequencies ``theta^(-2i / d_head)``."""
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """Rotate ``x`` ``(..., S, H, d_head)`` by ``positions`` (broadcastable
    to ``(..., S)``), halves convention, in float32; returns ``x``'s
    dtype."""
    d_head = x.shape[-1]
    freqs = rope_freqs(d_head, theta, x.device)
    ang = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softmax_xent(logits, labels, mask=None):
    """Mean negative log-likelihood of ``labels`` under ``logits`` (in
    float32), over the positions where ``mask`` is set when given."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = settle_partial(
        torch.gather(logits, -1, labels[..., None].long()))[..., 0]
    nll = lse - picked
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()


def _tracer():
    """The dry run's recorder while it traces a step (the active dispatch
    mode with a ``trip_cache``), else ``None``."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    for mode in _get_current_dispatch_mode_stack():
        if getattr(mode, "trip_cache", None) is not None:
            return mode
    return None


def _recorded(fn, *args, remat: bool = True):
    """``fn(*args)``; while autograd records and ``remat`` is set, its
    intermediates are dropped and recomputed in the backward (only
    ``args`` are kept).  Under the dry run's trace, the recompute runs
    under the trace's modes and a repeated trip replays its first
    trip's costs (``roofline.analysis.TripCache``)."""
    if not (remat and torch.is_grad_enabled()):
        return fn(*args)
    tracer = _tracer()
    if tracer is None:
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)

    def run(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              tracer.recompute_context()))
    return tracer.trip_cache.call(fn, args, run)


def _picked(logits, labels):
    """``logits[i, labels[i]]``.  On a ``DTensor`` (vocabulary split over
    ranks) it is a masked sum over the vocabulary, which stays split:
    ``gather``'s backward makes a zero tensor of the whole logits on
    every rank."""
    if not hasattr(logits, "placements"):
        return torch.gather(logits, -1, labels[:, None].long())[:, 0]
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(vocab == labels[:, None].long(), logits,
                       0.0).sum(dim=-1)


def _xent_terms(logits_fn, xc, lc, mc):
    logits = logits_fn(xc).float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = _picked(logits, lc)
    nll = (lse - picked) * mc
    zl = (lse ** 2) * mc
    return nll.sum(), zl.sum(), mc.sum()


def chunked_softmax_xent(logits_fn: Callable, x, labels, mask, *,
                         n_chunks: int, z_loss: float = 1e-4):
    """Cross entropy over the vocabulary in ``n_chunks`` sequence chunks,
    so the ``(tokens, V)`` logits never materialize whole.

    ``logits_fn(x_chunk) -> (tokens_chunk, V)``; ``x`` is ``(T, d)``
    flattened tokens, ``labels`` / ``mask`` ``(T,)``.  Returns ``(loss,
    count)``: the mean negative log-likelihood over the masked tokens
    plus ``z_loss`` times their mean squared log-normalizer, and the
    number of masked tokens, both float32 0-d tensors.  Under autograd
    each chunk keeps only its slice of ``x`` and recomputes its float32
    logits in the backward, so one chunk's logits are alive at a time.
    """
    T = x.shape[0]
    assert T % n_chunks == 0, (T, n_chunks)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    loss_sum, z_sum, count = zero, zero, zero
    mask = mask.float()
    for xc, lc, mc in row_chunks(n_chunks, x, labels, mask):
        nll, zl, n = _recorded(_xent_terms, logits_fn, xc, lc, mc)
        loss_sum, z_sum, count = loss_sum + nll, z_sum + zl, count + n
    denom = torch.clamp_min(count, 1.0)
    return loss_sum / denom + z_loss * z_sum / denom, count


def scan_layers(block_fn: Callable, carry, layers, *, remat: bool = True):
    """``carry = block_fn(carry, layer)`` for each ``layer`` in turn (the
    reference's ``lax.scan`` over stacked layers, as a Python loop).
    With ``remat`` and autograd recording, each call keeps only its
    inputs and is recomputed in the backward (the reference's
    ``jax.checkpoint`` per layer), so the activations of one layer are
    alive at a time."""
    for layer in layers:
        carry = _recorded(block_fn, carry, layer, remat=remat)
    return carry
