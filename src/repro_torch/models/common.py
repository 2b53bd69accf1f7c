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
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - picked
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()


def _recorded(fn, *args, remat: bool = True):
    """``fn(*args)``; while autograd records and ``remat`` is set, its
    intermediates are dropped and recomputed in the backward (only
    ``args`` are kept)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _xent_terms(logits_fn, xc, lc, mc):
    logits = logits_fn(xc).float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, lc[:, None].long())[:, 0]
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
    chunk = T // n_chunks
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    loss_sum, z_sum, count = zero, zero, zero
    mask = mask.float()
    for c0 in range(0, T, chunk):
        nll, zl, n = _recorded(_xent_terms, logits_fn, x[c0:c0 + chunk],
                               labels[c0:c0 + chunk], mask[c0:c0 + chunk])
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
