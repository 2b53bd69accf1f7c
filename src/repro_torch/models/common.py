"""Shared model building blocks (counterpart of
:mod:`repro.models.common`): RMS norm, SwiGLU, rotary embeddings and the
softmax cross entropy, as plain PyTorch functions of tensors.

Each keeps the reference's numerics: the norm and the rotary
embedding compute in float32 and return the input's dtype, the loss
computes in float32.  The reference's ``chunked_softmax_xent`` and
``scan_layers`` (its remat policy) serve training, which the port has
not taken yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
