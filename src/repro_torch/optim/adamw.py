"""AdamW, its cosine schedule and gradient utilities (counterpart of
:mod:`repro.optim.adamw`).

Plain functions over (nested) dicts of tensors, the reference's pytrees:
optimizer state is congruent with the params, global-norm clipping,
cosine schedule with warmup, and the per-chunk int8 gradient compression.

Not ``torch.optim.AdamW``: the reference folds the decay into the update,
``p - lr * (mhat / (sqrt(vhat) + eps) + wd * p)``, with float32 bias
corrections ``1 - b ** step``; ``torch.optim.AdamW`` decays the weights
first, in its own order, and rounds differently.  Every divisor is a
tensor (CUDA turns division by a Python scalar into a reciprocal
multiply, which is not the reference's true division).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _is_enc(x):
    return isinstance(x, dict) and "q" in x


def _map(fn, *trees, is_leaf=None):
    """``fn`` over the leaves of congruent dicts (keys in sorted order, as
    JAX flattens a dict)."""
    first = trees[0]
    if isinstance(first, dict) and not (is_leaf and is_leaf(first)):
        return {k: _map(fn, *(t[k] for t in trees), is_leaf=is_leaf)
                for k in sorted(first)}
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _scalar(value, like):
    return torch.full((), value, dtype=torch.float32, device=like.device)


def cosine_schedule(cfg: AdamWConfig):
    """Linear warmup to ``peak_lr``, then a cosine down to
    ``min_lr_frac * peak_lr`` at ``total_steps``; ``lr(step)`` takes an
    integer step tensor and returns a float32 0-d tensor."""
    def lr(step):
        step = step.to(torch.float32)
        warm = cfg.peak_lr * step / _scalar(max(cfg.warmup_steps, 1), step)
        prog = torch.clamp(
            (step - cfg.warmup_steps)
            / _scalar(max(cfg.total_steps - cfg.warmup_steps, 1), step), 0, 1)
        cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) \
            * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)
    return lr


def init_state(params):
    """Zero moments congruent with ``params`` and an int32 step of 0."""
    leaf = _leaves(params)[0]
    return {"m": _map(torch.zeros_like, params),
            "v": _map(torch.zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def state_from_reference(m, v, step, *, device=None):
    """The port's optimizer state from the reference's: ``m`` / ``v`` as
    numpy arrays (or dicts of them, congruent with the params) and the
    step count, on ``device`` (CUDA unless the caller passes another)."""
    from repro_torch.core.engine import resolve_device

    dev = resolve_device(device)

    def put(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    return {"m": _map(put, m), "v": _map(put, v),
            "step": torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                                 device=dev)}


def global_norm(tree):
    leaves = _leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves))


def clip_by_global_norm(grads, max_norm):
    """``grads`` scaled to a global norm of at most ``max_norm``; returns
    ``(clipped, pre-clip norm)``."""
    norm = global_norm(grads)
    scale = torch.minimum(
        _scalar(1.0, norm),
        _scalar(max_norm, norm) / torch.maximum(norm, _scalar(1e-9, norm)))
    return _map(lambda g: g * scale, grads), norm


def apply_updates(params, grads, state, cfg: AdamWConfig,
                  lr_fn: Callable | None = None):
    """One AdamW step.  Returns ``(new_params, new_state, metrics)``."""
    lr_fn = lr_fn or cosine_schedule(cfg)
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state["step"] + 1
    lr = lr_fn(step)
    step_f = step.to(torch.float32)
    b1c = 1.0 - cfg.b1 ** step_f
    b2c = 1.0 - cfg.b2 ** step_f

    def upd(p, g, m, v):
        g = g.to(torch.float32)
        p32 = p.to(torch.float32)
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m / b1c
        vhat = v / b2c
        new_p = p32 - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                            + cfg.weight_decay * p32)
        return new_p.to(p.dtype), m, v

    out = _map(upd, params, grads, state["m"], state["v"])

    def pick(i):
        return _map(lambda o: o[i], out)

    new_state = {"m": pick(1), "v": pick(2), "step": step}
    return pick(0), new_state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# gradient compression (optional int8 all-reduce payload)
# ---------------------------------------------------------------------------

def compress_int8(tree, chunk: int = 256):
    """Per-chunk-scaled int8 encode: a payload 4x smaller than float32.
    Each leaf becomes ``{"q": int8 (n_chunks, chunk), "scale": float32
    (n_chunks, 1), "shape": original shape}``."""
    def enc(x):
        flat = x.to(torch.float32).reshape(-1)
        pad = (-flat.shape[0]) % chunk
        flat = torch.cat([flat, flat.new_zeros(pad)])
        c = flat.reshape(-1, chunk)
        scale = torch.amax(torch.abs(c), dim=1, keepdim=True) \
            / _scalar(127.0, c)
        q = torch.clamp(torch.round(c / torch.maximum(scale,
                                                      _scalar(1e-12, c))),
                        -127, 127).to(torch.int8)
        return {"q": q, "scale": scale, "shape": tuple(x.shape)}
    return _map(enc, tree)


def decompress_int8(enc_tree):
    def dec(e):
        c = e["q"].to(torch.float32) * e["scale"]
        n = 1
        for s in e["shape"]:
            n *= s
        return c.reshape(-1)[:n].reshape(e["shape"])
    return _map(dec, enc_tree, is_leaf=_is_enc)
