"""AdamW, its cosine schedule and gradient utilities (counterpart of
:mod:`repro.optim.adamw`).

Plain functions over (nested) dicts and lists of tensors, the
reference's pytrees: optimizer state is congruent with the params,
global-norm clipping, cosine schedule with warmup, and the per-chunk
int8 gradient compression.
:func:`apply_updates` is functional, as the reference's;
:func:`apply_updates_` computes the same step in place, block by block
(a trainer at full width has no room for a second copy of its
parameters and moments; on ``DTensor`` leaves each rank updates its own
shards, the global norm summed over the ranks), and :func:`int8_roundtrip_` overwrites each
gradient with ``decompress_int8(compress_int8(.))`` of it, row block by
row block.

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
    """``fn`` over the leaves of congruent dicts and lists (dict keys in
    sorted order, as JAX flattens a dict; lists in order)."""
    first = trees[0]
    if isinstance(first, dict) and not (is_leaf and is_leaf(first)):
        return {k: _map(fn, *(t[k] for t in trees), is_leaf=is_leaf)
                for k in sorted(first)}
    if isinstance(first, list):
        return [_map(fn, *leaves, is_leaf=is_leaf) for leaves in zip(*trees)]
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _leaves(t)]
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


def _clip_scale(norm, max_norm):
    return torch.minimum(
        _scalar(1.0, norm),
        _scalar(max_norm, norm) / torch.maximum(norm, _scalar(1e-9, norm)))


def clip_by_global_norm(grads, max_norm):
    """``grads`` scaled to a global norm of at most ``max_norm``; returns
    ``(clipped, pre-clip norm)``."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
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


# elements per piece of a leaf that apply_updates_ updates at once, and
# chunks per piece that int8_roundtrip_ encodes at once: each bounds the
# temporaries of an in-place step (64 MiB and 16 MiB of float32)
BLOCK = 1 << 24
ROWS = 1 << 16
# elements per int8 chunk, each with its own scale
CHUNK = 256


def _local(t):
    """A ``DTensor``'s local shard (a plain tensor as it is): the in-place
    step is elementwise, so each rank updates its own shard."""
    return t.to_local() if hasattr(t, "to_local") else t


def _blocks(t, block):
    flat = _local(t).view(-1)
    return [flat[i:i + block] for i in range(0, flat.numel(), block)]


@torch.no_grad()
def apply_updates_(params, grads, state, cfg: AdamWConfig):
    """:func:`apply_updates` in place: clips ``grads``, then updates each
    parameter and its moments ``state["m"]`` / ``state["v"]`` and
    advances ``state["step"]``, ``BLOCK`` elements at a time, with the
    functional step's operations in its order, so the results are
    bit-equal to it.  Every leaf is a contiguous float32 tensor.  Returns
    the metrics ``{"grad_norm", "lr"}``."""
    leaves = [_leaves(t) for t in (params, grads, state["m"], state["v"])]
    # a DTensor gradient takes its parameter's layout first (the
    # data-parallel reduction of a Partial gradient)
    leaves[1] = [g.redistribute(p.device_mesh, p.placements)
                 if hasattr(g, "placements") and g.placements != p.placements
                 else g for p, g in zip(leaves[0], leaves[1])]
    gnorm = global_norm(leaves[1])
    scale = _clip_scale(gnorm, cfg.clip_norm)
    step = state["step"] + 1
    lr = cosine_schedule(cfg)(step)
    step_f = step.to(torch.float32)
    b1c = 1.0 - cfg.b1 ** step_f
    b2c = 1.0 - cfg.b2 ** step_f
    scale, lr, b1c, b2c = (_local(t) for t in (scale, lr, b1c, b2c))
    for p, g, m, v in zip(*leaves):
        for t in (p, g, m, v):
            if t.dtype != torch.float32:
                raise TypeError(f"apply_updates_ takes float32 leaves, got "
                                f"{t.dtype}")
        for pb, gb, mb, vb in zip(*(_blocks(t, BLOCK) for t in (p, g, m, v))):
            gb.mul_(scale)
            mb.mul_(cfg.b1).add_(gb * (1 - cfg.b1))
            vb.mul_(cfg.b2).add_((gb * (1 - cfg.b2)).mul_(gb))
            upd = (mb / b1c).div_(torch.sqrt(vb / b2c).add_(cfg.eps))
            upd.add_(pb * cfg.weight_decay).mul_(lr)
            pb.sub_(upd)
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# gradient compression (optional int8 all-reduce payload)
# ---------------------------------------------------------------------------

def compress_int8(tree, chunk: int = CHUNK):
    """Per-chunk-scaled int8 encode: a payload 4x smaller than float32.
    Each leaf becomes ``{"q": int8 (n_chunks, chunk), "scale": float32
    (n_chunks, 1), "shape": original shape}``."""
    def enc(x):
        flat = x.to(torch.float32).reshape(-1)
        pad = (-flat.shape[0]) % chunk
        flat = torch.cat([flat, flat.new_zeros(pad)])
        q, scale = _encode_rows(flat.reshape(-1, chunk))
        return {"q": q, "scale": scale, "shape": tuple(x.shape)}
    return _map(enc, tree)


def _encode_rows(c):
    """int8 codes and float32 scales of the rows of ``c``."""
    scale = torch.amax(torch.abs(c), dim=1, keepdim=True) \
        / _scalar(127.0, c)
    q = torch.clamp(torch.round(c / torch.maximum(scale, _scalar(1e-12, c))),
                    -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(enc_tree):
    def dec(e):
        c = e["q"].to(torch.float32) * e["scale"]
        n = 1
        for s in e["shape"]:
            n *= s
        return c.reshape(-1)[:n].reshape(e["shape"])
    return _map(dec, enc_tree, is_leaf=_is_enc)


@torch.no_grad()
def int8_roundtrip_(tree):
    """Overwrite every leaf (a contiguous float32 tensor) with its values
    after :func:`compress_int8` (``chunk=CHUNK``) and
    :func:`decompress_int8`, ``ROWS`` chunks at a time (the last chunk of
    a leaf padded with zeros, as ``compress_int8`` pads it), without
    holding the encoded tree."""
    for x in _leaves(tree):
        if x.dtype != torch.float32:
            raise TypeError(f"int8_roundtrip_ takes float32 leaves, got "
                            f"{x.dtype}")
        flat = x.view(-1)
        whole = flat.numel() // CHUNK * CHUNK
        for c in _blocks(flat[:whole], ROWS * CHUNK):
            c = c.view(-1, CHUNK)
            q, scale = _encode_rows(c)
            torch.mul(q.to(torch.float32), scale, out=c)
        if whole < flat.numel():
            tail = torch.cat([flat[whole:],
                              flat.new_zeros(CHUNK - flat.numel() + whole)])
            q, scale = _encode_rows(tail.view(1, CHUNK))
            flat[whole:] = (q.to(torch.float32) * scale).view(-1)[
                :flat.numel() - whole]
