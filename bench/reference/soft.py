"""The gradient layout search, plainly: the restart batch, the soft loss,
its gradient, and AdamW's steps.

The soft loss relaxes each hard pair test of the enhanced scores into a
sigmoid: an occlusion ``d2 < (2r)^2`` becomes ``sigmoid(((2r)^2 - d2) /
(tau (2r)^2))`` over the candidate pairs of an occlusion grid, a strip
reversal becomes ``sigmoid((yl_j - yl_i) / (2 r tau)) * sigmoid((yr_i -
yr_j) / (2 r tau))`` over the ordered segment pairs of each strip
(pairs sharing an endpoint excluded).  Per layout,

    loss = N_c / C(V, 2) + (1 - M_a) + M_l / (1 + M_l)
           + E_c / C(E, 2) + (1 - E_ca),

with ``E_c`` the larger soft count of the two strip orientations and
``E_ca = 1 - dev / max(count, 1)`` of that orientation.

The occlusion grid is worked out from the restart batch by the search's
rule: its lower corner at the batch's minimum less 1e-6, cells of side
``max(2r, sqrt(area * 8 / V))``, cell indices formed in float32; every
step runs under it while the search makes no new plan.  A step of AdamW
starts from the moments the last step left (zeros before the first):
the gradient clipped to a global norm of ``clip_norm``, then the moments and the positions, with
the learning rate of a linear warm-up and a cosine decay and the
temperature annealed geometrically, both taken from the step's index.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from bench.reference import scores, strips
from bench.reference.pairs import const

HALF_NEIGHBOURHOOD = ((1, 0), (0, 1), (1, 1), (1, -1))


def restart_batch(pos0, restarts, jitter, seed):
    """``(restarts, V, 2)`` float32: the seed layout, then copies moved by
    ``jitter * extent * N(0, 1)`` drawn from ``seed``; ``extent`` is the
    layout's larger side."""
    pos0 = np.asarray(pos0, np.float32)
    rng = np.random.default_rng(seed)
    extent = float(max(np.ptp(pos0, axis=0).max(), 1e-6))
    batch = np.repeat(pos0[None], restarts, axis=0)
    noise = rng.standard_normal((restarts - 1,) + pos0.shape).astype(
        np.float32)
    batch[1:] += jitter * extent * noise
    return batch


def occlusion_grid(batch, radius, target=8.0):
    """``(origin (2,) float32, size, nx, ny)`` of the batch's grid."""
    flat = batch.reshape(-1, 2)
    lo = flat.min(axis=0) - 1e-6
    hi = flat.max(axis=0) + 1e-6
    area = float(hi[0] - lo[0]) * float(hi[1] - lo[1])
    size = max(2.0 * float(radius), (area * target / batch.shape[1]) ** 0.5)
    nx = max(1, int(np.ceil((hi[0] - lo[0]) / size)))
    ny = max(1, int(np.ceil((hi[1] - lo[1]) / size)))
    return lo.astype(np.float32), size, nx, ny


def soft_occlusion(pos, grid, radius, tau):
    """Soft occlusion count of one layout ``pos (V, 2)``."""
    origin, size, nx, ny = grid
    dev = pos.device
    with torch.no_grad():
        p32 = pos.detach().float()
        s32 = torch.tensor(size, dtype=torch.float32, device=dev)
        o32 = torch.tensor(origin, dtype=torch.float32, device=dev)
        ix = torch.floor((p32[:, 0] - o32[0]) / s32).long().clamp(0, nx - 1)
        iy = torch.floor((p32[:, 1] - o32[1]) / s32).long().clamp(0, ny - 1)
        cell = iy * nx + ix
        order = torch.argsort(cell, stable=True)
        occ = torch.bincount(cell, minlength=nx * ny)
        cap = max(int(occ.max()), 1)
        slot = torch.arange(cell.shape[0], device=dev) - (
            torch.cumsum(occ, 0) - occ)[cell[order]]
        flat = cell[order] * cap + slot
        idx = torch.full((nx * ny * cap,), -1, dtype=torch.long, device=dev)
        idx[flat] = order
        idx = idx.reshape(ny, nx, cap)
    thresh = const((2.0 * float(radius)) ** 2, pos)
    t_occ = tau * thresh

    def weight(a, b):
        """Sum of the pair weights between ``(..., cap)`` index blocks."""
        ok = (a[..., :, None] >= 0) & (b[..., None, :] >= 0)
        pa, pb = pos[a.clamp_min(0)], pos[b.clamp_min(0)]
        d = pa[..., :, None, :] - pb[..., None, :, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
        w = torch.sigmoid((thresh - d2) / t_occ)
        return torch.where(ok, w, 0.0).sum()

    tri = torch.triu(torch.ones(cap, cap, dtype=torch.bool, device=dev), 1)
    ok = (idx[..., :, None] >= 0) & (idx[..., None, :] >= 0) & tri
    pa = pos[idx.clamp_min(0)]
    d = pa[..., :, None, :] - pa[..., None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    total = torch.where(ok, torch.sigmoid((thresh - d2) / t_occ), 0.0).sum()
    for dx, dy in HALF_NEIGHBOURHOOD:
        ys = slice(max(0, -dy), ny - max(0, dy))
        yt = slice(max(0, dy), ny - max(0, -dy))
        xs, xt = slice(0, nx - dx), slice(dx, nx)
        total = total + weight(idx[ys, xs], idx[yt, xt])
    return total


def soft_strips(pos, edges, n_strips, axis, ideal, tau_rev, *,
                pair_budget=1 << 24):
    """``(soft count, soft deviation sum)`` of one orientation."""
    strip, yl, yr, theta, v, u = strips.strip_segments(
        pos, edges, n_strips, axis, index_pos=pos.detach().float())
    dev = pos.device
    with torch.no_grad():
        order = torch.sort(strip, stable=True).indices
        occ = torch.bincount(strip, minlength=n_strips)
        cap = max(int(occ.max()), 1)
        slot = torch.arange(strip.shape[0], device=dev) - (
            torch.cumsum(occ, 0) - occ)[strip[order]]
        flat = strip[order] * cap + slot
    idx = torch.full((n_strips * cap,), -1, dtype=torch.long, device=dev)
    idx[flat] = order
    idx = idx.reshape(n_strips, cap)
    ok = idx >= 0
    gi = idx.clamp_min(0)
    vv = torch.where(ok, v.long()[gi], -1)
    uu = torch.where(ok, u.long()[gi], -2)
    ideal_t = const(float(ideal), pos)

    def block(yl_b, yr_b, th_b, v_b, u_b, ok_b):
        w = (torch.sigmoid((yl_b[:, None, :] - yl_b[:, :, None]) / tau_rev)
             * torch.sigmoid((yr_b[:, :, None] - yr_b[:, None, :])
                             / tau_rev))
        shared = ((v_b[:, :, None] == v_b[:, None, :])
                  | (v_b[:, :, None] == u_b[:, None, :])
                  | (u_b[:, :, None] == v_b[:, None, :])
                  | (u_b[:, :, None] == u_b[:, None, :]))
        mask = ~shared & ok_b[:, :, None] & ok_b[:, None, :]
        wm = torch.where(mask, w, 0.0)
        d = torch.abs(th_b[:, :, None] - th_b[:, None, :])
        a_c = torch.minimum(d, math.pi - d)
        dv = torch.abs(ideal_t - a_c) / ideal_t
        return wm.sum(), (wm * dv).sum()

    yl_d, yr_d, th_d = yl[gi], yr[gi], theta[gi]
    cnt = dsum = 0.0
    rows = max(1, pair_budget // (cap * cap))
    for s0 in range(0, n_strips, rows):
        sl = slice(s0, s0 + rows)
        c, dsm = checkpoint(block, yl_d[sl], yr_d[sl], th_d[sl], vv[sl],
                            uu[sl], ok[sl], use_reentrant=False)
        cnt, dsum = cnt + c, dsum + dsm
    return cnt, dsum


def soft_loss(pos, edges, grid, *, radius, n_strips, ideal, tau):
    """The soft loss of one layout ``pos (V, 2)`` (differentiable)."""
    n_v, n_e = pos.shape[0], edges.shape[0]
    nc = soft_occlusion(pos, grid, radius, tau)
    tau_rev = tau * const(2.0 * float(radius), pos)
    (c0, d0), (c1, d1) = (soft_strips(pos, edges, n_strips, axis, ideal,
                                      tau_rev) for axis in (0, 1))
    take1 = c1 > c0
    count = torch.where(take1, c1, c0)
    dsum = torch.where(take1, d1, d0)
    e_ca = 1.0 - dsum / torch.clamp_min(count, 1.0)
    m_a = scores.minimum_angle_t(pos, edges)
    m_l = scores.edge_length_variation_t(pos, edges)
    return (nc / max(n_v * (n_v - 1) / 2, 1) + (1.0 - m_a)
            + m_l / (1.0 + m_l) + torch.maximum(c0, c1)
            / max(n_e * (n_e - 1) / 2, 1) + (1.0 - e_ca))


def temperature_at(traffic, k):
    """The soft loss's temperature at step ``k`` (from 0): geometric from
    ``temperature`` to ``final_temperature`` over ``steps``, rounded to
    float32 as the configuration states."""
    t0, t1 = traffic["temperature"], traffic["final_temperature"]
    frac = k / max(traffic["steps"] - 1, 1)
    return float(np.float32(t0 * (t1 / t0) ** frac))


def lr_at(opt, step):
    """The learning rate of step ``step`` (from 1): linear warm-up to
    ``peak_lr`` over ``warmup_steps``, then a cosine down to
    ``min_lr_frac * peak_lr`` at ``total_steps``."""
    warm, total = opt["warmup_steps"], opt["total_steps"]
    if step < warm:
        return opt["peak_lr"] * step / max(warm, 1)
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return opt["peak_lr"] * (opt["min_lr_frac"] + (1 - opt["min_lr_frac"])
                             * 0.5 * (1 + math.cos(math.pi * prog)))


def apply_moments(pos, m, v, step, opt):
    """AdamW's new positions from ``pos`` and the moments ``m``, ``v``
    after step ``step``, in float64: ``pos - lr (mhat / (sqrt(vhat) +
    eps) + wd pos)`` with the bias corrections of ``step``."""
    pos, m, v = (torch.as_tensor(t).double() for t in (pos, m, v))
    mhat = m / (1 - opt["b1"] ** step)
    vhat = v / (1 - opt["b2"] ** step)
    return pos - lr_at(opt, step) * (mhat / (torch.sqrt(vhat) + opt["eps"])
                                     + opt["weight_decay"] * pos)


def gradients(pos, edges, grid, *, radius, n_strips, ideal, tau,
              dtype=torch.float64, device="cuda"):
    """Per-layout soft losses ``(B,)`` and their gradients ``(B, V, 2)``
    float64 (on the host) at ``pos``, the loss formed in ``dtype``."""
    e = torch.as_tensor(edges, device=device)
    tau_t = torch.tensor(float(tau), dtype=dtype, device=device)
    losses, grads = [], []
    for b in range(pos.shape[0]):
        p = torch.as_tensor(pos[b]).to(device=device, dtype=dtype)
        p.requires_grad_(True)
        loss = soft_loss(p, e, grid, radius=radius, n_strips=n_strips,
                         ideal=ideal, tau=tau_t)
        g, = torch.autograd.grad(loss, p)
        losses.append(float(loss.detach()))
        grads.append(g.double().cpu())
    return np.array(losses), torch.stack(grads)


def step(pos, m, v, k, edges, grid, *, traffic, radius, n_strips, ideal,
         dtype=torch.float64, device="cuda"):
    """Step ``k`` (from 1) of the search from the positions ``pos`` and
    the moments ``m``, ``v`` that step ``k - 1`` left (host tensors or
    arrays; zeros before the first): the losses, the pre-clip gradient
    norm, the clipped gradient ``g``, the new moments and the new
    positions, float64 on the host."""
    opt = traffic["opt"]
    losses, g = gradients(pos, edges, grid, radius=radius,
                          n_strips=n_strips, ideal=ideal,
                          tau=temperature_at(traffic, k - 1), dtype=dtype,
                          device=device)
    norm = float(torch.sqrt((g * g).sum()))
    g = g * min(1.0, opt["clip_norm"] / max(norm, 1e-9))
    m = opt["b1"] * torch.as_tensor(m).double() + (1 - opt["b1"]) * g
    v = opt["b2"] * torch.as_tensor(v).double() + (1 - opt["b2"]) * g * g
    return dict(losses=losses, grad_norm=norm, g=g, m=m, v=v,
                new_pos=apply_moments(pos, m, v, k, opt))


def search_steps(batch, edges, *, traffic, radius, n_strips, ideal,
                 dtype=torch.float64, device="cuda"):
    """Every step of the search from the restart ``batch``, as the
    program records them: ``[dict(pos, m, v, losses, grad_norm)]``, the
    state float32 on the host."""
    grid = occlusion_grid(batch, radius)
    pos = torch.as_tensor(batch)
    m = v = torch.zeros(batch.shape, dtype=torch.float64)
    out = []
    for k in range(1, traffic["steps"] + 1):
        s = step(pos, m, v, k, edges, grid, traffic=traffic, radius=radius,
                 n_strips=n_strips, ideal=ideal, dtype=dtype, device=device)
        pos, m, v = s["new_pos"], s["m"], s["v"]
        out.append(dict(pos=pos.float(), m=m.float(), v=v.float(),
                        losses=s["losses"], grad_norm=s["grad_norm"]))
    return out
