"""Differentiable readability: sigmoid relaxations of the integer metrics
(counterpart of :mod:`repro.core.soft`).

The exact engine counts with hard indicators -- ``d2 < (2r)^2`` for node
occlusion, the strict ordinate reversal ``(yl_i < yl_j) & (yr_i > yr_j)``
for edge crossing -- so its gradient is zero almost everywhere.  This
module is its soft companion: the same plan, the same cell and strip
bucketing (:func:`repro_torch.core.grid.gather_ragged_buckets` over the
plan's occupancy tiers), the same orientation vote, but every hard
comparison ``a < b`` becomes ``sigmoid((b - a) / tau)``, so
:func:`soft_scores` is differentiable with ``torch.autograd`` and a
gradient step moves vertices along the engine's own decompositions.

* **Exact numbers are the reported numbers.**  The search
  (:mod:`repro_torch.search.gradient`) descends soft losses and re-scores
  with the exact engine.
* **Temperature is a 0-d tensor on the device.**  Sigmoid widths are
  ``temperature`` x the metric's natural scale: ``temperature * (2r)^2``
  for the occlusion indicator (squared distances), ``temperature * 2r``
  for the reversal indicator (boundary ordinates).
* **Soft -> exact as temperature -> 0** on layouts without exact ties (a
  tied comparison converges to 1/2 per sigmoid where the strict exact
  one says 0).
* **Gradients are finite on degenerate layouts** (duplicates, zero-length
  edges, E=0, collinear): every ``atan2`` / ``sqrt`` on the soft path is
  double-``where`` guarded (:func:`~repro_torch.core.geometry.segment_theta_safe`,
  :func:`~repro_torch.core.geometry.directed_angle_safe`,
  :func:`_safe_sqrt`): forward values unchanged, partials zero instead of
  NaN at the singular point.
* **Gradients at ties split as the reference's do**: ``torch.minimum`` /
  ``torch.maximum`` (never ``clamp``) on every value that carries a
  gradient, and ``amin`` / ``amax`` spread it evenly over ties.

The blocked pair sweeps recompute each block during the backward pass
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``; the
blocks draw no random numbers, so no RNG state is kept), so the backward
holds one block's ``(rows, cap, cap)`` intermediates at a time.
``grid.CALL_COUNTS`` are bumped outside the checkpointed blocks, where
the reference bumps them, so a recomputed block never counts twice.

The reference's ``trace_count()`` is not ported: eager PyTorch traces
nothing, so there is no retrace to count.  A caller that captures or
compiles the step would owe the port contract's zero-recompile proof.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import engine
from repro_torch.core import grid as gridlib
from repro_torch.core.min_angle import minimum_angle_batched


class SoftScores(NamedTuple):
    """Differentiable per-layout scores (``(B,)`` float fields).

    ``node_occlusion`` and ``edge_crossing`` are soft expected counts;
    ``overflow`` is the hard bucketing-drop counter (not differentiable).
    Fields are ``None`` when the plan's metric subset pruned them."""

    node_occlusion: torch.Tensor = None
    minimum_angle: torch.Tensor = None
    edge_length_variation: torch.Tensor = None
    edge_crossing: torch.Tensor = None
    edge_crossing_angle: torch.Tensor = None
    overflow: torch.Tensor = None


class SoftWeights(NamedTuple):
    """Per-metric weights of :func:`soft_loss`; each term is already
    normalized to a [0, 1]-ish scale before weighting."""

    node_occlusion: float = 1.0
    minimum_angle: float = 1.0
    edge_length_variation: float = 1.0
    edge_crossing: float = 1.0
    edge_crossing_angle: float = 1.0


def _safe_sqrt(x):
    """``sqrt`` with the double-``where`` guard: identical forward values
    (``sqrt(0) = 0``), zero gradient at 0 instead of ``inf``."""
    positive = x > 0
    return torch.where(positive, torch.sqrt(torch.where(positive, x, 1.0)),
                       0.0)


def _abs(x):
    """``|x|`` with the reference's derivative at 0: JAX differentiates
    ``abs`` as ``select(x >= 0, g, -g)`` (+1 at 0) where ``torch.abs``
    gives 0, and parallel segments put exact zeros here."""
    return torch.where(x >= 0, x, -x)


def _pair_diff(a):
    """``[r, i, j] = a[r, i] - a[r, j]`` of a ``(rows, cap)`` block, as the
    transpose of one broadcast minus itself: its backward sums ``G^T - G``
    along one axis, so the gradients of a pair ``(i, j)`` and its mirror
    ``(j, i)`` cancel exactly where they are equal (a degenerate strip
    whose segments all coincide), as they do in the reference.  Two
    broadcasts would be summed along two axes, in two orders, and leave a
    rounding residue there."""
    d = a[:, None, :].expand(-1, a.shape[1], -1)
    return d.transpose(1, 2) - d


def _blocks(rows: int, block: int):
    """Row slices of ``block`` rows: the reference's block starts, the
    last block cut short instead of padded (rows are independent, so no
    value changes)."""
    return [slice(b0, min(b0 + block, rows)) for b0 in range(0, rows, block)]


# ---------------------------------------------------------------------------
# soft node occlusion (the exact batched gridded counter, sigmoid indicator)
# ---------------------------------------------------------------------------

def _soft_occlusion(plan, pos, vertex_valid, tau):
    """Soft N_c over the plan's occlusion grid: the exact batched
    counter's bucketing and half-neighbourhood sweep with ``d2 <
    (2r)^2`` relaxed to ``sigmoid((thresh - d2) / tau)``.  Returns
    ``((B,) soft count, (B,) overflow)``."""
    B, V = pos.shape[0], pos.shape[1]
    nx, ny, cap = plan.grid_nx, plan.grid_ny, plan.cell_cap
    n_cells = nx * ny
    dev = pos.device
    gridlib.CALL_COUNTS["cell_builds"] += 1
    _, _, cid = gridlib.cell_indices(pos, plan.radius, plan.grid_origin, nx,
                                     ny, cell_size=plan.grid_cell_size)
    vmask = None if vertex_valid is None else vertex_valid.expand(B, V)
    x, y, bval, _, overflow = gridlib.gather_ragged_buckets(
        cid, n_cells, np.arange(n_cells, dtype=np.int64) * cap,
        np.full(n_cells, cap, np.int64), pos[..., 0], pos[..., 1],
        valid=vmask)
    rows = B * n_cells
    x = x.reshape(rows, cap)
    y = y.reshape(rows, cap)
    bval = bval.reshape(rows, cap)

    nbr = gridlib.neighbour_bucket_ids(nx, ny, device=dev)
    base = torch.arange(B, device=dev)[:, None, None] * n_cells
    nbr_f = torch.where(nbr[None] >= 0, nbr[None] + base,
                        -1).reshape(rows, 4)
    nbr_ok = nbr_f >= 0
    nbr_idx = torch.clamp_min(nbr_f, 0)
    thresh = gridlib._scalar((2.0 * plan.radius) ** 2, pos)
    tri = (torch.arange(cap, device=dev)[:, None]
           < torch.arange(cap, device=dev)[None, :])

    def block_fn(bx, by, bv, ni, no, x, y, tau):
        n = bx.shape[0]
        d2 = ((bx[:, :, None] - bx[:, None, :]) ** 2
              + (by[:, :, None] - by[:, None, :]) ** 2)
        smask = bv[:, :, None] & bv[:, None, :] & tri[None]
        w = torch.sigmoid((thresh - d2) / tau)
        same = torch.where(smask, w, 0.0).sum(dim=(1, 2))
        cx = x[ni].reshape(n, -1)
        cy = y[ni].reshape(n, -1)
        cv = (bval[ni] & no[:, :, None]).reshape(n, -1)
        c2 = ((bx[:, :, None] - cx[:, None, :]) ** 2
              + (by[:, :, None] - cy[:, None, :]) ** 2)
        cmask = bv[:, :, None] & cv[:, None, :]
        wc = torch.sigmoid((thresh - c2) / tau)
        cross = torch.where(cmask, wc, 0.0).sum(dim=(1, 2))
        return same + cross

    per_row = torch.cat([
        checkpoint(block_fn, x[sl], y[sl], bval[sl], nbr_idx[sl],
                   nbr_ok[sl], x, y, tau, use_reentrant=False,
                   preserve_rng_state=False)
        for sl in _blocks(rows, min(plan.cell_block, rows))])
    return per_row.reshape(B, n_cells).sum(dim=1), overflow


# ---------------------------------------------------------------------------
# soft reversal sweep (the exact tiered sweep, sigmoid reversal indicator)
# ---------------------------------------------------------------------------

def soft_reversal_block(yl, yr, theta, v, u, valid, *, ideal, tau,
                        with_angle: bool = True):
    """Soft :func:`~repro_torch.kernels.strip_reversal.fused_reversal_block`
    over a ``(rows, cap)`` bucket block, per-row reduction.

    The hard reversal becomes ``sigmoid((yl_j - yl_i) / tau) *
    sigmoid((yr_i - yr_j) / tau)``; the shared-endpoint and validity
    masks are the exact ones (pair membership comes from the exact
    bucketing, only the indicator is relaxed).  Returns per-row ``((rows,)
    soft count, (rows,) soft deviation sum)``."""
    w = (torch.sigmoid(-_pair_diff(yl) / tau)
         * torch.sigmoid(_pair_diff(yr) / tau))
    shared = ((v[:, :, None] == v[:, None, :]) |
              (v[:, :, None] == u[:, None, :]) |
              (u[:, :, None] == v[:, None, :]) |
              (u[:, :, None] == u[:, None, :]))
    mask = ~shared & valid[:, :, None] & valid[:, None, :]
    wm = torch.where(mask, w, 0.0)
    cnt = wm.sum(dim=(1, 2))
    if not with_angle:
        return cnt, torch.zeros(yl.shape[0], dtype=yl.dtype,
                                device=yl.device)
    ideal = gridlib._scalar(ideal, yl)
    d = _abs(_pair_diff(theta))
    a_c = torch.minimum(d, math.pi - d)
    dev = _abs(ideal - a_c) / ideal
    return cnt, (wm * dev).sum(dim=(1, 2))


def _soft_reversal_rows(yl, yr, th, v, u, ok, *, ideal, tau,
                        with_angle: bool, row_block: int):
    """Blocked per-row soft sweep (the soft twin of the engine's row
    blocking): ``row_block`` capped so that one ``(row_block, cap, cap)``
    intermediate holds at most 2^26 elements; each block recomputed in
    the backward pass."""
    rows, cap = yl.shape
    row_block = max(1, min(row_block, (1 << 26) // max(cap * cap, 1), rows))

    def block_fn(yl, yr, th, v, u, ok, tau):
        return soft_reversal_block(yl, yr, th, v, u, ok, ideal=ideal,
                                   tau=tau, with_angle=with_angle)

    out = [checkpoint(block_fn, yl[sl], yr[sl], th[sl], v[sl], u[sl],
                      ok[sl], tau, use_reentrant=False,
                      preserve_rng_state=False)
           for sl in _blocks(rows, row_block)]
    if not out:
        return yl.new_zeros(0), yl.new_zeros(0)
    return (torch.cat([c for c, _ in out]), torch.cat([d for _, d in out]))


def _soft_tiered_strip_stats(plan, axis_i, segs, B, *, tau,
                             with_angle: bool):
    """Soft twin of ``engine._tiered_strip_stats``: the same one-sort
    gather bucketing over the same occupancy-tier layout, soft sweep.
    Returns ``((B,) soft count, (B,) soft dev sum, (B,) dropped)``."""
    strip_off, strip_cap, _, slabs = engine._tier_layout(plan, axis_i)
    yl, yr, th, v, u, ok, _, dropped = gridlib.gather_ragged_buckets(
        segs.strip, plan.n_strips, strip_off, strip_cap,
        segs.yl, segs.yr, segs.theta, segs.v, segs.u, valid=segs.valid)

    gridlib.CALL_COUNTS["reversal_sweeps"] += 1
    cnt = yl.new_zeros(B)
    dev = yl.new_zeros(B)
    row_block = min(plan.strip_block, plan.n_strips)
    for off, n_t, cap_t in slabs:
        def sl(a):
            return a[:, off:off + n_t * cap_t].reshape(B * n_t, cap_t)
        rc, rd = _soft_reversal_rows(sl(yl), sl(yr), sl(th), sl(v), sl(u),
                                     sl(ok), ideal=plan.ideal, tau=tau,
                                     with_angle=with_angle,
                                     row_block=row_block)
        cnt = cnt + rc.reshape(B, n_t).sum(dim=1)
        dev = dev + rd.reshape(B, n_t).sum(dim=1)
    return cnt, dev, dropped


# ---------------------------------------------------------------------------
# guarded M_l (continuous already; sqrt guards only)
# ---------------------------------------------------------------------------

def _soft_edge_length_variation(pos, edges, edge_valid):
    """Batched M_l with every ``sqrt`` and division double-``where``
    guarded: identical forward values, finite gradients on zero-length
    edges and all-duplicate layouts."""
    d = pos[:, edges[:, 0].long()] - pos[:, edges[:, 1].long()]  # (B, E, 2)
    lengths = _safe_sqrt((d * d).sum(dim=-1))                    # (B, E)
    if edge_valid is None:
        edge_valid = torch.ones(edges.shape[0], dtype=torch.bool,
                                device=pos.device)
    ev = edge_valid.expand(lengths.shape)
    n_e = torch.clamp_min(ev.sum(dim=1), 1)
    l_mu = torch.where(ev, lengths, 0.0).sum(dim=1) / n_e
    sq = torch.where(ev, (lengths - l_mu[:, None]) ** 2, 0.0)
    denom = n_e * torch.maximum(l_mu, gridlib._scalar(1e-30, l_mu)) ** 2
    ok = denom > 0
    ratio = sq.sum(dim=1) / torch.where(ok, denom, 1.0)
    l_a = torch.where(ok, _safe_sqrt(ratio), 0.0)
    return torch.where(n_e > 1,
                       l_a / torch.sqrt(torch.clamp_min(n_e - 1, 1)), 0.0)


# ---------------------------------------------------------------------------
# the soft companion of evaluate_batched_body
# ---------------------------------------------------------------------------

def _tau(temperature, like):
    """``temperature`` as a 0-d tensor of ``like``'s dtype on its device
    (a fill: a host float never waits for the device's queue)."""
    if isinstance(temperature, torch.Tensor):
        return temperature.to(like.device, like.dtype).reshape(())
    return gridlib._scalar(float(temperature), like)


def soft_scores(plan, batch_pos, edges, temperature, *,
                n_valid_vertices=None, n_valid_edges=None) -> SoftScores:
    """Differentiable scores of ``(B, V, 2)`` layouts under ``plan``.

    The soft companion of
    :func:`repro_torch.core.engine.evaluate_batched_body`: same plan,
    same bucketing, same padding contract (``n_valid_*`` mask padded
    tails), but every count is a sigmoid-relaxed expectation and every
    primitive is gradient-safe, so ``torch.autograd.grad`` of any field's
    sum is finite on any input -- duplicates, E=0 (pad ``edges`` to one
    masked row), collinear.  ``batch_pos`` is a tensor (gradients flow
    into it) or a host array (placed on the CUDA device).
    ``temperature`` is a positive float or 0-d tensor."""
    pos, edges = engine.device_inputs(batch_pos, edges, None, plan.dtype)
    dev = pos.device
    B = pos.shape[0]
    tau = _tau(temperature, pos)
    vertex_valid = engine._valid_mask(pos.shape[1], n_valid_vertices, dev)
    edge_valid = engine._valid_mask(edges.shape[0], n_valid_edges, dev)
    m = plan.metrics
    out = {}
    overflow = torch.zeros(B, dtype=torch.int64, device=dev)

    if "node_occlusion" in m:
        tau_occ = tau * gridlib._scalar((2.0 * plan.radius) ** 2, pos)
        cnt, ov = _soft_occlusion(plan, pos, vertex_valid, tau_occ)
        overflow = overflow + ov
        out["node_occlusion"] = cnt
    if "minimum_angle" in m:
        out["minimum_angle"], _ = minimum_angle_batched(
            pos, edges, edge_valid=edge_valid, safe_grad=True)
    if "edge_length_variation" in m:
        out["edge_length_variation"] = _soft_edge_length_variation(
            pos, edges, edge_valid)

    want_ec = "edge_crossing" in m
    want_eca = "edge_crossing_angle" in m
    if want_ec or want_eca:
        tau_rev = tau * gridlib._scalar(2.0 * plan.radius, pos)
        stats = []
        for axis_i, (axis, (max_segments, _)) in enumerate(
                zip(plan.axes, plan.strip_plans)):
            segs = gridlib.build_strip_segments_batched(
                pos, edges, plan.n_strips, max_segments, axis=axis,
                edge_valid=edge_valid, safe_theta=True)
            cnt, dsum, drop = _soft_tiered_strip_stats(
                plan, axis_i, segs, B, tau=tau_rev, with_angle=want_eca)
            stats.append((cnt, dsum, drop + segs.overflow))
        if len(stats) == 1:
            ec_count, best_dev, ec_ov = stats[0]
            best_count = ec_count
        else:
            (c0, d0, o0), (c1, d1, o1) = stats
            ec_count = torch.maximum(c0, c1)
            ec_ov = torch.maximum(o0, o1)
            # the exact body's orientation vote on the soft counts; the
            # selected orientation carries the whole E_ca gradient
            take1 = c1 > c0
            best_count = torch.where(take1, c1, c0)
            best_dev = torch.where(take1, d1, d0)
        if want_ec:
            out["edge_crossing"] = ec_count
        if want_eca:
            # the exact "1 - dev / max(count, 1) if count else 1" without
            # the branch: dev and count vanish together
            out["edge_crossing_angle"] = 1.0 - best_dev / torch.maximum(
                best_count, gridlib._scalar(1.0, best_count))
        overflow = overflow + ec_ov

    return SoftScores(overflow=overflow, **out)


def soft_loss(plan, batch_pos, edges, temperature, *, weights=None,
              n_valid_vertices=None, n_valid_edges=None):
    """Per-layout scalar losses ``(B,)``: lower is better, 0 is perfect.

    Each metric contributes ``1 - normalized`` in the sense of
    :meth:`repro_torch.core.scores.ReadabilityScores.normalized` (counts
    over their pair budgets, ``M_l`` squashed by ``1/(1 + M_l)``), so with
    unit :class:`SoftWeights` minimizing the loss maximizes the mean
    normalized readability the search ranks by."""
    s = soft_scores(plan, batch_pos, edges, temperature,
                    n_valid_vertices=n_valid_vertices,
                    n_valid_edges=n_valid_edges)
    w = SoftWeights() if weights is None else weights
    like = s.overflow.new_zeros((), dtype=plan.dtype)
    nv = batch_pos.shape[1] if n_valid_vertices is None else n_valid_vertices
    ne = edges.shape[0] if n_valid_edges is None else n_valid_edges
    nv = _count(nv, like)
    ne = _count(ne, like)
    one = gridlib._scalar(1.0, like)
    vpairs = torch.maximum(nv * (nv - 1) / 2, one)
    epairs = torch.maximum(ne * (ne - 1) / 2, one)
    loss = torch.zeros(s.overflow.shape[0], dtype=plan.dtype,
                       device=like.device)
    if s.node_occlusion is not None:
        loss = loss + w.node_occlusion * s.node_occlusion / vpairs
    if s.minimum_angle is not None:
        loss = loss + w.minimum_angle * (1.0 - s.minimum_angle)
    if s.edge_length_variation is not None:
        m_l = s.edge_length_variation
        loss = loss + w.edge_length_variation * m_l / (1.0 + m_l)
    if s.edge_crossing is not None:
        loss = loss + w.edge_crossing * s.edge_crossing / epairs
    if s.edge_crossing_angle is not None:
        loss = loss + w.edge_crossing_angle * (1.0 - s.edge_crossing_angle)
    return loss


def _count(n, like):
    """A vertex or edge count (int or tensor) as a float 0-d tensor."""
    if isinstance(n, torch.Tensor):
        return n.to(like.device, like.dtype).reshape(())
    return gridlib._scalar(float(n), like)
