"""Distributed enhanced readability metrics (paper S3.2) over a mesh
(counterpart of :mod:`repro.distributed.gridded`).

The enhanced algorithms are bags of independent per-strip and per-cell
subproblems, the embarrassingly parallel regime behind the paper's fig. 4
strong scaling.  The bucketing runs on every rank; the O(cap^2) per-strip
pair blocks, the work that dominates, split over every mesh axis with no
communication until the final sum; over-decomposition (strips much more
numerous than ranks) bounds what a slow rank delays.
"""

from __future__ import annotations

import torch

from repro_torch.core.grid import SegmentBuckets
from repro_torch.core.validate import BackendUnavailableError, ReadabilityError
from repro_torch.distributed.collectives import psum, psum_all
from repro_torch.distributed.sharding import mesh_size
from repro_torch.kernels.strip_reversal import (fused_reversal_block,
                                                strip_reversal_rows)


def _pad_strips(buckets: SegmentBuckets, n_dev: int):
    """``buckets`` with empty strips appended up to a multiple of
    ``n_dev``; returns ``(buckets, n_strips)``."""
    n_strips = buckets.yl.shape[0]
    pad = (-n_strips) % n_dev
    if pad == 0:
        return buckets, n_strips

    def padc(a, fill):
        return torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]), fill,
                                        dtype=a.dtype, device=a.device)])

    return SegmentBuckets(
        yl=padc(buckets.yl, 0.0), yr=padc(buckets.yr, 0.0),
        theta=padc(buckets.theta, 0.0), v=padc(buckets.v, -1),
        u=padc(buckets.u, -2), valid=padc(buckets.valid, False),
        overflow=buckets.overflow), n_strips + pad


def sharded_reversal_stats(mesh, buckets: SegmentBuckets, *,
                           ideal_angle=None, strip_block: int = 64):
    """Strip-sharded crossing count (and deviation sum with
    ``ideal_angle``) of flat ``(n_strips, cap)`` buckets: each rank sweeps
    its contiguous share of the strips with
    :func:`~repro_torch.kernels.strip_reversal.strip_reversal_rows` (the
    kernel on CUDA, the engine's formula on the CPU), then the ranks sum.
    Returns ``(count,)`` or ``(count, deviation_sum)``.  A failed dispatch
    raises :class:`BackendUnavailableError` (``request_index=0``) with
    the original chained; typed errors pass through."""
    want_angle = ideal_angle is not None
    try:
        buckets, n_strips = _pad_strips(buckets, mesh.size)
        per = n_strips // mesh.size
        cap = buckets.yl.shape[1]
        sl = slice(mesh.rank * per, (mesh.rank + 1) * per)

        def mine(a, dtype):
            return a[sl].to(mesh.device, dtype).contiguous()

        f32, i32 = torch.float32, torch.int32
        rc, rd = strip_reversal_rows(
            mine(buckets.yl, f32), mine(buckets.yr, f32),
            mine(buckets.theta, f32), mine(buckets.v, i32),
            mine(buckets.u, i32), mine(buckets.valid, torch.bool),
            ideal=float(ideal_angle if want_angle else 1.0),
            with_angle=want_angle,
            row_block=max(1, min(strip_block, (1 << 26) // max(cap * cap, 1),
                                 per)))
        count = psum(mesh, rc.sum())
        dev_sum = psum(mesh, rd.sum())
    except ReadabilityError:
        raise
    except Exception as err:
        raise BackendUnavailableError(
            f"strip-sharded reversal dispatch over {mesh.size} ranks "
            f"failed: {type(err).__name__}: {err}", request_index=0) from err
    if want_angle:
        return count, dev_sum
    return (count,)


def evaluate_sharded(mesh, pos, edges, *, config=None, plan=None):
    """Config-driven distributed front door: one
    :class:`~repro_torch.core.keys.EvalConfig` -> one host
    :class:`~repro_torch.core.scores.ReadabilityScores`, computed over
    ``mesh`` (``Evaluator(EvalConfig(backend="distributed"))`` routes
    here).  Every rank of the mesh calls it with the same arguments.

    * ``N_c``: the row-sharded exact pairwise count
      (:func:`repro_torch.distributed.pairwise.sharded_occlusion_count`,
      the occlusion-pair kernel on each rank's rows; the grid count
      equals it, paper Table 3);
    * ``E_c`` / ``E_ca``: per orientation, the strip decomposition of the
      flat plan swept by :func:`sharded_reversal_stats`, the orientation
      with the most crossings taken as the engine takes it;
    * ``M_a`` / ``M_l``: on one rank's device, never worth a collective.

    Skipped metrics are skipped: a crossing-only config builds no cells
    and an occlusion-only one runs no sweep.  A ``(B, V, 2)`` batch goes
    to :func:`repro_torch.distributed.batched.evaluate_layouts_sharded`
    (the batch axis over the ranks).
    """
    from repro_torch.core import engine
    from repro_torch.core import grid as gridlib
    from repro_torch.core.edge_length import edge_length_variation
    from repro_torch.core.keys import EvalConfig
    from repro_torch.core.min_angle import minimum_angle
    from repro_torch.core.scores import ReadabilityScores, host_batch
    from repro_torch.distributed.pairwise import sharded_occlusion_count

    config = config or EvalConfig()
    pos, edges = engine.device_inputs(pos, edges, mesh.device)
    if pos.ndim == 3:
        from repro_torch.distributed.batched import evaluate_layouts_sharded
        if plan is None:
            plan = engine.plan_readability(pos, edges,
                                           **config.plan_kwargs())
        return host_batch(evaluate_layouts_sharded(mesh, plan, pos, edges),
                          int(pos.shape[1]), int(edges.shape[0]))
    if plan is None:
        # flat strips: each rank sweeps a contiguous share of the dense
        # flat buckets (tiering is a single-device pair-tile saving)
        plan = engine.plan_readability(
            pos, edges, **config.plan_kwargs(tier_default=False))
    m = config.metrics
    out = {}
    overflow = 0

    if "node_occlusion" in m:
        out["node_occlusion"] = int(sharded_occlusion_count(
            mesh, pos, config.radius))
    if "minimum_angle" in m:
        m_a, _ = minimum_angle(pos, edges)
        out["minimum_angle"] = float(m_a)
    if "edge_length_variation" in m:
        out["edge_length_variation"] = float(edge_length_variation(pos,
                                                                   edges))

    want_ec = "edge_crossing" in m
    want_eca = "edge_crossing_angle" in m
    if want_ec or want_eca:
        stats = []
        for axis, (max_segments, cap) in zip(plan.axes, plan.strip_plans):
            segs = gridlib.build_strip_segments(
                pos, edges, plan.n_strips, max_segments, axis=axis)
            buckets = gridlib.bucketize_segments(segs, plan.n_strips, cap)
            res = sharded_reversal_stats(
                mesh, buckets, ideal_angle=plan.ideal if want_eca else None)
            cnt = int(res[0])
            dev = float(res[1]) if want_eca else 0.0
            stats.append((cnt, dev, int(buckets.overflow)))
        # best orientation = most crossings; strictly greater keeps axis
        # 0 on ties (the engine's rule)
        best = max(range(len(stats)), key=lambda i: (stats[i][0], -i))
        overflow += max(s[2] for s in stats)
        if want_ec:
            out["edge_crossing"] = max(s[0] for s in stats)
        if want_eca:
            cnt, dev, _ = stats[best]
            out["edge_crossing_angle"] = (1.0 - dev / cnt if cnt > 0
                                          else 1.0)
            out["crossing_count_for_angle"] = cnt

    return ReadabilityScores(overflow=overflow,
                             n_vertices=int(pos.shape[0]),
                             n_edges=int(edges.shape[0]), **out)


def lower_sharded_reversal(mesh, n_strips: int, cap: int, *,
                           strip_block: int = 64, with_angle: bool = False,
                           ideal_angle=None):
    """The strip-sharded enhanced crossing counter as one rank's program,
    for the dry run at full problem size: returns ``(fn,
    abstract_args)``.

    ``abstract_args`` are meta tensors of this rank's shards of the
    reference's padded ``(n_strips_pad, cap)`` bucket arrays (``yl``,
    ``yr``, ``theta`` float32, ``v``, ``u`` int32, ``valid`` bool, strips
    split over every mesh axis); ``fn(yl, yr, theta, v, u, valid)``
    sweeps them ``strip_block`` strips at a time with
    :func:`~repro_torch.kernels.strip_reversal.fused_reversal_block` (the
    formula the kernel computes; a fake trace cannot enter the kernel)
    and returns ``(count, deviation sum)`` summed over the mesh (one
    all-reduce each).  On real tensors it runs."""
    n_dev = mesh_size(mesh)
    n_strips_pad = -(-n_strips // n_dev) * n_dev
    per = n_strips_pad // n_dev
    b = min(strip_block, per)
    ideal = 1.0 if ideal_angle is None else ideal_angle

    def fn(yl, yr, theta, v, u, valid):
        count = torch.zeros((), dtype=torch.int64, device=yl.device)
        dev = torch.zeros((), dtype=torch.float32, device=yl.device)
        for s0 in range(0, per, b):
            # the reference's dynamic_slice clamps a last short block
            sl = slice(min(s0, per - b), min(s0, per - b) + b)
            c, d = fused_reversal_block(yl[sl], yr[sl], theta[sl], v[sl],
                                        u[sl], valid[sl], ideal=ideal,
                                        with_angle=with_angle)
            count = count + c
            dev = dev + d
        return psum_all(mesh, count), psum_all(mesh, dev)

    def meta(dtype):
        return torch.empty((per, cap), dtype=dtype, device="meta")

    f32, i32 = torch.float32, torch.int32
    return fn, (meta(f32), meta(f32), meta(f32), meta(i32), meta(i32),
                meta(torch.bool))
