"""Fused readability engine: plan once, evaluate many (counterpart of
:mod:`repro.core.engine`).

* **Plan** (:func:`plan_readability`, host side, once per graph
  topology/extent): occlusion-grid dims + capacity, per-orientation strip
  segment budgets, capacities and occupancy tiers.  The
  :class:`ReadabilityPlan` is a frozen dataclass with the reference's
  fields; :func:`plan_from_reference` rebuilds one from a reference plan.

* **Evaluate** (:func:`evaluate_planned` / :func:`evaluate_once`): all
  five metrics with shared decompositions, as eager PyTorch ops::

      pos ──> cell buckets ───────────────────────────> N_c
      pos ──> strip segments ──> per-strip buckets ──┐
              (per orientation, built ONCE and       ├─> reversal sweep
               shared by E_c and E_ca)               ┘   -> (E_c, E_ca dev)
      pos ──> half-edge sort ──> M_a;   pos ──> edge lengths ──> M_l

  The per-strip reversal sweep, the dominant O(cap^2 * strips) cost,
  runs once per orientation and occupancy tier through
  :func:`repro_torch.kernels.strip_reversal.strip_reversal_rows`: the
  hand-written kernel on a CUDA device, its plain formula
  (:func:`fused_reversal_block`) on the CPU.  The orientation with the
  most crossings is selected on the device.

* **Batch** (:func:`evaluate_layouts`): ``(B, V, 2)`` candidate layouts
  of one graph in one natively batched pass: every bucketing step groups
  the whole batch with one sort per row and gathers, and one sweep per
  tier and orientation covers the ``(B * n_t, cap_t)`` rows.  Integer
  metrics equal the single-layout path's.

``use_kernels=True`` (``backend="kernels"``) sweeps flat
``(n_strips, cap)`` buckets and counts N_c with the exact all-pairs
occlusion kernel instead of the grid.

**Padding contract**: the evaluators take optional ``n_valid_vertices``
/ ``n_valid_edges``; only ``pos[:n_valid_vertices]`` and
``edges[:n_valid_edges]`` exist as far as every metric is concerned.
Integer metrics are equal between natural-size and padded evaluation.
If a layout outgrows the plan's capacities, ``overflow`` says so and
:func:`replan_on_overflow` grows the plan.

**Device**: tensors keep their device; numpy inputs go to ``device``,
which defaults to CUDA (see :func:`resolve_device`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import crossing_angle as _calib
from repro_torch.core import grid as gridlib
from repro_torch.core.edge_length import (edge_length_variation,
                                          edge_length_variation_batched)
from repro_torch.core.min_angle import minimum_angle, minimum_angle_batched
from repro_torch.core.occlusion import (count_occlusions_gridded,
                                        count_occlusions_gridded_batched)
from repro_torch.core.scores import ReadabilityScores
from repro_torch.kernels.ops import occlusion_count_op, strip_reversal_op
from repro_torch.kernels.strip_reversal import (fused_reversal_block,  # noqa: F401
                                                strip_reversal_rows)

ALL_METRICS = ("node_occlusion", "minimum_angle", "edge_length_variation",
               "edge_crossing", "edge_crossing_angle")

# the ideal crossing angle (70 deg) as the float32 rounding the reference
# uses, as a plan-hashable Python float
DEFAULT_IDEAL = float(_calib.DEFAULT_IDEAL)

_AXES = {"vertical": (0,), "horizontal": (1,), "both": (0, 1)}

# the reference's name of the engine's result type
EngineResult = ReadabilityScores


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  Never falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the CUDA device by default and no CUDA "
            "device is available; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class ReadabilityPlan:
    """Host-side static plan: everything shape-like, hashable.  Fields
    mirror :class:`repro.core.engine.ReadabilityPlan`."""

    radius: float
    ideal: float
    n_strips: int
    axes: tuple                 # strip orientations, subset of (0, 1)
    metrics: tuple              # subset of ALL_METRICS
    grid_origin: tuple          # (x0, y0) of the occlusion grid
    grid_nx: int
    grid_ny: int
    cell_cap: int
    grid_cell_size: float       # >= 2*radius
    strip_plans: tuple          # ((max_segments, cap), ...) aligned w/ axes
    cell_block: int = 512
    strip_block: int = 256
    # occupancy tiers per orientation: ((caps, counts, order), ...); ()
    # disables tiering (one flat tier at the strip_plans cap)
    strip_tiers: tuple = ()
    precision: str = "float32"
    graph_shard: tuple = None
    resident: tuple = None

    @property
    def orientation(self) -> str:
        for name, axes in _AXES.items():
            if axes == self.axes:
                return name
        return str(self.axes)

    @property
    def dtype(self):
        if self.precision != "float32":
            raise NotImplementedError(
                f"precision={self.precision!r} is not ported yet; "
                "repro_torch evaluates in float32")
        return torch.float32


def _plain(v):
    """Reference plan values as plain hashable Python data."""
    if isinstance(v, (tuple, list)):
        return tuple(_plain(x) for x in v)
    if isinstance(v, np.generic):
        return v.item()
    return v


def plan_from_reference(obj) -> ReadabilityPlan:
    """A :class:`ReadabilityPlan` from any object or dict that carries the
    reference plan's field names (read by attribute or key)."""
    def get(name):
        if isinstance(obj, dict):
            return obj[name] if name in obj else _DEFAULTS[name]
        return getattr(obj, name, _DEFAULTS[name])

    return ReadabilityPlan(**{f.name: _plain(get(f.name))
                              for f in dataclasses.fields(ReadabilityPlan)})


_DEFAULTS = {f.name: f.default for f in dataclasses.fields(ReadabilityPlan)}


# ---------------------------------------------------------------------------
# the reversal sweep
# ---------------------------------------------------------------------------

def fused_reversal_stats(buckets: gridlib.SegmentBuckets, *, ideal=1.0,
                         with_angle: bool = True):
    """All-strip reversal stats of flat ``(n_strips, cap)`` buckets (the
    ``use_kernels`` route): ONE sweep -> ``(count, deviation_sum)``."""
    gridlib.CALL_COUNTS["reversal_sweeps"] += 1
    return strip_reversal_op(buckets, ideal=float(ideal),
                             with_angle=with_angle)


def _tier_layout(plan: ReadabilityPlan, axis_i: int):
    """Host-side ragged bucket layout for one strip orientation: per-strip
    (offset, capacity) arrays plus per-tier slabs ``((flat_offset,
    n_strips_t, cap_t), ...)``.  Falls back to one flat tier at the
    planned cap when the tier data is absent or inconsistent with
    ``strip_plans``."""
    n_strips = plan.n_strips
    _, cap = plan.strip_plans[axis_i]
    tiers = (plan.strip_tiers[axis_i]
             if axis_i < len(plan.strip_tiers) else ())
    ok = (len(tiers) == 3 and len(tiers[0]) == len(tiers[1])
          and sum(tiers[1]) == n_strips and len(tiers[2]) == n_strips
          and sorted(tiers[2]) == list(range(n_strips))
          and max(tiers[0]) <= cap)
    caps, counts, order = (tiers if ok else
                           ((cap,), (n_strips,), tuple(range(n_strips))))
    order_np = np.asarray(order, np.int64)
    pos_caps = np.repeat(np.asarray(caps, np.int64),
                         np.asarray(counts, np.int64))
    pos_off = np.concatenate([[0], np.cumsum(pos_caps)])[:-1]
    total = int(pos_caps.sum())
    strip_cap = np.zeros(n_strips, np.int32)
    strip_off = np.zeros(n_strips, np.int32)
    strip_cap[order_np] = pos_caps
    strip_off[order_np] = pos_off
    slabs, off = [], 0
    for c, n in zip(caps, counts):
        slabs.append((off, int(n), int(c)))
        off += int(n) * int(c)
    return strip_off, strip_cap, total, slabs


def tier_slabs(plan: ReadabilityPlan, axis_i: int, segs, B: int):
    """One-sort gather bucketing of a batched
    :class:`~repro_torch.core.grid.StripSegments` (``(B, max_segments)``
    fields; ``B=1`` for the single-layout path), cut into one contiguous
    ``(B * n_t, cap_t)`` slab per occupancy tier: the sweep's inputs.
    Returns ``([(n_t, (yl, yr, theta, v, u, valid)), ...], (B,)
    dropped)``."""
    strip_off, strip_cap, _, tiers = _tier_layout(plan, axis_i)
    yl, yr, th, v, u, ok, _, dropped = gridlib.gather_ragged_buckets(
        segs.strip, plan.n_strips, strip_off, strip_cap,
        segs.yl, segs.yr, segs.theta, segs.v, segs.u, valid=segs.valid)
    slabs = []
    for off, n_t, cap_t in tiers:
        def sl(a):
            return (a[:, off:off + n_t * cap_t].reshape(B * n_t, cap_t)
                    .contiguous())
        slabs.append((n_t, (sl(yl), sl(yr), sl(th), sl(v).to(torch.int32),
                            sl(u).to(torch.int32), sl(ok))))
    return slabs, dropped


def _tiered_strip_stats(plan: ReadabilityPlan, axis_i: int, segs, B: int,
                        *, with_angle: bool):
    """Occupancy-tiered reversal sweep: one sweep per tier slab of
    :func:`tier_slabs`, each swept at its own ``cap_t^2`` pair tile.
    Returns ``((B,) count, (B,) dev_sum, (B,) dropped)``."""
    slabs, dropped = tier_slabs(plan, axis_i, segs, B)
    gridlib.CALL_COUNTS["reversal_sweeps"] += 1
    dev_ = segs.yl.device
    cnt = torch.zeros(B, dtype=gridlib.count_dtype(), device=dev_)
    dev = torch.zeros(B, dtype=segs.yl.dtype, device=dev_)
    row_block = min(plan.strip_block, plan.n_strips)
    for n_t, args in slabs:
        rc, rd = strip_reversal_rows(*args, ideal=plan.ideal,
                                     with_angle=with_angle,
                                     row_block=row_block)
        cnt = cnt + rc.reshape(B, n_t).sum(dim=1)
        dev = dev + rd.reshape(B, n_t).sum(dim=1)
    return cnt, dev, dropped


# ---------------------------------------------------------------------------
# planning (host side, once per graph topology/extent)
# ---------------------------------------------------------------------------

def _host(a, dtype):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def plan_readability(pos, edges, *, radius: float = 0.5, ideal_angle=None,
                     n_strips: int = 64, orientation: str = "both",
                     metrics=ALL_METRICS, cell_block: int = 512,
                     strip_block: int = 256, tier_strips: bool = True,
                     precision: str = "float32") -> ReadabilityPlan:
    """Build a :class:`ReadabilityPlan` from concrete ``(V, 2)`` or
    ``(B, V, 2)`` data (host side; a batched plan covers all B layouts).
    ``tier_strips=False`` gives every strip the flat top cap."""
    pos = _host(pos, np.float32)
    edges = _host(edges, np.int32)
    pos_b = pos[None] if pos.ndim == 2 else pos
    metrics = tuple(metrics)
    ideal = float(DEFAULT_IDEAL if ideal_angle is None else ideal_angle)

    if "node_occlusion" in metrics:
        origin, nx, ny, cell_cap, cell_size = gridlib.plan_occlusion_grid(
            pos_b, radius)
    else:
        origin, nx, ny, cell_cap, cell_size = (0.0, 0.0), 1, 1, 8, 1.0

    axes = _AXES[orientation]
    strip_plans, strip_tiers = [], []
    if ("edge_crossing" in metrics) or ("edge_crossing_angle" in metrics):
        for axis in axes:
            max_segments = 0
            occ = np.zeros(n_strips, np.int64)
            for p in pos_b:
                ms, per_strip = gridlib.plan_strip_occupancy(
                    p, edges, n_strips, axis=axis)
                max_segments = max(max_segments, ms)
                occ = np.maximum(occ, per_strip)
            tiers = gridlib.plan_strip_tiers(occ)
            # the flat cap IS the top tier's cap
            strip_plans.append((max_segments, tiers[0][0]))
            strip_tiers.append(tiers if tier_strips else ())

    return ReadabilityPlan(
        radius=float(radius), ideal=ideal, n_strips=int(n_strips),
        axes=axes, metrics=metrics, grid_origin=origin, grid_nx=nx,
        grid_ny=ny, cell_cap=cell_cap, grid_cell_size=float(cell_size),
        strip_plans=tuple(strip_plans), strip_tiers=tuple(strip_tiers),
        cell_block=int(cell_block), strip_block=int(strip_block),
        precision=str(precision))


# ---------------------------------------------------------------------------
# fused evaluation (all metrics)
# ---------------------------------------------------------------------------

def device_inputs(pos, edges, device=None, dtype=torch.float32):
    """``pos`` / ``edges`` (may be None) as tensors: tensors stay on their
    device (moved if ``device`` is given), host arrays go to
    ``resolve_device(device)``."""
    if isinstance(pos, torch.Tensor):
        dev = pos.device if device is None else torch.device(device)
    else:
        dev = resolve_device(device)
    pos = torch.as_tensor(_host(pos, np.float32) if not isinstance(
        pos, torch.Tensor) else pos).to(dev, dtype)
    if edges is not None:
        edges = torch.as_tensor(_host(edges, np.int32) if not isinstance(
            edges, torch.Tensor) else edges).to(dev, torch.int32)
    return pos, edges


def _valid_mask(n, n_valid, dev):
    if n_valid is None:
        return None
    if isinstance(n_valid, torch.Tensor):
        n_valid = n_valid.to(dev)
    else:
        n_valid = int(n_valid)
    return torch.arange(n, device=dev) < n_valid


def _combine(stats, want_ec, want_eca, out):
    """Orientation vote + E_ca from per-orientation ``(count, dev,
    overflow)``; returns the strip overflow."""
    if len(stats) == 1:
        (ec_count, best_dev, ec_ov) = stats[0]
        best_count = ec_count
    else:
        (c0, d0, o0), (c1, d1, o1) = stats
        ec_count = torch.maximum(c0, c1)
        ec_ov = torch.maximum(o0, o1)
        # orientation with the most crossings = best-covered estimate;
        # strictly greater keeps axis 0 on ties
        take1 = c1 > c0
        best_count = torch.where(take1, c1, c0)
        best_dev = torch.where(take1, d1, d0)
    if want_ec:
        out["edge_crossing"] = ec_count
    if want_eca:
        out["edge_crossing_angle"] = torch.where(
            best_count > 0,
            1.0 - best_dev / torch.clamp_min(best_count, 1), 1.0)
        out["crossing_count_for_angle"] = best_count
    # the strip decomposition is shared by E_c and E_ca, so its dropped
    # segments count once, as the max over orientations
    return ec_ov


def _evaluate(plan: ReadabilityPlan, pos, edges, use_kernels: bool,
              n_valid_vertices=None, n_valid_edges=None,
              device=None) -> ReadabilityScores:
    pos, edges = device_inputs(pos, edges, device, plan.dtype)
    dev = pos.device
    vertex_valid = _valid_mask(pos.shape[0], n_valid_vertices, dev)
    edge_valid = _valid_mask(edges.shape[0], n_valid_edges, dev)
    m = plan.metrics
    out = {}
    overflow = torch.zeros((), dtype=torch.int64, device=dev)

    if "node_occlusion" in m:
        if use_kernels:
            # exact all-pairs kernel: same count as the grid, no
            # capacities to overflow
            cnt = occlusion_count_op(pos, plan.radius, valid=vertex_valid)
        else:
            cnt, ov = count_occlusions_gridded(
                pos, plan.radius, plan.grid_origin, plan.grid_nx,
                plan.grid_ny, plan.cell_cap, valid=vertex_valid,
                cell_size=plan.grid_cell_size)
            overflow = overflow + ov
        out["node_occlusion"] = cnt
    if "minimum_angle" in m:
        out["minimum_angle"], _ = minimum_angle(pos, edges,
                                                edge_valid=edge_valid)
    if "edge_length_variation" in m:
        out["edge_length_variation"] = edge_length_variation(
            pos, edges, edge_valid=edge_valid)

    want_ec = "edge_crossing" in m
    want_eca = "edge_crossing_angle" in m
    if want_ec or want_eca:
        stats = []
        for axis_i, (axis, (max_segments, cap)) in enumerate(
                zip(plan.axes, plan.strip_plans)):
            segs = gridlib.build_strip_segments(
                pos, edges, plan.n_strips, max_segments, axis=axis,
                edge_valid=edge_valid)
            if use_kernels:
                buckets = gridlib.bucketize_segments(segs, plan.n_strips,
                                                     cap)
                cnt, dsum = fused_reversal_stats(
                    buckets, ideal=plan.ideal, with_angle=want_eca)
                stats.append((cnt, dsum, buckets.overflow))
            else:
                # occupancy-tiered sweep, as the B=1 case of the batched
                # program (shared code keeps looped == batched)
                segs1 = segs._replace(
                    strip=segs.strip[None], yl=segs.yl[None],
                    yr=segs.yr[None], theta=segs.theta[None],
                    v=segs.v[None], u=segs.u[None], valid=segs.valid[None])
                cnt, dsum, drop = _tiered_strip_stats(
                    plan, axis_i, segs1, 1, with_angle=want_eca)
                stats.append((cnt[0], dsum[0], drop[0] + segs.overflow))
        overflow = overflow + _combine(stats, want_ec, want_eca, out)

    return ReadabilityScores(overflow=overflow, **out)


def evaluate_once(plan: ReadabilityPlan, pos, edges, *,
                  n_valid_vertices=None, n_valid_edges=None,
                  use_kernels: bool = False, device=None) -> ReadabilityScores:
    """One fused evaluation (the ``backend="eager"`` path)."""
    return _evaluate(plan, pos, edges, use_kernels, n_valid_vertices,
                     n_valid_edges, device)


def evaluate_planned(plan: ReadabilityPlan, pos, edges,
                     n_valid_vertices=None, n_valid_edges=None,
                     use_kernels: bool = False, device=None) -> ReadabilityScores:
    """All five metrics for one layout under ``plan`` -> an
    :class:`ReadabilityScores` of device scalars.  PyTorch runs eagerly, so
    this is the same program as :func:`evaluate_once`; the name keeps the
    reference's call sites."""
    return _evaluate(plan, pos, edges, use_kernels, n_valid_vertices,
                     n_valid_edges, device)


def evaluate_batched_body(plan: ReadabilityPlan, batch_pos, edges,
                          n_valid_vertices=None, n_valid_edges=None,
                          device=None) -> ReadabilityScores:
    """The natively batched engine program: ``(B, V, 2)`` in one pass.

    Each bucketing step groups the whole batch with one sort per row and
    gathers, and the occupancy-tiered sweep covers ``(B * n_t, cap_t)``
    rows per tier.  Integer metrics equal looping :func:`_evaluate` over
    the members.
    """
    pos, edges = device_inputs(batch_pos, edges, device, plan.dtype)
    dev = pos.device
    B = pos.shape[0]
    vertex_valid = _valid_mask(pos.shape[1], n_valid_vertices, dev)
    edge_valid = _valid_mask(edges.shape[0], n_valid_edges, dev)
    m = plan.metrics
    out = {}
    overflow = torch.zeros(B, dtype=torch.int64, device=dev)

    if "node_occlusion" in m:
        cnt, ov = count_occlusions_gridded_batched(
            pos, plan.radius, plan.grid_origin, plan.grid_nx, plan.grid_ny,
            plan.cell_cap, valid=vertex_valid,
            cell_size=plan.grid_cell_size)
        overflow = overflow + ov
        out["node_occlusion"] = cnt
    if "minimum_angle" in m:
        out["minimum_angle"], _ = minimum_angle_batched(
            pos, edges, edge_valid=edge_valid)
    if "edge_length_variation" in m:
        out["edge_length_variation"] = edge_length_variation_batched(
            pos, edges, edge_valid=edge_valid)

    want_ec = "edge_crossing" in m
    want_eca = "edge_crossing_angle" in m
    if want_ec or want_eca:
        stats = []
        for axis_i, (axis, (max_segments, cap)) in enumerate(
                zip(plan.axes, plan.strip_plans)):
            segs = gridlib.build_strip_segments_batched(
                pos, edges, plan.n_strips, max_segments, axis=axis,
                edge_valid=edge_valid)
            cnt, dsum, drop = _tiered_strip_stats(
                plan, axis_i, segs, B, with_angle=want_eca)
            stats.append((cnt, dsum, drop + segs.overflow))
        overflow = overflow + _combine(stats, want_ec, want_eca, out)

    return ReadabilityScores(overflow=overflow, **out)


def evaluate_layouts(plan: ReadabilityPlan, batch_pos, edges,
                     n_valid_vertices=None, n_valid_edges=None,
                     use_kernels: bool = False, device=None) -> ReadabilityScores:
    """Batched evaluation of ``(B, V, 2)`` candidate layouts of one graph;
    fields carry a leading batch dimension.  ``use_kernels`` evaluates
    the members one by one on the kernels route (the reference vmaps the
    single-layout program there)."""
    if not use_kernels:
        return evaluate_batched_body(plan, batch_pos, edges,
                                     n_valid_vertices, n_valid_edges, device)
    results = [_evaluate(plan, batch_pos[b], edges, True, n_valid_vertices,
                         n_valid_edges, device)
               for b in range(batch_pos.shape[0])]
    return ReadabilityScores(*(
        None if results[0][k] is None
        else torch.stack([r[k] for r in results])
        for k in range(len(ReadabilityScores._fields))))


def replan_on_overflow(plan: ReadabilityPlan, pos, edges, result,
                       *, growth: float = 1.5) -> ReadabilityPlan:
    """Grow ``plan`` when ``result`` reports capacity overflow.

    Returns ``plan`` unchanged when nothing overflowed; otherwise re-plans
    from the concrete offending layout (the natural, unpadded arrays)
    and floors every capacity at ``growth`` x the old plan's.  Bounding
    the retry loop is the caller's contract."""
    ov = result.overflow
    if ov is None or int(np.max(_host(ov, np.int64))) == 0:
        return plan
    fresh = plan_readability(
        pos, edges, radius=plan.radius, ideal_angle=plan.ideal,
        n_strips=plan.n_strips, orientation=plan.orientation,
        metrics=plan.metrics, cell_block=plan.cell_block,
        strip_block=plan.strip_block,
        tier_strips=any(plan.strip_tiers), precision=plan.precision)
    cell_cap = max(fresh.cell_cap,
                   gridlib._round_up(int(plan.cell_cap * growth), 8))
    strip_plans, strip_tiers = [], []
    for axis_i, ((f_ms, f_cap), (o_ms, o_cap)) in enumerate(
            zip(fresh.strip_plans, plan.strip_plans)):
        _, fresh_cap_s, _, _ = _tier_layout(fresh, axis_i)
        _, old_cap_s, _, _ = _tier_layout(plan, axis_i)
        floored = np.maximum(
            fresh_cap_s.astype(np.int64),
            np.array([gridlib._next_pow2(int(c * growth))
                      for c in old_cap_s], np.int64))
        tiers = gridlib.tiers_from_caps(floored)
        strip_plans.append(
            (max(f_ms, gridlib._round_up(int(o_ms * growth), 128)),
             tiers[0][0]))
        strip_tiers.append(tiers)
    return dataclasses.replace(fresh, cell_cap=cell_cap,
                               strip_plans=tuple(strip_plans),
                               strip_tiers=tuple(strip_tiers))
