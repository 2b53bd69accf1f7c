"""Incremental re-evaluation for dynamic layouts (counterpart of
:mod:`repro.core.incremental`).

An interactive layout editor drags a handful of vertices per frame.
Re-running the full engine rebuilds every grid cell and every strip,
although almost none of their *membership* changed.  This module keeps
the plan's bucketed decompositions **resident on the device** -- the
cell-occupancy tables and per-cell occlusion partials, the per-strip
segment tables with per-strip (count, deviation) partials, and the
per-vertex minimum-angle deviations -- and re-derives only the dirty
rows when :meth:`repro_torch.launch.session.EvalSession.update` moves a
small vertex set.

Dirty-set rule (the reference's)
--------------------------------
* **cells** -- the union of the moved vertices' old and new grid cells;
  the owner rows that re-count are those cells plus every cell whose
  half-neighbourhood sweep reads a dirty cell;
* **strips** -- per orientation, the union of the old and new strip
  spans of every *affected edge* (an edge with a moved endpoint);
* **minimum angle** -- the moved vertices and their graph neighbours.

Bit-identity
------------
Integer metrics equal a from-scratch evaluation: every pair count is
set-determined (a rebuilt bucket holds the same members as a fresh
build, in another order), clean partials stay resident, and integer
totals are order-free sums.  Slot values are re-derived from the
positions by formula mirrors (:func:`_cell_ids`, :func:`_strip_domain`,
:func:`_strip_spans`, :func:`_strip_values`) that repeat the op sequence
of :func:`repro_torch.core.grid.build_strip_segments` and
:func:`~repro_torch.core.grid.cell_indices` op for op.  Float partials
sum in another order than the full path, so floats agree at rtol 1e-5.
A bucket overflow in the delta, a mover lost from the planned dirty set
or a changed strip domain is reported (``overflow`` or the probe) and
the session re-evaluates from scratch.

Both strip sweeps -- every strip at priming, the dirty strips at each
update -- go through
:func:`repro_torch.kernels.strip_reversal.strip_reversal_rows`: the
hand-written kernel on a CUDA device, its plain formula on the CPU.

Counters
--------
:func:`prime_state` is a full build and bumps ``cell_builds``,
``strip_builds``, ``reversal_sweeps`` and ``vertex_sorts`` as the
reference does; the probe and the delta bump none of
:data:`repro_torch.core.grid.CALL_COUNTS`.

Dropped writes
--------------
The reference writes dirty rows with ``.at[ids].set(..., mode="drop")``,
where padded ids carry an out-of-range sentinel.  PyTorch raises on such
an index (or corrupts memory on the device), so :func:`_set_rows` writes
through one spare row that is cut off afterwards.

Host traffic: :func:`prime_state` and :func:`delta_probe` fetch once
each (all fields packed into one copy), :func:`evaluate_delta` fetches
nothing (the session fetches its scores once).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core import grid as gridlib
from repro_torch.core.edge_length import edge_length_variation
from repro_torch.core.engine import ReadabilityPlan
from repro_torch.core.geometry import (TWO_PI, directed_angle, scalar_like,
                                       segment_theta)
from repro_torch.core.min_angle import ideal_gap
from repro_torch.core.occlusion import _cross_count, _d2
from repro_torch.core.scores import ReadabilityScores
from repro_torch.kernels.strip_reversal import strip_reversal_rows

# elements of the (rows, cap, 5*cap) pair tiles one priming block may hold
_PAIR_BUDGET = 1 << 24
_NP = {torch.int64: np.int64, torch.float32: np.float32}


# ---------------------------------------------------------------------------
# resident state
# ---------------------------------------------------------------------------

class ResidentStrip(NamedTuple):
    """Per-orientation resident strip decomposition (flat layout)."""

    eid: torch.Tensor    # (n_strips, cap) int64 parent edge per slot
    valid: torch.Tensor  # (n_strips, cap) bool
    cnt: torch.Tensor    # (n_strips,) int64 per-strip crossing partial
    dev: torch.Tensor    # (n_strips,) float per-strip deviation partial
    lo: torch.Tensor     # () strip domain lower bound
    hi: torch.Tensor     # () strip domain upper bound


class ResidentState(NamedTuple):
    """Device-resident partials of ONE layout under ONE plan, all on one
    device.  Only membership (ids and validity) and reduced partials are
    kept; slot values are re-derived from ``pos``.  Fields of a metric the
    plan does not compute are ``None``."""

    pos: torch.Tensor         # (vb, 2) padded positions
    cell_vid: Any = None      # (n_cells, cap) int64, invalid slot -> vb
    cell_valid: Any = None    # (n_cells, cap) bool
    occ_partial: Any = None   # (n_cells,) int64
    strips: tuple = ()        # ResidentStrip per plan axis
    ma_dev: Any = None        # (vb,) per-vertex deviation
    inc_nbr: Any = None       # (vb, deg_cap) int64 incidence, -1 pads
    inc_deg: Any = None       # (vb,) int64


# ---------------------------------------------------------------------------
# host-side helpers (incidence, padding, dirty sets)
# ---------------------------------------------------------------------------

def incidence_table(edges, n_v: int, vb: int):
    """Host-built per-vertex incidence: ``(inc_nbr, inc_deg, deg_cap)``.

    ``inc_nbr`` is ``(vb, deg_cap)`` int32 with -1 pads: row v lists the
    opposite endpoints of v's incident edges in edge order (a self-loop
    contributes v twice).  ``deg_cap`` is the power-of-two capacity
    (floor 2), plan-hashable via ``ReadabilityPlan.resident``."""
    edges = np.asarray(edges, np.int32).reshape(-1, 2)
    # half-edges in the order the reference's edge loop fills them: per
    # edge (a, b), first b into row a, then a into row b
    src = edges.reshape(-1).astype(np.int64)
    dst = edges[:, ::-1].reshape(-1)
    deg = np.bincount(src, minlength=vb)[:vb]
    deg_cap = 2
    top = int(deg.max()) if len(edges) else 0
    while deg_cap < top:
        deg_cap *= 2
    order = np.argsort(src, kind="stable")
    s = src[order]
    starts = np.searchsorted(s, s, side="left")
    rank = np.arange(len(s)) - starts
    inc = np.full((vb, deg_cap), -1, np.int32)
    inc[s, rank] = dst[order]
    return inc, deg.astype(np.int32), deg_cap


def pad_ids(ids, sentinel: int, floor: int = 8) -> np.ndarray:
    """Sort-unique ``ids`` and pad with ``sentinel`` to a power-of-two
    length (few distinct shapes for the delta)."""
    ids = np.unique(np.asarray(ids, np.int64))
    cap = floor
    while cap < len(ids):
        cap *= 2
    out = np.full(cap, sentinel, np.int32)
    out[:len(ids)] = ids
    return out


def affected_edges(edges, moved, n_v: int) -> np.ndarray:
    """Edge ids with >= 1 moved endpoint (host O(E) mask)."""
    am = np.zeros(n_v, bool)
    am[np.asarray(moved, np.int64)] = True
    edges = np.asarray(edges, np.int64)
    return np.nonzero(am[edges[:, 0]] | am[edges[:, 1]])[0]


def owner_cells(dirty, nx: int, ny: int) -> np.ndarray:
    """Dirty cells plus every cell whose half-neighbourhood reads one
    (the backward offsets of the forward sweep)."""
    dirty = np.asarray(dirty, np.int64)
    cx, cy = dirty % nx, dirty // nx
    out = [dirty]
    for dx, dy in ((-1, 0), (0, -1), (-1, -1), (-1, 1)):
        ox, oy = cx + dx, cy + dy
        ok = (ox >= 0) & (ox < nx) & (oy >= 0) & (oy < ny)
        out.append((oy * nx + ox)[ok])
    return np.unique(np.concatenate(out))


# ---------------------------------------------------------------------------
# device transfers
# ---------------------------------------------------------------------------

def _upload(device, arrays, dtype):
    """Host arrays -> tensors on ``device`` in ONE copy (concatenated, then
    split into views).  On CUDA the copy is from pinned memory and does
    not wait for the device."""
    flat = [np.asarray(a).reshape(-1) for a in arrays]
    # numpy has no bfloat16: float32 goes up and rounds on the device
    t = gridlib._to_device(
        np.concatenate(flat).astype(_NP.get(dtype, np.float32)),
        device).to(dtype)
    out, off = [], 0
    for a, f in zip(arrays, flat):
        out.append(t[off:off + f.size].reshape(np.shape(a)))
        off += f.size
    return out


def _fetch(*tensors):
    """Device tensors -> numpy arrays of their dtypes in ONE copy (packed
    as float64: exact for every float32 and every count below 2**53)."""
    flat = [t.reshape(-1).to(torch.float64) for t in tensors]
    host = torch.cat(flat).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        dtype = np.float32 if t.dtype.is_floating_point else np.int64
        out.append(host[off:off + n].astype(dtype).reshape(tuple(t.shape)))
        off += n
    return out


def _set_rows(table, ids, rows):
    """``table.at[ids].set(rows, mode="drop")``: ids outside ``[0, n)``
    write into one spare row that is cut off (valid ids are unique)."""
    n = table.shape[0]
    ext = torch.cat([table, table.new_zeros((1,) + tuple(table.shape[1:]))])
    ext[torch.where((ids >= 0) & (ids < n), ids, n)] = rows
    return ext[:n]


# ---------------------------------------------------------------------------
# exact formula mirrors (same elementwise op sequences as the full path)
# ---------------------------------------------------------------------------

def _cell_ids(x, y, plan: ReadabilityPlan):
    """Flat cell id per point -- mirror of
    :func:`repro_torch.core.grid.cell_indices`."""
    size = gridlib._scalar(plan.grid_cell_size, x)
    ox, oy = (gridlib._scalar(o, x) for o in plan.grid_origin)
    ix = torch.clamp(gridlib._index(torch.floor((x - ox) / size)),
                     0, plan.grid_nx - 1).to(torch.int64)
    iy = torch.clamp(gridlib._index(torch.floor((y - oy) / size)),
                     0, plan.grid_ny - 1).to(torch.int64)
    return iy * plan.grid_nx + ix


def _strip_domain(pos, edges, edge_valid, axis: int):
    """(lo, hi) exactly as ``build_strip_segments`` derives them."""
    x1 = pos[edges[:, 0].long(), axis]
    x2 = pos[edges[:, 1].long(), axis]
    lo = torch.where(edge_valid, torch.minimum(x1, x2), np.inf).min()
    hi = torch.where(edge_valid, torch.maximum(x1, x2), -np.inf).max()
    return lo, hi


def _strip_width(lo, hi, n_strips: int):
    return torch.clamp_min((hi - lo) / gridlib._scalar(n_strips, lo), 1e-30)


def _strip_spans(pos, edges, eids, ok, lo, hi, n_strips: int, axis: int):
    """Per-edge strip span ``(s_first, s_last, n_seg)`` -- mirror of the
    span arithmetic in ``build_strip_segments`` (same casts and clips)."""
    e = torch.clamp(eids, 0, edges.shape[0] - 1)
    x1 = pos[edges[e, 0].long(), axis]
    x2 = pos[edges[e, 1].long(), axis]
    width = _strip_width(lo, hi, n_strips)
    xa = torch.minimum(x1, x2)
    xb = torch.maximum(x1, x2)
    s_first = gridlib._index(torch.ceil((xa - lo) / width))
    s_last = gridlib._index(torch.floor((xb - lo) / width)) - 1
    s_first = torch.clamp(s_first, 0, n_strips - 1).to(torch.int64)
    s_last = torch.clamp(s_last, -1, n_strips - 1).to(torch.int64)
    n_seg = torch.where(ok, torch.clamp_min(s_last - s_first + 1, 0), 0)
    return s_first, s_last, n_seg


def _strip_values(pos, edges, eid, strip, lo, hi, n_strips: int, axis: int):
    """Slot values ``(yl, yr, theta, v, u)`` of (edge, strip) pairs --
    mirror of the ordinate arithmetic in ``build_strip_segments``."""
    e = torch.clamp(eid, 0, edges.shape[0] - 1)
    p = pos[edges[e, 0].long()]
    q = pos[edges[e, 1].long()]
    theta = segment_theta(p[:, 0], p[:, 1], q[:, 0], q[:, 1])
    ex1, ey1 = p[:, axis], p[:, 1 - axis]
    ex2, ey2 = q[:, axis], q[:, 1 - axis]
    width = _strip_width(lo, hi, n_strips)
    dx = ex2 - ex1
    slope = (ey2 - ey1) / torch.where(torch.abs(dx) < 1e-30, 1e-30, dx)
    bl = lo + strip.to(pos.dtype) * width
    br = bl + width
    yl = ey1 + (bl - ex1) * slope
    yr = ey1 + (br - ex1) * slope
    return yl, yr, theta, edges[e, 0], edges[e, 1]


def _sweep(yl, yr, th, v, u, ok, shape, plan: ReadabilityPlan,
           with_angle: bool):
    """The strip-reversal sweep of a ``shape`` slab: the kernel on CUDA,
    its plain formula on the CPU.  Returns ``((rows,) count, (rows,)
    dev)``."""
    cnt, dev = strip_reversal_rows(
        yl.reshape(shape), yr.reshape(shape), th.reshape(shape),
        v.reshape(shape).to(torch.int32).contiguous(),
        u.reshape(shape).to(torch.int32).contiguous(), ok,
        ideal=plan.ideal, with_angle=with_angle,
        row_block=min(plan.strip_block, shape[0]))
    # the float32 row partials in the slab's dtype: the reference's
    # per-row sum
    return cnt, dev.to(yl.dtype)


def _occ_rows(row_ids, vid_tab, val_tab, px, py, nbr_idx, nbr_ok, thresh):
    """Per-cell occlusion partial of the given rows -- mirror of the block
    formula of the gridded sweep (same-cell triangle plus the four
    half-neighbour buckets), reduced per row.  ``px`` / ``py`` carry one
    spare entry at index ``vb`` for the empty-slot id."""
    n_cells = vid_tab.shape[0]
    ok = row_ids < n_cells
    r = torch.clamp(row_ids, 0, n_cells - 1)
    bvid = vid_tab[r]
    bv = val_tab[r] & ok[:, None]
    bx, by = px[bvid], py[bvid]
    cap = bvid.shape[1]
    tri = torch.triu(torch.ones(cap, cap, dtype=torch.bool,
                                device=bx.device), diagonal=1)
    d2 = _d2(bx[:, :, None], by[:, :, None], bx[:, None, :], by[:, None, :])
    smask = bv[:, :, None] & bv[:, None, :] & tri[None]
    same = (smask & (d2 < thresh)).sum(dim=(1, 2))
    ni = nbr_idx[r]                                    # (R, 4)
    no = nbr_ok[r] & ok[:, None]
    cvid = vid_tab[ni]                                 # (R, 4, cap)
    rows = r.shape[0]
    cx = px[cvid].reshape(rows, -1)
    cy = py[cvid].reshape(rows, -1)
    cv = (val_tab[ni] & no[:, :, None]).reshape(rows, -1)
    return same + _cross_count(bx, by, bv, cx, cy, cv, thresh)


def _occ_rows_blocked(row_ids, vid_tab, val_tab, px, py, nbr_idx, nbr_ok,
                      thresh, block: int):
    """Blocked :func:`_occ_rows` for the priming sweep (block size changes
    no count)."""
    cap = vid_tab.shape[1]
    block = max(1, min(block, _PAIR_BUDGET // max(5 * cap * cap, 1),
                       row_ids.shape[0]))
    return torch.cat([
        _occ_rows(row_ids[b0:b0 + block], vid_tab, val_tab, px, py,
                  nbr_idx, nbr_ok, thresh)
        for b0 in range(0, row_ids.shape[0], block)])


def _ma_rows(pos, row_ids, inc_nbr, inc_deg):
    """Per-vertex minimum-angle deviation of the given rows, from the
    resident incidence table: the angles and the sorted neighbour-gap
    reduction of :func:`repro_torch.core.min_angle.minimum_angle`,
    restricted to one vertex's run."""
    vb = pos.shape[0]
    ok = row_ids < vb
    r = torch.clamp(row_ids, 0, vb - 1)
    nbr = inc_nbr[r]                                   # (R, D)
    deg = inc_deg[r]
    D = nbr.shape[1]
    dev = pos.device
    slot_ok = torch.arange(D, device=dev)[None, :] < deg[:, None]
    nn = torch.clamp(nbr, 0, vb - 1)
    ang = directed_angle(pos[r, 0][:, None], pos[r, 1][:, None],
                         pos[nn, 0], pos[nn, 1])
    a = torch.sort(torch.where(slot_ok, ang, np.inf), dim=1).values
    if D > 1:
        gaps_ok = torch.arange(D - 1, device=dev)[None, :] < deg[:, None] - 1
        gaps = torch.where(gaps_ok, a[:, 1:] - a[:, :-1], np.inf)
        gap_min = gaps.min(dim=1).values
    else:
        gap_min = torch.full(r.shape, np.inf, dtype=a.dtype, device=dev)
    amin = a[:, 0]
    amax = torch.gather(a, 1, torch.clamp(deg - 1, 0, D - 1)[:, None])[:, 0]
    wrap = scalar_like(TWO_PI, a) - (amax - amin)
    phi_min = torch.minimum(gap_min, wrap)
    counted = deg >= 1
    ideal = ideal_gap(deg, phi_min.dtype)
    return torch.where(counted & ok, (ideal - phi_min) / ideal, 0.0)


def _uniform_buckets(n_buckets: int, cap: int):
    """Host bucket layout of ``n_buckets`` buckets of ``cap`` slots."""
    return (np.arange(n_buckets, dtype=np.int64) * cap,
            np.full(n_buckets, cap, np.int64))


# ---------------------------------------------------------------------------
# prime: one full build of the resident state
# ---------------------------------------------------------------------------

def _on(device, a, dtype):
    if isinstance(a, torch.Tensor):
        return a.to(device, dtype)
    return torch.as_tensor(np.asarray(a)).to(device, dtype)


def _prime(plan: ReadabilityPlan, pos, edges, n_v: int, n_e: int, inc_nbr,
           inc_deg):
    dev = pos.device
    vb, eb = pos.shape[0], edges.shape[0]
    vertex_valid = torch.arange(vb, device=dev) < n_v
    edge_valid = torch.arange(eb, device=dev) < n_e
    m = plan.metrics
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    zero = torch.zeros(1, dtype=pos.dtype, device=dev)
    px = torch.cat([pos[:, 0], zero])
    py = torch.cat([pos[:, 1], zero])

    cell_vid = cell_valid = occ_partial = None
    vert_cell = torch.zeros(vb, dtype=torch.int64, device=dev)
    if "node_occlusion" in m:
        n_cells = plan.grid_nx * plan.grid_ny
        vert_cell = _cell_ids(pos[:, 0], pos[:, 1], plan)
        vid, bvalid, _, ov = gridlib.scatter_to_buckets(
            vert_cell, n_cells, plan.cell_cap,
            torch.arange(vb, device=dev), valid=vertex_valid)
        cell_vid = torch.where(bvalid, vid, vb)
        cell_valid = bvalid
        nbr = gridlib.neighbour_bucket_ids(plan.grid_nx, plan.grid_ny,
                                           device=dev)
        thresh = gridlib._scalar((2.0 * plan.radius) ** 2, pos)
        occ_partial = _occ_rows_blocked(
            torch.arange(n_cells, device=dev), cell_vid, cell_valid, px, py,
            torch.clamp_min(nbr, 0), nbr >= 0, thresh,
            min(plan.cell_block, n_cells))
        overflow = overflow + ov

    strips, strip_aux = [], []
    if ("edge_crossing" in m) or ("edge_crossing_angle" in m):
        with_angle = "edge_crossing_angle" in m
        n_strips = plan.n_strips
        for axis, (max_segments, cap) in zip(plan.axes, plan.strip_plans):
            lo, hi = _strip_domain(pos, edges, edge_valid, axis)
            sf, sl, nseg = _strip_spans(
                pos, edges, torch.arange(eb, device=dev), edge_valid,
                lo, hi, n_strips, axis)
            offsets = torch.cumsum(nseg, 0)
            total = offsets[-1]
            starts = offsets - nseg
            slot = torch.arange(max_segments, device=dev)
            eid = torch.searchsorted(offsets, slot, right=True)
            eid = torch.clamp_max(eid, eb - 1)
            valid = slot < total
            strip = sf[eid] + (slot - starts[eid])
            key = torch.where(valid, strip, n_strips)
            drop = torch.clamp_min(total - max_segments, 0)
            tab_eid, in_cap, _, ov = gridlib.gather_ragged_buckets(
                key[None], n_strips, *_uniform_buckets(n_strips, cap),
                eid[None], valid=valid[None])
            tab_eid = tab_eid.reshape(n_strips, cap)
            tab_ok = in_cap.reshape(n_strips, cap)
            row_strip = torch.arange(n_strips, device=dev)[:, None].expand(
                n_strips, cap)
            yl, yr, th, v, u = _strip_values(
                pos, edges, tab_eid.reshape(-1), row_strip.reshape(-1),
                lo, hi, n_strips, axis)
            cnt, dsum = _sweep(yl, yr, th, v, u, tab_ok, (n_strips, cap),
                               plan, with_angle)
            strips.append(ResidentStrip(eid=tab_eid, valid=tab_ok, cnt=cnt,
                                        dev=dsum, lo=lo, hi=hi))
            strip_aux.append((sf, sl, total, lo, hi))
            overflow = overflow + drop + ov[0]

    ma_dev = None
    if "minimum_angle" in m:
        ma_dev = _ma_rows(pos, torch.arange(vb, device=dev), inc_nbr,
                          inc_deg)

    state = ResidentState(pos=pos, cell_vid=cell_vid, cell_valid=cell_valid,
                          occ_partial=occ_partial, strips=tuple(strips),
                          ma_dev=ma_dev, inc_nbr=inc_nbr, inc_deg=inc_deg)
    return state, overflow, vert_cell, strip_aux


def prime_state(plan: ReadabilityPlan, pos, edges, n_v: int, n_e: int,
                inc_nbr, inc_deg, *, device=None):
    """Build the resident state on ``device`` (CUDA unless the caller asks
    for another; ONE host fetch).

    Returns ``(state, aux)`` with ``aux`` a host dict: ``overflow``
    (int), ``vert_cell`` ((vb,) cell mirror), and per-axis ``strips``
    tuples ``(s_first, s_last, total, lo, hi)`` (numpy).  A full build,
    counted as one: bumps ``cell_builds`` / ``strip_builds`` /
    ``reversal_sweeps`` / ``vertex_sorts`` as the reference does."""
    dev = engine.resolve_device(device)
    m = plan.metrics
    if "node_occlusion" in m:
        gridlib.CALL_COUNTS["cell_builds"] += 1
    if ("edge_crossing" in m) or ("edge_crossing_angle" in m):
        gridlib.CALL_COUNTS["strip_builds"] += len(plan.axes)
        gridlib.CALL_COUNTS["reversal_sweeps"] += len(plan.axes)
    if "minimum_angle" in m:
        gridlib.CALL_COUNTS["vertex_sorts"] += 1
    state, overflow, vert_cell, strip_aux = _prime(
        plan, _on(dev, pos, plan.dtype), _on(dev, edges, torch.int32),
        int(n_v), int(n_e), _on(dev, inc_nbr, torch.int64),
        _on(dev, inc_deg, torch.int64))
    host = _fetch(overflow, vert_cell,
                  *(t for aux in strip_aux for t in aux))
    strips = tuple(
        (host[2 + 5 * i], host[3 + 5 * i], int(host[4 + 5 * i]),
         host[5 + 5 * i], host[6 + 5 * i])
        for i in range(len(strip_aux)))
    return state, {"overflow": int(host[0]), "vert_cell": host[1],
                   "strips": strips}


def _device_of(state: ResidentState, device):
    dev = state.pos.device
    want = dev if device is None else torch.device(device)
    if want.type != dev.type or want.index not in (None, dev.index):
        raise ValueError(f"the resident state lives on {dev}, not on "
                         f"{torch.device(device)}")
    return dev


# ---------------------------------------------------------------------------
# probe: where do the moved vertices land?
# ---------------------------------------------------------------------------

def delta_probe(plan: ReadabilityPlan, state: ResidentState, edges,
                n_e: int, moved_p, new_xy_p, aff_p, *, device=None):
    """Where the moved vertices land: their new cells and, per axis, the
    moved layout's strip domain and the affected edges' new spans.  Runs
    on the state's device (``device``, if given, must be it); ONE host
    fetch, numpy outputs."""
    dev = _device_of(state, device)
    pos = state.pos
    vb, eb = pos.shape[0], int(edges.shape[0])
    edges = _on(dev, edges, torch.int32)
    moved, aff = _upload(dev, (moved_p, aff_p), torch.int64)
    (new_xyc,) = _upload(dev, (new_xy_p,), pos.dtype)
    pos2 = _set_rows(pos, moved, new_xyc)
    new_cid = (_cell_ids(new_xyc[:, 0], new_xyc[:, 1], plan)
               if "node_occlusion" in plan.metrics
               else torch.zeros(moved.shape, dtype=torch.int64, device=dev))
    edge_valid = torch.arange(eb, device=dev) < n_e
    out = []
    for axis_i, axis in enumerate(plan.axes if state.strips else ()):
        st = state.strips[axis_i]
        lo2, hi2 = _strip_domain(pos2, edges, edge_valid, axis)
        sf, sl, nseg = _strip_spans(pos2, edges, aff, aff < eb,
                                    st.lo, st.hi, plan.n_strips, axis)
        out += [lo2, hi2, sf, sl, nseg]
    host = _fetch(new_cid, *out)
    return {"new_cid": host[0],
            "axes": tuple(tuple(host[1 + 5 * i:6 + 5 * i])
                          for i in range(len(out) // 5))}


# ---------------------------------------------------------------------------
# the delta program (non-counting primitives only)
# ---------------------------------------------------------------------------

def _delta(plan: ReadabilityPlan, state: ResidentState, edges, n_e: int,
           moved, new_xyc, aff, dirty_cells, owners, dirty_strips,
           dirty_ma):
    pos = state.pos
    dev = pos.device
    vb, eb = pos.shape[0], edges.shape[0]
    pos2 = _set_rows(pos, moved, new_xyc)
    zero = torch.zeros(1, dtype=pos.dtype, device=dev)
    px = torch.cat([pos2[:, 0], zero])
    py = torch.cat([pos2[:, 1], zero])
    mv_ok = moved < vb
    edge_valid = torch.arange(eb, device=dev) < n_e
    m = plan.metrics
    out = {}
    overflow = torch.zeros((), dtype=torch.int64, device=dev)

    # -- cells: rebuild dirty buckets, re-count owner rows ------------------
    cell_vid2, cell_val2, occ2 = (state.cell_vid, state.cell_valid,
                                  state.occ_partial)
    if "node_occlusion" in m:
        n_cells = plan.grid_nx * plan.grid_ny
        cap_c = plan.cell_cap
        dc = dirty_cells
        dc_cap = dc.shape[0]
        dci = torch.clamp_max(dc, n_cells - 1)
        rows_vid = state.cell_vid[dci]                     # (dc, cap)
        rows_val = state.cell_valid[dci] & (dc < n_cells)[:, None]
        # survivors: current members minus every copy of a moved vertex
        # (the moved pad sentinel vb hits the spare mask slot, and the
        # empty-slot id vb rows are invalid anyway)
        mm = torch.zeros(vb + 1, dtype=torch.bool, device=dev)
        mm.index_fill_(0, torch.clamp(moved, 0, vb), True)
        keep = rows_val & ~mm[rows_vid]
        local = torch.arange(dc_cap, device=dev)[:, None].expand(dc_cap,
                                                                 cap_c)
        # movers: their new cell, located in the sorted dirty-cell list; a
        # miss means the host dirty set was wrong -> count it lost, so
        # the session falls back rather than under-count
        cid2 = _cell_ids(new_xyc[:, 0], new_xyc[:, 1], plan)
        lk = torch.searchsorted(dc, cid2)
        found = (lk < dc_cap) & (dc[torch.clamp_max(lk, dc_cap - 1)] == cid2)
        lost_cells = (mv_ok & ~found).sum()
        keys = torch.cat([local.reshape(-1), lk])
        vids = torch.cat([rows_vid.reshape(-1), moved])
        ok = torch.cat([keep.reshape(-1), mv_ok & found])
        nvid, in_cap, _, ovc = gridlib.gather_ragged_buckets(
            keys[None], dc_cap, *_uniform_buckets(dc_cap, cap_c),
            vids[None], valid=ok[None])
        nvid = torch.where(in_cap[0], nvid[0], vb).reshape(dc_cap, cap_c)
        nok = in_cap[0].reshape(dc_cap, cap_c)
        cell_vid2 = _set_rows(state.cell_vid, dc, nvid)
        cell_val2 = _set_rows(state.cell_valid, dc, nok)
        nbr = gridlib.neighbour_bucket_ids(plan.grid_nx, plan.grid_ny,
                                           device=dev)
        thresh = gridlib._scalar((2.0 * plan.radius) ** 2, pos)
        part = _occ_rows(owners, cell_vid2, cell_val2, px, py,
                         torch.clamp_min(nbr, 0), nbr >= 0, thresh)
        occ2 = _set_rows(state.occ_partial, owners, part)
        out["node_occlusion"] = occ2.sum()
        overflow = overflow + ovc[0] + lost_cells

    # -- strips: rebuild dirty strip buckets, re-sweep them -----------------
    want_ec = "edge_crossing" in m
    want_eca = "edge_crossing_angle" in m
    new_strips = []
    if want_ec or want_eca:
        n_strips = plan.n_strips
        me = torch.zeros(eb + 1, dtype=torch.bool, device=dev)
        me.index_fill_(0, torch.clamp(aff, 0, eb), True)
        ae_ok = aff < eb
        stats = []
        for axis_i, axis in enumerate(plan.axes):
            st = state.strips[axis_i]
            cap_s = st.eid.shape[1]
            ds = dirty_strips[axis_i]
            ds_cap = ds.shape[0]
            dsi = torch.clamp_max(ds, n_strips - 1)
            rows_eid = st.eid[dsi]                         # (ds, cap)
            rows_val = st.valid[dsi] & (ds < n_strips)[:, None]
            keep = rows_val & ~me[rows_eid]
            local = torch.arange(ds_cap, device=dev)[:, None].expand(
                ds_cap, cap_s)
            # every new segment of an affected edge must land in a dirty
            # strip (the host unions old and new spans); any that does not
            # counts as lost -> overflow -> fallback
            sf, sl, nseg = _strip_spans(pos2, edges, aff, ae_ok, st.lo,
                                        st.hi, n_strips, axis)
            in_span = (ds[None, :] >= sf[:, None]) & \
                      (ds[None, :] <= sl[:, None])
            cmask = ae_ok[:, None] & (ds < n_strips)[None, :] & in_span
            ckey = torch.arange(ds_cap, device=dev)[None, :].expand(
                cmask.shape)
            ceid = aff[:, None].expand(cmask.shape)
            lost = torch.abs(nseg.sum() - cmask.sum())
            keys = torch.cat([local.reshape(-1), ckey.reshape(-1)])
            eids = torch.cat([rows_eid.reshape(-1), ceid.reshape(-1)])
            ok = torch.cat([keep.reshape(-1), cmask.reshape(-1)])
            neid, in_cap, _, ovs = gridlib.gather_ragged_buckets(
                keys[None], ds_cap, *_uniform_buckets(ds_cap, cap_s),
                eids[None], valid=ok[None])
            neid = neid[0].reshape(ds_cap, cap_s)
            nok = in_cap[0].reshape(ds_cap, cap_s)
            eid2 = _set_rows(st.eid, ds, neid)
            val2 = _set_rows(st.valid, ds, nok)
            # values of the dirty rows, re-derived from pos2 (invalid
            # slots carry garbage values, never read by the sweep)
            row_strip = dsi[:, None].expand(ds_cap, cap_s)
            yl, yr, th, v, u = _strip_values(
                pos2, edges, neid.reshape(-1), row_strip.reshape(-1),
                st.lo, st.hi, n_strips, axis)
            cnt_r, dev_r = _sweep(yl, yr, th, v, u, nok, (ds_cap, cap_s),
                                  plan, want_eca)
            cnt2 = _set_rows(st.cnt, ds, cnt_r)
            dev2 = _set_rows(st.dev, ds, dev_r)
            stats.append((cnt2.sum(), dev2.sum(), ovs[0] + lost))
            new_strips.append(ResidentStrip(eid=eid2, valid=val2, cnt=cnt2,
                                            dev=dev2, lo=st.lo, hi=st.hi))
        # best-orientation vote, exactly as the engine's
        overflow = overflow + engine._combine(stats, want_ec, want_eca, out)

    # -- min angle: re-derive moved vertices and their neighbours ----------
    ma2 = state.ma_dev
    if "minimum_angle" in m:
        rows = _ma_rows(pos2, dirty_ma, state.inc_nbr, state.inc_deg)
        ma2 = _set_rows(state.ma_dev, dirty_ma, rows)
        counted = state.inc_deg >= 1
        out["minimum_angle"] = 1.0 - ma2.sum() / torch.clamp_min(
            counted.sum(), 1).to(ma2.dtype)

    # -- edge length variation: O(E) elementwise, recomputed in full --------
    if "edge_length_variation" in m:
        out["edge_length_variation"] = edge_length_variation(
            pos2, edges, edge_valid=edge_valid)

    result = ReadabilityScores(overflow=overflow, **out)
    new_state = ResidentState(
        pos=pos2, cell_vid=cell_vid2, cell_valid=cell_val2,
        occ_partial=occ2, strips=tuple(new_strips), ma_dev=ma2,
        inc_nbr=state.inc_nbr, inc_deg=state.inc_deg)
    return result, new_state


def evaluate_delta(plan: ReadabilityPlan, state: ResidentState, edges,
                   n_e: int, moved_p, new_xy_p, aff_p, dirty_cells_p,
                   owners_p, dirty_strips_p, dirty_ma_p, *, device=None):
    """Re-evaluate after a small move, from the resident state, on the
    state's device (``device``, if given, must be it).

    All ``*_p`` inputs are host-padded id vectors (:func:`pad_ids`) with
    out-of-range sentinels.  Returns ``(result, new_state)`` with
    ``result`` a :class:`~repro_torch.core.scores.ReadabilityScores` of
    device scalars (no host fetch here); a non-zero ``result.overflow``
    means the delta could not preserve membership equality (bucket
    overflow or a dirty-set miss) and the caller MUST discard
    ``new_state`` and re-evaluate from scratch."""
    dev = _device_of(state, device)
    ids = [moved_p, aff_p, dirty_cells_p, owners_p, *dirty_strips_p,
           dirty_ma_p]
    t = _upload(dev, ids, torch.int64)
    (new_xyc,) = _upload(dev, (new_xy_p,), state.pos.dtype)
    n_ax = len(dirty_strips_p)
    return _delta(plan, state, _on(dev, edges, torch.int32), int(n_e),
                  t[0], new_xyc, t[1], t[2], t[3], tuple(t[4:4 + n_ax]),
                  t[4 + n_ax])
