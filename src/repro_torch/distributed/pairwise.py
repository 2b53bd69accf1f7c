"""Distributed exact readability metrics (paper S3.1) over a mesh
(counterpart of :mod:`repro.distributed.pairwise`).

Two strategies, as a Spark all-pairs join maps onto a set of ranks:

* **replicated** -- the pair matrix's *rows* split over the ranks and the
  column operand (the whole coordinate set, a few MB even at SNAP scale)
  is on every rank: no communication until the final sum.  Each rank
  launches the hand-written all-pairs kernel on its row range
  (:func:`~repro_torch.kernels.occlusion_pairs.occlusion_pairs_rows`,
  :func:`~repro_torch.kernels.segment_crossing.crossing_count_rows`,
  :func:`~repro_torch.kernels.crossing_angle_sum.
  crossing_angle_stats_rows`), which counts the pairs with ``i`` in its
  rows and global ``j > i`` (``occlusion_rows``, ``crossing_rows``,
  ``crossing_angle_rows``: a rank's share, launched and not waited on).
  Counts are summed by ``psum`` (``sum_counts``); the float64 deviation
  sums are gathered and added in rank order on every rank
  (``sum_in_rank_order``), so every rank gets the same bits on every
  run.  ``sharded_*`` do both; a caller that launches every share before
  any collective (``evaluate_exact(mesh=...)``) calls them apart, and
  combines all its shares in one gather (``sum_partials``).
* **ring** -- both sides split; ``n`` steps pass the column blocks around
  the ring of ranks (the out-of-memory path for layouts too large to
  replicate).  A step compares a rectangular block of local rows with a
  received column block under global-index masks, which neither kernel
  computes, so it runs as blocked PyTorch ops here, as the reference runs
  it in jnp.

Every mesh axis is flattened into one rank order; counting masks use
global indices so the ``i < j`` rule holds across ranks.
"""

from __future__ import annotations

import torch

from repro_torch.core.validate import BackendUnavailableError, ReadabilityError
from repro_torch.core.geometry import (pair_dist_sq, segments_cross,
                                       segments_cross_bool)
from repro_torch.distributed.collectives import (all_gather, psum, psum_all,
                                                 ring_shift)
from repro_torch.distributed.sharding import mesh_rank, mesh_size
from repro_torch.kernels.crossing_angle_sum import crossing_angle_stats_rows
from repro_torch.kernels.occlusion_pairs import TILE as VERTEX_TILE
from repro_torch.kernels.occlusion_pairs import occlusion_pairs_rows
from repro_torch.kernels.ops import _edge_arrays, _pad1
from repro_torch.kernels.segment_crossing import TILE as EDGE_TILE
from repro_torch.kernels.segment_crossing import crossing_count_rows

# elements of the (rows, cols) pair blocks one ring step may hold
_PAIR_BUDGET = 1 << 24


def _run_sharded(tag, mesh, fn):
    """Run a mesh dispatch behind the typed error taxonomy: a failure (a
    lost rank, a collective or kernel error) becomes one
    :class:`BackendUnavailableError` (``request_index=0``) with the
    original chained; typed errors pass through."""
    try:
        return fn()
    except ReadabilityError:
        raise
    except Exception as err:
        raise BackendUnavailableError(
            f"{tag} dispatch over {mesh.size} ranks failed: "
            f"{type(err).__name__}: {err}", request_index=0) from err


def _inputs(mesh, pos, edges, valid):
    """``pos`` (and ``edges``) on the rank's device, and the validity mask
    (all valid by default) of the vertices, or of the edges when
    ``edges`` is given."""
    from repro_torch.core.engine import device_inputs
    pos, edges = device_inputs(pos, edges, mesh.device)
    n = (pos if edges is None else edges).shape[0]
    if valid is None:   # made on the device: no copy waits on the stream
        return pos, edges, torch.ones(n, dtype=torch.bool, device=pos.device)
    return pos, edges, torch.as_tensor(valid).to(pos.device, torch.bool)


def _my_rows(mesh, n_pad):
    per = n_pad // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


def _edge_rows(mesh, pos, edges, edge_valid):
    """The crossing kernels' edge arrays ``(x1, y1, x2, y2, theta, v, u,
    valid)`` padded to a whole number of tiles per rank, and this rank's
    row range."""
    p, e, ok = _inputs(mesh, pos, edges, edge_valid)
    arrays = _edge_arrays(p, e, ok)
    e_pad = -(-e.shape[0] // (mesh.size * EDGE_TILE)) \
        * (mesh.size * EDGE_TILE)
    fills = (0.0, 0.0, 0.0, 0.0, 0.0, -1, -2, False)
    return ([_pad1(a, e_pad, f) for a, f in zip(arrays, fills)],
            _my_rows(mesh, e_pad))


def occlusion_rows(mesh, pos, radius, *, valid=None):
    """This rank's share of the row-sharded exact N_c (the replicated
    strategy): the occluded pairs whose first vertex lies in its row
    range.  Returns an int64 scalar tensor, launched and not waited on;
    :func:`sum_counts` adds the ranks' shares."""
    def run():
        p, _, ok = _inputs(mesh, pos, None, valid)
        n_pad = -(-p.shape[0] // (mesh.size * VERTEX_TILE)) \
            * (mesh.size * VERTEX_TILE)
        x = _pad1(p[:, 0], n_pad, 0.0)
        y = _pad1(p[:, 1], n_pad, 0.0)
        ok = _pad1(ok, n_pad, False)
        return occlusion_pairs_rows(x, y, ok, radius, *_my_rows(mesh, n_pad))
    return _run_sharded("row-sharded occlusion", mesh, run)


def crossing_rows(mesh, pos, edges, *, edge_valid=None, block: int = 256):
    """This rank's share of the row-sharded exact E_c: the crossing pairs
    whose first edge lies in its row range (an int64 scalar tensor, not
    waited on).  ``block`` is the plain route's row block."""
    def run():
        (x1, y1, x2, y2, _, v, u, ok), rows = _edge_rows(mesh, pos, edges,
                                                         edge_valid)
        return crossing_count_rows(x1, y1, x2, y2, v, u, ok, *rows,
                                   row_block=block)
    return _run_sharded("row-sharded crossing", mesh, run)


def crossing_angle_rows(mesh, pos, edges, *, ideal, edge_valid=None,
                        block: int = 512):
    """This rank's share of the row-sharded exact E_c and E_ca from one
    sweep: the crossing pairs whose first edge lies in its row range and
    the sum of their deviations ``|ideal - a_c| / ideal``.  Returns
    ``(int64 count, float64 deviation sum)`` scalar tensors, not waited
    on; ``block`` is the plain route's row block."""
    def run():
        arrays, rows = _edge_rows(mesh, pos, edges, edge_valid)
        return crossing_angle_stats_rows(*arrays, *rows, ideal=ideal,
                                         row_block=block)
    return _run_sharded("row-sharded crossing angle", mesh, run)


def sum_counts(mesh, t):
    """The ranks' partial counts summed (``psum``); every rank gets the
    sum."""
    return _run_sharded("sum of partial counts", mesh, lambda: psum(mesh, t))


def sum_in_rank_order(mesh, t):
    """The ranks' float64 partial sums gathered and added in rank order
    on every rank, so that every rank gets the same bits on every run."""
    def run():
        parts = all_gather(mesh, t.reshape(1))
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total
    return _run_sharded("sum of partial sums", mesh, run)


def sum_partials(mesh, counts, sums=()):
    """Every rank's int64 partial counts and float64 partial sums (scalar
    tensors) in one gather: returns ``(counts, sums)``, each count summed
    over the ranks and each sum added in rank order, as
    :func:`sum_counts` and :func:`sum_in_rank_order` give them, on every
    rank."""
    def run():
        n = len(counts)
        mine = torch.cat([c.reshape(1) for c in counts]
                         + [s.reshape(1).view(torch.int64) for s in sums])
        rows = all_gather(mesh, mine).reshape(-1, mine.shape[0])
        total = rows[0, n:].view(torch.float64)
        for row in rows[1:]:
            total = total + row[n:].view(torch.float64)
        summed = rows[:, :n].sum(dim=0)
        return ([summed[k] for k in range(n)],
                [total[k] for k in range(len(sums))])
    return _run_sharded("sum of partials", mesh, run)


def sharded_occlusion_count(mesh, pos, radius, *, valid=None):
    """Row-sharded exact N_c over every mesh axis (the replicated
    strategy): :func:`occlusion_rows` on each rank, then the ranks sum.
    Returns an int64 scalar tensor."""
    return sum_counts(mesh, occlusion_rows(mesh, pos, radius, valid=valid))


def sharded_crossing_count(mesh, pos, edges, *, edge_valid=None,
                           block: int = 256):
    """Row-sharded exact E_c (the replicated strategy):
    :func:`crossing_rows` on each rank, then the ranks sum.  Returns an
    int64 scalar tensor."""
    return sum_counts(mesh, crossing_rows(mesh, pos, edges,
                                          edge_valid=edge_valid, block=block))


def sharded_crossing_angle_stats(mesh, pos, edges, *, ideal,
                                 edge_valid=None, block: int = 512):
    """Row-sharded exact E_c and E_ca from one sweep (the replicated
    strategy): :func:`crossing_angle_rows` on each rank; the counts
    summed, the deviation sums added in rank order
    (:func:`sum_in_rank_order`).  Returns ``(int64 count, float64
    deviation sum)`` scalar tensors."""
    count, dev_sum = crossing_angle_rows(mesh, pos, edges, ideal=ideal,
                                         edge_valid=edge_valid, block=block)
    return sum_counts(mesh, count), sum_in_rank_order(mesh, dev_sum)


def ring_occlusion_count(mesh, pos, radius, *, valid=None):
    """Ring-streamed exact N_c: both operands split over the ranks; in
    ``n`` steps each rank compares its rows with the column block it
    holds, then passes that block to the next rank.  Returns an int64
    scalar tensor."""
    def run():
        p, _, ok = _inputs(mesh, pos, None, valid)
        n_dev = mesh.size
        n_pad = -(-p.shape[0] // n_dev) * n_dev
        per = n_pad // n_dev
        r0, r1 = _my_rows(mesh, n_pad)
        x = _pad1(p[:, 0], n_pad, 0.0)[r0:r1]
        y = _pad1(p[:, 1], n_pad, 0.0)[r0:r1]
        oi = _pad1(ok, n_pad, False)[r0:r1]
        dev = x.device
        thresh = torch.tensor((2.0 * radius) ** 2, dtype=torch.float32,
                              device=dev)
        my_rows = r0 + torch.arange(per, device=dev)
        block = max(1, min(per, _PAIR_BUDGET // max(per, 1)))
        total = torch.zeros((), dtype=torch.int64, device=dev)
        cx, cy, cok = x, y, oi
        for k in range(n_dev):
            # after k steps the resident block came from k ranks behind
            src = (mesh.rank - k) % n_dev
            col = src * per + torch.arange(per, device=dev)
            for i0 in range(0, per, block):
                sl = slice(i0, i0 + block)
                dx = x[sl, None] - cx[None, :]
                dy = y[sl, None] - cy[None, :]
                d2 = dx * dx + dy * dy
                mask = ((my_rows[sl, None] < col[None, :]) & oi[sl, None]
                        & cok[None, :])
                total = total + (mask & (d2 < thresh)).sum()
            if k + 1 < n_dev:
                cx, cy, cok = ring_shift(mesh, (cx, cy, cok))
        return psum(mesh, total)
    return _run_sharded("ring-streamed occlusion", mesh, run)



# ---------------------------------------------------------------------------
# one rank's programs for the dry run (full problem sizes, no allocation)
# ---------------------------------------------------------------------------

def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def lower_sharded_occlusion(mesh, n_vertices: int, radius: float, *,
                            block: int = 1024):
    """The row-sharded exact N_c as one rank's program: returns ``(fn,
    abstract_args)``.

    ``abstract_args`` are meta tensors of the reference's shapes: this
    rank's ``(1, rows_per)`` shards of ``x``, ``y``, ``valid`` and the
    replicated ``(n_pad,)`` column operands (``n_pad`` rounded up to
    ``ranks x block``).  ``fn(xs, ys, oks, xg, yg, okg)`` counts its rows
    ``block`` at a time with :func:`~repro_torch.core.geometry.
    pair_dist_sq` under global ``i < j`` indices and ends in one
    all-reduce over every mesh axis; on real tensors it runs."""
    n_dev = mesh_size(mesh)
    n_pad = -(-n_vertices // (n_dev * block)) * (n_dev * block)
    rows_per = n_pad // n_dev

    def fn(xs, ys, oks, xg, yg, okg):
        dev = xg.device
        thresh = torch.tensor((2.0 * radius) ** 2, dtype=torch.float32,
                              device=dev)
        row0 = mesh_rank(mesh) * rows_per
        col_idx = torch.arange(n_pad, device=dev)
        total = torch.zeros((), dtype=torch.int64, device=dev)
        for i0 in range(0, rows_per, block):
            sl = slice(i0, i0 + block)
            gi = row0 + i0 + torch.arange(block, device=dev)
            d2 = pair_dist_sq(xs[0, sl], ys[0, sl], xg, yg)
            mask = (gi[:, None] < col_idx[None, :]) & oks[0, sl, None] \
                & okg[None]
            total = total + (mask & (d2 < thresh)).sum()
        return psum_all(mesh, total)

    f32, b8 = torch.float32, torch.bool
    return fn, (_meta((1, rows_per), f32), _meta((1, rows_per), f32),
                _meta((1, rows_per), b8), _meta((n_pad,), f32),
                _meta((n_pad,), f32), _meta((n_pad,), b8))


def lower_sharded_crossing(mesh, n_edges: int, *, block: int = 256,
                           predicate: str = "sign"):
    """The row-sharded exact E_c as one rank's program: returns ``(fn,
    (sharded, replicated))``.  ``predicate='bool'`` uses the
    boolean-straddle form (:func:`~repro_torch.core.geometry.
    segments_cross_bool`) in place of the sign products.

    The abstract arguments are meta tensors of the reference's shapes:
    this rank's ``(1, per)`` shards of ``x1, y1, x2, y2`` (float32),
    ``v, u`` (int32) and ``valid`` (bool), and the same seven arrays
    replicated at ``(e_pad,)``.  ``fn(sharded, replicated)`` counts its
    rows ``block`` at a time under global ``i < j`` indices, shared
    endpoints excluded, and ends in one all-reduce over every mesh
    axis."""
    cross_fn = {"sign": segments_cross, "bool": segments_cross_bool}[
        predicate]
    n_dev = mesh_size(mesh)
    e_pad = -(-n_edges // (n_dev * block)) * (n_dev * block)
    per = e_pad // n_dev

    def fn(sh, rep):
        gx1, gy1, gx2, gy2, gv, gu, gok = rep
        dev = gx1.device
        row0 = mesh_rank(mesh) * per
        col_idx = torch.arange(e_pad, device=dev)
        total = torch.zeros((), dtype=torch.int64, device=dev)
        for i0 in range(0, per, block):
            bx1, by1, bx2, by2, bv, bu, bok = (a[0, i0:i0 + block]
                                               for a in sh)
            gi = row0 + i0 + torch.arange(block, device=dev)
            cross = cross_fn(
                bx1[:, None], by1[:, None], bx2[:, None], by2[:, None],
                gx1[None, :], gy1[None, :], gx2[None, :], gy2[None, :])
            shared = ((bv[:, None] == gv[None, :])
                      | (bv[:, None] == gu[None, :])
                      | (bu[:, None] == gv[None, :])
                      | (bu[:, None] == gu[None, :]))
            mask = (gi[:, None] < col_idx[None, :]) & bok[:, None] \
                & gok[None, :] & ~shared
            total = total + (mask & cross).sum()
        return psum_all(mesh, total)

    dtypes = (torch.float32,) * 4 + (torch.int32,) * 2 + (torch.bool,)
    sh = tuple(_meta((1, per), d) for d in dtypes)
    rep = tuple(_meta((e_pad,), d) for d in dtypes)
    return fn, (sh, rep)
