"""The port's planners and bucketing decompositions against the
reference's, on the parity-matrix families.

Plans must be equal field by field (single and batched ``pos``, tiered
and flat).  The bucketing steps -- ``gather_ragged_buckets``,
``scatter_to_buckets``, ``build_strip_segments(_batched)`` and
``build_cell_buckets`` -- must give equal values, valid masks, counts,
overflow and ``eid``: the reference runs them op by op (as its own
tests do, outside ``jit``), so both sides round every float op the same
way and the comparison is exact, no tolerance.  The one exception is
the segment angle ``theta``: XLA's and PyTorch's ``atan2`` differ in the
last bits, so it is held to ``ANGLE_ATOL``, two float32 ulps of pi.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import engine as ref_engine
from repro.core import grid as ref_grid
from repro_torch.core import engine as t_engine
from repro_torch.core import grid as t_grid
from test_parity_matrix import FAMILIES, RADIUS, N_STRIPS, make_family


ANGLE_ATOL = 2 * float(np.spacing(np.float32(np.pi)))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_equal_arrays(got, ref, what, angles=()):
    """Field by field equality; the fields at ``angles`` are held to
    ``ANGLE_ATOL``."""
    for k, (g, r) in enumerate(zip(got, ref)):
        g, r = _np(g), _np(r)
        assert g.shape == r.shape, (what, k, g.shape, r.shape)
        if k in angles:
            np.testing.assert_allclose(g, r, rtol=0, atol=ANGLE_ATOL,
                                       err_msg=f"{what}[{k}]")
        else:
            np.testing.assert_array_equal(g, r, err_msg=f"{what}[{k}]")


def _batch(pos):
    rng = np.random.default_rng(3)
    return np.stack([pos, pos + rng.normal(0, 0.7, pos.shape),
                     pos * 0.5]).astype(np.float32)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("tier", [True, False])
def test_plan_readability_equal(family, batched, tier):
    pos, edges = make_family(family)
    p = _batch(pos) if batched else pos
    ref = ref_engine.plan_readability(p, edges, radius=RADIUS,
                                      n_strips=N_STRIPS, tier_strips=tier)
    got = t_engine.plan_readability(p, edges, radius=RADIUS,
                                    n_strips=N_STRIPS, tier_strips=tier)
    for f in ref.__dataclass_fields__:
        assert getattr(got, f) == getattr(ref, f), f
    assert t_engine.plan_from_reference(ref) == got
    assert t_engine.plan_from_reference(
        {f: getattr(ref, f) for f in ref.__dataclass_fields__}) == got
    for axis_i in range(len(ref.axes)):
        assert_equal_arrays(t_engine._tier_layout(got, axis_i)[:3],
                            ref_engine._tier_layout(ref, axis_i)[:3],
                            "tier_layout")


def test_plan_metric_subsets_equal():
    pos, edges = make_family("random")
    for metrics in (("edge_crossing",), ("node_occlusion",),
                    ("minimum_angle", "edge_crossing_angle")):
        ref = ref_engine.plan_readability(pos, edges, radius=RADIUS,
                                          n_strips=56, metrics=metrics,
                                          orientation="horizontal")
        got = t_engine.plan_readability(pos, edges, radius=RADIUS,
                                        n_strips=56, metrics=metrics,
                                        orientation="horizontal")
        assert t_engine.plan_from_reference(ref) == got


@pytest.mark.parametrize("seed", range(3))
def test_gather_ragged_buckets_equal(seed):
    rng = np.random.default_rng(seed)
    B, M, K = 3, 200, 17
    keys = rng.integers(0, K, size=(B, M)).astype(np.int32)
    valid = rng.random((B, M)) < 0.8
    vals = rng.normal(size=(B, M)).astype(np.float32)
    ids = rng.integers(-5, 500, size=(B, M)).astype(np.int32)
    # ragged, permuted bucket layout with starved buckets (overflow)
    caps = rng.integers(0, 20, size=K)
    order = rng.permutation(K)
    off = np.zeros(K, np.int64)
    off[order] = np.concatenate([[0], np.cumsum(caps[order])])[:-1]
    ref = ref_grid.gather_ragged_buckets(
        jnp.asarray(keys), K, off, caps, jnp.asarray(vals),
        jnp.asarray(ids), valid=jnp.asarray(valid))
    got = t_grid.gather_ragged_buckets(
        torch.from_numpy(keys), K, off, caps, torch.from_numpy(vals),
        torch.from_numpy(ids), valid=torch.from_numpy(valid))
    assert_equal_arrays(got, ref, "gather_ragged")
    assert int(got[-1].sum()) > 0          # the fixture does overflow


@pytest.mark.parametrize("cap", [1, 4, 16])
def test_scatter_to_buckets_equal(cap):
    rng = np.random.default_rng(cap)
    keys = rng.integers(0, 9, size=120).astype(np.int32)
    valid = rng.random(120) < 0.7
    vals = rng.normal(size=120).astype(np.float32)
    ref = ref_grid.scatter_to_buckets(jnp.asarray(keys), 9, cap,
                                      jnp.asarray(vals),
                                      valid=jnp.asarray(valid))
    got = t_grid.scatter_to_buckets(torch.from_numpy(keys), 9, cap,
                                    torch.from_numpy(vals),
                                    valid=torch.from_numpy(valid))
    assert_equal_arrays(got, ref, "scatter")


def _segs_fields(s):
    return (s.strip, s.yl, s.yr, s.theta, s.v, s.u, s.valid, s.overflow,
            s.eid)


THETA = (3,)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("axis", [0, 1])
def test_build_strip_segments_equal(family, axis):
    pos, edges = make_family(family)
    E = edges.shape[0]
    ep = np.zeros((E + 37, 2), np.int32)
    ep[:E] = edges
    ev = np.arange(E + 37) < E
    plan = ref_engine.plan_readability(pos, edges, radius=RADIUS,
                                       n_strips=N_STRIPS)
    ms = plan.strip_plans[axis][0]
    ref = ref_grid.build_strip_segments(jnp.asarray(pos), jnp.asarray(ep),
                                        N_STRIPS, ms, axis=axis,
                                        edge_valid=jnp.asarray(ev))
    got = t_grid.build_strip_segments(torch.from_numpy(pos),
                                      torch.from_numpy(ep), N_STRIPS, ms,
                                      axis=axis, edge_valid=torch.from_numpy(ev))
    assert_equal_arrays(_segs_fields(got), _segs_fields(ref), "segments",
                        THETA)
    # a starved budget overflows identically
    ref = ref_grid.build_strip_segments(jnp.asarray(pos), jnp.asarray(edges),
                                        N_STRIPS, 128, axis=axis)
    got = t_grid.build_strip_segments(torch.from_numpy(pos),
                                      torch.from_numpy(edges), N_STRIPS, 128,
                                      axis=axis)
    assert_equal_arrays(_segs_fields(got), _segs_fields(ref), "starved",
                        THETA)


@pytest.mark.parametrize("family", FAMILIES)
def test_build_strip_segments_batched_equal(family):
    pos, edges = make_family(family)
    batch = _batch(pos)
    plan = ref_engine.plan_readability(batch, edges, radius=RADIUS,
                                       n_strips=N_STRIPS)
    for axis_i, axis in enumerate(plan.axes):
        ms = plan.strip_plans[axis_i][0]
        ref = ref_grid.build_strip_segments_batched(
            jnp.asarray(batch), jnp.asarray(edges), N_STRIPS, ms, axis=axis)
        got = t_grid.build_strip_segments_batched(
            torch.from_numpy(batch), torch.from_numpy(edges), N_STRIPS, ms,
            axis=axis)
        assert_equal_arrays(_segs_fields(got), _segs_fields(ref), "batched",
                            THETA)
    # zero valid edges: the batched build's empty-extent pin
    ev = np.zeros(edges.shape[0], bool)
    ref = ref_grid.build_strip_segments_batched(
        jnp.asarray(batch), jnp.asarray(edges), N_STRIPS, 128,
        edge_valid=jnp.asarray(ev))
    got = t_grid.build_strip_segments_batched(
        torch.from_numpy(batch), torch.from_numpy(edges), N_STRIPS, 128,
        edge_valid=torch.from_numpy(ev))
    assert_equal_arrays(_segs_fields(got), _segs_fields(ref), "empty",
                        THETA)


@pytest.mark.parametrize("family", FAMILIES)
def test_build_cell_buckets_equal(family):
    pos, _ = make_family(family)
    V = pos.shape[0]
    pp = np.full((V + 29, 2), -1.0e6, np.float32)       # PARK rows
    pp[:V] = pos
    valid = np.arange(V + 29) < V
    origin, nx, ny, cap, size = ref_grid.plan_occlusion_grid(pos, RADIUS)
    assert (origin, nx, ny, cap, size) == t_grid.plan_occlusion_grid(
        pos, RADIUS)
    for c in (cap, 2):                                  # 2: starved
        ref = ref_grid.build_cell_buckets(jnp.asarray(pp), RADIUS, origin,
                                          nx, ny, c, valid=jnp.asarray(valid),
                                          cell_size=size)
        got = t_grid.build_cell_buckets(torch.from_numpy(pp), RADIUS,
                                        origin, nx, ny, c,
                                        valid=torch.from_numpy(valid),
                                        cell_size=size)
        assert_equal_arrays(got[:5], ref[:5], f"cells cap={c}")
    assert_equal_arrays([t_grid.neighbour_bucket_ids(nx, ny)],
                        [ref_grid.neighbour_bucket_ids(nx, ny)], "nbr")


def test_host_planners_equal():
    rng = np.random.default_rng(0)
    occ = rng.integers(0, 400, size=64)
    assert t_grid.plan_strip_tiers(occ) == ref_grid.plan_strip_tiers(occ)
    caps = rng.integers(1, 2000, size=40)
    for k in (1, 2, 3):
        assert (t_grid.tiers_from_caps(caps, max_tiers=k)
                == ref_grid.tiers_from_caps(caps, max_tiers=k))
    for n in (0, 1, 7, 8, 9, 1000):
        assert t_grid._next_pow2(n) == ref_grid._next_pow2(n)
        assert t_grid._round_up(n, 8) == ref_grid._round_up(n, 8)
    pos, edges = make_family("cluster")
    for axis in (0, 1):
        ms, per = t_grid.plan_strip_occupancy(pos, edges, 40, axis=axis)
        ms_r, per_r = ref_grid.plan_strip_occupancy(pos, edges, 40, axis=axis)
        assert ms == ms_r
        np.testing.assert_array_equal(per, per_r)
    assert (t_grid.plan_strip_occupancy(pos, edges[:0], 16)[0]
            == ref_grid.plan_strip_occupancy(pos, edges[:0], 16)[0])
    assert (t_grid.plan_occlusion_grid(pos[:0], 1.0)
            == ref_grid.plan_occlusion_grid(pos[:0], 1.0))
