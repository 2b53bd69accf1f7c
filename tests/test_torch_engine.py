"""The port's engine against the reference's on the parity-matrix
families: ``evaluate_planned``, ``evaluate_once`` and
``evaluate_layouts``, single and batched, natural and padded (``n_valid``
scalars, ``PARK`` rows), tiered and flat, ``use_kernels`` on and off,
under the same plan (``plan_from_reference``) and under each side's own.

The bar is the reference's parity rule: integer metrics (N_c, E_c,
``crossing_count_for_angle``, ``overflow``) equal; float metrics (M_a,
M_l, E_ca) at ``RTOL = 1e-5``.

The reference runs jitted, as its own tests run it: the families are
built so that no float rounding can flip a count.  Jittered layouts hold
near-ties, and there XLA's CPU ``jit`` contracts multiply-adds into FMAs
that flip some of them (the port rounds each op, as the reference does
op by op), so jittered layouts are compared with the reference's eager
``evaluate_once``, whose strip build runs op by op.

The near-parallel case (``fixtures.near_parallel_layouts``) pins the
open E_ca fault of ROADMAP queue 3 against the reference run op by op:
integers and the deviation sum pass, E_ca's rtol 1e-5 check is a strict
xfail, and a diagnostic shows that ``atan2`` does not cause it.
"""

import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core import grid as ref_grid
from repro_torch.core import engine as t_engine
from repro_torch.core import grid as t_grid
from repro_torch.kernels.fixtures import near_parallel_layouts, parity_family
from repro_torch.launch.session import PARK
from test_parity_matrix import FAMILIES, RADIUS, N_STRIPS, make_family
from test_torch_kernels import (NEAR_PARALLEL_REASON, NEAR_PARALLEL_REFERENCE,
                                check_near_parallel, near_parallel_scores)

RTOL = 1e-5
INT_FIELDS = ("node_occlusion", "edge_crossing", "crossing_count_for_angle",
              "overflow")
FLOAT_FIELDS = ("minimum_angle", "edge_length_variation",
                "edge_crossing_angle")


def assert_parity(got, ref, what=""):
    for f in INT_FIELDS + FLOAT_FIELDS:
        g, r = getattr(got, f), getattr(ref, f)
        assert (g is None) == (r is None), (what, f)
        if g is None:
            continue
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        r = np.asarray(r)
        if f in INT_FIELDS:
            np.testing.assert_array_equal(g, r, err_msg=f"{what}/{f}")
        else:
            np.testing.assert_allclose(g, r, rtol=RTOL,
                                       err_msg=f"{what}/{f}")


def padded(pos, edges, extra_v=41, extra_e=57):
    V, E = pos.shape[-2], edges.shape[0]
    pp = np.full(pos.shape[:-2] + (V + extra_v, 2), PARK, np.float32)
    pp[..., :V, :] = pos
    ep = np.zeros((E + extra_e, 2), np.int32)
    ep[:E] = edges
    return pp, ep


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("family,use_kernels", [
    *((f, False) for f in FAMILIES), ("duplicate", True)])
def test_evaluate_planned_parity(family, use_kernels):
    """Tiered plan, natural size; same plan and own plan."""
    pos, edges = make_family(family)
    plan = ref_engine.plan_readability(pos, edges, radius=RADIUS,
                                       n_strips=N_STRIPS)
    ref = ref_engine.evaluate_planned(plan, pos, edges,
                                      use_kernels=use_kernels)
    got = t_engine.evaluate_planned(t_engine.plan_from_reference(plan),
                                    T(pos), T(edges),
                                    use_kernels=use_kernels)
    assert_parity(got, ref, family)
    own = t_engine.plan_readability(pos, edges, radius=RADIUS,
                                    n_strips=N_STRIPS)
    assert_parity(t_engine.evaluate_planned(own, T(pos), T(edges),
                                            use_kernels=use_kernels),
                  ref, family + "/own plan")


@pytest.mark.parametrize("family", ["random", "grid", "duplicate"])
def test_flat_plan_padded_parity(family):
    """Flat plan (the session's), PARK-padded with n_valid scalars: equal
    to the reference's padded run and, on integers, to the port's
    natural-size run."""
    pos, edges = make_family(family)
    plan = ref_engine.plan_readability(pos, edges, radius=RADIUS,
                                       n_strips=N_STRIPS, tier_strips=False)
    pp, ep = padded(pos, edges)
    nv, ne = pos.shape[0], edges.shape[0]
    ref = ref_engine.evaluate_planned(plan, pp, ep, np.int32(nv),
                                      np.int32(ne))
    tplan = t_engine.plan_from_reference(plan)
    got = t_engine.evaluate_planned(tplan, T(pp), T(ep), nv, ne)
    assert_parity(got, ref, family)
    natural = t_engine.evaluate_planned(tplan, T(pos), T(edges))
    for f in INT_FIELDS:
        assert int(getattr(natural, f)) == int(getattr(got, f)), f


def test_evaluate_once_parity_jittered():
    """The reference's eager program (``evaluate_once``: its strip build
    runs op by op) on jittered layouts full of near-ties, member by
    member, against the port's batched program (and its singles)."""
    pos, edges = make_family("duplicate")
    rng = np.random.default_rng(11)
    batch = np.stack([pos, pos + rng.normal(0, 0.5, pos.shape)]
                     ).astype(np.float32)
    plan = ref_engine.plan_readability(batch, edges, radius=RADIUS,
                                       n_strips=N_STRIPS, tier_strips=False)
    tplan = t_engine.plan_from_reference(plan)
    got = t_engine.evaluate_layouts(tplan, T(batch), T(edges))
    for b in range(batch.shape[0]):
        ref = ref_engine.evaluate_once(plan, batch[b], edges)
        assert_parity(t_engine.evaluate_once(tplan, T(batch[b]), T(edges)),
                      ref, f"once[{b}]")
        assert_parity(type(got)(*(None if v is None else v[b]
                                  for v in got)), ref, f"batch[{b}]")


def check_batched(plan, batch, edges, ref):
    """The port's padded batched program against ``ref`` (the reference
    result on the padded batch); within the port, batched == looped and
    padded == natural on integers."""
    bp, ep = padded(batch, edges)
    nv, ne = batch.shape[1], edges.shape[0]
    tplan = t_engine.plan_from_reference(plan)
    got = t_engine.evaluate_layouts(tplan, T(bp), T(ep), nv, ne)
    assert_parity(got, ref(bp, ep, np.int32(nv), np.int32(ne)), "batch")
    natural = t_engine.evaluate_layouts(tplan, T(batch), T(edges))
    for b in range(batch.shape[0]):
        single = t_engine.evaluate_planned(tplan, T(batch[b]), T(edges))
        for f in INT_FIELDS:
            assert int(getattr(single, f)) == int(getattr(got, f)[b]), f
            assert int(getattr(natural, f)[b]) == int(getattr(got, f)[b]), f


@pytest.mark.parametrize("family", ["random", "collinear", "duplicate"])
def test_batched_parity_padded(family):
    """Batch members: the layout and its x/y swap, whose strip arithmetic
    is member 0's with the orientations exchanged -- so the jitted
    reference can be compared exactly."""
    pos, edges = make_family(family)
    batch = np.stack([pos, pos[:, ::-1], pos]).astype(np.float32)
    plan = ref_engine.plan_readability(batch, edges, radius=RADIUS,
                                       n_strips=N_STRIPS)
    check_batched(plan, batch, edges,
                  lambda *a: ref_engine.evaluate_layouts(plan, *a))


def test_batched_kernels_route_parity():
    """``use_kernels`` batches: the reference vmaps the kernel route; the
    port loops it.  Members are exact translations of the random family."""
    pos, edges = make_family("random")
    batch = np.stack([pos, pos + 0.5, pos - 0.25]).astype(np.float32)
    plan = ref_engine.plan_readability(batch, edges, radius=RADIUS,
                                       n_strips=N_STRIPS, tier_strips=False)
    ref = ref_engine.evaluate_layouts(plan, batch, edges, use_kernels=True)
    got = t_engine.evaluate_layouts(t_engine.plan_from_reference(plan),
                                    T(batch), T(edges), use_kernels=True)
    assert_parity(got, ref, "kernels batch")


@pytest.mark.parametrize("metrics,counts", [
    (("edge_crossing",), dict(cell_builds=0, vertex_sorts=0,
                              strip_builds=2, reversal_sweeps=2)),
    (("node_occlusion",), dict(cell_builds=1, vertex_sorts=0,
                               strip_builds=0, reversal_sweeps=0)),
])
def test_metric_subsets_prune(metrics, counts):
    """The port's work counters show the reference's subset pruning
    (``tests/test_api.py``), and the subset values match."""
    pos, edges = make_family("cluster")
    plan = ref_engine.plan_readability(pos, edges, radius=RADIUS,
                                       n_strips=56, metrics=metrics)
    ref = ref_engine.evaluate_planned(plan, pos, edges)
    t_grid.reset_call_counts()
    got = t_engine.evaluate_planned(t_engine.plan_from_reference(plan),
                                    T(pos), T(edges))
    for k, v in counts.items():
        assert t_grid.CALL_COUNTS[k] == v, k
    assert_parity(got, ref, str(metrics))
    t_grid.reset_call_counts()
    t_engine.evaluate_layouts(t_engine.plan_from_reference(plan),
                              T(np.stack([pos, pos])), T(edges))
    for k, v in counts.items():
        assert t_grid.CALL_COUNTS[k] == v, ("batched", k)


def test_replan_on_overflow_matches_reference():
    """A starved plan overflows alike on both sides, and the replan gives
    the reference's plan."""
    pos, edges = make_family("cluster")
    plan = ref_engine.plan_readability(pos, edges, radius=RADIUS,
                                       n_strips=N_STRIPS)
    import dataclasses
    starved = dataclasses.replace(
        plan, cell_cap=8,
        strip_plans=tuple((ms, 16) for ms, _ in plan.strip_plans),
        strip_tiers=())
    ref = ref_engine.evaluate_planned(starved, pos, edges)
    got = t_engine.evaluate_planned(t_engine.plan_from_reference(starved),
                                    T(pos), T(edges))
    assert int(ref.overflow) > 0
    assert int(got.overflow) == int(ref.overflow)
    for f in ("node_occlusion", "edge_crossing"):
        assert int(getattr(got, f)) == int(getattr(ref, f)), f
    ref_plan = ref_engine.replan_on_overflow(starved, pos, edges, ref,
                                             growth=1.5)
    got_plan = t_engine.replan_on_overflow(
        t_engine.plan_from_reference(starved), pos, edges, got, growth=1.5)
    assert got_plan == t_engine.plan_from_reference(ref_plan)
    assert int(t_engine.evaluate_planned(got_plan, T(pos),
                                         T(edges)).overflow) == 0
    # nothing overflowed: the plan comes back unchanged
    assert t_engine.replan_on_overflow(got_plan, pos, edges,
                                       got._replace(overflow=0)) is got_plan


def test_shared_reversal_formula():
    """The engine's sweep and the kernel module's plain version are one
    function, and it equals the reference's per-row formula."""
    from repro_torch.kernels.strip_reversal import fused_reversal_block
    assert t_engine.fused_reversal_block is fused_reversal_block
    rng = np.random.default_rng(0)
    a = [rng.uniform(0, 5, (4, 50)).astype(np.float32) for _ in range(3)]
    vu = [rng.integers(0, 30, (4, 50)).astype(np.int32) for _ in range(2)]
    ok = rng.random((4, 50)) < 0.9
    args = a + vu + [ok]
    rc, rd = ref_engine.fused_reversal_block(*map(np.asarray, args),
                                             ideal=1.0, reduce="rows")
    gc, gd = fused_reversal_block(*map(T, args), ideal=1.0, reduce="rows")
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    np.testing.assert_allclose(gd.numpy(), np.asarray(rd), rtol=RTOL)
    assert ref_grid.count_dtype() is not None


# ---------------------------------------------------------------------------
# the open E_ca fault: near-parallel crossings (ROADMAP queue 3)
# ---------------------------------------------------------------------------

NEAR_PARALLEL_BACKENDS = [(b, m) for b in ("fused", "eager", "kernels")
                          for m in ("single", "batched")]


@pytest.mark.parametrize("kind", FAMILIES)
def test_parity_family_twins(kind):
    """The JAX-free families of ``repro_torch.kernels.fixtures`` (the card
    tests use them) are the parity matrix's, and the near-parallel case is
    its ``collinear`` family jittered by N(0, 0.02) from
    ``default_rng(3)``."""
    pos, edges = make_family(kind)
    tpos, tedges = parity_family(kind)
    np.testing.assert_array_equal(tpos, pos)
    np.testing.assert_array_equal(tedges, edges)
    if kind == "collinear":
        rng = np.random.default_rng(3)
        want = np.stack([pos + rng.normal(0, 0.02, pos.shape)
                         for _ in range(2)]).astype(np.float32)
        batch, nedges = near_parallel_layouts()
        np.testing.assert_array_equal(batch, want)
        np.testing.assert_array_equal(nedges, edges)


@pytest.fixture(scope="module")
def near_parallel():
    """The near-parallel case; the reference runs op by op (jit disabled)
    under one flat plan of both layouts."""
    import jax
    batch, edges = near_parallel_layouts()
    plan = ref_engine.plan_readability(batch, edges, radius=RADIUS,
                                       n_strips=N_STRIPS, tier_strips=False)
    with jax.disable_jit():
        ref = [ref_engine.evaluate_planned(plan, b, edges) for b in batch]
    return batch, edges, plan, ref


def test_near_parallel_card_constants(near_parallel):
    """The reference constants the card tests hold the CUDA sweep to
    (``test_torch_kernels.NEAR_PARALLEL_REFERENCE``) are the op-by-op
    reference's values."""
    *_, ref = near_parallel
    for r, want in zip(ref, NEAR_PARALLEL_REFERENCE):
        for f in INT_FIELDS + FLOAT_FIELDS:
            assert np.asarray(getattr(r, f)).item() == want[f], f


@pytest.mark.parametrize("backend,mode", NEAR_PARALLEL_BACKENDS)
def test_near_parallel_ints_and_deviation_sum(near_parallel, backend, mode):
    """Integers equal the op-by-op reference, and so does the deviation
    sum behind E_ca at rtol 1e-5 (it differs by about 1e-7 relative)."""
    batch, edges, _, ref = near_parallel
    check_near_parallel(
        near_parallel_scores(batch, edges, backend, mode, "cpu"), ref)


@pytest.mark.xfail(strict=True, reason=NEAR_PARALLEL_REASON)
@pytest.mark.parametrize("backend,mode", NEAR_PARALLEL_BACKENDS)
def test_near_parallel_eca(near_parallel, backend, mode):
    """E_ca itself at the parity bar (rtol 1e-5): it misses by 1.3e-4 and
    1.6e-4 relative, the open fault of ROADMAP queue 3."""
    batch, edges, _, ref = near_parallel
    got = near_parallel_scores(batch, edges, backend, mode, "cpu")
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.edge_crossing_angle,
                                   r.edge_crossing_angle, rtol=RTOL)


def test_near_parallel_gap_is_not_atan2(near_parallel):
    """The diagnostic: the reference's segment thetas fed to the port's
    sweep give the port's E_ca bit for bit, so ``atan2`` (one ulp apart on
    about a quarter of the thetas here) does not account for the gap; the
    float32 summation order of the deviation terms does."""
    import jax.numpy as jnp
    from repro.core.geometry import segment_theta as ref_theta
    batch, edges, plan, _ = near_parallel
    tplan = t_engine.plan_from_reference(plan)
    e = T(edges)
    for b in batch:
        p, q = b[edges[:, 0]], b[edges[:, 1]]
        theta = torch.from_numpy(np.array(ref_theta(
            jnp.asarray(p[:, 0]), jnp.asarray(p[:, 1]),
            jnp.asarray(q[:, 0]), jnp.asarray(q[:, 1]))))

        def eca(own_theta):
            stats = []
            for axis_i, (axis, (ms, _)) in enumerate(zip(tplan.axes,
                                                          tplan.strip_plans)):
                segs = t_grid.build_strip_segments(T(b), e, tplan.n_strips,
                                                   ms, axis=axis)
                if not own_theta:
                    segs = segs._replace(theta=theta[segs.eid])
                segs = segs._replace(**{f: getattr(segs, f)[None] for f in (
                    "strip", "yl", "yr", "theta", "v", "u", "valid")})
                cnt, dsum, drop = t_engine._tiered_strip_stats(
                    tplan, axis_i, segs, 1, with_angle=True)
                stats.append((cnt[0], dsum[0], drop[0]))
            out = {}
            t_engine._combine(stats, True, True, out)
            return float(out["edge_crossing_angle"])

        got = t_engine.evaluate_planned(tplan, T(b), e)
        assert eca(own_theta=True) == float(got.edge_crossing_angle)
        assert eca(own_theta=False) == eca(own_theta=True)
