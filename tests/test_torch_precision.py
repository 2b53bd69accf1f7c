"""``precision="bfloat16"`` on the port against the reference's bfloat16
run, route by route, on the parity-matrix families.

The reference's precision is one cast (``jnp.asarray(pos, plan.dtype)``)
after which every op follows the dtype, so bfloat16 results drift from
float32 by far more than rounding (on ``examples/quickstart.py``'s
graph N_c 39 -> 35, E_c 148,319 -> 126,101).  The port is therefore held
to the reference's own bfloat16 results:

* integer metrics (N_c, E_c, ``crossing_count_for_angle``, ``overflow``)
  equal;
* float metrics within ``RTOL`` = 2^-7 (two bfloat16 ulps): the port's
  sums run in another order and round to bfloat16 (the fused route sums
  deviations in bfloat16; the kernels route casts the buckets to float32
  and sums float32 partials, as the reference's wrapper does).

Routes: ``fused`` (the session, pow2-padded with ``PARK`` rows),
``kernels``, and the batched ``evaluate_batch`` of the fused and
kernels backends, each against the reference's same call; ``eager``
(the single-layout program the eager backend runs) and the engine on
``PARK``-padded arrays under ``n_valid`` scalars, each under the
reference's batch plan and held to the reference's batched program's
member 0 (one plan, so looped equals batched as in float32).  The
reference runs jitted here, one compile per route and family; on these
families its jitted and op-by-op bfloat16 results were measured equal
(integers and floats), and the card's constants are made op by op
(``tools/chip_smoke_reference.py --bf16``).

Kernels: the bfloat16 plain version of the strip-reversal sweep against
the reference's ``fused_reversal_block`` in bfloat16 (the Pallas kernel
refuses bfloat16 inputs, which is why the reference's kernels route
casts them to float32), and the occlusion-pair plain version on
bfloat16 coordinates against the reference's ``occlusion_count_op``
(Pallas, interpret mode), which widens them to float32 first.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import EvalConfig as RefConfig
from repro.api import Evaluator as RefEvaluator
from repro.core import engine as ref_engine
from repro.kernels import ops as ref_ops
from repro.kernels.strip_reversal import strip_reversal_stats
from repro.launch.session import PARK as REF_PARK
from repro_torch.api import EvalConfig, Evaluator
from repro_torch.core import engine as t_engine
from repro_torch.core.engine import DEFAULT_IDEAL
from repro_torch.kernels import occlusion_pairs as t_occ
from repro_torch.kernels import strip_reversal as t_rev
from repro_torch.kernels.fixtures import (STRIP_SLABS, WIDE_STRIP_SLABS,
                                          boundary_points, strip_slab)
from repro_torch.launch.session import PARK
from test_parity_matrix import FAMILIES, N_STRIPS, RADIUS, make_family

RTOL = 2.0 ** -7
INT_FIELDS = ("node_occlusion", "edge_crossing", "crossing_count_for_angle",
              "overflow")
FLOAT_FIELDS = ("minimum_angle", "edge_length_variation",
                "edge_crossing_angle")
ROUTES = ("fused", "eager", "kernels", "batch", "kernels_batch")
KW = dict(radius=RADIUS, n_strips=N_STRIPS, precision="bfloat16")


def assert_bf16_parity(got, ref, what, ints_only=False):
    for f in INT_FIELDS + FLOAT_FIELDS:
        g = getattr(got, f)
        r = getattr(ref, f)
        assert (g is None) == (r is None), (what, f)
        g = (g.float().numpy() if isinstance(g, torch.Tensor)
             else np.asarray(g, np.float64))
        r = np.asarray(np.asarray(r, np.float32), np.float64)
        if f in INT_FIELDS:
            np.testing.assert_array_equal(g, r, err_msg=f"{what}/{f}")
        elif not ints_only:
            np.testing.assert_allclose(g, r, rtol=RTOL,
                                       err_msg=f"{what}/{f}")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side runs on one intra-op thread here (restored
    afterwards): the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """One family's inputs and the reference's bfloat16 results on every
    route (one run each, shared by the family's tests): the fused and
    kernels evaluators, and the batched program under the batch's plan
    (what ``evaluate_batch`` plans and runs)."""
    pos, edges = make_family(request.param)
    batch = np.stack([pos, pos + 0.5]).astype(np.float32)
    cfg = RefConfig(**KW)
    kcfg = dataclasses.replace(cfg, backend="kernels")
    plan = ref_engine.plan_readability(batch, edges, **cfg.plan_kwargs())
    batched = ref_engine.evaluate_layouts(plan, batch, edges)
    ref = {
        "fused": RefEvaluator(cfg).evaluate(pos, edges),
        "kernels": RefEvaluator(kcfg).evaluate(pos, edges),
        "batch": batched,
        "eager": batched.unbatch()[0],
    }
    return request.param, pos, edges, batch, plan, ref


def _port(route, pos, edges, batch, plan):
    base = EvalConfig(**KW)
    kernels = dataclasses.replace(base, backend="kernels")
    if route == "fused":
        return Evaluator(base, device="cpu").evaluate(pos, edges)
    if route == "eager":
        return t_engine.evaluate_once(t_engine.plan_from_reference(plan),
                                      pos, edges, device="cpu")
    if route == "kernels":
        return Evaluator(kernels, device="cpu").evaluate(pos, edges)
    ev = Evaluator(kernels if route == "kernels_batch" else base,
                   device="cpu")
    return ev.evaluate_batch(batch, edges)


@pytest.mark.parametrize("route", ROUTES)
def test_bf16_route_matches_reference(family, route):
    kind, pos, edges, batch, plan, ref = family
    got = _port(route, pos, edges, batch, plan)
    if route == "kernels_batch":
        # the reference vmaps its kernels program; the port loops it:
        # member 0 is the kernels route's result, every member's
        # integers are the fused batch's
        members = got.unbatch()
        assert_bf16_parity(members[0], ref["kernels"], f"{kind}/{route}")
        for i, m in enumerate(members):
            assert_bf16_parity(m, ref["batch"].unbatch()[i],
                               f"{kind}/{route}[{i}]", ints_only=True)
        return
    if route == "batch":
        # the port plans the batch as the reference does
        assert Evaluator(EvalConfig(**KW), device="cpu").plan(
            batch, edges) == t_engine.plan_from_reference(plan)
        for i, (g, r) in enumerate(zip(got.unbatch(),
                                       ref["batch"].unbatch())):
            assert_bf16_parity(g, r, f"{kind}/{route}[{i}]")
        return
    assert_bf16_parity(got, ref[route], f"{kind}/{route}")


def test_bf16_padded_engine_equals_natural(family):
    """The engine under ``n_valid`` scalars on ``PARK``-padded arrays, in
    bfloat16, under the reference's plan: its natural-size result
    (integers equal, floats at ``RTOL``)."""
    kind, pos, edges, _, plan, ref = family
    tp = t_engine.plan_from_reference(plan)
    V, E = pos.shape[0], edges.shape[0]
    pp = np.full((V + 41, 2), PARK, np.float32)
    pp[:V] = pos
    ep = np.zeros((E + 57, 2), np.int32)
    ep[:E] = edges
    got = t_engine.evaluate_planned(tp, pp, ep, n_valid_vertices=V,
                                    n_valid_edges=E, device="cpu")
    assert_bf16_parity(got, ref["eager"], f"{kind}/padded")


def test_park_rounds_alike():
    """The session's padding value lands on the same bfloat16 value in
    both packages (-1e6 rounds to -999424)."""
    assert PARK == REF_PARK
    t = torch.tensor(PARK, dtype=torch.float32).to(torch.bfloat16)
    j = jnp.asarray(np.float32(REF_PARK), jnp.bfloat16)
    assert float(t) == float(j) == -999424.0


def test_bf16_config_evaluates_in_bf16():
    """``EvalConfig(precision="bfloat16")`` has the reference's digest and
    evaluates, with bfloat16 floats in the fused route's result;
    ``asdict`` gives the reference's plain dict of the scores."""
    cfg = EvalConfig(precision="bfloat16")
    assert cfg.digest() == RefConfig(precision="bfloat16").digest()
    pos, edges = make_family("random")
    ev = Evaluator(dataclasses.replace(cfg, radius=RADIUS,
                                       n_strips=N_STRIPS), device="cpu")
    assert ev.plan(pos, edges).dtype == torch.bfloat16
    got = ev.evaluate(pos, edges)
    assert got.ok and got.overflow == 0
    assert got.asdict() == dict(got._asdict())
    # the fused route's E_ca is a bfloat16 value
    e_ca = float(got.edge_crossing_angle)
    assert float(torch.tensor(e_ca).to(torch.bfloat16)) == e_ca


def test_bf16_incremental_and_graph_sharded_routes_follow_reference():
    """On one family: ``register_layout`` / ``update`` and the
    ``graph_sharded`` backend in bfloat16, against the reference's same
    calls."""
    pos, edges = make_family("cluster")
    moved, new_xy = np.arange(3), pos[:3] + 1.5
    cfg, rcfg = EvalConfig(**KW), RefConfig(**KW)
    ev, rev = Evaluator(cfg, device="cpu"), RefEvaluator(rcfg)
    assert_bf16_parity(ev.register_layout("a", pos, edges),
                       rev.register_layout("a", pos, edges), "register")
    assert_bf16_parity(ev.update("a", moved, new_xy),
                       rev.update("a", moved, new_xy), "update")
    gev = Evaluator(dataclasses.replace(cfg, backend="graph_sharded"),
                    device="cpu")
    grev = RefEvaluator(dataclasses.replace(rcfg, backend="graph_sharded"))
    assert_bf16_parity(gev.evaluate(pos, edges), grev.evaluate(pos, edges),
                       "graph_sharded")


def test_bf16_server_matches_reference():
    """``ReadabilityServer`` at bfloat16 on two requests of one topology
    (one coalesced session dispatch), against the reference's server."""
    from repro.launch.serve import ReadabilityServer as RefServer
    from repro_torch.launch.serve import ReadabilityServer

    pos, edges = make_family("random")
    reqs = [(pos, edges), ((pos + 0.5).astype(np.float32), edges)]
    got = ReadabilityServer(EvalConfig(**KW), device="cpu")
    want = RefServer(RefConfig(**KW))
    for i, (g, r) in enumerate(zip(got.evaluate_batch(reqs),
                                   want.evaluate_batch(reqs))):
        assert g.ok and r.ok
        assert_bf16_parity(g, r, f"server[{i}]")
    assert got.stats["dispatches"] == want.stats["dispatches"] == 1


def test_bf16_distributed_single_layout_evaluates_in_float32():
    """The reference's single-layout ``distributed`` route ignores the
    precision: ``repro.distributed.gridded.evaluate_sharded`` casts the
    layout to float32 (``gridded.py:137``).  The port's route does the
    same: at ``precision="bfloat16"`` it returns the float32 run's
    scores exactly.  (Its batched route follows the precision, as the
    reference's does: ``test_bf16_route_matches_reference`` covers the
    engine it shards.)"""
    pos, edges = make_family("cluster")
    cfg = EvalConfig(**KW, backend="distributed")
    got = Evaluator(cfg, device="cpu").evaluate(pos, edges)
    f32 = Evaluator(dataclasses.replace(cfg, precision="float32"),
                    device="cpu").evaluate(pos, edges)
    for f in INT_FIELDS + FLOAT_FIELDS:
        assert float(getattr(got, f)) == float(getattr(f32, f)), f


# ---------------------------------------------------------------------------
# the kernels' bfloat16 plain versions
# ---------------------------------------------------------------------------

SLABS = {**STRIP_SLABS, **WIDE_STRIP_SLABS}
KERNEL_SLABS = ("cap200_ties", "interior_gaps", "cap2500_windows")


@pytest.mark.parametrize("name", KERNEL_SLABS)
def test_bf16_plain_reversal_matches_reference_block(name):
    """The strip-reversal plain version on a bfloat16 slab: counts equal
    to the reference's ``fused_reversal_block`` in bfloat16, and its
    float32 row partials rounded to bfloat16 equal the reference's
    bfloat16 row sums bit for bit."""
    yl, yr, th, v, u, ok = strip_slab(**SLABS[name])
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (yl, yr, th)]
    rc, rd = jax.jit(lambda a, b, c, d, e, f: ref_engine.fused_reversal_block(
        a, b, c, d, e, f, ideal=DEFAULT_IDEAL, reduce="rows"))(
        *bf, jnp.asarray(v), jnp.asarray(u), jnp.asarray(ok))
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (yl, yr, th)]
    cnt, dev = t_rev.strip_reversal_rows_plain(
        *tb, torch.from_numpy(v), torch.from_numpy(u), torch.from_numpy(ok),
        ideal=DEFAULT_IDEAL)
    assert dev.dtype == torch.float32
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(dev.to(torch.bfloat16).float().numpy(),
                                  np.asarray(rd, np.float32))


def test_pallas_reversal_refuses_bf16_so_kernels_route_casts():
    """The reference's Pallas sweep cannot take bfloat16 inputs (its
    deviation output is float32); its kernels route casts the buckets to
    float32 first, and the port's kernels route does the same: its sweep
    of a bfloat16 slab through ``ops.strip_reversal_op`` equals the Pallas
    kernel's on the widened slab."""
    yl, yr, th, v, u, ok = strip_slab(**SLABS["cap200_ties"])
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (yl, yr, th)]
    with pytest.raises(ValueError, match="dtype"):
        strip_reversal_stats(*bf, jnp.asarray(v), jnp.asarray(u),
                             jnp.asarray(ok.astype(np.int32)),
                             ideal=DEFAULT_IDEAL, with_angle=True,
                             interpret=True)
    from repro.core.grid import SegmentBuckets as RefBuckets
    from repro_torch.core.grid import SegmentBuckets
    from repro_torch.kernels.ops import strip_reversal_op
    kc, kd = ref_ops.strip_reversal_op(
        RefBuckets(*bf, jnp.asarray(v), jnp.asarray(u), jnp.asarray(ok),
                   overflow=0), ideal=DEFAULT_IDEAL, with_angle=True)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (yl, yr, th)]
    cnt, dsum = strip_reversal_op(
        SegmentBuckets(*tb, torch.from_numpy(v), torch.from_numpy(u),
                       torch.from_numpy(ok), torch.zeros(())),
        ideal=DEFAULT_IDEAL, with_angle=True)
    assert int(cnt) == int(kc)
    assert dsum.dtype == torch.float32
    np.testing.assert_allclose(float(dsum), float(kd), rtol=1e-5)


@pytest.mark.parametrize("seed", range(2))
def test_bf16_plain_occlusion_matches_reference_route(seed):
    """The occlusion-pair plain version on bfloat16 coordinates equals the
    reference's ``occlusion_count_op`` on the bfloat16 layout (Pallas,
    interpret mode), which widens the layout to float32 before the
    kernel; pairs at exactly ``2r`` included."""
    rng = np.random.default_rng(seed)
    pos = np.concatenate([boundary_points(0.5),
                          rng.uniform(0, 20, (700, 2)).astype(np.float32)])
    pos_bf = jnp.asarray(pos, jnp.bfloat16)
    ok = rng.random(pos.shape[0]) < 0.9
    want = int(ref_ops.occlusion_count_op(pos_bf, 0.5,
                                          valid=jnp.asarray(ok)))
    tp = torch.from_numpy(pos).to(torch.bfloat16)
    n = pos.shape[0]
    n_pad = -(-n // t_occ.TILE) * t_occ.TILE
    x = torch.zeros(n_pad, dtype=torch.bfloat16)
    y = torch.zeros(n_pad, dtype=torch.bfloat16)
    valid = torch.zeros(n_pad, dtype=torch.bool)
    x[:n], y[:n], valid[:n] = tp[:, 0], tp[:, 1], torch.from_numpy(ok)
    assert int(t_occ.occlusion_pairs_plain(x, y, valid, 0.5)) == want > 0
    before = (t_occ.occlusion_pairs.LAUNCHES,
              t_occ.occlusion_pairs.LAUNCHES_BF16)
    assert int(t_occ.occlusion_pairs(x, y, valid, 0.5)) == want
    assert (t_occ.occlusion_pairs.LAUNCHES,
            t_occ.occlusion_pairs.LAUNCHES_BF16) == before
