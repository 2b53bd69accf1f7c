"""The port's gradient layout search (:mod:`repro_torch.search`,
``Evaluator.search``) and its force-directed layout against
:mod:`repro.search` and :func:`repro.graphs.layouts.fruchterman_reingold`.

* **One step** from the same ``(pos, m, v, step, tau)`` -- a mid-run
  optimizer state drawn from a seed, carried across with
  ``state_from_reference`` -- gives the reference's new positions at rtol
  1e-5.  The reference's step runs op by op (``jax.disable_jit()``): under
  ``jit`` XLA contracts multiply-adds into FMAs (jitted, its new positions
  are 2.4e-4 off the port's, relative).  It runs in a process of its own
  started with the module, while the other tests run.
* **A whole run** on the families of ``tests/test_search.py`` (the
  reference jitted, as its own tests run it) gives equal
  ``init_positions``, ``init_scores`` (integers equal, floats at rtol
  1e-5), ``init_objectives`` (rtol 1e-6), trajectory temperatures and
  ``counters["rescores"]`` / ``["replans"]``.  After the first steps the
  two trajectories part: where a vertex's gradient is near 0, a rounding
  difference flips its sign, and AdamW's first update is about ``lr *
  sign(g)``.  So the final layouts are held to a bound derived from the
  step size: with ``b1 = 0.9 <= 1 - sqrt(1 - b2)`` (``b2 = 0.95``), Adam's
  update ``|mhat| / (sqrt(vhat) + eps)`` is at most 1, so each run moves a
  coordinate by at most ``sum_k lr_k`` and the two final layouts differ
  by at most twice that.  Their exact objectives are not compared with
  each other (one run's is not a function of the other's layout); the
  port's final objectives must equal the reference engine's objectives
  of the port's final layouts (rtol 1e-6), and each run must improve.
* Twins of every other case of ``tests/test_search.py``:
  ``test_distributed_backend_matches_single_host_start`` runs the
  sharded step on a one-rank mesh and requires the single-host search's
  results from the same restarts (the 1, 2 and 4 rank cases are in
  ``tests/test_torch_distributed.py``);
  ``test_one_soft_trace_per_search`` keeps its ``replans`` and
  ``rescores`` assertions and drops ``soft_traces`` (eager PyTorch
  traces nothing).
* ``fruchterman_reingold`` against the reference at ``n_iter=3``, rtol
  1e-4: FR is chaotic, so over more iterations float32 rounding (the
  reference is jitted, with FMAs, and its scatter-add sums in its own
  order) grows past any fixed tolerance.
"""

import multiprocessing

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.api import EvalConfig as RefConfig
from repro.api import Evaluator as RefEvaluator
from repro.core import engine as ref_engine
from repro.graphs.layouts import fruchterman_reingold as ref_fr
from repro.search import GradientSearch as RefSearch
from repro.search import batch_objectives as ref_objectives
from repro_torch.api import (EvalConfig, Evaluator, InvalidInputError,
                             SearchResult)
from repro_torch.core import engine as t_engine
from repro_torch.graphs.datasets import random_edges
from repro_torch.graphs.layouts import fruchterman_reingold, random_layout
from repro_torch.optim import adamw
from repro_torch.search import GradientSearch, batch_objectives
from test_parity_matrix import N_STRIPS, RADIUS, make_family

RTOL = 1e-5
CFG = EvalConfig(radius=RADIUS, n_strips=N_STRIPS)
REF_CFG = RefConfig(radius=RADIUS, n_strips=N_STRIPS)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side runs on one intra-op thread here (restored
    afterwards): the suite's worker processes share the machine's cores,
    and many threads per worker on these small tensors only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
INT_FIELDS = ("node_occlusion", "edge_crossing", "crossing_count_for_angle",
              "overflow", "n_vertices", "n_edges")
FLOAT_FIELDS = ("minimum_angle", "edge_length_variation",
                "edge_crossing_angle")
SEARCH_FAMILIES = ("random", "cluster", "duplicate")


def _knobs(**kw):
    kw.setdefault("steps", 12)
    kw.setdefault("restarts", 2)
    kw.setdefault("rescore_every", 6)
    kw.setdefault("seed", 0)
    return kw


def _search(kind, **kw):
    pos, edges = make_family(kind)
    gs = GradientSearch(kw.pop("config", CFG), device="cpu", **_knobs(**kw))
    return gs.run(pos, edges), pos, edges


def same_scores(got, want, what):
    for f in INT_FIELDS:
        assert getattr(got, f) == getattr(want, f), (what, f)
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, err_msg=f"{what}/{f}")


@pytest.fixture(scope="module")
def runs():
    """Per family: the reference's and the port's search with
    ``tests/test_search.py``'s knobs, computed once."""
    cache = {}

    def get(kind):
        if kind not in cache:
            pos, edges = make_family(kind)
            ref = RefSearch(REF_CFG, **_knobs()).run(pos, edges)
            got = GradientSearch(CFG, device="cpu", **_knobs()).run(pos,
                                                                     edges)
            cache[kind] = (ref, got, pos, edges)
        return cache[kind]

    return get


def lr_sum(steps, extent):
    """``sum_k lr_k`` of the search's default schedule over ``steps``."""
    cfg = adamw.AdamWConfig(peak_lr=0.01 * extent,
                            warmup_steps=max(1, min(10, steps // 10)),
                            total_steps=steps, min_lr_frac=0.1,
                            weight_decay=0.0, clip_norm=1.0)
    lr = adamw.cosine_schedule(cfg)
    return sum(float(lr(torch.tensor(k, dtype=torch.int32)))
               for k in range(1, steps + 1))


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def one_step_case():
    """The one-step case: a batch of the random family and a jittered copy,
    mid-run moments drawn from a seed, step 4, temperature 0.03, the
    reference's flat-strip plan and its optimizer config."""
    pos, edges = make_family("random")
    rng = np.random.default_rng(21)
    batch = np.stack([pos, pos + rng.normal(0, 2.0, pos.shape)]
                     ).astype(np.float32)
    m = rng.normal(0, 1e-3, batch.shape).astype(np.float32)
    v = rng.uniform(1e-7, 1e-6, batch.shape).astype(np.float32)
    step, tau = 4, 0.03
    ref_gs = RefSearch(REF_CFG, steps=12)
    plan = ref_engine.plan_readability(
        batch, edges, **REF_CFG.plan_kwargs(tier_default=False))
    opt = ref_gs._resolve_opt(ref_gs._extent(batch))
    return ref_gs, plan, opt, batch, edges, m, v, step, tau


def reference_step():
    """The reference's search step on :func:`one_step_case`, op by op
    (``jax.disable_jit()``); ``(positions, m, v, step, losses)`` as
    numpy."""
    ref_gs, plan, opt, batch, edges, m, v, step, tau = one_step_case()
    with jax.disable_jit():
        fn = ref_gs._make_step(plan, opt, None, ())
        out = fn(jnp.asarray(batch), jnp.asarray(m), jnp.asarray(v),
                 jnp.asarray(step, jnp.int32), jnp.asarray(edges, jnp.int32),
                 jnp.asarray(tau, jnp.float32))
    r_pos, r_m, r_v, r_step, r_loss, _ = out
    return tuple(np.asarray(x) for x in (r_pos, r_m, r_v, r_step, r_loss))


@pytest.fixture(autouse=True, scope="module")
def reference_step_result(request):
    """:func:`reference_step`, started in a process of its own with the
    module when ``test_one_step_matches_reference`` is selected: op by
    op, its first call compiles every primitive shape of the soft loss's
    forward and backward (about a minute of one core), which then runs
    while this module's other tests do."""
    if not any(item.module is request.module
               and item.name == "test_one_step_matches_reference"
               for item in request.session.items):
        yield None
        return
    pool = multiprocessing.get_context("spawn").Pool(1)
    pending = pool.apply_async(reference_step)
    yield pending
    pool.terminate()
    pool.join()


@pytest.mark.parametrize("kind", SEARCH_FAMILIES)
def test_whole_run_matches_reference(runs, kind):
    ref, got, pos, edges = runs(kind)
    np.testing.assert_array_equal(got.init_positions, ref.init_positions)
    for i, (g, r) in enumerate(zip(got.init_scores, ref.init_scores)):
        same_scores(g, r, f"{kind} init {i}")
    np.testing.assert_allclose(got.init_objectives, ref.init_objectives,
                               rtol=1e-6)
    for key in ("rescores", "replans"):
        assert got.counters[key] == ref.counters[key], key
    assert [t["step"] for t in got.trajectory] == \
        [t["step"] for t in ref.trajectory]
    assert [t["temperature"] for t in got.trajectory] == \
        [t["temperature"] for t in ref.trajectory]
    # the bound on the final layouts, from the step size
    bound = 2.0 * lr_sum(got.steps, GradientSearch._extent(
        got.init_positions))
    assert np.abs(got.positions - ref.positions).max() <= bound
    # the port's reported objectives are the reference engine's
    ref_eval = RefEvaluator(REF_CFG).evaluate_batch(got.positions, edges)
    np.testing.assert_allclose(got.objectives, ref_objectives(ref_eval),
                               rtol=1e-6)
    assert got.improvement > 0 and ref.improvement > 0


def test_fruchterman_reingold_matches_reference():
    """Three FR iterations from a random start (n = 300, so the blocked
    repulsion pads 212 rows at ``block=128``): rtol 1e-4."""
    edges = random_edges(300, 600, seed=0)
    pos0 = random_layout(300, seed=1)
    want = np.asarray(ref_fr(jnp.asarray(pos0), jnp.asarray(edges),
                             n_iter=3, block=128))
    got = fruchterman_reingold(pos0, edges, n_iter=3, block=128,
                               device="cpu")
    assert got.device.type == "cpu" and got.shape == (300, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)


# ---------------------------------------------------------------------------
# twins of tests/test_search.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", SEARCH_FAMILIES)
def test_search_improves_objective(runs, kind):
    _, res, _, _ = runs(kind)
    assert res.improvement > 0, (kind, res.init_objectives, res.objectives)
    assert np.all(res.objectives >= res.init_objectives - 1e-12)


def test_best_objective_monotone_in_trajectory(runs):
    _, res, _, _ = runs("random")
    best = [t["best_objective"] for t in res.trajectory]
    assert all(a <= b + 1e-12 for a, b in zip(best, best[1:]))
    temps = [t["temperature"] for t in res.trajectory]
    assert all(a >= b for a, b in zip(temps, temps[1:]))


def test_result_contract():
    res, pos, edges = _search("random", restarts=3)
    V = pos.shape[0]
    assert isinstance(res, SearchResult)
    assert res.positions.shape == (3, V, 2)
    assert res.init_positions.shape == (3, V, 2)
    assert res.objectives.shape == (3,)
    assert len(res.scores) == 3 and len(res.init_scores) == 3
    assert res.best_positions.shape == (V, 2)
    assert res.best_objective == pytest.approx(
        float(res.objectives[res.best_index]))
    assert res.best_scores is res.scores[res.best_index]
    check = Evaluator(CFG, device="cpu").evaluate(res.best_positions, edges)
    assert int(check.edge_crossing) == int(res.best_scores.edge_crossing)
    assert int(check.node_occlusion) == int(res.best_scores.node_occlusion)
    np.testing.assert_array_equal(res.init_positions[0],
                                  np.asarray(pos, np.float32))


def test_one_rescore_cadence_per_search():
    """Twin of ``test_one_soft_trace_per_search``: no replan, and the
    re-scores are the initial one plus one per ``rescore_every`` steps
    (the last included).  Its ``soft_traces`` count has no counterpart:
    eager PyTorch traces nothing."""
    res, _, _ = _search("random", steps=9, rescore_every=3)
    assert res.counters["replans"] == 0
    assert res.counters["rescores"] >= 4
    assert "soft_traces" not in res.counters


def test_explicit_restart_batch():
    pos, edges = make_family("random")
    rng = np.random.default_rng(5)
    batch = np.stack([pos, pos + rng.normal(0, 2.0, pos.shape)
                      .astype(np.float32)])
    res = GradientSearch(CFG, steps=4, rescore_every=4,
                         device="cpu").run(batch, edges)
    assert res.restarts == 2
    np.testing.assert_array_equal(res.init_positions, batch)


def test_zero_edges_search_runs():
    rng = np.random.default_rng(2)
    base = rng.integers(0, 8, (12, 2)).astype(np.float32)
    pos = np.repeat(base, 2, axis=0)
    edges = np.zeros((0, 2), np.int32)
    gs = GradientSearch(EvalConfig(radius=RADIUS, n_strips=8), steps=10,
                        restarts=2, rescore_every=5, device="cpu")
    res = gs.run(pos, edges)
    assert np.all(np.isfinite(res.positions))
    assert (int(res.best_scores.node_occlusion)
            <= int(res.init_scores[0].node_occlusion))
    assert res.best_scores.n_edges == 0


def test_evaluator_search_routes():
    pos, edges = make_family("random")
    ev = Evaluator(CFG, device="cpu")
    res = ev.search(pos, edges, steps=4, restarts=2, rescore_every=4)
    assert isinstance(res, SearchResult)
    assert res.improvement >= 0


def test_search_defaults_to_cuda():
    """``GradientSearch`` and ``Evaluator.search`` run on CUDA unless the
    caller passes ``device="cpu"``, and raise without a CUDA device."""
    if torch.cuda.is_available():
        assert GradientSearch(CFG).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GradientSearch(CFG)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Evaluator(CFG).search(*make_family("random"), steps=1)
    assert GradientSearch(CFG, device="cpu").device == CPU


def test_strict_validation_rejects_nonfinite_seed():
    pos, edges = make_family("random")
    bad = pos.copy()
    bad[3, 1] = np.nan
    with pytest.raises(InvalidInputError):
        GradientSearch(CFG, steps=2, device="cpu").run(bad, edges)


def test_strict_validation_rejects_out_of_range_edges():
    pos, edges = make_family("random")
    bad = edges.copy()
    bad[0, 0] = pos.shape[0] + 7
    with pytest.raises(InvalidInputError):
        GradientSearch(CFG, steps=2, device="cpu").run(pos, bad)


def test_zero_vertices_rejected():
    with pytest.raises(InvalidInputError):
        GradientSearch(CFG, steps=2, device="cpu").run(
            np.zeros((0, 2), np.float32), np.zeros((0, 2), np.int32))


def test_bad_knobs_rejected():
    with pytest.raises(ValueError):
        GradientSearch(CFG, steps=0, device="cpu")
    with pytest.raises(ValueError):
        GradientSearch(CFG, restarts=0, device="cpu")
    with pytest.raises(ValueError):
        GradientSearch(CFG, temperature=-1.0, device="cpu")


def test_distributed_backend_matches_single_host_start():
    """``backend="distributed"`` shards the step over the batch axis (here
    a one-rank mesh brought up by the serving policy); from the same
    restarts it takes the single-host search's steps and exact scores."""
    pos, edges = make_family("random")
    cfg = EvalConfig(radius=RADIUS, n_strips=N_STRIPS,
                     backend="distributed")
    gs = GradientSearch(cfg, steps=4, restarts=2, rescore_every=4, seed=3,
                        device="cpu")
    res = gs.run(pos, edges)
    assert gs.mesh is not None and gs.mesh.size == 1
    assert np.all(np.isfinite(res.positions))
    assert res.restarts >= 2
    assert res.improvement >= 0
    single = GradientSearch(CFG, steps=4, restarts=2, rescore_every=4,
                            seed=3, device="cpu").run(pos, edges)
    np.testing.assert_array_equal(res.positions, single.positions)
    for got, want in zip(res.scores, single.scores):
        same_scores(got, want, "distributed")


def test_objective_matches_normalized_mean():
    pos, edges = make_family("random")
    batch = np.stack([pos, pos * 0.5])
    scores = Evaluator(CFG, device="cpu").evaluate_batch(batch, edges)
    obj = batch_objectives(scores)
    norm = scores.normalized()
    want = np.mean([np.asarray(norm.node_occlusion, np.float64),
                    np.asarray(norm.minimum_angle, np.float64),
                    np.asarray(norm.edge_length_variation, np.float64),
                    np.asarray(norm.edge_crossing, np.float64),
                    np.asarray(norm.edge_crossing_angle, np.float64)],
                   axis=0)
    np.testing.assert_allclose(obj, want, rtol=1e-12)


def test_one_step_matches_reference(reference_step_result):
    """One search step (soft loss forward and backward, AdamW update) from
    the same positions, mid-run state, temperature and plan: new
    positions at rtol 1e-5, the per-restart losses at rtol 1e-5, the
    moments at rtol 1e-5 (atol at 1e-6 of their scale: the clip factor's
    norm is summed in another order, see ``tests/test_torch_adamw.py``).
    The plan has flat strips (one slab per orientation): op by op, each
    new primitive shape compiles, and three tiers per orientation would
    double the reference's time for no other gain.  The reference's step
    runs in a process of its own, started with the module
    (:func:`reference_step_result`), so this test comes last."""
    _, plan, opt, batch, edges, m, v, step, tau = one_step_case()
    r_pos, r_m, r_v, r_step, r_loss = reference_step_result.get(timeout=900)
    gs = GradientSearch(CFG, steps=12, device="cpu")
    state = adamw.state_from_reference({"pos": m}, {"pos": v}, step,
                                       device="cpu")
    new, state, losses, _ = gs.step(
        t_engine.plan_from_reference(plan),
        adamw.AdamWConfig(**vars(opt)), torch.from_numpy(batch), state,
        torch.from_numpy(edges), torch.tensor(tau))
    np.testing.assert_allclose(new.numpy(), np.asarray(r_pos), rtol=RTOL)
    np.testing.assert_allclose(losses.numpy(), np.asarray(r_loss),
                               rtol=RTOL)
    for got, want in ((state["m"]["pos"], r_m), (state["v"]["pos"], r_v)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   atol=1e-6 * np.abs(want).max())
    assert int(state["step"]) == int(r_step) == step + 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_search_on_card(cuda):
    """One search on CUDA (its re-scores launch the strip-reversal
    kernel): every reported score equals the port's own
    ``evaluate_batch`` of the returned layouts on the card (integers
    equal, floats at rtol 1e-5), positions are finite and no restart
    ends below its start.  The backward's gathers add with atomics on
    the card, so the trajectory is not compared with the CPU's."""
    from repro_torch.kernels.strip_reversal import strip_reversal_rows
    pos, edges = make_family("cluster")
    before = strip_reversal_rows.LAUNCHES
    res = GradientSearch(CFG, **_knobs()).run(pos, edges)
    assert strip_reversal_rows.LAUNCHES > before
    assert np.isfinite(res.positions).all()
    assert np.all(res.objectives >= res.init_objectives)
    ev = Evaluator(CFG)
    for label, batch, scores in (("final", res.positions, res.scores),
                                 ("init", res.init_positions,
                                  res.init_scores)):
        check = ev.evaluate_batch(batch, edges).unbatch()
        for i, (g, w) in enumerate(zip(scores, check)):
            same_scores(g, w, f"{label} {i}")


@pytest.mark.gpu
def test_fruchterman_reingold_on_card(cuda):
    """FR on CUDA against the CPU route at ``n_iter=3``, rtol 1e-4 (its
    attraction adds with atomics there)."""
    edges = random_edges(300, 600, seed=0)
    pos0 = random_layout(300, seed=1)
    got = fruchterman_reingold(pos0, edges, n_iter=3, block=128)
    assert got.is_cuda
    want = fruchterman_reingold(pos0, edges, n_iter=3, block=128,
                                device="cpu")
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4)
