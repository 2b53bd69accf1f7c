"""The serving front in the port, twinned with the reference: the
session's plan cache and coalescing (``tests/test_session.py``),
``ReadabilityServer`` on every ``method=`` of its deprecated mirror, the
deprecated ``evaluate_layout`` / ``EvalSession(**kwargs)`` shims with
their one-time warnings, ``evaluator_for``, the api surface and
``python -m repro_torch.launch.serve``.  Integers equal, floats at rtol
1e-5, counters equal; the port runs on the CPU.

Like ``tests/test_api.py`` this module escalates ``DeprecationWarning``
to an error: a shim that warns twice, or a modern call that warns at
all, fails here.
"""

import numpy as np
import pytest
import torch

import repro.core.keys as ref_keys
import repro_torch
from _serving_twins import (PORT, REF, assert_same_outcomes,
                            assert_same_scores, assert_same_stats,
                            make_session, twin)
from repro.core.metrics import evaluate_layout as ref_evaluate_layout
from repro_torch import api as t_api
from repro_torch.core import engine
from repro_torch.core import metrics as t_metrics
from repro_torch.core.keys import (EvalConfig, pow2_bucket,
                                   reset_deprecation_warnings)
from repro_torch.launch.serve import DEFAULT_N_STRIPS, ReadabilityServer, main
from repro_torch.launch.session import EvalSession, PlanCache
from test_session import lattice_graph, random_graph

pytestmark = pytest.mark.filterwarnings("error::DeprecationWarning")

RADIUS = 2.0
N_STRIPS = 64
CFG = dict(radius=RADIUS, n_strips=N_STRIPS)


def reset_warnings():
    """Both packages' one-time warning registries."""
    reset_deprecation_warnings()
    ref_keys.reset_deprecation_warnings()


@pytest.fixture(scope="module")
def graph():
    return random_graph(220, 440, seed=11)


# ---------------------------------------------------------------------------
# the session (twins of tests/test_session.py)
# ---------------------------------------------------------------------------

def test_pow2_bucket_and_plan_cache_lru():
    assert [pow2_bucket(n) for n in (1, 128, 129, 5000)] == \
        [128, 128, 256, 8192]
    assert pow2_bucket(50, floor=64) == 64
    cache = PlanCache(capacity=2)
    cache.put("a", 1)
    cache.put("b", 2)
    assert cache.get("a") == 1
    cache.put("c", 3)
    assert cache.get("b") is None
    assert (cache.get("a"), cache.get("c")) == (1, 3)
    assert (cache.evictions, cache.hits, cache.misses) == (1, 3, 1)


def test_session_matches_engine_and_caches_plans():
    pos, edges = random_graph(250, 500, seed=1)
    rng = np.random.default_rng(2)
    reqs = [(pos + rng.normal(0, 1.0, pos.shape).astype(np.float32), edges)
            for _ in range(4)]

    def run(pkg):
        sess = make_session(pkg, CFG)
        first = sess.evaluate_batch(reqs)
        stats = sess.stats
        again = sess.evaluate_batch(reqs)
        return first, stats, again, sess.stats

    (got, stats, again, stats2), (ref, ref_stats, _, ref_stats2) = twin(run)
    assert_same_outcomes(got, ref)
    assert_same_stats(stats, ref_stats)
    assert_same_stats(stats2, ref_stats2)
    assert (stats["plan_misses"], stats["plan_hits"], stats["coalesced"],
            stats["dispatches"], stats["replans"]) == (1, 0, 4, 1, 0)
    assert (stats2["plan_hits"], stats2["replans"]) == (1, 0)
    assert again == got
    # padded + coalesced equals the engine on the natural arrays
    plan = engine.plan_readability(pos, edges, radius=RADIUS,
                                   n_strips=N_STRIPS)
    for (p, e), rep in zip(reqs, got):
        want = engine.evaluate_planned(plan, p, e, device="cpu")
        for f in ("node_occlusion", "edge_crossing", "overflow"):
            assert getattr(rep, f) == int(getattr(want, f)), f
        np.testing.assert_allclose(rep.edge_crossing_angle,
                                   float(want.edge_crossing_angle),
                                   rtol=1e-5)


def test_session_mixed_sizes_keep_separate_plans():
    a = random_graph(150, 300, seed=3)
    b = random_graph(300, 600, seed=4)

    def run(pkg):
        sess = make_session(pkg, CFG)
        return sess.evaluate_batch([a, b, a, b]), sess.stats, len(sess.plans)

    (got, stats, n_plans), (ref, ref_stats, ref_n) = twin(run)
    assert_same_outcomes(got, ref)
    assert_same_stats(stats, ref_stats)
    assert n_plans == ref_n == 2
    assert (stats["plan_misses"], stats["dispatches"], stats["coalesced"]) \
        == (2, 2, 4)
    assert got[0] == got[2] and got[1] == got[3]


def test_overflow_auto_replan_retry():
    pos_a, edges = lattice_graph()
    pos_b = np.random.default_rng(5).uniform(
        0, 100, pos_a.shape).astype(np.float32)

    def run(pkg):
        sess = make_session(pkg, CFG)
        out = [sess.evaluate(pos_a, edges), sess.evaluate(pos_b, edges)]
        replans = sess.stats["replans"]
        out.append(sess.evaluate(pos_b, edges))
        return out, replans, sess.stats

    (got, replans, stats), (ref, ref_replans, ref_stats) = twin(run)
    assert_same_outcomes(got, ref)
    assert_same_stats(stats, ref_stats)
    assert replans == ref_replans == 1 == stats["replans"]
    assert got[1].overflow == 0 and got[2] == got[1]


def test_server_smoke_mixed_size_stream():
    small = random_graph(100, 200, seed=6)
    reqs = [small, random_graph(200, 400, seed=7),
            (small[0] + 1.0, small[1]), random_graph(300, 600, seed=8)]

    def run(pkg):
        server = pkg.serve.ReadabilityServer(
            pkg.keys.EvalConfig(**CFG), **pkg.device)
        return server.evaluate_batch(reqs), server.stats

    (got, stats), (ref, ref_stats) = twin(run)
    assert_same_stats(stats, ref_stats)
    assert_same_outcomes([got[1], got[3]], [ref[1], ref[3]])
    # requests 0 and 2 against the reference run without jit: on them
    # XLA's jit contracts a strip ordinate into an FMA and flips one exact
    # tie (E_c 3808 where the reference's eager route and the port count
    # 3807; ROADMAP queue 3)
    ref_eager = REF.api.Evaluator(REF.keys.EvalConfig(backend="eager",
                                                      **CFG))
    assert_same_outcomes([got[0], got[2]],
                         [ref_eager.evaluate(*reqs[i]) for i in (0, 2)])
    assert (stats["requests"], stats["plan_misses"], stats["coalesced"],
            stats["dispatches"]) == (4, 3, 2, 3)
    assert all(r.overflow == 0 for r in got)
    assert got[0].edge_crossing == got[2].edge_crossing


# ---------------------------------------------------------------------------
# ReadabilityServer: every method= of the deprecated mirror
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,use_kernels", [
    ("session", False), ("session", True), ("enhanced", False),
    ("enhanced", True), ("exact", False), ("exact", True)])
def test_server_method_shim_matches_reference(graph, method, use_kernels):
    pos, edges = graph
    reset_warnings()
    legacy = dict(method=method, radius=RADIUS, n_strips=N_STRIPS,
                  use_kernels=use_kernels)

    def run(pkg):
        with pytest.warns(DeprecationWarning, match="ReadabilityServer"):
            server = pkg.serve.ReadabilityServer(**legacy, **pkg.device)
        # a second legacy server must not warn again (errors here)
        pkg.serve.ReadabilityServer(**legacy, **pkg.device)
        return server, server.evaluate(pos, edges), server.stats

    (server, got, stats), (ref_server, ref, ref_stats) = twin(run)
    assert_same_scores(got, ref, method)
    assert server.method == ref_server.method
    assert repr(server.config) == repr(ref_server.config)
    assert server.config.digest() == ref_server.config.digest()
    assert set(stats) == set(ref_stats)
    if method == "session":
        assert server.config.backend == ("kernels" if use_kernels
                                         else "fused")
        assert_same_stats({k: v for k, v in stats.items()
                           if k not in ("requests", "evals")},
                          {k: v for k, v in ref_stats.items()
                           if k not in ("requests", "evals")})
    else:
        assert server.config.backend == "eager"
        assert "plan_hits" not in stats
        assert stats == ref_stats
    reset_warnings()


def test_server_methods_agree_with_the_modern_routes(graph):
    """session == enhanced on every metric (same flat plan); the exact
    route equals ``evaluate_exact``; the enhanced+use_kernels route sweeps
    flat buckets and counts N_c exactly, so its integers equal the fused
    path's."""
    pos, edges = graph
    reset_warnings()
    cfg = EvalConfig(radius=RADIUS, n_strips=N_STRIPS)
    modern = ReadabilityServer(cfg, device="cpu").evaluate(pos, edges)
    with pytest.warns(DeprecationWarning):
        servers = {(m, k): ReadabilityServer(method=m, radius=RADIUS,
                                             n_strips=N_STRIPS,
                                             use_kernels=k, device="cpu")
                   for m in ("session", "enhanced", "exact")
                   for k in (False, True)}
    out = {key: s.evaluate(pos, edges) for key, s in servers.items()}
    for key in (("session", False), ("session", True), ("enhanced", False),
                ("enhanced", True)):
        assert_same_scores(out[key], modern, str(key))
    for k in (False, True):
        assert out[("exact", k)] == t_api.evaluate_exact(
            pos, edges, config=servers[("exact", k)].config, use_kernels=k,
            device="cpu")
    reset_warnings()


def test_server_defaults_and_knobs():
    server = ReadabilityServer(device="cpu")
    assert server.config == EvalConfig(n_strips=DEFAULT_N_STRIPS)
    assert server.method == "session"
    assert ReadabilityServer(EvalConfig(backend="eager"),
                             device="cpu").method == "enhanced"
    with pytest.raises(TypeError):
        ReadabilityServer(EvalConfig(), method="session", device="cpu")
    with pytest.raises(TypeError, match="unknown"):
        ReadabilityServer(method="session", bogus=1, device="cpu")
    pos, edges = random_graph(100, 200, seed=6)
    eager = ReadabilityServer(EvalConfig(backend="eager"), device="cpu")
    with pytest.raises(ValueError, match="deadline/cancel"):
        eager.evaluate_batch([(pos, edges)], deadline=1.0)
    # the overload knobs reach the session
    bounded = ReadabilityServer(EvalConfig(**CFG), device="cpu",
                                max_queue=1, dispatch_timeout=30.0)
    out = bounded.evaluate_batch([(pos, edges), (pos + 1.0, edges)])
    assert [r.shed for r in out] == [False, True]
    assert bounded.session.dispatch_timeout == 30.0
    assert bounded.stats["shed"] == 1


def test_server_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReadabilityServer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReadabilityServer(EvalConfig(backend="eager"))


# ---------------------------------------------------------------------------
# the deprecated shims and evaluator_for
# ---------------------------------------------------------------------------

def test_evaluate_layout_shim_warns_once_and_matches(graph):
    pos, edges = graph
    cfg = EvalConfig(**CFG)
    want = t_api.evaluator_for(cfg, device="cpu").evaluate(pos, edges)
    reset_warnings()
    with pytest.warns(DeprecationWarning, match="evaluate_layout"):
        got = t_metrics.evaluate_layout(pos, edges, device="cpu", **CFG)
    assert got == want
    assert t_metrics.evaluate_layout(pos, edges, device="cpu", **CFG) == want
    with pytest.warns(DeprecationWarning, match="evaluate_layout"):
        ref = ref_evaluate_layout(pos, edges, **CFG)
    assert_same_scores(got, ref)
    reset_warnings()


@pytest.mark.parametrize("use_kernels", [False, True])
def test_evaluate_layout_exact_shim(graph, use_kernels):
    pos, edges = graph
    reset_warnings()
    with pytest.warns(DeprecationWarning):
        got = t_metrics.evaluate_layout(pos, edges, radius=RADIUS,
                                        method="exact",
                                        use_kernels=use_kernels,
                                        device="cpu")
    want = t_api.evaluate_exact(pos, edges,
                                config=EvalConfig(radius=RADIUS),
                                use_kernels=use_kernels, device="cpu")
    assert got == want
    with pytest.warns(DeprecationWarning):
        ref = ref_evaluate_layout(pos, edges, radius=RADIUS,
                                  method="exact")
    assert_same_scores(got, ref)
    # the enhanced estimate never counts more crossings than exist
    fused = t_metrics.evaluate_layout(pos, edges, radius=RADIUS,
                                      device="cpu")
    assert fused.edge_crossing <= got.edge_crossing
    assert fused.node_occlusion == got.node_occlusion
    reset_warnings()


def test_session_kwarg_shim(graph):
    pos, edges = graph
    reset_warnings()
    with pytest.warns(DeprecationWarning, match="EvalSession"):
        legacy = EvalSession(device="cpu", **CFG)
    EvalSession(device="cpu", **CFG)             # warns once only
    modern = EvalSession(EvalConfig(**CFG), device="cpu")
    assert legacy.config == modern.config
    assert legacy.evaluate(pos, edges) == modern.evaluate(pos, edges)
    (key,) = legacy.plans._entries.keys()
    assert key[-1] == legacy.config
    with pytest.raises(TypeError):
        EvalSession(EvalConfig(), device="cpu", radius=1.0)
    with pytest.warns(DeprecationWarning, match="EvalSession"):
        ref = REF.session.EvalSession(**CFG)
    assert ref.config.digest() == legacy.config.digest()
    reset_warnings()


def test_evaluator_for_reuses_evaluator_and_plans(graph):
    pos, edges = graph
    cfg = EvalConfig(**CFG)
    ev = t_api.evaluator_for(cfg, device="cpu")
    assert t_api.evaluator_for(EvalConfig(radius=2.0, n_strips=64),
                               device="cpu") is ev
    ev.evaluate(pos, edges)
    s0 = ev._bound_session().stats
    ev.evaluate(pos + 1.0, edges)
    s1 = ev._bound_session().stats
    assert s1["plan_hits"] == s0["plan_hits"] + 1
    assert s1["plan_misses"] == s0["plan_misses"]
    # knobs reach the evaluator's sessions, overload knobs included
    sess = ev.session(max_queue=3, default_deadline=5.0)
    assert (sess.max_queue, sess.default_deadline) == (3, 5.0)


def test_api_surface_is_warning_free_and_matches_reference(graph):
    pos, edges = graph
    cfg = EvalConfig(**CFG)
    ev = t_api.Evaluator(cfg, device="cpu")
    ev.evaluate(pos, edges)
    ev.session().evaluate(pos, edges)
    t_api.evaluate_exact(pos, edges, config=cfg, device="cpu")
    ReadabilityServer(cfg, device="cpu").evaluate_batch([(pos, edges)])
    # the reference's front door, search included
    assert set(t_api.__all__) == set(REF.api.__all__)
    for name in t_api.__all__:
        assert getattr(t_api, name) is not None


def test_legacy_names_and_core_exports():
    import repro.core as ref_core
    import repro_torch.core as t_core
    assert t_metrics.ReadabilityReport is t_api.ReadabilityScores
    assert t_metrics.report_from_result is t_api.scores_from_result
    assert t_metrics.reports_from_batch is t_api.scores_from_batch
    assert t_metrics.EngineResult is engine.EngineResult
    ref_names = {n for n in dir(ref_core) if not n.startswith("_")
                 and not hasattr(getattr(ref_core, n), "__path__")
                 and getattr(getattr(ref_core, n), "__module__", "")
                 .startswith("repro.core")}
    assert ref_names <= set(t_core.__all__)
    for name in t_core.__all__:
        assert getattr(t_core, name) is not None


def test_serve_main_runs(capsys):
    main(["--requests", "3", "--rounds", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert sum(line.startswith("req ") for line in out.splitlines()) == 3
    assert "replans=0" in out and "device=cpu" in out
    assert repro_torch.launch.serve.main is main
