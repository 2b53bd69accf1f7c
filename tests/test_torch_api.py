"""The port's front door against the reference's: ``Evaluator(cfg,
device="cpu").evaluate`` / ``.evaluate_batch`` on the fused, eager and
kernels backends equal to ``repro.api.Evaluator``'s (integers equal,
floats at rtol 1e-5); the session's plan cache, pow2 coalescing and
bounded replan with their counters; validation and degenerate requests;
the device rule; and that importing the port loads neither ``jax`` nor
``repro``.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro_torch
import repro_torch.api as t_api
from repro_torch.core.validate import CapacityError, InvalidInputError
from test_parity_matrix import RADIUS, N_STRIPS, make_family

RTOL = 1e-5
INT_FIELDS = ("node_occlusion", "edge_crossing", "crossing_count_for_angle",
              "overflow", "n_vertices", "n_edges")
FLOAT_FIELDS = ("minimum_angle", "edge_length_variation",
                "edge_crossing_angle")


def assert_scores(got, ref, what=""):
    for f in INT_FIELDS + FLOAT_FIELDS:
        g, r = getattr(got, f), getattr(ref, f)
        assert (g is None) == (r is None), (what, f)
        if g is None:
            continue
        if f in INT_FIELDS:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(r),
                                          err_msg=f"{what}/{f}")
        else:
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(r, np.float64), rtol=RTOL,
                                       err_msg=f"{what}/{f}")
    assert got.flags == ref.flags, what


def cfgs(**kw):
    kw.setdefault("radius", RADIUS)
    kw.setdefault("n_strips", N_STRIPS)
    return t_api.EvalConfig(**kw), ref_api.EvalConfig(**kw)


@pytest.fixture(scope="module")
def graph():
    return make_family("random")


@pytest.mark.parametrize("backend", ["fused", "eager", "kernels"])
def test_evaluate_matches_reference(graph, backend):
    pos, edges = graph
    tc, rc = cfgs(backend=backend)
    got = t_api.Evaluator(tc, device="cpu").evaluate(pos, edges)
    ref = ref_api.Evaluator(rc).evaluate(pos, edges)
    assert_scores(got, ref, backend)
    assert_scores(got.normalized(), ref.normalized(), backend + " norm")


@pytest.mark.parametrize("backend", ["fused", "kernels"])
def test_evaluate_batch_matches_reference(graph, backend):
    pos, edges = graph
    # the layout and its x/y swap: exact under the reference's jit
    batch = np.stack([pos, pos[:, ::-1], pos + 0.5]).astype(np.float32)
    tc, rc = cfgs(backend=backend)
    got = t_api.Evaluator(tc, device="cpu").evaluate_batch(batch, edges)
    ref = ref_api.Evaluator(rc).evaluate_batch(batch, edges)
    assert got.batch_size == 3
    assert_scores(got, ref, backend)
    for g, r in zip(got.unbatch(), ref.unbatch()):
        assert_scores(g, r, backend + " unbatched")
    # eager serves batches with the same batched program as fused
    eager = t_api.Evaluator(cfgs(backend="eager")[0],
                            device="cpu").evaluate_batch(batch, edges)
    if backend == "fused":
        assert_scores(eager, got, "eager batch")


def test_subset_and_horizontal_config_matches_reference():
    pos, edges = make_family("grid")
    tc, rc = cfgs(metrics=("edge_crossing", "minimum_angle"),
                  orientation="horizontal", n_strips=56)
    got = t_api.Evaluator(tc, device="cpu").evaluate(pos, edges)
    ref = ref_api.Evaluator(rc).evaluate(pos, edges)
    assert_scores(got, ref, "subset")
    assert got.node_occlusion is None and got.edge_crossing_angle is None


def test_degenerate_requests_match_reference():
    pos, edges = make_family("cluster")
    for backend in ("fused", "eager"):
        tc, rc = cfgs(backend=backend)
        for p, e in ((pos, edges[:0]), (pos[:1], np.zeros((0, 2), int))):
            got = t_api.Evaluator(tc, device="cpu").evaluate(p, e)
            ref = ref_api.Evaluator(rc).evaluate(p, e)
            assert_scores(got, ref, f"{backend} V={len(p)} E={len(e)}")


def test_validation_matches_reference(graph):
    pos, edges = graph
    bad = pos.copy()
    bad[3] = np.nan
    loops = np.concatenate([edges, [[5, 5], [0, 999]]])
    for mode in ("strict", "sanitize"):
        tc, rc = cfgs(validation=mode)
        ev = t_api.Evaluator(tc, device="cpu")
        out = ev.session().evaluate_batch([(bad, edges), (pos, loops),
                                           (pos, edges)])
        ref = ref_api.Evaluator(rc).session().evaluate_batch(
            [(bad, edges), (pos, loops), (pos, edges)])
        for k, (g, r) in enumerate(zip(out, ref)):
            assert g.ok == r.ok, (mode, k)
            if g.ok:
                assert_scores(g, r, f"{mode}[{k}]")
            else:
                assert type(g.error).__name__ == type(r.error).__name__
                assert str(g.error) == str(r.error)
        if mode == "strict":
            with pytest.raises(InvalidInputError):
                ev.evaluate(bad, edges)


def test_session_plan_hits_and_pow2_coalescing(graph):
    pos, edges = graph
    rng = np.random.default_rng(2)
    layouts = [pos + rng.normal(0, 0.3, pos.shape).astype(np.float32)
               for _ in range(5)]
    sess = t_api.Evaluator(cfgs()[0], device="cpu").session(max_coalesce=4)
    out = sess.evaluate_batch([(p, edges) for p in layouts])
    s = sess.stats
    # one topology/bucket key: one plan; 5 requests -> chunks of 4 + 1
    assert (s["plan_misses"], s["plan_hits"]) == (1, 0)
    assert (s["dispatches"], s["coalesced"], s["requests"]) == (2, 4, 5)
    assert s["replans"] == 0
    again = sess.evaluate_batch([(p, edges) for p in layouts[:2]])
    s = sess.stats
    assert (s["plan_misses"], s["plan_hits"]) == (1, 1)
    assert (s["dispatches"], s["coalesced"]) == (3, 6)
    for a, b in zip(again, out[:2]):
        assert_scores(a, b, "repeat")
    # coalesced results equal single-request evaluation
    single = t_api.Evaluator(cfgs()[0], device="cpu")
    for p, r in zip(layouts, out):
        assert_scores(single.evaluate(p, edges), r, "coalesced vs single")


def lattice_graph(side=12, seed=0):
    rng = np.random.default_rng(seed)
    n = side * side
    xs, ys = np.meshgrid(np.arange(side), np.arange(side))
    pos = np.stack([xs.ravel(), ys.ravel()], axis=1).astype(np.float32)
    pos = pos * (100.0 / side) + rng.normal(0, 0.5, (n, 2)).astype(np.float32)
    right = np.stack([np.arange(n), np.arange(n) + 1], axis=1)
    right = right[(right[:, 1] % side) != 0]
    down = np.stack([np.arange(n), np.arange(n) + side], axis=1)
    down = down[down[:, 1] < n]
    return pos, np.concatenate([right, down]).astype(np.int32)


def test_session_replans_once_on_overflow():
    """A tight lattice plan, then a collapsed layout of the same graph
    that outgrows it: one replan, no overflow, equal to a fresh plan."""
    pos, edges = lattice_graph()
    crowded = (pos * 0.05 + 40.0).astype(np.float32)
    tc = cfgs(n_strips=64)[0]
    sess = t_api.EvalSession(tc, device="cpu")
    first = sess.evaluate(pos, edges)
    assert first.overflow == 0 and sess.stats["replans"] == 0
    got = sess.evaluate(crowded, edges)
    s = sess.stats
    assert s["replans"] == 1 and s["saturated"] == 0
    assert got.overflow == 0
    fresh = t_api.EvalSession(tc, device="cpu").evaluate(crowded, edges)
    for f in ("node_occlusion", "edge_crossing", "crossing_count_for_angle"):
        assert getattr(got, f) == getattr(fresh, f), f
    # the replanned plan stays cached: no further replans
    sess.evaluate(crowded, edges)
    assert sess.stats["replans"] == 1
    # with no retries left a strict session surfaces CapacityError
    tight = t_api.EvalSession(tc, device="cpu", max_replan_retries=0)
    tight.evaluate(pos, edges)
    with pytest.raises(CapacityError):
        tight.evaluate(crowded, edges)


def test_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_api.Evaluator(t_api.EvalConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_api.EvalSession(t_api.EvalConfig())
    ev = t_api.Evaluator(t_api.EvalConfig(), device="cpu")
    assert ev.device.type == "cpu"
    assert repr(ev).startswith("Evaluator(EvalConfig(")


def test_distributed_backend_matches_fused(graph):
    """Twin of ``tests/test_api.py``'s: the distributed front door (here on
    a one-rank mesh: exact row-sharded N_c, strip-sharded E_c / E_ca)
    against the reference's fused scores; the graph-sharded backend and
    the distributed batch too."""
    pos, edges = graph
    fused = ref_api.Evaluator(ref_api.EvalConfig(
        radius=RADIUS, n_strips=N_STRIPS)).evaluate(pos, edges)
    for backend in ("distributed", "graph_sharded"):
        tc, _ = cfgs(backend=backend)
        ev = t_api.Evaluator(tc, device="cpu")
        dist = ev.evaluate(pos, edges)
        assert dist.node_occlusion == fused.node_occlusion, backend
        assert dist.edge_crossing == fused.edge_crossing, backend
        np.testing.assert_allclose(dist.edge_crossing_angle,
                                   fused.edge_crossing_angle, rtol=1e-5)
        np.testing.assert_allclose(dist.minimum_angle, fused.minimum_angle,
                                   rtol=1e-5)
        batch = ev.evaluate_batch(np.stack([pos, pos]), edges).unbatch()
        assert [b.edge_crossing for b in batch] == [fused.edge_crossing] * 2
    # distributed dynamic layouts: host-tracked, each update a full
    # re-evaluation equal to a fresh evaluate of the moved layout
    ev = t_api.Evaluator(cfgs(backend="distributed")[0], device="cpu")
    ev.register_layout("a", pos, edges)
    moved = pos.copy()
    moved[3] += np.float32(0.5)
    got = ev.update("a", [3], moved[3:4])
    assert got == ev.evaluate(moved, edges)


def test_import_loads_neither_jax_nor_reference():
    pkg = Path(repro_torch.__file__).parent
    mods = sorted(".".join(("repro_torch",) + f.relative_to(pkg).with_suffix(
        "").parts).removesuffix(".__init__") for f in pkg.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    src = str(pkg.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": src, "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 16
