"""The port's graph-axis sharded engine (``backend="graph_sharded"``,
:mod:`repro_torch.distributed.graph_sharded`) against the reference's
single-device results; twin of ``tests/test_graph_sharded.py``.

ONE layout spatially partitioned over 1, 2 and 4 gloo ranks on the CPU
(``tests/_torch_dist.py``, each rank count spawned once for the module)
must give

* integer metrics equal to the reference's single-host fused engine under
  the same flat plan (and to the port's own), floats at rtol 1e-5;
* results that do not depend on the rank count;
* exactly one halo exchange per evaluation, zero (and no cell build) for
  a strip-only metric subset;
* each occluded pair of a column straddling every shard boundary counted
  once;
* a working replan-on-overflow loop, and the session's graph-sharded rung.

It also holds every parity family (``tests/test_parity_matrix.py``) to the
reference at every rank count, and the near-parallel layouts through
their integers and deviation sum (ROADMAP queue 3: E_ca cancels there).
In process, on a one-rank mesh: the typed errors of the dispatch paths,
the session's degradation to fused, and the rejected shapes.
"""

import numpy as np
import pytest

import repro.api as ref_api
from repro.core import engine as ref_engine
import _torch_dist as dist_
from repro_torch.api import EvalConfig, Evaluator
from repro_torch.core import engine
from repro_torch.core.validate import BackendUnavailableError
from repro_torch.distributed import graph_sharded as gs
from repro_torch.distributed.compat import Mesh, make_mesh
from repro_torch.kernels.fixtures import parity_family
from test_torch_kernels import NEAR_PARALLEL_REFERENCE, check_near_parallel

RTOL = 1e-5
WORLDS = (1, 2, 4)
INT_KEYS = ("node_occlusion", "edge_crossing", "crossing_count_for_angle",
            "overflow")
FLOAT_KEYS = ("edge_crossing_angle", "minimum_angle",
              "edge_length_variation")


def assert_scores(got, want, what):
    for k in INT_KEYS:
        if k in want:
            assert got[k] == want[k], (what, k, got[k], want[k])
    for k in FLOAT_KEYS:
        if k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                       err_msg=f"{what}/{k}")


def reference(plan_kw, pos, edges):
    """The reference's single-host fused engine under its flat plan."""
    plan = ref_engine.plan_readability(pos, edges, tier_strips=False,
                                       **plan_kw)
    res = ref_engine.evaluate_planned(plan, pos, edges)
    return {k: np.asarray(getattr(res, k)).item()
            for k in INT_KEYS + FLOAT_KEYS}


@pytest.fixture(scope="module")
def started():
    """The rank processes, started before the reference results are made
    so that both run at once."""
    return dist_.start_worlds(WORLDS, "graph_sharded")


@pytest.fixture(scope="module")
def runs(started, ref):
    return dist_.finish_worlds(started)


@pytest.fixture(scope="module")
def ref(started):
    pos, edges = dist_.graph_sharded_graph()
    out = {"natural": reference(dict(radius=2.0, n_strips=48), pos, edges)}
    for kind in dist_.FAMILIES:
        out[kind] = reference(dict(radius=dist_.RADIUS,
                                   n_strips=dist_.N_STRIPS),
                              *parity_family(kind))
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_graph_sharded_matches_reference(runs, ref, world):
    """Natural and padded evaluation equal the reference's single-host
    fused engine (and the port's own) under the same flat plan."""
    out = runs[world]
    for path in ("natural", "padded", "single_host"):
        assert_scores(out[path], ref["natural"], f"{world}/{path}")
    for k in INT_KEYS:
        assert out["padded"][k] == out["natural"][k]


@pytest.mark.parametrize("world", WORLDS)
def test_halo_budget(runs, world):
    """ONE halo exchange per evaluation; none, and no cell build, for the
    strip-only subset, whose E_c equals the full evaluation's."""
    out = runs[world]
    assert out["halo_exchanges"] == 1
    assert out["crossing_only_halo"] == 0
    assert out["crossing_only_cells"] == 0
    assert out["crossing_only"]["edge_crossing"] == \
        out["natural"]["edge_crossing"]


@pytest.mark.parametrize("world", WORLDS)
def test_straddling_column_counted_once(runs, world):
    assert runs[world]["boundary_occlusion"] == 63


@pytest.mark.parametrize("world", WORLDS)
def test_replan_under_sharding(runs, world):
    """A starved plan overflows under sharding, the grown plan converges
    to the healthy counts."""
    out = runs[world]
    assert out["starved_overflow"] > 0
    assert out["replan"]["overflow"] == 0
    for k in ("node_occlusion", "edge_crossing"):
        assert out["replan"][k] == out["natural"][k]


@pytest.mark.parametrize("world", WORLDS)
def test_session_serves_graph_sharded(runs, world):
    out = runs[world]
    assert out["session_dispatches"] > 0
    assert out["session_mode"] == "graph_sharded"
    for k in ("node_occlusion", "edge_crossing", "overflow"):
        assert out["session"][k] == out["natural"][k]


@pytest.mark.parametrize("world", (2, 4))
def test_rank_count_invariance(runs, world):
    base, out = runs[1], runs[world]
    for path in ("natural", "padded", "replan", "session"):
        assert_scores(out[path], base[path], f"{world}/{path}")


@pytest.mark.parametrize("kind", dist_.FAMILIES)
@pytest.mark.parametrize("world", WORLDS)
def test_parity_families(runs, ref, world, kind):
    got = runs[world]["families"][kind]
    assert got["overflow"] == 0
    assert_scores(got, ref[kind], f"{world}/{kind}")


@pytest.mark.parametrize("world", WORLDS)
def test_near_parallel_ints_and_deviation_sum(runs, world):
    """Integers equal the op-by-op reference, and so does the deviation
    sum behind E_ca at rtol 1e-5 (summed over the ranks in another
    float32 order)."""
    check_near_parallel(runs[world]["near_parallel"],
                        NEAR_PARALLEL_REFERENCE)


# ---------------------------------------------------------------------------
# in process: typed errors, the degradation ladder, rejected shapes
# ---------------------------------------------------------------------------

def _fixture(n_v=120, seed=5):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 40, (n_v, 2)).astype(np.float32)
    edges = set()
    while len(edges) < 2 * n_v:
        v, u = rng.integers(0, n_v, 2)
        if v != u:
            edges.add((min(v, u), max(v, u)))
    return pos, np.array(sorted(edges), np.int32)


def _mesh1():
    return make_mesh((1,), ("x",), device="cpu")


def _plan(pos, edges):
    return engine.plan_readability(pos, edges, radius=1.0, n_strips=16,
                                   tier_strips=False)


def test_graph_sharded_dispatch_failure_is_typed(monkeypatch):
    pos, edges = _fixture()

    def boom(*a, **k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(engine, "evaluate_graph_shard_body", boom)
    with pytest.raises(BackendUnavailableError) as ei:
        gs.evaluate_graph_sharded(_mesh1(), _plan(pos, edges), pos, edges)
    assert isinstance(ei.value.__cause__, RuntimeError)
    assert hasattr(ei.value, "request_index")


def test_pairwise_dispatch_failure_is_typed(monkeypatch):
    """A failed launch of any pairwise driver surfaces as ONE typed
    BackendUnavailableError with the cause chained and
    ``request_index == 0``."""
    from repro_torch.distributed import pairwise

    pos, edges = _fixture()

    def boom(*a, **k):
        raise RuntimeError("kernel launch failed")

    for name in ("occlusion_pairs_rows", "crossing_count_rows",
                 "ring_shift", "psum"):
        monkeypatch.setattr(pairwise, name, boom)
    mesh = _mesh1()
    for call in (lambda: pairwise.sharded_occlusion_count(mesh, pos, 1.0),
                 lambda: pairwise.sharded_crossing_count(mesh, pos, edges),
                 lambda: pairwise.ring_occlusion_count(mesh, pos, 1.0)):
        with pytest.raises(BackendUnavailableError) as ei:
            call()
        assert isinstance(ei.value.__cause__, RuntimeError)
        assert ei.value.request_index == 0


def test_gridded_dispatch_failure_is_typed(monkeypatch):
    import torch
    from repro_torch.core import grid
    from repro_torch.distributed import gridded

    pos, edges = _fixture()
    plan = _plan(pos, edges)
    max_segments, cap = plan.strip_plans[0]
    segs = grid.build_strip_segments(torch.from_numpy(pos),
                                     torch.from_numpy(edges), plan.n_strips,
                                     max_segments, axis=plan.axes[0])
    buckets = grid.bucketize_segments(segs, plan.n_strips, cap)

    def boom(*a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(gridded, "strip_reversal_rows", boom)
    with pytest.raises(BackendUnavailableError) as ei:
        gridded.sharded_reversal_stats(_mesh1(), buckets)
    assert isinstance(ei.value.__cause__, RuntimeError)
    assert ei.value.request_index == 0


def test_session_degrades_graph_sharded_to_fused(monkeypatch):
    """Mesh loss mid-serve: the graph_sharded rung fails, the session
    serves from the fused rung with the reference's integers, and the
    degradation shows in stats and health."""
    pos, edges = _fixture()
    want = ref_api.Evaluator(ref_api.EvalConfig(radius=1.0, n_strips=16)) \
        .evaluate(pos, edges)

    def boom(*a, **k):
        raise BackendUnavailableError("mesh lost")

    monkeypatch.setattr(gs, "evaluate_graph_sharded", boom)
    ev = Evaluator(EvalConfig(radius=1.0, n_strips=16,
                              backend="graph_sharded"), device="cpu")
    got = ev.evaluate(pos, edges)
    assert got.node_occlusion == want.node_occlusion
    assert got.edge_crossing == want.edge_crossing
    sess = ev._bound_session()
    assert sess.stats["degraded_dispatches"] >= 1
    assert sess.stats["graph_sharded_dispatches"] == 0
    assert sess.health()["dispatch_mode"] != "graph_sharded"


def test_graph_sharded_rejects_bad_shapes():
    pos, edges = _fixture()
    plan = _plan(pos, edges)
    with pytest.raises(ValueError):
        gs.evaluate_graph_sharded(_mesh1(), plan, np.stack([pos, pos]),
                                  edges)
    mesh2d = make_mesh((1, 1), ("a", "b"), device="cpu")
    with pytest.raises(ValueError):
        gs.evaluate_graph_sharded(mesh2d, plan, pos, edges)


def test_one_rank_mesh_needs_no_group():
    """The reference's one-device mesh: a one-rank mesh without a process
    group, whose collectives are the identity; a larger mesh needs a
    group."""
    mesh = _mesh1()
    assert isinstance(mesh, Mesh) and mesh.group is None
    assert (mesh.size, mesh.rank, mesh.axis_shape) == (1, 0, (1,))
    with pytest.raises(ValueError):
        make_mesh((2,), ("x",), device="cpu")
    with pytest.raises(ValueError):
        make_mesh((1, 1, 1), ("a", "b", "c"), device="cpu")


@pytest.mark.gpu
def test_graph_sharded_on_one_rank_nccl_group():
    """On the card: a one-rank NCCL group, the strip sweeps through the
    strip-reversal kernel; integers equal the single-device fused engine
    under the same flat plan, one halo exchange, none for E_c alone."""
    import datetime

    import torch
    import torch.distributed as tdist
    from repro_torch.core import grid
    from repro_torch.kernels.strip_reversal import strip_reversal_rows

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tdist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{dist_.free_port()}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh((1,), ("graph",))
        assert mesh.backend == "nccl" and mesh.device.type == "cuda"
        pos, edges = dist_.graph_sharded_graph()
        plan = engine.plan_readability(pos, edges, radius=2.0, n_strips=48,
                                       tier_strips=False)
        want = dist_.fetch(engine.evaluate_planned(plan, pos, edges,
                                                   device=mesh.device))
        c0 = grid.CALL_COUNTS["halo_exchanges"]
        launches = strip_reversal_rows.LAUNCHES
        got = dist_.fetch(gs.evaluate_graph_sharded(mesh, plan, pos, edges))
        assert grid.CALL_COUNTS["halo_exchanges"] == c0 + 1
        assert strip_reversal_rows.LAUNCHES == launches + len(plan.axes)
        assert_scores(got, want, "nccl")
        xplan = engine.plan_readability(pos, edges, radius=2.0, n_strips=48,
                                        tier_strips=False,
                                        metrics=("edge_crossing",))
        res = gs.evaluate_graph_sharded(mesh, xplan, pos, edges)
        assert int(res.edge_crossing) == want["edge_crossing"]
        assert grid.CALL_COUNTS["halo_exchanges"] == c0 + 1
    finally:
        tdist.destroy_process_group()
