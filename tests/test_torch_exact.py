"""The port's exact all-pairs path against the reference, on the CPU.

``count_crossings_exact``, ``crossing_angle_exact``,
``count_occlusions_exact`` and ``evaluate_exact`` of
:mod:`repro_torch` against their :mod:`repro` counterparts on the five
parity-matrix families (``RADIUS = 2.0``), natural, with validity masks
and padded; how each ``use_kernels`` route finishes E_ca; the geometry
primitives against the reference's; and the core functions on the
adversarial fixtures of :mod:`repro_torch.kernels.fixtures`, against the
reference's naive oracles.

The bar is the reference's parity rule: integers equal, floats at
``RTOL = 1e-5`` (sums run in another order, and PyTorch's ``atan2``
differs from XLA's in the last bits).  The reference's exact sweeps run
under ``jit`` (``lax.map``), where XLA's CPU backend contracts the cross
products into FMAs; the parity families are built so that no rounding
decides a count, and the fixtures, whose near-collinear layout is decided
by rounding, are held to the reference's oracles, which run op by op.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import EvalConfig as RefConfig
from repro.api import evaluate_exact as ref_evaluate_exact
from repro.core import geometry as ref_geometry
from repro.core.crossing import count_crossings_exact as ref_crossings
from repro.core.crossing_angle import crossing_angle_exact as ref_angle
from repro.core.occlusion import count_occlusions_exact as ref_occlusions
from repro.kernels import ref as ref_oracles
from repro_torch.api import EvalConfig, Evaluator, evaluate_exact
from repro_torch.core import geometry
from repro_torch.core.crossing import count_crossings_exact
from repro_torch.core.crossing_angle import DEFAULT_IDEAL, crossing_angle_exact
from repro_torch.core.engine import ALL_METRICS
from repro_torch.core.occlusion import count_occlusions_exact
from repro_torch.kernels import ops
from repro_torch.kernels.fixtures import FIXTURES
from test_parity_matrix import FAMILIES, RADIUS, make_family

RTOL = 1e-5
INT_FIELDS = ("node_occlusion", "edge_crossing", "crossing_count_for_angle")
FLOAT_FIELDS = ("minimum_angle", "edge_length_variation",
                "edge_crossing_angle")
VARIANTS = ("natural", "masked", "padded")


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def variant(pos, edges, kind, seed=0):
    """``(pos, edges, vertex_valid, edge_valid)`` of a family: as is,
    with random validity masks, or padded with invalid vertices and
    edges (far away, crossing everything, sharing no endpoint)."""
    if kind == "natural":
        return pos, edges, None, None
    rng = np.random.default_rng(seed)
    if kind == "masked":
        return (pos, edges, rng.random(pos.shape[0]) < 0.8,
                rng.random(edges.shape[0]) < 0.8)
    V, E = pos.shape[0], edges.shape[0]
    extra = rng.uniform(-50, 150, (37, 2)).astype(np.float32)
    pos_p = np.concatenate([pos, extra])
    extra_e = rng.integers(0, V + 37, (53, 2)).astype(np.int32)
    edges_p = np.concatenate([edges, extra_e])
    vv = np.arange(V + 37) < V
    ev = np.arange(E + 53) < E
    return pos_p, edges_p, vv, ev


def opt(a, wrap):
    return None if a is None else wrap(a)


@pytest.mark.parametrize("kind", VARIANTS)
@pytest.mark.parametrize("family", FAMILIES)
def test_count_crossings_exact_matches_reference(family, kind):
    pos, edges, _, ev = variant(*make_family(family), kind)
    got = count_crossings_exact(T(pos), T(edges), edge_valid=opt(ev, T))
    want = ref_crossings(jnp.asarray(pos), jnp.asarray(edges),
                         edge_valid=opt(ev, jnp.asarray))
    assert int(got) == int(want)
    if kind == "padded":
        natural = count_crossings_exact(*map(T, make_family(family)))
        assert int(got) == int(natural)


@pytest.mark.parametrize("kind", VARIANTS)
@pytest.mark.parametrize("family", FAMILIES)
def test_crossing_angle_exact_matches_reference(family, kind):
    pos, edges, _, ev = variant(*make_family(family), kind)
    e_ca, count, dev = crossing_angle_exact(T(pos), T(edges),
                                            edge_valid=opt(ev, T))
    r_eca, r_count, r_dev = ref_angle(jnp.asarray(pos), jnp.asarray(edges),
                                      edge_valid=opt(ev, jnp.asarray))
    assert int(count) == int(r_count)
    assert e_ca.dtype == dev.dtype == torch.float32
    np.testing.assert_allclose(float(dev), float(r_dev), rtol=RTOL)
    np.testing.assert_allclose(float(e_ca), float(r_eca), rtol=RTOL)


@pytest.mark.parametrize("kind", VARIANTS)
@pytest.mark.parametrize("family", FAMILIES)
def test_count_occlusions_exact_matches_reference(family, kind):
    pos, _, vv, _ = variant(*make_family(family), kind)
    got = count_occlusions_exact(T(pos), RADIUS, valid=opt(vv, T))
    want = ref_occlusions(jnp.asarray(pos), RADIUS,
                          valid=opt(vv, jnp.asarray))
    assert int(got) == int(want)


def assert_scores(got, want, what):
    for f in INT_FIELDS + FLOAT_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), (what, f)
        if g is None:
            continue
        if f in INT_FIELDS:
            assert g == w, (what, f, g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, err_msg=f"{what}/{f}")
    for f in ("overflow", "n_vertices", "n_edges"):
        assert getattr(got, f) == getattr(want, f), (what, f)


@pytest.fixture(scope="module")
def reference_scores():
    """The reference's ``evaluate_exact(use_kernels=False)`` per family."""
    return {f: ref_evaluate_exact(*make_family(f),
                                  config=RefConfig(radius=RADIUS))
            for f in FAMILIES}


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_evaluate_exact_matches_reference(reference_scores, family,
                                          use_kernels):
    pos, edges = make_family(family)
    got = evaluate_exact(pos, edges, config=EvalConfig(radius=RADIUS),
                         use_kernels=use_kernels, device="cpu")
    assert_scores(got, reference_scores[family], family)
    assert got.edge_crossing == got.crossing_count_for_angle


SUBSETS = [("edge_crossing",), ("node_occlusion", "minimum_angle"),
           ("edge_crossing_angle", "edge_length_variation")]


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("metrics", SUBSETS)
def test_evaluate_exact_metric_subsets(reference_scores, metrics,
                                       use_kernels):
    pos, edges = make_family("cluster")
    got = evaluate_exact(pos, edges,
                         config=EvalConfig(radius=RADIUS, metrics=metrics),
                         use_kernels=use_kernels, device="cpu")
    want = ref_evaluate_exact(pos, edges, config=RefConfig(
        radius=RADIUS, metrics=metrics))
    assert_scores(got, want, str(metrics))
    for f in ALL_METRICS:
        assert (getattr(got, f) is None) == (f not in metrics), f
        if f in metrics:
            full = reference_scores["cluster"]
            np.testing.assert_allclose(getattr(got, f), getattr(full, f),
                                       rtol=RTOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_evaluate_exact_finishes_e_ca_per_route(family):
    """``use_kernels`` changes only how E_ca is finished from the
    kernel's count and deviation sum: in float32 (``False``, as
    ``crossing_angle_exact``) or in Python floats (``True``)."""
    pos, edges = make_family(family)
    cfg = EvalConfig(radius=RADIUS)
    count, dev = ops.crossing_angle_op(T(pos), T(edges),
                                       ideal=cfg.ideal_angle)
    assert int(count) > 0
    by_route = {uk: evaluate_exact(pos, edges, config=cfg, use_kernels=uk,
                                   device="cpu")
                for uk in (False, True)}
    assert by_route[True].edge_crossing_angle == (
        1.0 - float(dev) / int(count))
    assert by_route[False].edge_crossing_angle == float(
        np.float32(1.0) - np.float32(float(dev)) / np.float32(int(count)))
    for f in INT_FIELDS:
        assert getattr(by_route[False], f) == getattr(by_route[True], f)


SWEEP_SUBSETS = {"all": ALL_METRICS, "e_c": ("edge_crossing",),
                 "e_ca": ("edge_crossing_angle",),
                 "both": ("edge_crossing", "edge_crossing_angle")}
# (crossing sweeps, crossing-angle sweeps) of one exact call: one sweep
# gives both crossing metrics, E_c alone takes the crossing sweep
SWEEPS = {"all": (0, 1), "e_c": (1, 0), "e_ca": (0, 1), "both": (0, 1)}


def count_sweeps(monkeypatch):
    """Wrap both exact crossing sweeps of ``ops`` with counting spies."""
    calls = {"crossing_count_op": 0, "crossing_angle_op": 0}

    def spy(name):
        fn = getattr(ops, name)

        def counted(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(ops, name, counted)

    for name in calls:
        spy(name)
    return calls


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("subset", list(SWEEP_SUBSETS))
def test_evaluate_exact_sweeps_once_per_call(monkeypatch, subset,
                                             use_kernels):
    calls = count_sweeps(monkeypatch)
    pos, edges = make_family("cluster")
    cfg = EvalConfig(radius=RADIUS, metrics=SWEEP_SUBSETS[subset])
    for k in (1, 2):
        got = evaluate_exact(pos, edges, config=cfg,
                             use_kernels=use_kernels, device="cpu")
        assert (calls["crossing_count_op"],
                calls["crossing_angle_op"]) == tuple(
                    k * n for n in SWEEPS[subset])
    for f in ALL_METRICS:
        assert (getattr(got, f) is None) == (f not in cfg.metrics), f
    assert (got.crossing_count_for_angle is None) == (
        "edge_crossing_angle" not in cfg.metrics)


def two_sweep_fields(pos, edges, ideal, use_kernels):
    """The crossing fields as two separate sweeps give them: E_c from the
    crossing sweep, E_ca and its count from the crossing-angle sweep,
    finished per ``use_kernels`` route."""
    pos, edges = T(pos), T(edges)
    out = {"edge_crossing": int(count_crossings_exact(pos, edges))}
    if use_kernels:
        count, dev = ops.crossing_angle_op(pos, edges, ideal=ideal)
        count = int(count)
        out["edge_crossing_angle"] = (1.0 - float(dev) / count
                                      if count > 0 else 1.0)
    else:
        e_ca, count, _ = crossing_angle_exact(pos, edges, ideal=ideal)
        out["edge_crossing_angle"] = float(e_ca)
    out["crossing_count_for_angle"] = int(count)
    return out


def bits(value):
    return (type(value), value.hex() if isinstance(value, float) else value)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_one_sweep_equals_two_sweeps_bit_for_bit(family, use_kernels):
    pos, edges = make_family(family)
    cfg = EvalConfig(radius=RADIUS)
    got = evaluate_exact(pos, edges, config=cfg, use_kernels=use_kernels,
                         device="cpu")
    others = evaluate_exact(pos, edges, config=EvalConfig(
        radius=RADIUS, metrics=("node_occlusion", "minimum_angle",
                                "edge_length_variation")),
        use_kernels=use_kernels, device="cpu")
    want = others._replace(**two_sweep_fields(pos, edges, cfg.ideal_angle,
                                              use_kernels))
    assert got.edge_crossing > 0
    for f, g in got.asdict().items():
        assert bits(g) == bits(getattr(want, f)), (f, g, getattr(want, f))


def test_exact_counts_collinear_overlaps_the_enhanced_sweep_does_not():
    """Exact E_c counts collinear overlaps (the paper's convention); the
    strip sweep sees no order reversal on them."""
    pos, edges = make_family("collinear")
    cfg = EvalConfig(radius=RADIUS, n_strips=32)
    exact = evaluate_exact(pos, edges, config=cfg, device="cpu")
    enhanced = Evaluator(dataclasses.replace(cfg, backend="eager"),
                         device="cpu").evaluate(pos, edges)
    assert exact.edge_crossing > 0
    assert enhanced.edge_crossing == 0


def test_evaluate_exact_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pos, edges = make_family("random")
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_exact(pos, edges)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_exact_path_on_fixtures_matches_oracles(name):
    """The core functions on the adversarial fixtures against the
    reference's op-by-op oracles."""
    pos, edges, valid = FIXTURES[name]()
    p, q = pos[edges[:, 0]], pos[edges[:, 1]]
    arrays = [jnp.asarray(a) for a in (p[:, 0], p[:, 1], q[:, 0], q[:, 1],
                                       edges[:, 0], edges[:, 1], valid)]
    want = int(ref_oracles.crossing_count_ref(*arrays))
    w_cnt, w_dev = ref_oracles.crossing_angle_ref(*arrays[:6],
                                                  DEFAULT_IDEAL, arrays[6])
    got = count_crossings_exact(T(pos), T(edges), edge_valid=T(valid))
    e_ca, count, dev = crossing_angle_exact(T(pos), T(edges),
                                            edge_valid=T(valid))
    assert int(got) == int(count) == want == int(w_cnt)
    np.testing.assert_allclose(float(dev), float(w_dev), rtol=RTOL)
    # e_ca is finished in float32 as the reference finishes it (on the
    # near-collinear fixture every crossing is near-parallel and e_ca is
    # a cancellation near 0, so it is checked by its formula)
    assert float(e_ca) == float(np.float32(1.0) - np.float32(dev)
                                / np.float32(int(count)))
    w_occ = ref_oracles.occlusion_count_ref(
        jnp.asarray(pos[:, 0]), jnp.asarray(pos[:, 1]), 1.0)
    assert int(count_occlusions_exact(T(pos), 1.0)) == int(w_occ)


# ---------------------------------------------------------------------------
# geometry primitives and naive oracles
# ---------------------------------------------------------------------------

def segment_inputs(seed=0, n=64):
    """Segment pairs mixing random floats with lattice degeneracies
    (collinear, touching, zero-length), as ``(n, 1)`` x ``(1, n)``."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 10, (n, 4)).astype(np.float32)
    pts[: n // 2] = np.round(pts[: n // 2])
    pts[:4, 2:] = pts[:4, :2]                       # zero-length
    return [pts[:, k] for k in range(4)]


def pair_args(cols, wrap):
    x1, y1, x2, y2 = (wrap(c) for c in cols)
    return (x1[:, None], y1[:, None], x2[:, None], y2[:, None],
            x1[None, :], y1[None, :], x2[None, :], y2[None, :])


GEOMETRY = ("ccw", "segments_cross", "segments_cross_bool",
            "line_crossing_angle", "crossing_angle_deviation",
            "pair_dist_sq", "share_endpoint")


@pytest.mark.parametrize("name", GEOMETRY)
def test_geometry_matches_reference(name):
    cols = segment_inputs()
    rng = np.random.default_rng(1)
    th = rng.uniform(0, np.pi, 64).astype(np.float32)
    ids = rng.integers(0, 12, (4, 64)).astype(np.int32)
    if name == "ccw":
        args = [c[:, None] for c in cols[:4]] + [cols[0][None, :],
                                                 cols[1][None, :]]
        targs, rargs = [T(a) for a in args], [jnp.asarray(a) for a in args]
    elif name.startswith("segments_cross"):
        targs, rargs = pair_args(cols, T), pair_args(cols, jnp.asarray)
    elif name == "line_crossing_angle":
        targs = [T(th)[:, None], T(th)[None, :]]
        rargs = [jnp.asarray(th)[:, None], jnp.asarray(th)[None, :]]
    elif name == "crossing_angle_deviation":
        targs = [T(th)[:, None], T(th)[None, :], DEFAULT_IDEAL]
        rargs = [jnp.asarray(th)[:, None], jnp.asarray(th)[None, :],
                 jnp.asarray(DEFAULT_IDEAL)]
    elif name == "pair_dist_sq":
        targs = [T(c) for c in cols]
        rargs = [jnp.asarray(c) for c in cols]
    else:
        targs = [T(ids[0])[:, None], T(ids[1])[:, None], T(ids[2])[None, :],
                 T(ids[3])[None, :]]
        rargs = [jnp.asarray(ids[0])[:, None], jnp.asarray(ids[1])[:, None],
                 jnp.asarray(ids[2])[None, :], jnp.asarray(ids[3])[None, :]]
    got = getattr(geometry, name)(*targs).numpy()
    want = np.asarray(getattr(ref_geometry, name)(*rargs))
    if got.dtype == bool or name == "ccw":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=0)
    if name == "segments_cross":
        assert 0 < got.sum() < got.size
        np.testing.assert_array_equal(
            got, geometry.segments_cross_bool(*targs).numpy())


def test_ccw_keeps_nan_as_the_reference_does():
    nan = torch.tensor([float("nan")])
    zero = torch.zeros(1)
    assert torch.isnan(geometry.ccw(nan, zero, zero, zero, zero, zero)).all()
    assert not geometry.segments_cross(nan, zero, zero, zero, zero, zero,
                                       zero, zero).any()
