"""The port's distributed drivers on ``torch.distributed`` against the
reference; twin of ``tests/test_distributed.py`` and of the three mesh
cells of ``tests/test_parity_matrix.py``.

Each rank count (1, 2 and 4 gloo ranks on the CPU, ``tests/_torch_dist.py``)
is spawned once for the module.  On a mesh of every rank (2-D, ``(2, 2)``,
at 4 ranks: the drivers flatten its axes):

* the row-sharded and ring-streamed exact N_c and the row-sharded exact
  E_c (:mod:`repro_torch.distributed.pairwise`) equal the reference's
  oracles (``repro.kernels.ref``, run op by op), on the layout of
  ``tests/test_distributed.py`` and on every parity family;
* the strip-sharded reversal sweep
  (:func:`~repro_torch.distributed.gridded.sharded_reversal_stats`)
  equals the reference's single-device ``bucket_reversal_stats`` (count
  exactly, deviation sum at rtol 1e-5);
* the parity matrix's ``distributed``, ``sharded_batched`` and
  ``graph_sharded`` cells, through ``Evaluator(..., mesh=...)``, equal
  the reference's fused scores on every family (integers exactly, floats
  at rtol 1e-5); the near-parallel layouts through the distributed front
  door are held through their integers and deviation sum;
* the serving mesh policy caps and trims the group; a distributed search
  equals the single-host search from the same restarts.

* ``sharded_embedding_lookup`` on a ``model`` axis of every rank equals
  the reference's ``jnp.take`` of the whole table (the last check of
  ``tests/test_distributed.py``; ``merge_decode_attention``, the one
  before it, is held in ``tests/test_torch_lm.py``);
* ``examples/torch/distributed_eval.py``'s counts at 4 ranks equal the
  reference's oracles, as ``examples/distributed_eval.py`` checks its
  own;
* ``evaluate_exact(mesh=...)``, for every metric subset that changes its
  route, equals the port's one-device ``evaluate_exact`` (counts, M_a and
  M_l exactly, E_ca at rtol 1e-5), the benchmark's plain reference
  (``bench.reference.scores.exact_scores``) and the JAX package's
  ``evaluate_exact`` (counts exactly, scores at rtol 1e-5); the one
  collective that combines the ranks' partials runs in one
  ``exact.reduce`` span under the root ``exact``, and a second call
  gives the same E_ca bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as ref_api
from repro.core import grid as ref_grid
from repro.core.crossing import bucket_reversal_stats
from repro.core.metrics import evaluate_exact as ref_evaluate_exact
from repro.graphs.datasets import random_edges as ref_random_edges
from repro.graphs.layouts import random_layout as ref_random_layout
from repro.kernels import ref as ref_oracles
import _torch_dist as dist_
from bench.reference import scores as bench_scores
from repro_torch.core.keys import EvalConfig
from repro_torch.core.metrics import evaluate_exact
from repro_torch.distributed.collectives import sharded_embedding_lookup
from repro_torch.distributed.compat import make_mesh
from repro_torch.kernels.fixtures import parity_family
from test_torch_kernels import NEAR_PARALLEL_REFERENCE, check_near_parallel

RTOL = 1e-5
WORLDS = (1, 2, 4)
CELLS = ("distributed", "sharded_batched", "graph_sharded")
INT_FIELDS = ("node_occlusion", "edge_crossing", "crossing_count_for_angle")
FLOAT_FIELDS = ("minimum_angle", "edge_length_variation",
                "edge_crossing_angle")


def oracles(pos, edges, radius):
    """The reference's exact N_c and E_c, op by op."""
    x, y = jnp.asarray(pos[:, 0]), jnp.asarray(pos[:, 1])
    p, q = pos[edges[:, 0]], pos[edges[:, 1]]
    occ = int(ref_oracles.occlusion_count_ref(x, y, radius))
    cross = int(ref_oracles.crossing_count_ref(
        jnp.asarray(p[:, 0]), jnp.asarray(p[:, 1]), jnp.asarray(q[:, 0]),
        jnp.asarray(q[:, 1]), jnp.asarray(edges[:, 0]),
        jnp.asarray(edges[:, 1])))
    return occ, cross


@pytest.fixture(scope="module")
def started():
    """The rank processes, started before the reference results are made
    so that both run at once."""
    return dist_.start_worlds(WORLDS, "distributed")


@pytest.fixture(scope="module")
def runs(started, ref):
    return dist_.finish_worlds(started)


@pytest.fixture(scope="module")
def ref(started):
    pos, edges = dist_.distributed_graph()
    out = {"oracles": oracles(pos, edges, 2.0)}
    segs = ref_grid.build_strip_segments(jnp.asarray(pos),
                                         jnp.asarray(edges), 64, 16384)
    buckets = ref_grid.bucketize_segments(segs, 64, cap=128)
    (cnt,) = bucket_reversal_stats(buckets)
    cnt_a, dev = bucket_reversal_stats(buckets, ideal_angle=1.2)
    out["strip"] = (int(cnt), int(cnt_a), float(dev))
    for kind in dist_.FAMILIES:
        fpos, fedges = parity_family(kind)
        out[kind] = (ref_api.Evaluator(ref_api.EvalConfig(
            radius=dist_.RADIUS, n_strips=dist_.N_STRIPS)).evaluate(
            fpos, fedges), oracles(fpos, fedges, dist_.RADIUS))
    table, ids = dist_.embedding_inputs()
    out["take"] = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ids),
                                      axis=0))
    out["exact_mesh"] = exact_one_device()
    # examples/distributed_eval.py's graph and radius
    out["distributed_eval"] = oracles(
        ref_random_layout(1500, seed=0), ref_random_edges(1500, 3000, seed=0),
        1.0)
    return out


# collectives a call of evaluate_exact(mesh=...) makes, by metric subset:
# one gather of every count and deviation sum the call's sweeps made
EXACT_REDUCES = {"all": 1, "crossing": 1, "crossing_angle": 1,
                 "occlusion": 1}


def exact_one_device():
    """The port's one-device ``evaluate_exact`` on the CPU, the plain
    reference's exact scores and the JAX package's ``evaluate_exact``, of
    the mesh twin's layouts."""
    layouts = {"graph": dist_.distributed_graph()}
    for kind in dist_.FAMILIES:
        layouts[kind] = parity_family(kind)
    out = {}
    ideal = EvalConfig().ideal_angle
    for name, (pos, edges) in layouts.items():
        plain = bench_scores.exact_scores(
            torch.from_numpy(pos), torch.from_numpy(edges),
            radius=dist_.RADIUS, ideal=ideal)
        for subset, metrics in dist_.EXACT_SUBSETS.items():
            kw = {} if metrics is None else {"metrics": metrics}
            one = evaluate_exact(pos, edges, device="cpu",
                                 config=EvalConfig(radius=dist_.RADIUS, **kw))
            jax_ = ref_evaluate_exact(pos, edges, config=ref_api.EvalConfig(
                radius=dist_.RADIUS, **kw))
            out[f"{name}/{subset}"] = (dist_.fetch(one), plain,
                                       dist_.fetch(jax_))
    return out


@pytest.mark.parametrize("subset", list(dist_.EXACT_SUBSETS))
@pytest.mark.parametrize("world", WORLDS)
def test_evaluate_exact_over_a_mesh(runs, ref, world, subset):
    """Row-sharded kernels 2 and 4 (kernel 3 for E_c alone) through the
    exact front door: every rank's scores (``spawn`` holds them equal)
    against the one-device route (counts, M_a and M_l exactly), the
    plain reference and the JAX package's ``evaluate_exact`` (counts
    exactly, scores at ``RTOL``)."""
    for name in ("graph",) + dist_.FAMILIES:
        key = f"{name}/{subset}"
        got = runs[world]["exact_mesh"][key]
        one, plain, jax_ = ref["exact_mesh"][key]
        for f in INT_FIELDS + FLOAT_FIELDS:
            value = got["scores"][f]
            assert (value is None) == (one[f] is None) == (jax_[f] is None), \
                (world, key, f)
            if value is None:
                continue
            if f in INT_FIELDS:
                assert value == one[f] == jax_[f] == int(plain[f]), \
                    (world, key, f)
                continue
            if f != "edge_crossing_angle":
                assert value == one[f], (world, key, f)
            for want in (one[f], plain[f], jax_[f]):
                np.testing.assert_allclose(value, float(want), rtol=RTOL,
                                           err_msg=f"{world}/{key}/{f}")
        assert got["reduce_spans"] == EXACT_REDUCES[subset], key
        assert got["reduce_parents"] == ["exact"] * EXACT_REDUCES[subset]
        assert got["reduce_roots"] == ["exact"]
        assert got["same_bits"], key


@pytest.mark.parametrize("world", WORLDS)
def test_pairwise_drivers_match_oracles(runs, ref, world):
    out = runs[world]
    assert out["mesh_shape"] == ([2, 2] if world == 4 else [world])
    occ, cross = ref["oracles"]
    assert out["occlusion"] == occ
    assert out["ring_occlusion"] == occ
    assert out["crossing"] == cross
    # one row-sharded kernel-4 sweep: E_c's count and E_ca's deviation
    # sum, added in rank order, against the one-device sweep
    cnt, dev = out["crossing_angle"]
    assert cnt == out["crossing_angle_single"][0] == cross
    np.testing.assert_allclose(dev, out["crossing_angle_single"][1],
                               rtol=RTOL)


@pytest.mark.parametrize("world", WORLDS)
def test_strip_sharded_matches_single_device(runs, ref, world):
    out = runs[world]
    cnt, cnt_a, dev = ref["strip"]
    assert out["strip_sharded"] == cnt
    assert out["strip_sharded_angle"][0] == cnt_a == cnt
    np.testing.assert_allclose(out["strip_sharded_angle"][1], dev,
                               rtol=RTOL)
    assert out["strip_single_angle"][0] == cnt


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("kind", dist_.FAMILIES)
@pytest.mark.parametrize("world", WORLDS)
def test_parity_matrix_mesh_cells(runs, ref, world, kind, cell):
    got = runs[world]["families"][kind][cell]
    want = ref[kind][0]
    assert got["overflow"] == 0
    for f in INT_FIELDS:
        assert got[f] == getattr(want, f), (world, kind, cell, f)
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(got[f], getattr(want, f), rtol=RTOL,
                                   err_msg=f"{world}/{kind}/{cell}/{f}")


@pytest.mark.parametrize("kind", dist_.FAMILIES)
@pytest.mark.parametrize("world", WORLDS)
def test_pairwise_drivers_on_families(runs, ref, world, kind):
    got = runs[world]["families"][kind]
    occ, cross = ref[kind][1]
    assert got["occlusion"] == got["ring_occlusion"] == occ
    assert got["crossing"] == cross
    # the exact N_c is the grid's (paper Table 3)
    assert got["distributed"]["node_occlusion"] == occ


@pytest.mark.parametrize("world", WORLDS)
def test_near_parallel_ints_and_deviation_sum(runs, world):
    check_near_parallel(runs[world]["near_parallel"],
                        NEAR_PARALLEL_REFERENCE)


@pytest.mark.parametrize("world", WORLDS)
def test_serving_mesh_policy(runs, world):
    """The whole group by default, capped by ``shards`` and trimmed to a
    power of two (3 -> 2 on 4 ranks); ``Evaluator`` brings up the same."""
    out = runs[world]
    assert out["serving_mesh"] == {
        "None": [world, ["graph"]], "1": [1, ["graph"]],
        "2": [min(2, world), ["graph"]], "3": [min(2, world), ["graph"]]}
    assert out["evaluator_mesh"] == world


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_search_matches_single_host(runs, world):
    """Twin of ``tests/test_search.py::
    test_distributed_backend_matches_single_host_start``: the sharded
    step (each rank differentiates its restarts, the ranks gather) takes
    the single-host search's trajectory from the same restarts, padded
    up to the mesh size."""
    out = runs[world]["search"]
    dist, single = out["distributed"], out["fused"]
    assert dist["restarts"] == max(2, world)
    assert np.all(np.isfinite(dist["positions"]))
    assert dist["improvement"] >= 0
    for k in ("init_positions", "restarts", "counters", "init_scores",
              "scores"):
        assert dist[k] == single[k], k
    np.testing.assert_allclose(dist["positions"], single["positions"],
                               rtol=RTOL)
    np.testing.assert_allclose(dist["losses"][1:], single["losses"][1:],
                               rtol=RTOL)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_embedding_lookup_matches_take(runs, ref, world):
    """Rows range-partitioned over ``world`` ranks, gathered where owned
    and summed: the single-device ``take`` of the whole table."""
    np.testing.assert_allclose(runs[world]["embedding_lookup"], ref["take"],
                               rtol=0, atol=1e-6)


def test_sharded_embedding_lookup_takes_a_one_axis_mesh():
    """A mesh of two axes shards over the named axis and replicates over
    the other (the reference's ``P(axis, None)`` in-spec): on a (1, 1)
    mesh the lookup is ``table[ids]``; an axis the mesh lacks raises."""
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    table, ids = dist_.embedding_inputs()
    got = sharded_embedding_lookup(mesh, torch.from_numpy(table),
                                   torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), table[ids])
    with pytest.raises(ValueError, match="no axis"):
        sharded_embedding_lookup(mesh, torch.from_numpy(table),
                                 torch.from_numpy(ids), axis="x")


def test_sharded_embedding_lookup_on_a_two_axis_mesh(runs):
    """At 4 ranks, a (2, 2) mesh: rows split over ``model``, replicated
    over ``data``, the sum over the model axis's sub-group only; every
    rank gets ``table[ids]`` exactly."""
    table, ids = dist_.embedding_inputs()
    np.testing.assert_array_equal(
        np.asarray(runs[4]["embedding_lookup_2d"], np.float32), table[ids])


def test_distributed_eval_example_matches_oracles(runs, ref):
    """``examples/torch/distributed_eval.py`` on 4 gloo ranks (a ``(2,
    2)`` mesh): its exact N_c (row-sharded and ring) and E_c equal the
    reference's oracles, and the strip-sharded enhanced E_c plans without
    overflow."""
    out = runs[4]["distributed_eval"]
    occ, cross = ref["distributed_eval"]
    assert out["mesh"] == [2, 2]
    assert out["node_occlusion"] == out["ring_node_occlusion"] == occ
    assert out["edge_crossing"] == cross
    assert out["overflow"] == 0
    assert out["enhanced_edge_crossing"] > 0
