"""The paper's standalone enhanced algorithms in the port against the
reference's: ``count_crossings_enhanced``, ``crossing_angle_enhanced``
(with its on-device orientation pick), ``count_occlusions_enhanced``,
``grid.plan_strips`` and both inversion counters, on the parity families
of ``tests/test_parity_matrix.py`` in each orientation.  Integers and
overflow equal, floats at rtol 1e-5; everything on the CPU
(``device="cpu"``), where the strip sweep is the plain version of the
strip-reversal kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as t_core
from repro.core import grid as ref_grid
from repro.core import inversions as ref_inv
from repro_torch.core import grid as t_grid
from repro_torch.core import inversions as t_inv
from repro_torch.kernels.strip_reversal import strip_reversal_rows
from test_parity_matrix import FAMILIES, N_STRIPS, RADIUS, make_family

RTOL = 1e-5
ORIENTATIONS = ("vertical", "horizontal", "both")


@pytest.fixture(scope="module")
def families():
    return {f: make_family(f) for f in FAMILIES}


def as_jax(pos, edges):
    return jnp.asarray(pos), jnp.asarray(edges)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("orientation", ORIENTATIONS)
def test_count_crossings_enhanced_matches_reference(families, family,
                                                    orientation):
    pos, edges = families[family]
    ref = ref_core.count_crossings_enhanced(
        *as_jax(pos, edges), n_strips=N_STRIPS, orientation=orientation)
    got = t_core.count_crossings_enhanced(
        pos, edges, n_strips=N_STRIPS, orientation=orientation,
        device="cpu")
    assert [int(x) for x in got] == [int(x) for x in ref]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("orientation", ORIENTATIONS)
def test_crossing_angle_enhanced_matches_reference(families, family,
                                                   orientation):
    pos, edges = families[family]
    ref = ref_core.crossing_angle_enhanced(
        *as_jax(pos, edges), n_strips=N_STRIPS, orientation=orientation)
    got = t_core.crossing_angle_enhanced(
        pos, edges, n_strips=N_STRIPS, orientation=orientation,
        device="cpu")
    e_ca, count, dev_sum, overflow = got
    assert (int(count), int(overflow)) == (int(ref[1]), int(ref[3]))
    np.testing.assert_allclose(float(e_ca), float(ref[0]), rtol=RTOL)
    np.testing.assert_allclose(float(dev_sum), float(ref[2]), rtol=RTOL)
    assert e_ca.dtype == torch.float32


@pytest.mark.parametrize("counts", [(5, 5), (5, 6), (6, 5), (0, 0)])
def test_crossing_angle_orientation_pick_matches_reference(monkeypatch,
                                                           counts):
    """The 'both' pick alone: fed the same per-orientation results, both
    packages keep the orientation with more crossings, and the earlier
    axis on a tie (the deviations differ, so a wrong pick shows)."""
    import repro.core.crossing_angle as ref_ca
    import repro_torch.core.crossing_angle as t_ca
    pos, edges = make_family("random")

    def fake(mk):
        def strips(pos, edges, n_strips, max_segments, cap, *, axis, **kw):
            c = counts[axis]
            dev = 1.5 + axis
            return tuple(mk(v) for v in (1.0 - dev / max(c, 1), c, dev,
                                         axis))
        return strips

    monkeypatch.setattr(ref_ca, "crossing_angle_strips",
                        fake(jnp.asarray))
    monkeypatch.setattr(t_ca, "crossing_angle_strips", fake(torch.tensor))
    ref = ref_ca.crossing_angle_enhanced(*as_jax(pos, edges),
                                         n_strips=N_STRIPS)
    got = t_ca.crossing_angle_enhanced(pos, edges, n_strips=N_STRIPS,
                                       device="cpu")
    want_axis = 1 if counts[1] > counts[0] else 0
    assert int(got[3]) == int(ref[3]) == want_axis
    assert [float(x) for x in got] == [float(x) for x in ref]


@pytest.mark.parametrize("family", FAMILIES)
def test_count_occlusions_enhanced_matches_reference(families, family):
    pos, _ = families[family]
    ref = ref_core.count_occlusions_enhanced(jnp.asarray(pos), RADIUS)
    got = t_core.count_occlusions_enhanced(pos, RADIUS, device="cpu")
    assert [int(x) for x in got] == [int(x) for x in ref]
    exact = t_core.count_occlusions_exact(torch.from_numpy(pos), RADIUS)
    assert int(got[0]) == int(exact)


@pytest.mark.parametrize("family", FAMILIES)
def test_plan_strips_matches_reference(families, family):
    pos, edges = families[family]
    for axis in (0, 1):
        for n_strips in (N_STRIPS, 7):
            want = ref_grid.plan_strips(pos, edges, n_strips, axis=axis)
            assert t_grid.plan_strips(pos, edges, n_strips,
                                      axis=axis) == want
            assert t_grid.plan_strips(torch.from_numpy(pos),
                                      torch.from_numpy(edges), n_strips,
                                      axis=axis) == want


def test_starved_capacities_report_equal_overflow():
    """Under a cap and a segment budget below the plan's, the strip
    wrappers drop the same segments as the reference and say so."""
    pos, edges = make_family("cluster")
    for axis in (0, 1):
        ms, cap = ref_grid.plan_strips(pos, edges, N_STRIPS, axis=axis)
        args = (N_STRIPS, ms // 2, max(cap // 4, 1))
        ref_c = ref_core.count_crossings_strips(*as_jax(pos, edges), *args,
                                                axis=axis)
        got_c = t_core.count_crossings_strips(
            torch.from_numpy(pos), torch.from_numpy(edges), *args, axis=axis)
        assert int(ref_c[1]) > 0
        assert [int(x) for x in got_c] == [int(x) for x in ref_c]
        ref_a = ref_core.crossing_angle_strips(*as_jax(pos, edges), *args,
                                               axis=axis)
        got_a = t_core.crossing_angle_strips(
            torch.from_numpy(pos), torch.from_numpy(edges), *args, axis=axis)
        assert (int(got_a[1]), int(got_a[3])) == (int(ref_a[1]),
                                                  int(ref_a[3]))
        np.testing.assert_allclose(float(got_a[0]), float(ref_a[0]),
                                   rtol=RTOL)


def test_enhanced_sweep_goes_through_the_kernel_wrapper(monkeypatch):
    """The enhanced wrappers sweep through ``strip_reversal_rows`` (the
    kernel's wrapper; its plain version on the CPU), once per orientation,
    on flat ``(n_strips, cap)`` buckets."""
    import repro_torch.kernels.ops as ops
    pos, edges = make_family("random")
    calls = []

    def spy(*args, **kw):
        calls.append(tuple(args[0].shape))
        return strip_reversal_rows(*args, **kw)

    monkeypatch.setattr(ops, "strip_reversal_rows", spy)
    t_core.count_crossings_enhanced(pos, edges, n_strips=N_STRIPS,
                                    device="cpu")
    t_core.crossing_angle_enhanced(pos, edges, n_strips=N_STRIPS,
                                   device="cpu")
    caps = [t_grid.plan_strips(pos, edges, N_STRIPS, axis=a)[1]
            for a in (0, 1)]
    assert calls == [(N_STRIPS, caps[0]), (N_STRIPS, caps[1])] * 2


def test_enhanced_wrappers_need_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pos, edges = make_family("random")
    for call in (lambda: t_core.count_crossings_enhanced(pos, edges),
                 lambda: t_core.crossing_angle_enhanced(pos, edges),
                 lambda: t_core.count_occlusions_enhanced(pos, RADIUS)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


INVERSION_CASES = {
    "empty": (0, 0.0),
    "one": (1, 0.0),
    "ties": (37, 0.0),
    "invalid_gaps": (64, 0.3),
    "non_pow2": (100, 0.1),
}


@pytest.mark.parametrize("case", sorted(INVERSION_CASES))
def test_inversion_counters_match_reference(case):
    n, p_invalid = INVERSION_CASES[case]
    rng = np.random.default_rng(n)
    a = rng.integers(0, 12, n).astype(np.float32)    # many ties
    valid = rng.random(n) >= p_invalid
    want = int(ref_inv.count_inversions_dense(jnp.asarray(a),
                                              jnp.asarray(valid)))
    assert want == int(ref_inv.count_inversions_merge(jnp.asarray(a),
                                                      jnp.asarray(valid)))
    at, vt = torch.from_numpy(a), torch.from_numpy(valid)
    assert int(t_inv.count_inversions_dense(at, vt, block=64)) == want
    assert int(t_inv.count_inversions_merge(at, vt)) == want
    # int inputs and no mask: counted as float32, like the reference
    ai = torch.from_numpy(a.astype(np.int32))
    want_all = int(ref_inv.count_inversions_dense(jnp.asarray(a)))
    assert int(t_inv.count_inversions_merge(ai)) == want_all
    assert int(t_inv.count_inversions_dense(ai)) == want_all
