"""The chaos suite, twinned: the port's ``FaultPlan`` against the port's
``EvalSession`` (on the CPU), held against the reference session under an
equal plan.  Each slot's outcome (error type, located index and reason,
or scores) and every counter equal the reference's: the twins of the
non-mesh tests of ``tests/test_faults.py``.  The mesh-loss and
breaker-cycle tests wait for the port's mesh rung.

Hangs are armed with ``hang_seconds`` of at most 2 and a
``dispatch_timeout`` of at most 0.5 s.
"""

import threading
import time
import warnings

import numpy as np
import pytest

from _serving_twins import (PKGS, PORT, REF, assert_same_outcomes,
                            assert_same_stats, make_session, twin)
from repro_torch.core.keys import reset_deprecation_warnings, warn_once
from repro_torch.core.validate import (BackendUnavailableError,
                                       CapacityError, DeadlineExceededError,
                                       InvalidInputError)
from repro_torch.launch import faults
from repro_torch.launch.faults import FaultInjected, FaultPlan
from repro_torch.launch.session import PlanCache
from test_faults import graph, requests

RADIUS = 2.0
N_STRIPS = 48


def session(pkg, validation="strict", **kw):
    return make_session(pkg, dict(radius=RADIUS, n_strips=N_STRIPS,
                                  validation=validation), **kw)


# ---------------------------------------------------------------------------
# the harness itself
# ---------------------------------------------------------------------------

def test_fault_plan_bookkeeping():
    assert faults.active() is None
    with FaultPlan(nan_requests=0) as fp:
        assert faults.active() is fp
        # the reference's registry is its own: nothing is armed there
        assert REF.faults.active() is None
        with pytest.raises(RuntimeError):
            with FaultPlan():
                pass  # pragma: no cover
    assert faults.active() is None
    pos = np.ones((3, 2), np.float32)
    assert faults.corrupt_request(pos) is pos
    faults.check_dispatch()
    faults.check_sharded()
    faults.check_probe()
    faults.release_hangs()
    assert faults.storm_overflow(["x"]) == ["x"]
    ref = REF.faults.FaultPlan()
    assert fp.injected.keys() == ref.injected.keys()
    assert fp._seen.keys() == ref._seen.keys()


@pytest.mark.parametrize("spec", [None, False, True, 3, np.int64(2),
                                  [0, 5, 5], range(3)])
def test_fault_plan_specs_match_reference(spec):
    got = FaultPlan(fail_dispatches=spec, nan_requests=spec)
    ref = REF.faults.FaultPlan(fail_dispatches=spec, nan_requests=spec)
    assert got.fail_dispatches == ref.fail_dispatches
    assert got.nan_requests == ref.nan_requests
    assert (got.slow_seconds, got.hang_seconds) == (ref.slow_seconds,
                                                   ref.hang_seconds)


def test_fault_plan_ordinals_are_thread_safe():
    n_threads, per_thread = 8, 50
    total = n_threads * per_thread
    fail_at = set(range(0, total, 7))
    failures = []
    with FaultPlan(fail_dispatches=fail_at) as fp:
        start = threading.Barrier(n_threads)

        def worker():
            start.wait()
            for _ in range(per_thread):
                try:
                    faults.check_dispatch()
                except FaultInjected:
                    failures.append(1)

        threads = [threading.Thread(target=worker)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert fp._seen["dispatches"] == total
    assert fp.injected["fail_dispatches"] == len(fail_at)
    assert len(failures) == len(fail_at)


def test_warn_once_is_thread_safe():
    reset_deprecation_warnings()
    n_threads, per_thread = 8, 25
    keys = [f"torch-race-key-{i}" for i in range(4)]
    start = threading.Barrier(n_threads)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")

        def worker():
            start.wait()
            for _ in range(per_thread):
                for k in keys:
                    warn_once(k, f"deprecated: {k}")

        threads = [threading.Thread(target=worker)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert len(rec) == len(keys)
    assert all(issubclass(w.category, DeprecationWarning) for w in rec)
    reset_deprecation_warnings()
    with warnings.catch_warnings(record=True) as rec2:
        warnings.simplefilter("always")
        warn_once(keys[0], "again")
    assert len(rec2) == 1
    reset_deprecation_warnings()


def test_plan_cache_is_thread_safe():
    cache = PlanCache(capacity=2)
    assert cache.get("a") is None and cache.misses == 1
    cache.put("a", "plan_a")
    cache.put("b", "plan_b")
    assert cache.get("a") == "plan_a" and cache.hits == 1
    cache.put("c", "plan_c")
    assert cache.get("b") is None
    assert cache.evictions == 1 and len(cache) == 2

    cache = PlanCache(capacity=8)
    n_threads, per_thread, key_space = 8, 200, 16
    start = threading.Barrier(n_threads)
    errors = []

    def worker(tid):
        rng = np.random.default_rng(tid)
        start.wait()
        try:
            for _ in range(per_thread):
                key = int(rng.integers(0, key_space))
                if cache.get(key) is None:
                    cache.put(key, key * 10)
        except Exception as err:        # pragma: no cover - failure path
            errors.append(err)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert cache.hits + cache.misses == n_threads * per_thread
    assert len(cache) <= 8
    for k in range(key_space):
        v = cache.get(k)
        assert v is None or v == k * 10


# ---------------------------------------------------------------------------
# poison quarantine
# ---------------------------------------------------------------------------

def test_nan_poison_fails_only_its_own_slot():
    reqs = requests()
    clean, clean_ref = twin(lambda pkg: session(pkg).evaluate_batch(reqs))
    assert_same_outcomes(clean, clean_ref)

    def run(pkg):
        sess = session(pkg)
        return sess.evaluate_batch(reqs), sess.stats

    (got, stats), (ref, ref_stats) = twin(run, nan_requests=2)
    assert_same_outcomes(got, ref)
    assert_same_stats(stats, ref_stats)
    assert isinstance(got[2].error, InvalidInputError)
    assert got[2].error.reason == "non_finite_positions"
    for i in (0, 1, 3):
        assert got[i] == clean[i]
    assert stats["quarantined"] == 1 and stats["requests"] == 4


def test_single_request_evaluate_raises_instead():
    pos, edges = graph()
    for pkg in PKGS:
        sess = session(pkg)
        with pkg.faults.FaultPlan(nan_requests=0):
            with pytest.raises(Exception) as info:
                sess.evaluate(pos, edges)
        assert type(info.value).__name__ == "InvalidInputError"
        assert sess.evaluate(pos, edges).ok


def test_validation_off_is_garbage_in_garbage_out():
    reqs = requests()

    def crash(pkg):
        sess = session(pkg, validation="off")
        with pkg.faults.FaultPlan(nan_requests=0):
            with pytest.raises(Exception) as info:
                sess.evaluate_batch(reqs)
        return type(info.value).__name__, sess.stats["quarantined"]

    assert crash(PORT) == crash(REF)
    assert crash(PORT)[1] == 0

    def garbage(pkg):
        sess = session(pkg, validation="off")
        sess.evaluate_batch(reqs)
        return sess

    def run(pkg):
        sess = garbage(pkg)
        with pkg.faults.FaultPlan(nan_requests=1):
            return sess.evaluate_batch(reqs), sess.stats

    (got, stats), (ref, ref_stats) = run(PORT), run(REF)
    # no typed errors: nobody noticed; the poisoned slot's garbage is the
    # reference's garbage (a NaN coordinate buckets as XLA converts it)
    assert all(s.ok for s in got)
    assert_same_outcomes(got, ref)
    assert_same_stats(stats, ref_stats)
    assert stats["quarantined"] == 0


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_non_finite_coordinates_bucket_like_reference(bad):
    """A non-finite coordinate converts to a strip or cell index as the
    reference's ``astype(int32)`` does under XLA (NaN -> 0, saturated
    infinities, int32 wraparound), on the single and batched strip
    builds and the cell grid."""
    import jax.numpy as jnp
    import torch
    from repro.core import grid as ref_grid
    from repro_torch.core import grid as t_grid
    pos, edges = graph()
    pos = pos.copy()
    pos[0, 0] = bad
    pos[5, 1] = bad
    tp, te = torch.from_numpy(pos), torch.from_numpy(edges)
    jp, je = jnp.asarray(pos), jnp.asarray(edges)
    for axis in (0, 1):
        ref = ref_grid.build_strip_segments(jp, je, N_STRIPS, 640, axis=axis)
        got = t_grid.build_strip_segments(tp, te, N_STRIPS, 640, axis=axis)
        refb = ref_grid.build_strip_segments_batched(jp[None], je, N_STRIPS,
                                                     640, axis=axis)
        gotb = t_grid.build_strip_segments_batched(tp[None], te, N_STRIPS,
                                                   640, axis=axis)
        for r, g in ((ref, got), (refb, gotb)):
            np.testing.assert_array_equal(np.asarray(g.strip),
                                          np.asarray(r.strip))
            np.testing.assert_array_equal(np.asarray(g.valid),
                                          np.asarray(r.valid))
            assert int(np.max(np.asarray(g.overflow))) == \
                int(np.max(np.asarray(r.overflow)))
    ref_c = ref_grid.cell_indices(jp, RADIUS, (0.0, 0.0), 15, 15)
    got_c = t_grid.cell_indices(tp, RADIUS, (0.0, 0.0), 15, 15)
    for r, g in zip(ref_c, got_c):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


# ---------------------------------------------------------------------------
# dispatch splitting
# ---------------------------------------------------------------------------

def test_failed_dispatch_splits_chunk_and_retries_members():
    reqs = requests()
    clean = session(PORT).evaluate_batch(reqs)

    def run(pkg):
        sess = session(pkg)
        return sess.evaluate_batch(reqs), sess.stats

    (got, stats), (ref, ref_stats) = twin(run, fail_dispatches=0)
    assert_same_outcomes(got, ref)
    assert_same_stats(stats, ref_stats)
    for g, c in zip(got, clean):
        assert g == c                # each member retried alone, unchanged
    assert (stats["dispatch_failures"], stats["chunk_splits"],
            stats["quarantined"]) == (1, 1, 0)


def test_persistent_dispatch_failure_quarantines_each_slot():
    reqs = requests()

    def run(pkg):
        sess = session(pkg)
        return sess.evaluate_batch(reqs), sess.stats, sess

    (got, stats, sess), (ref, ref_stats, _) = twin(run, fail_dispatches=True)
    assert_same_outcomes(got, ref)
    assert_same_stats(stats, ref_stats)
    for i, s in enumerate(got):
        assert isinstance(s.error, BackendUnavailableError)
        assert s.error.request_index == i
        assert isinstance(s.error.__cause__, FaultInjected)
    assert stats["quarantined"] == len(reqs)
    # and the session recovers the moment the fault clears
    assert all(s.ok for s in sess.evaluate_batch(reqs))


# ---------------------------------------------------------------------------
# bounded replan backoff
# ---------------------------------------------------------------------------

def test_overflow_storm_strict_surfaces_capacity_error():
    pos, edges = graph()

    def run(pkg):
        sess = session(pkg, max_replan_retries=2)
        out = sess.evaluate_batch([(pos, edges)])
        return out, sess.stats, sess

    (got, stats, sess), (ref, ref_stats, _) = twin(run, overflow_storms=True)
    assert_same_outcomes(got, ref)
    assert_same_stats(stats, ref_stats)
    assert stats["replans"] == 2 and stats["saturated"] == 1
    assert isinstance(got[0].error, CapacityError)
    assert got[0].error.overflow >= 1
    assert sess.evaluate(pos, edges).ok


def test_overflow_storm_sanitize_flags_saturation():
    pos, edges = graph()

    def run(pkg):
        sess = session(pkg, validation="sanitize", max_replan_retries=1)
        return sess.evaluate_batch([(pos, edges)]), sess.stats

    (got, stats), (ref, ref_stats) = twin(run, overflow_storms=True)
    assert_same_outcomes(got, ref)
    assert_same_stats(stats, ref_stats)
    assert got[0].ok and got[0].saturated
    assert got[0].flags["saturated"] is True
    assert stats["replans"] == 1 and stats["saturated"] == 1


def test_replan_growth_is_bounded():
    pos, edges = graph(n_v=120, n_e=360, seed=5)

    def run(pkg):
        sess = session(pkg, max_replan_retries=3, replan_growth=2.0,
                       growth_ceiling=3.0)
        assert min(sess.replan_growth ** 3, sess.growth_ceiling) == 3.0
        return [sess.evaluate(pos, edges)], sess.stats

    (got, stats), (ref, ref_stats) = twin(run)
    assert_same_outcomes(got, ref)
    assert_same_stats(stats, ref_stats)
    assert got[0].ok and got[0].overflow == 0


# ---------------------------------------------------------------------------
# health snapshot, degenerate graphs
# ---------------------------------------------------------------------------

def test_health_snapshot_single_host():
    pos, edges = graph()

    def run(pkg):
        sess = session(pkg)
        before = sess.health()
        sess.evaluate(pos, edges)
        return before, sess.health()

    (before, after), (ref_before, ref_after) = twin(run)
    for got, ref in ((before, ref_before), (after, ref_after)):
        assert set(got) == set(ref)
        assert_same_stats(got.pop("counters"), ref.pop("counters"))
        assert got == ref
    assert before["status"] == "ok"
    assert before["dispatch_mode"] == "single-host"
    assert before["mesh"] is None and before["validation"] == "strict"
    assert after["plans_cached"] == 1


def test_degenerate_graphs_end_to_end():
    pos, _ = graph(n_v=8, n_e=10)
    e0 = np.zeros((0, 2), np.int32)
    cases = [(pos, e0), (pos[:1], e0), (np.zeros((0, 2), np.float32), e0),
             (np.zeros((8, 2), np.float32),
              np.array([[0, 1], [2, 3], [4, 5]], np.int32))]

    def run(pkg):
        sess = session(pkg)
        out = [sess.evaluate(p, e) for p, e in cases]
        return out, [s.normalized() for s in out], sess.stats

    (got, norm, stats), (ref, ref_norm, ref_stats) = twin(run)
    assert_same_outcomes(got, ref)
    assert_same_outcomes(norm, ref_norm)
    assert_same_stats(stats, ref_stats)
    for s, n in zip(got, norm):
        assert s.ok and s.edge_crossing == 0
        assert np.isfinite(s.edge_length_variation)
        for f in ("node_occlusion", "edge_crossing", "minimum_angle",
                  "edge_length_variation", "edge_crossing_angle"):
            v = getattr(n, f)
            assert v is not None and 0.0 <= v <= 1.0, f
    assert got[3].edge_length_variation == 0.0


# ---------------------------------------------------------------------------
# abandoned-dispatch late completions are no-ops on shared state
# ---------------------------------------------------------------------------

def test_abandoned_dispatch_late_completion_publishes_nothing():
    """A straggler outlives the watchdog budget, is abandoned, then
    completes the real dispatch on its discarded worker: the late
    completion changes no counter."""
    pos, edges = graph()

    def run(pkg):
        session(pkg).evaluate(pos, edges)      # compile outside the guard
        sess = session(pkg, dispatch_timeout=0.5)
        sess.evaluate(pos, edges)
        with pkg.faults.FaultPlan(slow_dispatches=0, slow_seconds=1.0) as fp:
            out = sess.evaluate_batch([(pos, edges)])
        assert fp.injected["slow_dispatches"] == 1
        snapshot = sess.stats
        worker = sess._last_abandoned_worker
        assert worker is not None
        worker.join(timeout=30.0)
        assert not worker.is_alive()
        assert sess.stats == snapshot
        return out, snapshot, sess.evaluate(pos, edges)

    (got, stats, after), (ref, ref_stats, _) = run(PORT), run(REF)
    assert_same_outcomes(got, ref)
    assert_same_stats(stats, ref_stats)
    assert got[0].expired
    assert isinstance(got[0].error, DeadlineExceededError)
    assert stats["watchdog_abandoned"] == 1
    assert after.ok


def test_abandoned_hang_releases_late_and_stays_clean():
    """The watchdog releases an injected hang at abandonment; the
    discarded worker's FaultInjected dies with the worker."""
    pos, edges = graph()

    def run(pkg):
        session(pkg).evaluate(pos, edges)
        sess = session(pkg, dispatch_timeout=0.5)
        sess.evaluate(pos, edges)
        with pkg.faults.FaultPlan(hang_dispatches=0, hang_seconds=2.0) as fp:
            out = sess.evaluate_batch([(pos, edges)])
            abandoned_at = time.monotonic()
            assert fp.injected["hang_dispatches"] == 1
            worker = sess._last_abandoned_worker
            snapshot = sess.stats
            worker.join(timeout=10.0)
            assert not worker.is_alive()
            # released at abandonment, not after the 2 s safety bound
            assert time.monotonic() - abandoned_at < 1.0
        assert sess.stats == snapshot
        return out, snapshot, sess.evaluate(pos, edges)

    (got, stats, after), (ref, ref_stats, _) = run(PORT), run(REF)
    assert_same_outcomes(got, ref)
    assert_same_stats(stats, ref_stats)
    assert got[0].expired
    assert (stats["watchdog_abandoned"], stats["dispatch_failures"],
            stats["expired"], stats["quarantined"]) == (1, 1, 1, 0)
    assert after.ok
