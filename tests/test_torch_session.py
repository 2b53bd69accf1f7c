"""Overload-safe serving in the port, twinned with the reference session:
admission control (shed, cost budget), deadlines, cancellation, the slow
and the hung dispatch under the watchdog, and the unbounded session equal
to the baseline.  Each slot's outcome and every counter equal the
reference's under equal ``FaultPlan`` s (the twins of the session tests
of ``tests/test_overload.py``); the port's sessions run on the CPU.

Hangs are armed with ``hang_seconds`` of at most 2 and a
``dispatch_timeout`` of at most 0.5 s.
"""

import numpy as np
import pytest

from _serving_twins import (PORT, REF, assert_same_outcomes,
                            assert_same_stats, make_session, twin)
from repro_torch.core.validate import (CancelledError, DeadlineExceededError,
                                       OverloadedError)
from repro_torch.launch.admission import CancelToken
from repro_torch.launch.session import EvalSession
from test_overload import graph, requests

RADIUS = 2.0
N_STRIPS = 48
HANG_SECONDS = 2.0


def session(pkg, **kw):
    kw.setdefault("vertex_floor", 64)
    kw.setdefault("edge_floor", 64)
    return make_session(pkg, dict(radius=RADIUS, n_strips=N_STRIPS), **kw)


def served(reqs, plan=None, warm=False, knobs=None, **call):
    """A twin scenario: a fresh session (``knobs``), optionally warmed on
    ``reqs``, then one ``evaluate_batch(reqs, **call)``; returns the
    outcomes and the counters."""
    def run(pkg):
        if warm:
            # compile outside the guard (the reference's jit), then warm
            # the guarded session's plan cache
            session(pkg, **{k: v for k, v in (knobs or {}).items()
                            if k == "max_coalesce"}).evaluate_batch(reqs)
        sess = session(pkg, **(knobs or {}))
        if warm:
            sess.evaluate_batch(reqs)
        if plan is None:
            out = sess.evaluate_batch(reqs, **call)
        else:
            with pkg.faults.FaultPlan(**plan) as fp:
                out = sess.evaluate_batch(reqs, **call)
            for k in plan:
                if k.endswith("dispatches"):
                    assert fp.injected[k] == 1, k
        return out, sess.stats, sess

    (got, stats, sess), (ref, ref_stats, _) = run(PORT), run(REF)
    assert_same_outcomes(got, ref)
    assert_same_stats(stats, ref_stats)
    return got, stats, sess


# ---------------------------------------------------------------------------
# admission wired into the session
# ---------------------------------------------------------------------------

def test_overload_sheds_excess_only():
    reqs = requests(B=8)
    clean = session(PORT).evaluate_batch(reqs)
    out, stats, _ = served(reqs, knobs=dict(max_queue=5))
    shed = [i for i, r in enumerate(out) if r.shed]
    assert shed == [5, 6, 7]          # deadline-free: FIFO drop-tail
    for i in shed:
        err = out[i].error
        assert isinstance(err, OverloadedError)
        assert (err.request_index, err.queue_depth, err.bound) == (i, 8, 5)
    for i, r in enumerate(out):
        if not r.shed:
            assert r == clean[i]
    assert (stats["shed"], stats["queue_high_watermark"]) == (3, 5)


def test_overload_sheds_oldest_deadline_first():
    out, _, _ = served(requests(B=4), knobs=dict(max_queue=2),
                       deadline=[60.0, 1.0, 60.0, 2.0])
    assert [r.shed for r in out] == [False, True, False, True]
    assert out[0].ok and out[2].ok


def test_cost_budget_backpressure():
    # each request pads to the 64/128 buckets: cost 64 + 128 = 192
    out, stats, _ = served(requests(B=6), knobs=dict(max_queue_cost=384))
    assert sum(r.shed for r in out) == 4 and stats["shed"] == 4


def test_unbounded_session_is_bit_identical_to_baseline():
    reqs = requests(B=6)
    base = session(PORT).evaluate_batch(reqs)
    out, stats, _ = served(reqs)
    assert out == base
    assert (stats["shed"], stats["expired"], stats["cancelled"],
            stats["watchdog_abandoned"]) == (0, 0, 0, 0)


# ---------------------------------------------------------------------------
# deadlines + cancellation
# ---------------------------------------------------------------------------

def test_zero_deadline_expires_without_dispatching():
    reqs = requests()
    out, stats, sess = served(reqs, deadline=0.0)
    assert all(r.expired for r in out)
    for i, r in enumerate(out):
        assert isinstance(r.error, DeadlineExceededError)
        assert r.error.request_index == i
    assert stats["dispatches"] == 0          # no engine work burned
    assert stats["expired"] == len(reqs)
    assert all(r.ok for r in sess.evaluate_batch(reqs))


def test_generous_deadline_full_parity_and_steady_state():
    reqs = requests()
    clean = session(PORT).evaluate_batch(reqs)
    out, stats, sess = served(reqs, knobs=dict(default_deadline=300.0))
    assert out == clean
    out2 = sess.evaluate_batch(reqs)
    assert out2 == clean
    s = sess.stats
    assert (s["replans"], s["watchdog_abandoned"], s["plan_hits"]) == \
        (0, 0, 1)


def test_cancel_token_fails_only_its_slot():
    reqs = requests()
    clean = session(PORT).evaluate_batch(reqs)

    def run(pkg):
        toks = [pkg.admission.CancelToken() for _ in reqs]
        toks[1].cancel()
        sess = session(pkg)
        return sess.evaluate_batch(reqs, cancel=toks), sess.stats, sess

    (out, stats, sess), (ref, ref_stats, _) = run(PORT), run(REF)
    assert_same_outcomes(out, ref)
    assert_same_stats(stats, ref_stats)
    assert out[1].cancelled
    assert isinstance(out[1].error, CancelledError)
    assert out[1].error.request_index == 1
    for i in (0, 2, 3):
        assert out[i] == clean[i]
    assert stats["cancelled"] == 1
    with pytest.raises(ValueError):
        sess.evaluate_batch(reqs, cancel=[CancelToken()] * 2)


def test_slow_dispatch_expires_queued_neighbours():
    """An injected straggler burns the queue's clock: members of later
    chunks whose deadline passes while it runs are reaped."""
    out, stats, _ = served(requests(B=4), warm=True,
                           knobs=dict(max_coalesce=2),
                           plan=dict(slow_dispatches=0, slow_seconds=0.3),
                           deadline=[30.0, 30.0, 0.05, 0.05])
    assert out[0].ok and out[1].ok
    assert out[2].expired and out[3].expired
    assert (stats["expired"], stats["quarantined"]) == (2, 0)


# ---------------------------------------------------------------------------
# the hung-dispatch watchdog
# ---------------------------------------------------------------------------

def test_hung_dispatch_fails_only_its_chunk_and_queue_drains():
    reqs = requests(B=4)
    clean = session(PORT, max_coalesce=2).evaluate_batch(reqs)
    out, stats, sess = served(
        reqs, warm=True, knobs=dict(max_coalesce=2),
        plan=dict(hang_dispatches=0, hang_seconds=HANG_SECONDS),
        deadline=[0.5, 0.5, 30.0, 30.0])
    assert out[0].expired and out[1].expired
    assert isinstance(out[0].error, DeadlineExceededError)
    assert out[2] == clean[2] and out[3] == clean[3]
    assert (stats["watchdog_abandoned"], stats["expired"],
            stats["quarantined"]) == (1, 2, 0)
    # the hang was cut at its 0.5 s budget (plus scheduling slack under
    # load), not at its safety bound
    assert out[0].error.elapsed < 0.5 + 0.5
    assert all(r.ok for r in sess.evaluate_batch(reqs))


def test_dispatch_timeout_guards_without_deadlines():
    pos, edges = graph()
    out, stats, _ = served([(pos, edges)], warm=True,
                           knobs=dict(dispatch_timeout=0.5),
                           plan=dict(hang_dispatches=0,
                                     hang_seconds=HANG_SECONDS))
    assert out[0].expired
    assert stats["watchdog_abandoned"] == 1


# ---------------------------------------------------------------------------
# the breaker, health, and what is still to port
# ---------------------------------------------------------------------------

def test_session_exposes_breaker_state():
    def run(pkg):
        sess = session(pkg)
        h = sess.health()
        sess.restore_mesh()                 # idempotent manual override
        return h, sess.health()["breaker_state"]

    (h, after), (ref_h, ref_after) = twin(run)
    assert h["breaker_state"] == ref_h["breaker_state"] == "closed"
    assert after == ref_after == "closed"
    assert_same_stats(h["counters"], ref_h["counters"])
    assert h["counters"]["probes"] == h["counters"]["auto_restores"] == 0


def test_mesh_and_incremental_paths_are_not_ported_yet():
    cfg = PORT.keys.EvalConfig(radius=RADIUS)
    with pytest.raises(NotImplementedError, match="item 10"):
        EvalSession(cfg, device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="item 10"):
        EvalSession(PORT.keys.EvalConfig(backend="graph_sharded"),
                    device="cpu")
    # the breaker's probe_interval matters only with a mesh rung
    with pytest.raises(NotImplementedError, match="item 10"):
        EvalSession(cfg, device="cpu", probe_interval=8)
    with pytest.raises(NotImplementedError, match="item 8"):
        EvalSession(cfg, device="cpu", update_dirty_threshold=0.25)
    sess = EvalSession(cfg, device="cpu")
    pos, edges = graph()
    with pytest.raises(NotImplementedError, match="item 8"):
        sess.register_layout("a", pos, edges)
    with pytest.raises(NotImplementedError, match="item 8"):
        sess.update("a", [0], np.zeros((1, 2), np.float32))
    # the counters of the paths still to port are there, and stay 0
    s = sess.stats
    assert s["sharded_dispatches"] == s["graph_sharded_dispatches"] == 0
    assert s["updates"] == s["delta_hits"] == s["delta_fallbacks"] == 0


def test_session_rejects_the_non_session_backends_like_reference():
    for pkg in (PORT, REF):
        with pytest.raises(ValueError, match="backend must be"):
            pkg.session.EvalSession(pkg.keys.EvalConfig(backend="eager"),
                                    **pkg.device)
