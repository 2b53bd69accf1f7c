"""The port's copy of the admission policy against the reference's:
``resolve_deadlines``, ``shed_order``, ``admit``, ``CancelToken`` and the
``CircuitBreaker`` state machine give equal outputs on equal inputs,
including a property test of the same shed set for the same arrivals.
Pure Python on both sides: no engine, no device.
"""

import math

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

from repro.launch import admission as ref_adm
from repro_torch.launch import admission as t_adm


def members(deadlines, costs=None):
    return [dict(index=i, deadline=d, cost=1 if costs is None else costs[i])
            for i, d in enumerate(deadlines)]


def split(adm, deadlines, costs, **bounds):
    admitted, shed = adm.admit(members(deadlines, costs), **bounds)
    return [m["index"] for m in admitted], [m["index"] for m in shed]


def test_module_constants_and_clock():
    assert (t_adm.CLOSED, t_adm.OPEN, t_adm.HALF_OPEN) == \
        (ref_adm.CLOSED, ref_adm.OPEN, ref_adm.HALF_OPEN)
    assert t_adm.clock is ref_adm.clock      # both read time.monotonic


@pytest.mark.parametrize("args", [
    (3, None, None, 100.0),
    (2, None, 5.0, 100.0),
    (2, 1.0, 5.0, 100.0),
    (2, 3, None, 7.5),
    (3, [1.0, None, 2.0], 5.0, 100.0),
    (0, [], None, 0.0),
])
def test_resolve_deadlines_matches_reference(args):
    assert t_adm.resolve_deadlines(*args) == ref_adm.resolve_deadlines(*args)


def test_resolve_deadlines_rejects_a_wrong_length_like_reference():
    for adm in (ref_adm, t_adm):
        with pytest.raises(ValueError, match="1 deadlines for 2"):
            adm.resolve_deadlines(2, [1.0], None, 0.0)


@pytest.mark.parametrize("deadlines,costs,bounds", [
    ([None, 5.0, 1.0], None, {}),
    ([5.0, None, 1.0, 5.0, 2.0], None, dict(max_queue=3)),
    ([1.0, 2.0, 3.0], [10, 10, 10], dict(max_cost=15)),
    ([None], [99], dict(max_cost=10)),
    ([None] * 8, None, dict(max_queue=5)),
    ([4.0, None, 4.0, 1.0], [3, 9, 1, 5], dict(max_queue=3, max_cost=6)),
])
def test_admit_and_shed_order_match_reference(deadlines, costs, bounds):
    assert t_adm.shed_order(members(deadlines, costs)) == \
        ref_adm.shed_order(members(deadlines, costs))
    assert split(t_adm, deadlines, costs, **bounds) == \
        split(ref_adm, deadlines, costs, **bounds)


def test_admit_seeded_sequences_match_reference():
    rng = np.random.default_rng(42)
    for _ in range(200):
        n = int(rng.integers(0, 30))
        deadlines = [None if rng.random() < 0.3 else float(rng.uniform(0, 9))
                     for _ in range(n)]
        costs = [int(rng.integers(1, 20)) for _ in range(n)]
        mq = None if rng.random() < 0.2 else int(rng.integers(1, 10))
        mc = None if rng.random() < 0.5 else int(rng.integers(5, 100))
        got = split(t_adm, deadlines, costs, max_queue=mq, max_cost=mc)
        assert got == split(ref_adm, deadlines, costs, max_queue=mq,
                            max_cost=mc)
        # replaying the same arrivals sheds the same set
        assert got == split(t_adm, deadlines, costs, max_queue=mq,
                            max_cost=mc)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.one_of(st.none(),
                          st.floats(min_value=0.0, max_value=100.0),
                          st.sampled_from([math.inf])),
                max_size=40),
       st.one_of(st.none(), st.integers(min_value=1, max_value=12)),
       st.one_of(st.none(), st.integers(min_value=1, max_value=200)))
def test_property_same_shed_set_as_reference(deadlines, max_queue, max_cost):
    """For any arrival sequence and bounds both packages shed the same
    set, in arrival order, and the admitted count respects the bound."""
    costs = [(i * 7) % 13 + 1 for i in range(len(deadlines))]
    got = split(t_adm, deadlines, costs, max_queue=max_queue,
                max_cost=max_cost)
    assert got == split(ref_adm, deadlines, costs, max_queue=max_queue,
                        max_cost=max_cost)
    admitted, shed = got
    if max_queue is not None:
        assert len(admitted) <= max_queue
    assert sorted(admitted + shed) == list(range(len(deadlines)))


def test_cancel_token_matches_reference():
    for adm in (ref_adm, t_adm):
        tok = adm.CancelToken()
        assert not tok.cancelled and repr(tok) == "CancelToken(cancelled=False)"
        tok.cancel()
        assert tok.cancelled and repr(tok) == "CancelToken(cancelled=True)"


def drive(adm, interval, script):
    """Run one breaker through ``script`` and record its observable state
    after every step."""
    b = adm.CircuitBreaker(probe_interval=interval)
    trace = []
    for step in script:
        out = getattr(b, step)()
        trace.append((step, out, b.state, b.probing, b.counters, repr(b)))
    return trace


BREAKER_SCRIPTS = {
    "cycle": ["allow", "record_failure", "allow", "record_fallback_success",
              "record_fallback_success", "record_fallback_success", "allow",
              "record_success", "allow"],
    "rejected_probe": ["record_failure", "record_fallback_success",
                       "record_fallback_success", "allow", "record_failure",
                       "record_fallback_success", "record_fallback_success",
                       "allow", "record_success"],
    "force_close": ["record_failure", "force_close", "allow",
                    "record_fallback_success", "record_success"],
}


@pytest.mark.parametrize("name", sorted(BREAKER_SCRIPTS))
@pytest.mark.parametrize("interval", [0, 1, 3])
def test_circuit_breaker_matches_reference(name, interval):
    script = BREAKER_SCRIPTS[name]
    assert drive(t_adm, interval, script) == \
        drive(ref_adm, interval, script)


def test_circuit_breaker_random_walks_match_reference():
    steps = ["allow", "record_success", "record_failure",
             "record_fallback_success", "force_close"]
    rng = np.random.default_rng(3)
    for _ in range(50):
        script = [steps[i] for i in rng.integers(0, len(steps), 30)]
        interval = int(rng.integers(1, 5))
        assert drive(t_adm, interval, script) == \
            drive(ref_adm, interval, script)
