"""The port's span recorder (:mod:`repro_torch.spans`): nesting, the
off mode, the bounded buffer, the span tree of each entry point the
benchmark's cells call, results unchanged by recording, and the clock
shared with ``torch.profiler``'s Chrome trace."""

import json
import threading

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.api import EvalConfig, Evaluator, evaluate_exact
from repro_torch.graphs.datasets import random_edges
from repro_torch.graphs.layouts import random_layout
from repro_torch.launch.session import EvalSession

N_V, N_E = 60, 120
CFG = EvalConfig(radius=0.5, n_strips=8)
ENGINE = ["engine.upload", "engine.occlusion", "engine.min_angle",
          "engine.edge_length", "engine.strips", "engine.strips"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def recorder_off():
    spans.disable()
    yield
    spans.disable()


@pytest.fixture(scope="module")
def graph():
    """The smoke graph, after one call of each entry point: a process's
    first batch and search spend a second or two in torch's lazy
    imports, which the cases below should not time."""
    edges = random_edges(N_V, N_E, seed=0)
    pos = np.asarray(random_layout(N_V, seed=0), np.float32)
    for entry in TREES:
        entry((pos, edges))
    return pos, edges


def tree(drained):
    """``[(name, [child trees...]), ...]`` of the roots, in start order."""
    kids = {}
    for s in sorted(drained.spans, key=lambda s: s.start_ns):
        kids.setdefault(s.parent, []).append(s)

    def sub(parent):
        return [(s.name, sub(s.id)) for s in kids.get(parent, [])]
    return sub(None)


def leaves(names):
    return [(n, []) for n in names]


def test_nesting_parent_call_and_thread():
    spans.enable()
    with spans.span("a"):
        with spans.span("a.b"):
            with spans.span("a.b.c"):
                pass
        with spans.span("a.d"):
            pass
    worker = threading.Thread(target=lambda: spans.span("w").__enter__()
                              .__exit__(None, None, None))
    worker.start()
    worker.join(timeout=10)
    assert not worker.is_alive()
    got = {s.name: s for s in spans.drain().spans}
    a, b, c, d, w = (got[n] for n in ("a", "a.b", "a.b.c", "a.d", "w"))
    assert a.parent is None and b.parent == a.id and c.parent == b.id
    assert d.parent == a.id and {a.call, b.call, c.call, d.call} == {a.id}
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns
    assert b.end_ns <= d.start_ns <= d.end_ns <= a.end_ns
    assert a.thread == threading.get_native_id() != w.thread
    assert w.parent is None and w.call == w.id


def test_off_records_nothing_and_hands_out_one_noop():
    assert spans.span("a") is spans.span("b")
    with spans.span("a"):
        pass
    assert spans.drain() == spans.Drained((), 0)
    spans.enable()
    with spans.span("a"):
        pass
    spans.disable()
    with spans.span("b"):
        pass
    spans.enable()
    assert spans.drain() == spans.Drained((), 0)


def test_drain_clears_and_the_buffer_counts_what_it_drops():
    spans.enable()
    for _ in range(spans.CAPACITY + 3):
        with spans.span("x"):
            pass
    got = spans.drain()
    assert len(got.spans) == spans.CAPACITY and got.dropped == 3
    assert spans.drain() == spans.Drained((), 0)
    with spans.span("y"):
        pass
    assert [s.name for s in spans.drain().spans] == ["y"]


def _exact(graph):
    return evaluate_exact(*graph, config=CFG, device="cpu")


def _batch(graph):
    pos, edges = graph
    batch = np.stack([pos, pos + np.float32(0.01)])
    return Evaluator(CFG, device="cpu").evaluate_batch(batch, edges)


def _search(graph):
    return Evaluator(CFG, device="cpu").search(
        *graph, steps=2, restarts=2, rescore_every=2, seed=3)


RESCORE = ("search.rescore", leaves(ENGINE + ["scores.fetch"]))
STEP = ("search.step", [("search.step.forward", leaves(["engine.upload"])),
                        ("search.step.backward", []),
                        ("search.step.adamw", [])])
TREES = {
    _exact: [("exact", leaves(["exact.occlusion", "exact.min_angle",
                               "exact.edge_length", "exact.crossing",
                               "exact.crossing_angle"]))],
    _batch: [("batch", leaves(["batch.validate", "batch.plan"] + ENGINE
                              + ["scores.fetch"]))],
    _search: [("search", [("search.init", []), ("search.plan", []),
                          ("engine.upload", []), RESCORE,
                          ("search.record", []), STEP, STEP, RESCORE,
                          ("search.record", [])])],
}


def _same(a, b):
    """Equal, bit for bit, through nested tuples, lists and arrays."""
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (np.ndarray, np.generic)):
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
    else:
        assert a == b or (a != a and b != b)


@pytest.mark.parametrize("entry", list(TREES), ids=["exact", "batch",
                                                    "search"])
def test_entry_points_give_their_span_tree_and_the_same_result(graph,
                                                                entry):
    off = entry(graph)
    spans.enable()
    on = entry(graph)
    drained = spans.drain()
    assert tree(drained) == TREES[entry] and drained.dropped == 0
    _same(on, off)


def test_session_serving_and_drag_spans(graph):
    pos, edges = graph
    sess = EvalSession(CFG, device="cpu", update_dirty_threshold=1.0)
    sess.register_layout("drag", pos, edges)
    spans.enable()
    sess.evaluate(pos, edges)
    sess.update("drag", [0], [pos[0] + np.float32(0.01)])
    got = tree(spans.drain())
    prepare = ("session.prepare", leaves(["session.prepare.validate",
                                          "session.prepare.hash"]))
    dispatch = ("session.dispatch", leaves(ENGINE + ["scores.fetch"]))
    update = ("session.update", leaves(["session.update.probe",
                                        "session.update.delta",
                                        "scores.fetch"]))
    assert got == [prepare, dispatch, update]
    assert sess.stats["delta_hits"] == 1


def test_spans_land_on_the_profilers_trace_clock(tmp_path):
    """A span around a ``record_function`` block holds that event at
    ``ts + baseTimeNanoseconds / 1000`` (within 1 ms)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    spans.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("outer"):
            with record_function("inner"):
                torch.ones(8).sum()
    outer, = spans.drain().spans
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    ev, = [e for e in doc["traceEvents"] if e.get("name") == "inner"
           and e.get("ph") == "X"]
    start = float(ev["ts"]) + doc["baseTimeNanoseconds"] / 1e3
    end = start + float(ev["dur"])
    assert outer.start_ns / 1e3 - 1e3 <= start
    assert end <= outer.end_ns / 1e3 + 1e3
