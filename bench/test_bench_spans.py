"""The span reader lays the program's spans on a profiler trace by the
trace's base time, puts device ops down to their launching span through
``correlation``, and the seven span metrics read a synthetic run; on the
card, a span and the trace's own event of one call agree."""

import json
import types

import pytest

from bench import harness, span_reader, trace_reader
from repro_torch import spans

BASE = 1_700_000_000_000_000_000      # ns: the trace's baseTimeNanoseconds
METRICS = {
    "crossing_sweeps_ms.exact": 0.023,
    "front_door_idle_ms.batch": 0.039,
    "occlusion_device_ms.batch": 0.030,
    "strips_device_ms.batch": 0.003,
    "prep_ms.search": 0.010,
    "rescore_ms.search": 0.010,
    "step_idle_ms.search": 0.015,
}


def _x(cat, name, ts, dur, corr=None, tid=1):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
          "tid": tid}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


# times in microseconds from BASE; tid 2 launches k2 with no span open
# there, as autograd's worker thread does
EVENTS = [
    _x("cuda_runtime", "cudaDeviceSynchronize", 0, 1, 100),
    _x("cuda_runtime", "cudaDeviceSynchronize", 199, 1, 101),
    _x("cuda_runtime", "cudaLaunchKernel", 5, 1, 1),
    _x("cuda_runtime", "cudaLaunchKernel", 12, 1, 2, tid=2),
    _x("cuda_runtime", "cudaLaunchKernel", 22, 1, 6),
    _x("cuda_runtime", "cudaMemcpyAsync", 55, 10, 3),
    _x("cuda_runtime", "cudaLaunchKernel", 162, 1, 5),
    _x("kernel", "k1", 10, 20, 1),
    _x("kernel", "k2", 40, 10, 2),
    _x("gpu_memcpy", "m3", 60, 10, 3),
    _x("kernel", "k4", 80, 5, 4),
    _x("kernel", "k6", 86, 3, 6),
    _x("kernel", "k5", 165, 5, 5),
]
# (name, start, end, parent name) on thread 1
SPANS = [
    ("batch", 2, 95, None), ("batch.validate", 2, 4, "batch"),
    ("engine.occlusion", 4, 20, "batch"), ("engine.strips", 20, 25, "batch"),
    ("scores.fetch", 50, 90, "batch"),
    ("exact", 100, 130, None), ("exact.crossing", 105, 115, "exact"),
    ("exact.crossing_angle", 115, 128, "exact"),
    ("search", 140, 190, None), ("search.init", 140, 145, "search"),
    ("search.plan", 145, 150, "search"),
    ("search.rescore", 150, 160, "search"),
    ("search.step", 160, 180, "search"),
]


def _drained():
    ids = {name: i for i, (name, *_) in enumerate(SPANS)}
    out = []
    for i, (name, s, e, parent) in enumerate(SPANS):
        pid = None if parent is None else ids[parent]
        root = i if parent is None else ids[parent]
        out.append(spans.Span(i, name, BASE + s * 1000, BASE + e * 1000,
                              pid, root, 1))
    return spans.Drained(tuple(out), 0)


@pytest.fixture
def traced(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": EVENTS,
                                "baseTimeNanoseconds": BASE}))
    trace = span_reader.read_span_trace(path)
    return trace, span_reader.Placed(_drained().spans, trace.base_ns), path


def test_spans_land_on_the_trace_by_its_base_time(traced):
    trace, placed, _ = traced
    assert trace.base_ns == BASE and trace.window == (0.0, 200.0)
    at = {placed.by_id[i].name: v for i, v in placed.at.items()}
    assert at["batch"] == (2.0, 95.0) and at["search.step"] == (160.0, 180.0)
    assert placed.count("engine.strips") == 1
    assert placed.length_us(("exact.crossing", "search.plan")) == 15.0


def test_device_ops_go_to_their_launching_span(traced):
    trace, placed, _ = traced
    launch = {n: l for n, _, _, l in trace.device}
    assert launch["k1"] == (5.0, 1) and launch["k4"] is None
    assert span_reader.busy_us(trace, placed, ("engine.occlusion",)) == 30.0
    assert span_reader.busy_us(trace, placed, ("batch",)) == 43.0
    assert span_reader.busy_by_span(trace, placed) == pytest.approx({
        "engine.occlusion": 30e-6, "engine.strips": 3e-6,
        "scores.fetch": 10e-6, "search.step": 5e-6, "-": 5e-6})
    assert span_reader.launched_share(trace, placed) == pytest.approx(48 / 53)


def test_idle_time_inside_and_outside_span_sets(traced):
    trace, placed, _ = traced
    assert span_reader.idle_us(trace, placed, ("batch",), (
        "engine.occlusion", "engine.strips")) == 39.0
    assert span_reader.idle_us(trace, placed, ("search.step",)) == 15.0
    by = span_reader.idle_by_span(trace, placed)
    assert by == pytest.approx({
        "batch": 15e-6, "batch.validate": 2e-6, "engine.occlusion": 6e-6,
        "engine.strips": 0.0, "scores.fetch": 22e-6, "exact": 7e-6,
        "exact.crossing": 10e-6, "exact.crossing_angle": 13e-6,
        "search": 10e-6, "search.init": 5e-6, "search.plan": 5e-6,
        "search.rescore": 10e-6, "search.step": 15e-6, "-": 27e-6})
    assert sum(by.values()) == pytest.approx(147e-6)


def test_gap_names_with_spans_and_without(traced):
    trace, placed, path = traced
    assert span_reader.named_gaps(trace, placed, k=3) == [
        ["scores.fetch/python", pytest.approx(76e-6)],
        ["search.step/python", pytest.approx(30e-6)],
        ["-/cudaDeviceSynchronize", pytest.approx(10e-6)]]
    # with no spans, the names and values are trace_reader's own
    plain = trace_reader.read_chrome_trace(path).idle_gaps()
    bare = span_reader.named_gaps(trace, span_reader.Placed(()))
    assert bare == [["-/" + n, v] for n, v in plain]


def test_span_metrics_read_a_traced_run_and_nothing_without_spans(traced):
    trace, _, _ = traced
    run = types.SimpleNamespace(spans=_drained(), span_trace=trace)
    untraced = types.SimpleNamespace(spans=_drained())
    bare = harness.Run(cell=None, seed=0)
    for name, want in METRICS.items():
        read = harness.reader(name)
        assert read(run) == pytest.approx(want), name
        assert read(bare) is None, name
        needs_trace = name not in ("crossing_sweeps_ms.exact",
                                   "prep_ms.search", "rescore_ms.search")
        assert (read(untraced) is None) == needs_trace, name


@pytest.mark.gpu
def test_spans_share_the_clock_of_the_cuda_trace(card, tmp_path):
    """Spans around ``torch.cuda.synchronize()`` hold the trace's
    ``cudaDeviceSynchronize`` of each call, the median gap at each end
    within 20 us (the first calls of a process pay Python's one-time
    costs between the span's stamp and the runtime call)."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.ones(1, device=card)
    torch.cuda.synchronize()
    spans.enable()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            for _ in range(10):
                with spans.span("sync"):
                    torch.cuda.synchronize()
                torch.ones(1 << 20, device=card).sum()
            torch.cuda.synchronize()
        got = spans.drain().spans
    finally:
        spans.disable()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base = doc["baseTimeNanoseconds"]
    syncs = [(float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
             for ev in doc["traceEvents"]
             if ev.get("name") == trace_reader.SYNC
             and ev.get("cat") == "cuda_runtime"]
    leads, lags = [], []
    for sp in got:
        s, e = (sp.start_ns - base) / 1e3, (sp.end_ns - base) / 1e3
        # the call's own event overlaps its span the most
        t0, t1 = max(syncs, key=lambda ev: min(ev[1], e) - max(ev[0], s))
        assert s <= t0 and t1 <= e, (s, e, t0, t1)
        leads.append(t0 - s)
        lags.append(e - t1)
    print(f"leads {leads} us, lags {lags} us")
    assert statistics.median(leads) <= 20 and statistics.median(lags) <= 20
