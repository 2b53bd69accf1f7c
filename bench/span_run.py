#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once with the program's spans
(:mod:`repro_torch.spans`) recorded, and print what they show.

    python3 bench/span_run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1> --spans <0|1>

From the root of a checkout, on the card.  The cell is found, set up,
warmed and checked as ``bench/run.py`` does it (:mod:`bench.harness`);
the window differs in two things: with ``--spans 1`` the recorder is on
from just before the window to its end, and traced, the profiler's
Chrome trace is read by :mod:`bench.span_reader` as well.  The line
printed holds, besides the cell's metrics and ``correct``:

* the span metrics of :data:`SPAN_METRICS` that the cell has (those
  that need a trace only when traced);
* with spans: spans a call, and the cost of one span, on and off (ns,
  the host's clock over a loop of empty spans);
* traced with spans: the share of device-busy time launched inside
  some span, device-busy and idle seconds by innermost span, and the
  longest idle gaps named ``<span>/<runtime call>``.

``bench/harness.py``'s ``measure`` records no spans: until it does,
this script is how the span metrics are read.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# the metrics read from spans, and the cell each is read in
SPAN_METRICS = {
    "crossing_sweeps_ms.exact": "epinions.exact",
    "front_door_idle_ms.batch": "local100k.batch64",
    "occlusion_device_ms.batch": "local100k.batch64",
    "strips_device_ms.batch": "local100k.batch64",
    "prep_ms.search": "local100k.search",
    "rescore_ms.search": "local100k.search",
    "step_idle_ms.search": "local100k.search",
}
ROOTS = ("exact", "batch", "search")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    return ap.parse_args(argv)


def measure(call, seconds, trace, record, run):
    """``bench.harness.measure``, with the span recorder on over the
    window when ``record``; traced, also sets ``run.span_trace``."""
    import torch
    from repro_torch import spans
    outputs = []
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
        torch.cuda.synchronize()
    limit = run.cell.traffic.get("trace_calls") if trace else None
    if record:
        spans.enable()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds and (
            limit is None or len(outputs) < limit):
        t = time.perf_counter()
        try:
            out = call(len(outputs))
        except Exception as exc:  # a failed call, counted
            print(f"call {len(outputs)} failed: {exc!r}", file=sys.stderr)
            out = None
            run.failed += 1
        run.latencies.append(time.perf_counter() - t)
        outputs.append(out)
        if out is not None:
            run.units += call.units(out)
    run.window_s = time.perf_counter() - t0
    run.attempted = len(outputs)
    if record:
        run.spans = spans.drain()
        spans.disable()
    if prof is not None:
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        from bench.span_reader import read_span_trace
        from bench.trace_reader import read_chrome_trace
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            run.trace = read_chrome_trace(path)
            run.span_trace = read_span_trace(path)
    return outputs


def span_cost_ns(n=100_000):
    """ns of one empty ``with span(...)`` block, recorder on and off."""
    from repro_torch import spans
    out = {}
    for on in (True, False):
        if on:
            spans.enable()
        t = time.perf_counter_ns()
        for _ in range(n):
            with spans.span("cost"):
                pass
        out["on" if on else "off"] = (time.perf_counter_ns() - t) / n
        spans.disable()
    return out


def breakdown(run):
    """What the spans show of a run: spans a call, and traced, where the
    device's busy and idle time went."""
    from bench import span_reader as sr
    placed = sr.spans_of(run)
    calls = sum(placed.count(r) for r in ROOTS)
    out = {"spans": len(placed.by_id), "dropped": run.spans.dropped,
           "spans_per_call": len(placed.by_id) / calls if calls else None}
    got = sr.of(run)
    if got is None:
        return out
    trace, placed = got
    out["launched_in_spans"] = sr.launched_share(trace, placed)
    total = run.trace.busy_s()
    engine = [n for n in {s.name for s in placed.by_id.values()}
              if n.startswith("engine.")]
    if engine and total:
        out["engine_busy_share"] = sr.busy_us(trace, placed,
                                              engine) * 1e-6 / total
    out["busy_s_by_span"] = _top(sr.busy_by_span(trace, placed))
    out["idle_s_by_span"] = _top(sr.idle_by_span(trace, placed))
    out["idle_gaps"] = sr.named_gaps(trace, placed)
    return out


def _top(by_name, k=16):
    return sorted(([n, v] for n, v in by_name.items() if v > 0),
                  key=lambda x: -x[1])[:k]


def main(argv=None):
    args = parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build"
                                             / "torch_extensions")
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [
        p for p in sys.path if Path(p or ".").resolve() != here]
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from bench import harness
    from bench.trace_reader import kernel_names

    if not torch.cuda.is_available():
        print("span_run: needs a CUDA device", file=sys.stderr)
        return 3
    cell = harness.find_cell(ROOT, args.workload)
    run = harness.Run(cell=cell, seed=args.seed)
    call = harness.make_call(cell, args.seed, torch.device("cuda"))
    call.warm()
    torch.cuda.synchronize()
    run.setup_s = time.perf_counter() - T_START
    outputs = measure(call, args.seconds, bool(args.trace),
                      bool(args.spans), run)
    if run.latencies:
        q = np.percentile(np.asarray(run.latencies) * 1e3, [0, 50, 95, 100])
        print("latency ms min/p50/p95/max " + " ".join(
            f"{v:.3f}" for v in q), file=sys.stderr)
    call.release(outputs)
    torch.cuda.empty_cache()
    checks = harness.check(call, outputs, run, cell.limits)
    ok = checks is not None and all(v <= lim for v, lim in checks.values())
    run.kernels = kernel_names(ROOT / "src" / "repro_torch" / "kernels"
                               / "csrc")
    names = [m["name"] for m in (cell.per_layer if args.trace
                                 else cell.end_to_end)]
    names += [n for n, w in SPAN_METRICS.items() if w == cell.name]
    metrics = {}
    for name in names:
        value = harness.reader(name)(run)
        if value is not None:
            metrics[name] = value
    result = {"workload": cell.name, "seed": args.seed,
              "trace": args.trace, "spans": args.spans,
              "correct": bool(ok and run.failed == 0),
              "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "card": harness.card()}
    if args.spans:
        result["span_cost_ns"] = span_cost_ns()
        result["breakdown"] = breakdown(run)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
