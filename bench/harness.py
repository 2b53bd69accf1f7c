"""One run of one cell: find it by name, set it up, measure a closed
loop of calls for ``--seconds``, check a sample of its answers against
the plain reference, read its metrics, print the result line.

What a cell is made of, each found by name:

* ``BENCHMARK.json`` ``workloads`` entry: its configuration, traffic mix
  and chips;
* ``bench/configs/<config>.json`` (the file ``configs[].file`` names):
  the deployment -- graph, layouts, ``EvalConfig``;
* ``bench/traffic/<traffic>.json``: the call (``bench/calls/<call>.py``)
  and its parameters;
* ``bench/limits/<cell>.json``: the limit of each number compared;
* ``bench/metrics/<metric>.py``: one reader per metric, ``read(run)``
  returning the value or ``None`` when it finds nothing to read.

A run exits with a code other than 0, and prints no result, when the
card is missing, the cell is unknown, or the process holds JAX or the
JAX package once the window has closed.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from bench import find

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _json(path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def find_cell(root: Path, name: str) -> Cell:
    spec = _json(root / "BENCHMARK.json")
    cell = [w for w in spec["workloads"] if w["name"] == name]
    if not cell:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cell[0]
    cfg = [c for c in spec["configs"] if c["name"] == w["config"]][0]
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return Cell(name=name, chips=int(w["chips"]),
                config=_json(root / cfg["file"]),
                traffic=_json(root / "bench" / "traffic"
                              / f"{w['traffic']}.json"),
                limits=_json(root / "bench" / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def reader(metric: str):
    """The ``read`` function of ``bench/metrics/<metric>.py``."""
    return find.module("metrics", metric).read


def make_call(cell: Cell, seed: int, device):
    """The ``Call`` of ``bench/calls/<call>.py`` that the cell's traffic
    names, set up for ``seed``."""
    cls = find.module("calls", cell.traffic["call"]).Call
    return cls(cell.config, cell.traffic, seed, device)


@dataclass
class Run:
    """What a run measured; the metric readers' one argument."""

    cell: Cell
    seed: int
    setup_s: float = 0.0
    window_s: float = 0.0
    latencies: list = field(default_factory=list)   # seconds, per call
    attempted: int = 0
    failed: int = 0
    units: int = 0          # layouts, or search steps, completed
    trace: object = None    # bench.trace_reader.DeviceTrace
    work: dict = None       # pair classes of one call (the reference's)
    kernels: list = field(default_factory=list)     # hand-written names

    @property
    def completed(self):
        return self.attempted - self.failed


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card():
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def measure(call, seconds, trace: bool, run: Run):
    """The closed loop: one client, the next call when the last has
    returned, until ``seconds`` have passed; a call that raises counts
    as failed.  Returns the outputs (``None`` for a failed call).

    Traced, the window also ends after the traffic's ``trace_calls``
    calls, which keeps the trace to a size that reads back in seconds.
    The profiler records the device's activity and the host's CUDA
    runtime calls, and no host operators, which would stretch the
    window; a device synchronisation on each side of the window marks
    its ends in the trace.  Tracing needs the card."""
    import torch
    outputs = []
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
        torch.cuda.synchronize()
    limit = run.cell.traffic.get("trace_calls") if trace else None
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
    if prof is not None:
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        from bench.trace_reader import read_chrome_trace
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            run.trace = read_chrome_trace(path)
    return outputs


def check(call, outputs, run: Run, limits: dict):
    """Compare one completed call, drawn from the seed, with the
    reference.  Returns ``{name: (value, limit)}``, or ``None`` when no
    call completed."""
    done = [i for i, o in enumerate(outputs) if o is not None]
    if not done:
        return None
    rng = np.random.default_rng([run.seed % (1 << 63), 7])
    pick = call.pick(done, rng) if hasattr(call, "pick") else [
        int(rng.choice(done))]
    gaps, run.work = call.check(outputs, pick)
    return {name: (gaps[name], limits[name]) for name in limits}


def run_cell(root: Path, cell: Cell, args, *, device="cuda",
             t_start=None):
    """Set up, measure, check and read one cell.  Returns ``(result
    dict, checks)``; the caller prints them."""
    import torch
    from bench.trace_reader import kernel_names

    t_start = time.perf_counter() if t_start is None else t_start
    run = Run(cell=cell, seed=args.seed)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    t_init = time.perf_counter()
    call = make_call(cell, args.seed, dev)
    call.warm()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    call.phases.mark("warm")
    run.setup_s = time.perf_counter() - t_start
    phases = {"process": t_init - t_start, **call.phases}
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in phases.items())
          + " s", file=sys.stderr)
    outputs = measure(call, args.seconds, bool(args.trace), run)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if run.latencies:
        q = np.percentile(np.asarray(run.latencies) * 1e3,
                          [0, 50, 90, 95, 99, 100])
        print("latency ms min/p50/p90/p95/p99/max " + " ".join(
            f"{v:.3f}" for v in q), file=sys.stderr)
    # the program's state goes before the reference runs
    call.release(outputs)
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    try:
        checks = check(call, outputs, run, cell.limits)
    except Exception as exc:  # an answer the reference cannot read
        print(f"check failed: {exc!r}", file=sys.stderr)
        checks = None
    print(f"check took {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    ok = checks is not None and all(v <= lim for v, lim in checks.values())
    if checks is not None and not ok:
        run.failed += 1
    run.kernels = kernel_names(root / "src" / "repro_torch" / "kernels"
                               / "csrc")
    wanted = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if on_card else dev.type,
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok and run.failed == 0),
              "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": device_info}
    if args.trace and run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s()
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    return result, checks


def main(args, *, root: Path, t_start: float):
    import torch
    try:
        cell = find_cell(root, args.workload)
    except (KeyError, OSError, IndexError) as exc:
        print(f"bench: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result, checks = run_cell(root, cell, args, t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"bench: the process holds {bad} after the window",
              file=sys.stderr)
        return 4
    result["card"] = card()
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in (checks or {}).items()}
    for k, (v, lim) in (checks or {}).items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    if checks is None:
        print("check none: no call could be compared", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
