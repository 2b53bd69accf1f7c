"""The harness finds every piece BENCHMARK.json names, loads neither JAX
nor the JAX package, refuses to run without a card, and reads traces."""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from bench import find, harness, trace_reader

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_benchmark_json_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [m["name"] for m in METRICS] + [
        w["name"] for w in SPEC["workloads"]] + [
        c["name"] for c in SPEC["configs"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(m["name"] for m in METRICS)) == len(METRICS)
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_harness_finds_every_piece_of_a_cell(workload):
    cell = harness.find_cell(ROOT, workload)
    assert callable(find.module("calls", cell.traffic["call"]).Call)
    assert callable(find.module("generators",
                                cell.config["graph"]["generator"]).make)
    assert callable(find.module("layouts",
                                cell.config["layouts"]["kind"]).make)
    assert set(cell.limits) >= {
        "node_occlusion", "minimum_angle", "edge_length_variation",
        "edge_crossing", "edge_crossing_angle", "crossing_count_for_angle"}
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert all(m["moves"] in e2e for m in cell.per_layer)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("config", SPEC["configs"],
                         ids=[c["name"] for c in SPEC["configs"]])
def test_config_files_lie_under_paths(config):
    path = ROOT / config["file"]
    assert path.is_file()
    assert any(config["file"].startswith(p + "/") for p in SPEC["paths"])
    body = json.loads(path.read_text())
    assert body["name"] == config["name"] and body["reduced"] == []


@pytest.mark.parametrize("what", ["harness", "reference"])
def test_imports_load_no_forbidden_module(what):
    """In a fresh process: the harness (with every metric reader) loads
    no module whose top-level name is jax, jaxlib, flax or repro; the
    reference loads none of those nor repro_torch."""
    if what == "harness":
        code = ("import bench.harness, bench.calls, bench.control, "
                "bench.trace_reader, json; from bench import find; "
                "s = json.load(open('BENCHMARK.json')); "
                "[bench.harness.reader(m['name']) for k in "
                "('end_to_end', 'per_layer') for m in s[k]]; "
                "[find.module('calls', json.load(open("
                "f'bench/traffic/{w[\"traffic\"]}.json'))['call']) "
                "for w in s['workloads']]")
        banned = {"jax", "jaxlib", "flax", "repro"}
    else:
        code = ("import bench.reference.scores, bench.reference.pairs, "
                "bench.reference.strips, bench.reference.soft, "
                "bench.inputs, bench.metrics._work; from bench import find; "
                "[find.module(d, n) for d, n in (('generators', "
                "'random_edges'), ('generators', 'layout_local_graph'), "
                "('layouts', 'uniform'), ('layouts', 'jittered'))]")
        banned = {"jax", "jaxlib", "flax", "repro", "repro_torch"}
    code += ("; import sys; print(sorted({m.split('.')[0] "
             "for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}",
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & banned


@pytest.mark.parametrize("workload", ["epinions.exact", "no.such.cell"])
def test_run_without_a_card_prints_no_result(workload):
    """Without a CUDA device (or with an unknown cell) a run exits with
    a code other than 0 and prints nothing on standard output."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 9), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_random_edges_is_a_simple_graph():
    random_edges = find.module("generators", "random_edges").random_edges
    e = random_edges(500, 4000, seed=3, skew=0.6)
    assert e.shape == (4000, 2) and e.dtype == np.int32
    assert (e[:, 0] != e[:, 1]).all()
    key = np.minimum(e[:, 0], e[:, 1]) * 500 + np.maximum(e[:, 0], e[:, 1])
    assert np.unique(key).size == 4000
    assert np.array_equal(e, random_edges(500, 4000, seed=3, skew=0.6))


def test_layout_local_graph_counts():
    pos, e = find.module("generators", "layout_local_graph").make(
        dict(n_vertices=100_000, seed=0, frac_long=0.002))[::-1]
    assert pos.shape == (100_000, 2) and e.shape == (199_765, 2)
    assert pos.min() > -2 and pos.max() < 102


def _trace(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace_reader.read_chrome_trace(path)


def test_trace_reader_unions_and_names_gaps(tmp_path):
    ev = [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize",
         "ts": 0, "dur": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize",
         "ts": 99, "dur": 1},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 20, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 90,
         "dur": 30},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 35, "dur": 40},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "ts": 45, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 150, "dur": 5},
    ]
    t = _trace(tmp_path, ev)
    assert t.window_s == pytest.approx(100e-6)
    # [10, 40) and [90, 100): overlaps counted once, clipped to the window
    assert t.busy_s() == pytest.approx(40e-6)
    assert t.busy_s(lambda n: n != "k2") == pytest.approx(30e-6)
    assert t.idle_gaps() == [["cudaStreamSynchronize", pytest.approx(50e-6)],
                             ["cudaDeviceSynchronize", pytest.approx(10e-6)]]
    assert t.top_ops()[0] == ["k1", pytest.approx(20e-6)]


def test_trace_window_from_the_device_synchronisations(tmp_path):
    """Without host annotations the window runs from the first device
    synchronisation to the end of the last."""
    ev = [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize",
         "ts": 0, "dur": 2},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 5, "dur": 3},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize",
         "ts": 90, "dur": 10},
    ]
    t = _trace(tmp_path, ev)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s() == pytest.approx(20e-6)
    assert t.idle_gaps() == [["python", pytest.approx(70e-6)],
                             ["cudaDeviceSynchronize", pytest.approx(10e-6)]]


def test_kernel_names_are_the_programs_global_functions():
    names = trace_reader.kernel_names(
        ROOT / "src" / "repro_torch" / "kernels" / "csrc")
    assert {"occlusion_pairs_kernel", "strip_reversal_kernel",
            "pair_sweep_kernel"} <= set(names)
