"""The 4-rank exact cell, ``epinions.exact4``, on the CPU at a small size:
4 gloo ranks, rank 0 the test's own process.  A sound run is correct;
the control fails; a fault on rank 0 fails the run; a run without 4
cards exits non-zero and prints nothing; a set-up that fails on rank 0
(as on a program whose ``evaluate_exact`` takes no mesh) raises; and
after each run no rank process is left."""

import subprocess
import sys
import types
from pathlib import Path

import pytest

from bench import control, harness
from bench.calls import evaluate_exact_mesh

ROOT = Path(__file__).resolve().parents[1]
NAME = "epinions.exact4"


@pytest.fixture
def small_exact4():
    """The cell at 300 vertices and 2,000 edges, on its 4 ranks."""
    cell = harness.find_cell(ROOT, NAME)
    cell.config["graph"].update(n_vertices=300, n_edges=2000)
    return cell


def rank_processes():
    """Pids of the live processes that run a rank of the cell."""
    marker = evaluate_exact_mesh.RANK_MAIN.encode()
    found = []
    for proc in Path("/proc").iterdir():
        if not proc.name.isdigit():
            continue
        try:
            if marker in (proc / "cmdline").read_bytes():
                found.append(int(proc.name))
        except OSError:  # gone meanwhile
            continue
    return found


@pytest.fixture
def no_rank_left():
    """Fails the test where a rank process outlives its run."""
    yield
    assert rank_processes() == []


def _run(cell, seed=2 ** 31 + 13):
    args = types.SimpleNamespace(workload=cell.name, seed=seed,
                                 seconds=0.3, trace=0)
    return harness.run_cell(ROOT, cell, args, device="cpu")


def test_a_sound_run_is_correct(small_exact4, no_rank_left):
    assert small_exact4.chips == 4 and small_exact4.traffic["ranks"] == 4
    result, checks = _run(small_exact4)
    assert result["correct"] and result["failed"] == 0, checks
    assert result["attempted"] >= 1
    assert set(result["metrics"]) >= {"setup_s", "exact_eval_ms"}
    assert result["device"]["count"] == 4


@pytest.mark.parametrize("seed", [3, 4])
def test_the_control_fails(small_exact4, no_rank_left, seed):
    got = control.control_gaps(ROOT, small_exact4, seed, "cpu")
    assert any(v > lim for v, lim in got.values()), got


def test_a_fault_on_rank_0_makes_the_run_incorrect(
        small_exact4, no_rank_left, monkeypatch):
    from repro_torch.core import metrics
    real = metrics.evaluate_exact

    def altered(*a, **k):
        out = real(*a, **k)
        return out._replace(edge_crossing=out.edge_crossing + 1)
    monkeypatch.setattr(metrics, "evaluate_exact", altered)
    result, checks = _run(small_exact4)
    assert not result["correct"] and result["failed"] >= 1, checks


def test_a_program_without_the_mesh_route_fails_in_set_up(
        small_exact4, no_rank_left, monkeypatch):
    """Rank 0's warm-up call raises, as on a program whose
    ``evaluate_exact`` has no ``mesh``: the run raises in set-up and
    stops the other ranks, which wait in the warm-up's collectives."""
    from repro_torch.core import metrics

    def no_mesh(pos, edges, *, config=None, use_kernels=False,
                device=None):
        raise AssertionError("not reached")
    monkeypatch.setattr(metrics, "evaluate_exact", no_mesh)
    with pytest.raises(TypeError, match="mesh"):
        _run(small_exact4)


def test_a_run_without_four_cards_prints_no_result(no_rank_left):
    import torch
    if torch.cuda.device_count() >= 4:
        pytest.skip("four CUDA devices are present")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", NAME,
         "--seed", str(2 ** 31 + 9), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
