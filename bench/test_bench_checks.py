"""The correctness check of each cell: a sound run passes it, and the
control and each fault the cell can have fail it.  Small sizes on the
CPU; the control at the cells' own sizes on the card (marked ``gpu``)."""

import types
from pathlib import Path

import numpy as np
import pytest

from bench import control, harness

ROOT = Path(__file__).resolve().parents[1]
CELLS = ["epinions.exact", "local100k.batch64", "local100k.search"]


def _run(cell, seed=2 ** 31 + 11):
    args = types.SimpleNamespace(workload=cell.name, seed=seed,
                                 seconds=0.3, trace=0)
    result, checks = harness.run_cell(ROOT, cell, args, device="cpu")
    return result, checks


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(small_cell, name):
    result, checks = _run(small_cell(name))
    assert result["correct"] and result["failed"] == 0, checks
    assert result["attempted"] >= 1 and set(result["metrics"]) >= {"setup_s"}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [3, 4])
def test_the_control_fails(small_cell, name, seed):
    got = control.control_gaps(ROOT, small_cell(name), seed, "cpu")
    assert any(v > lim for v, lim in got.values()), got


def _alter_exact(monkeypatch, fault):
    from repro_torch.core import metrics
    real = metrics.evaluate_exact

    def altered(*a, **k):
        out = real(*a, **k)
        if fault == "nan":
            return out._replace(minimum_angle=float("nan"))
        return out._replace(edge_crossing=out.edge_crossing + 1)
    monkeypatch.setattr(metrics, "evaluate_exact", altered)


def _batch_fault(monkeypatch, fault):
    from repro_torch.api import Evaluator
    real = Evaluator.evaluate_batch

    def broken(self, batch, edges, **k):
        if fault == "half":
            # half of the batch left out, the mean of the rest in its place
            half = batch.shape[0] // 2
            out = real(self, batch[:half], edges, **k)
            fields = {}
            for f in ("node_occlusion", "minimum_angle",
                      "edge_length_variation", "edge_crossing",
                      "edge_crossing_angle", "crossing_count_for_angle"):
                v = np.asarray(getattr(out, f))
                fill = np.full(batch.shape[0] - half, v.mean(),
                               dtype=np.float64).astype(v.dtype)
                fields[f] = np.concatenate([v, fill])
            return out._replace(**fields)
        out = real(self, batch, edges, **k)
        occ = np.array(out.node_occlusion, copy=True)
        occ[0] += 1
        return out._replace(node_occlusion=occ)
    monkeypatch.setattr(Evaluator, "evaluate_batch", broken)


def _search_fault(monkeypatch, fault):
    from repro_torch.search.gradient import GradientSearch
    real_run = GradientSearch.run

    def altered(self, *args, **kwargs):
        res = real_run(self, *args, **kwargs)
        first = res.scores[0]
        return res._replace(scores=(first._replace(
            edge_crossing=first.edge_crossing + 1),) + res.scores[1:])
    if fault == "answer":
        monkeypatch.setattr(GradientSearch, "run", altered)
    else:
        monkeypatch.setattr(GradientSearch, "step", GradientSearch.step)
        control.FAULTS["search"][fault]()


@pytest.mark.parametrize("name,fault", [
    ("epinions.exact", "answer"), ("epinions.exact", "nan"),
    ("local100k.batch64", "answer"),
    ("local100k.batch64", "half"), ("local100k.search", "state"),
    ("local100k.search", "later"), ("local100k.search", "stale_v"),
    ("local100k.search", "stale_step"), ("local100k.search", "answer")])
def test_a_fault_in_the_timed_path_makes_the_run_incorrect(
        small_cell, monkeypatch, name, fault):
    if name == "epinions.exact":
        _alter_exact(monkeypatch, fault)
    elif name == "local100k.batch64":
        _batch_fault(monkeypatch, fault)
    else:
        _search_fault(monkeypatch, fault)
    result, checks = _run(small_cell(name))
    assert not result["correct"] and result["failed"] >= 1, checks


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_the_cells_size(card, name):
    cell = harness.find_cell(ROOT, name)
    for seed in (101, 102, 103):
        got = control.control_gaps(ROOT, cell, seed, card)
        assert any(v > lim for v, lim in got.values()), (seed, got)
