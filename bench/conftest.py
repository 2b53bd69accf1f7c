"""Shared fixtures of the benchmark's tests: the repository root on the
import path, a cell shrunk to a size the CPU runs in moments, and the
card fixture of the tests marked ``gpu``."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# small stand-ins of the cells' sizes: (graph keys, traffic keys, eval keys)
SMALL = {
    "epinions.exact": ({"n_vertices": 300, "n_edges": 2000}, {}, {}),
    "local100k.batch64": ({"n_vertices": 2000, "n_edges": 3917},
                          {"batch": 4}, {"n_strips": 64}),
    "local100k.search": ({"n_vertices": 2000, "n_edges": 3917},
                         {"restarts": 3, "steps": 2, "rescore_every": 2},
                         {"n_strips": 64}),
}


@pytest.fixture
def small_cell():
    """``make(name)``: the cell of ``BENCHMARK.json`` at a small size."""
    from bench import harness

    def make(name):
        cell = harness.find_cell(ROOT, name)
        graph, traffic, ev = SMALL[name]
        cell.config["graph"].update(graph)
        cell.traffic.update(traffic)
        cell.config["eval"].update(ev)
        return cell
    return make


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
