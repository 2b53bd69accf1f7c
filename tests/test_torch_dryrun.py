"""The port's dry run (:mod:`repro_torch.launch.dryrun`,
:mod:`repro_torch.launch.mesh`) end to end over fake ranks, and the two
mesh layouts it brought: EquiformerV2's ``shard_channels`` and the
two-axis ``sharded_embedding_lookup`` (in ``test_torch_distributed.py``).

The dry run and every scenario that needs a fake process group run in a
child process of their own (a fake group is its process's default
group); the two-rank EquiformerV2 run is a gloo spawn
(``tests/_torch_dist.py``).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_dist as dist_
import _torch_fake_ranks as fake
from repro_torch.models import equivariant as eqv
from repro_torch.models.common import params_from_reference
from test_torch_gnn import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def dryrun_gcn(tmp_path_factory):
    """``python -m repro_torch.launch.dryrun --cell gcn-cora:full_graph_sm
    --device cpu`` in a child process: its exit code and records."""
    out = tmp_path_factory.mktemp("dryrun") / "records.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--cell",
         "gcn-cora:full_graph_sm", "--device", "cpu", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    return proc, json.loads(out.read_text()) if out.is_file() else []


def test_dryrun_cell_exits_zero(dryrun_gcn):
    proc, records = dryrun_gcn
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "1 ok, 4 skipped (documented), 0 failed" in proc.stdout


def test_dryrun_record(dryrun_gcn):
    """The traced cell's record on the 16 x 16 mesh: its numbers and its
    roofline terms, per device."""
    _, records = dryrun_gcn
    (rec,) = [r for r in records if r["status"] != "skipped"]
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["status"]) == \
        ("gcn-cora", "full_graph_sm", "pod16x16", "ok")
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert 0 < rec["argument_bytes"] <= rec["peak_bytes"]
    assert rec["fits_80gb"] is True
    assert rec["compute_s"] > 0 and rec["memory_s"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert rec["meta"]["compute_dtype"] == "torch.float32"
    # index_add has no DTensor rule: it runs on replicated inputs
    assert rec["replicated_ops"] == ["aten.index_add"]


def test_dryrun_records_the_skipped_cells(dryrun_gcn):
    _, records = dryrun_gcn
    skipped = {r["arch"]: r["reason"] for r in records
               if r["status"] == "skipped"}
    assert sorted(skipped) == sorted(["codeqwen1.5-7b", "internlm2-20b",
                                      "qwen3-4b", "qwen2-moe-a2.7b"])
    assert all("sub-quadratic" in r for r in skipped.values())


def test_importing_the_dry_run_starts_no_group():
    import torch.distributed as dist

    import repro_torch.launch.dryrun  # noqa: F401
    from repro_torch.launch.mesh import make_production_mesh
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="fake process group"):
        make_production_mesh()


def test_shard_channels_splits_the_node_state():
    """EquiformerV2's smoke forward with ``shard_channels`` traced on a
    (1, 2) fake mesh: the node state sits on ``Shard(2)`` over ``model``
    (``Replicate()`` over ``data``) after the embedding and after each
    layer, as the reference constrains it."""
    out = fake.run("shard_channels")
    assert out["names"] == ["data", "model"]
    assert out["placements"] == [["R", "S(2)"]] * 3
    assert out["n_collectives"] > 0 and out["flops"] > 0


def test_shard_channels_energies_on_two_ranks():
    """The same forward on 2 gloo ranks, channels split over them, gives
    the one-device energies (rtol 1e-5)."""
    got = dist_.spawn(2, "equiformer_channels")
    cfg, params, batch = dist_.channels_inputs()
    want = eqv.equiformer_forward(
        params_from_reference(params, device="cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
        n_graphs=2)
    np.testing.assert_allclose(got, want.tolist(), rtol=1e-5)
