"""Scenarios of the dry-run tests that need a process group of the
``"fake"`` backend (``test_torch_roofline.py``, ``test_torch_dryrun.py``).

A fake group is its process's default group, so each scenario runs in a
child process of its own (:func:`run`), which prints one JSON line.  The
children import only the port, hold torch to one intra-op thread and put
their fake tensors on the CPU (autograd on fake CUDA tensors needs a CUDA
build of torch).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300


def run(scenario):
    """``scenario()`` of this module in a child process; its result."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.run(
        [sys.executable, str(Path(__file__)), scenario], env=env,
        capture_output=True, text=True, timeout=TIMEOUT)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, (proc.stdout[-3000:],
                                            proc.stderr[-6000:])
    return json.loads(lines[-1][len("RESULT "):])


def _mesh(shape):
    from repro_torch.launch.mesh import make_host_mesh, start_fake_group
    start_fake_group(shape[0] * shape[1])
    return make_host_mesh(shape, device_type="cpu")


def collectives():
    """An all-gather over a group of 4 and an all-reduce of the whole
    group, recorded with their kind, bytes and group size."""
    import torch
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol

    from repro_torch.roofline.analysis import CostRecorder
    _mesh((2, 2))
    rec = CostRecorder()
    with rec:
        x = torch.empty(16, 128)
        funcol.all_gather_tensor(x, 0, dist.group.WORLD)
        y = torch.empty(1024, dtype=torch.bfloat16)
        funcol.all_reduce(y, "sum", dist.group.WORLD)
    return rec.collectives


def memory():
    """A (2, 2) mesh: ``x`` (8, 16) float32 split on dim 0 over ``data``,
    ``y = x * 2``: rank 0 holds (4, 16) of each."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import P, local_shape, placements
    from repro_torch.roofline.analysis import CostRecorder
    mesh = _mesh((2, 2))
    spec = P("data", None)
    rec = CostRecorder()
    with rec:
        local = torch.empty(local_shape(mesh, (8, 16), spec))
        x = DTensor.from_local(local, mesh, placements(mesh, spec),
                               run_check=False)
        arg = rec.storage_bytes([local])
        rec.track(local)
        y = x * 2.0
    return {"argument": arg, "peak": rec.peak, "flops": rec.flops,
            "bytes": rec.bytes, "local": list(y.to_local().shape)}


def analyze():
    """``analyze_cell("xdeepfm", "serve_p99")`` on a (1, 2) mesh."""
    import dataclasses

    from repro_torch.roofline.analysis import analyze_cell
    mesh = _mesh((1, 2))
    return dataclasses.asdict(analyze_cell("xdeepfm", "serve_p99", mesh,
                                           "test"))


def shard_channels():
    """EquiformerV2's smoke forward with ``shard_channels`` on a (1, 2)
    mesh, traced: the node state's placements where the config constrains
    it, and the trace's counts."""
    import dataclasses

    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_arch
    from repro_torch.launch import cells
    from repro_torch.models import equivariant as eqv
    mesh = _mesh((1, 2))
    seen = []
    inner = eqv._shard_channels

    def spy(f, cfg):
        out = inner(f, cfg)
        seen.append([str(p) for p in out.placements]
                    if isinstance(out, DTensor) else None)
        return out
    eqv._shard_channels = spy
    cfg = dataclasses.replace(get_arch("equiformer-v2").smoke_config,
                              shard_channels=True)
    cell = cells.make_cell("equiformer-v2", "molecule", mesh,
                           config_patch=dataclasses.asdict(cfg))
    cost = cells.trace_cell(cell, mesh)
    return {"placements": seen, "n_collectives": cost["n_collectives"],
            "flops": cost["flops"], "names": list(mesh.mesh_dim_names)}


if __name__ == "__main__":
    import torch
    torch.set_num_threads(1)
    print("RESULT " + json.dumps(globals()[sys.argv[1]]()), flush=True)
