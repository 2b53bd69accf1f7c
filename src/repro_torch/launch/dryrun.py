"""The dry run over fake ranks (counterpart of :mod:`repro.launch.dryrun`):
trace every (architecture x input shape) cell on the production mesh and
derive its roofline terms, allocating nothing.

  PYTHONPATH=src python -m repro_torch.launch.dryrun               # all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b
  PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod   # 2x16x16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --cell gcn-cora:full_graph_sm
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu --jobs 4

Where the reference lowers and compiles each cell for 256 or 512 TPU
devices, this process plays rank 0 of a ``"fake"`` process group of 256
or 512 ranks (``launch.mesh.start_fake_group``) and runs the cell's step
once on fake ``DTensor`` shards (``cells.trace_cell``).  Each cell's
record: status, trace seconds, flops, bytes, per-device argument, output
and peak bytes, collective bytes, the roofline terms, and whether the
peak fits one H100's 80 GB; skipped cells are recorded with their
reasons.  Results land in ``--out`` (``dryrun_results_torch.json``).
The fake tensors sit on ``--device`` (``cuda`` unless the caller asks for
the CPU; this needs no card either way, but autograd on fake CUDA
tensors needs a CUDA build of torch).

A fake group is its process's default group, so the dry run owns its
process (never start it beside a real group); ``--jobs N`` spreads the
cells over N child processes, each with a fake group of its own.  It
exits 1 if any cell fails.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback

MESHES = {"pod16x16": False, "pods2x16x16": True}


def _mesh(name, device):
    """The named mesh over a fake group this process starts."""
    from repro_torch.launch.mesh import (PRODUCTION_SHAPES,
                                         make_production_mesh,
                                         start_fake_group)
    shape, _ = PRODUCTION_SHAPES[MESHES[name]]
    start_fake_group(math.prod(shape))
    return make_production_mesh(multi_pod=MESHES[name], device_type=device)


def run_cell(arch_id, shape_id, mesh, mesh_name):
    """Trace one cell; its record."""
    from repro_torch.launch.cells import make_cell, trace_cell
    from repro_torch.roofline.analysis import HBM_BYTES, terms_of

    cell = make_cell(arch_id, shape_id, mesh)
    cost = trace_cell(cell, mesh)
    terms = terms_of(cost, cell.meta, arch=arch_id, shape=shape_id,
                     mesh_name=mesh_name, chips=mesh.size())
    rec = {
        "arch": arch_id, "shape": shape_id, "mesh": mesh_name,
        "status": "ok", "trace_s": cost["trace_s"],
        "flops": cost["flops"], "bytes_accessed": cost["bytes accessed"],
        "argument_bytes": cost["argument_bytes"],
        "output_bytes": cost["output_bytes"],
        "peak_bytes": cost["peak_bytes"],
        "fits_80gb": cost["peak_bytes"] <= HBM_BYTES,
        "collective_bytes": cost["collectives"],
        "n_collectives": cost["n_collectives"],
        "replicated_ops": cost["replicated"],
        "remat_trips": cost["trips"],
        "compute_s": terms.compute_s, "memory_s": terms.memory_s,
        "collective_s": terms.collective_s, "dominant": terms.dominant,
        "model_flops": terms.model_flops, "useful_ratio": terms.useful_ratio,
        "meta": {k: (str(v) if k == "compute_dtype" else v)
                 for k, v in cell.meta.items()
                 if isinstance(v, (int, float, str)) or k == "compute_dtype"},
    }
    print(f"[{mesh_name}] {arch_id} x {shape_id}: OK "
          f"flops={cost['flops']:.3e} peak={cost['peak_bytes'] / 2**30:.3f}"
          f" GiB fits={rec['fits_80gb']} dominant={terms.dominant} "
          f"trace={cost['trace_s']:.2f}s", flush=True)
    return rec


def _cells(args):
    from repro_torch.configs import all_cells
    from repro_torch.configs.readability import READABILITY_SHAPES

    if args.cell:
        return [tuple(c.split(":")) for c in args.cell.split(",")]
    cells = [(a, s) for a, s, _ in all_cells()
             if not args.arch or a == args.arch]
    if not args.skip_readability and not args.arch:
        cells.extend(("readability", s) for s in READABILITY_SHAPES)
    return cells


def _trace_all(mesh_name, cells, device):
    """Trace ``cells`` on ``mesh_name`` in this process: their records."""
    import torch.distributed as dist

    mesh = _mesh(mesh_name, device)
    records = []
    try:
        for arch_id, shape_id in cells:
            try:
                records.append(run_cell(arch_id, shape_id, mesh, mesh_name))
            except Exception as e:  # noqa: BLE001 - report and continue
                records.append({"arch": arch_id, "shape": shape_id,
                                "mesh": mesh_name, "status": "fail",
                                "error": f"{type(e).__name__}: {e}"})
                print(f"[{mesh_name}] {arch_id} x {shape_id}: FAIL {e}",
                      flush=True)
                traceback.print_exc()
    finally:
        dist.destroy_process_group()
    return records


def _spread(mesh_name, cells, args):
    """Trace ``cells`` in ``args.jobs`` child processes, each with its own
    fake group; their records, merged (the skipped cells are this
    process's to record)."""
    jobs = min(args.jobs, len(cells))
    records = []
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        procs, outs = [], []
        for j in range(jobs):
            out = os.path.join(tmp, f"part{j}.json")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--device", args.device, "--out", out, "--cell",
                   ",".join(f"{a}:{s}" for a, s in cells[j::jobs])]
            if MESHES[mesh_name]:
                cmd.append("--multi-pod")
            procs.append(subprocess.Popen(cmd))
            outs.append(out)
        for p, out in zip(procs, outs):
            p.wait()
            if os.path.exists(out):
                with open(out) as f:
                    records.extend(r for r in json.load(f)
                                   if r["status"] != "skipped")
    return records


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None,
                    help="arch:shape (several: comma-separated)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="run ONLY the 2x16x16 multi-pod mesh")
    ap.add_argument("--both", action="store_true",
                    help="run single-pod AND multi-pod meshes")
    ap.add_argument("--skip-readability", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors (cuda unless asked)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="child processes to spread the cells over")
    ap.add_argument("--out", default="dryrun_results_torch.json")
    args = ap.parse_args(argv)

    from repro_torch.configs import all_cells

    if args.both:
        meshes = ["pod16x16", "pods2x16x16"]
    elif args.multi_pod:
        meshes = ["pods2x16x16"]
    else:
        meshes = ["pod16x16"]
    cells = _cells(args)

    # skipped cells are recorded, not silently dropped
    records = []
    for arch_id, shape_id, reason in all_cells(include_skipped=True):
        if reason and (not args.arch or arch_id == args.arch):
            records.append({"arch": arch_id, "shape": shape_id,
                            "status": "skipped", "reason": reason})
            print(f"SKIP {arch_id} x {shape_id}: {reason}")

    t0 = time.time()
    for mesh_name in meshes:
        if args.jobs > 1:
            records.extend(_spread(mesh_name, cells, args))
        else:
            records.extend(_trace_all(mesh_name, cells, args.device))

    with open(args.out, "w") as f:
        json.dump(records, f, indent=1)
    ok = sum(1 for r in records if r["status"] == "ok")
    skipped = sum(1 for r in records if r["status"] == "skipped")
    failures = sum(1 for r in records if r["status"] == "fail")
    expected = len(cells) * len(meshes)
    missing = expected - ok - failures
    print(f"\ndry run: {ok} ok, {skipped} skipped (documented), "
          f"{failures} failed, {missing} missing, "
          f"{time.time() - t0:.1f} s -> {args.out}")
    raise SystemExit(1 if failures or missing else 0)


if __name__ == "__main__":
    main()
