"""Distributed readability evaluation on a mesh of ranks, with the PyTorch
port, as ``examples/distributed_eval.py`` does on 8 simulated devices with
the JAX package: the paper's exact and enhanced algorithms through the
mesh drivers (row-sharded and ring-streamed exact N_c, row-sharded exact
E_c, strip-sharded enhanced E_c) and the exact front door over the mesh
(``evaluate_exact(..., mesh=mesh)``: every score, the pair rows split over
the ranks), each exact count checked against the port's single-device
exact path.

On the CUDA devices by default: one NCCL rank per card.  ``--device cpu``
runs ``--world`` gloo ranks on the CPU (8 by default, as the reference's
8 forced host devices).  The script starts its ranks itself.  Rank 0
prints the counts, and last a line ``counts: {...}`` of JSON.

  PYTHONPATH=src python examples/torch/distributed_eval.py [--device cpu] [--world 8]
"""

import argparse
import datetime
import json
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.api import EvalConfig, evaluate_exact
from repro_torch.core import grid as gridlib
from repro_torch.core.engine import resolve_device
from repro_torch.distributed.compat import make_mesh
from repro_torch.distributed.gridded import sharded_reversal_stats
from repro_torch.distributed.pairwise import (ring_occlusion_count,
                                              sharded_crossing_count,
                                              sharded_occlusion_count)
from repro_torch.graphs.datasets import random_edges
from repro_torch.graphs.layouts import random_layout

N_V, N_E, RADIUS, N_STRIPS = 1500, 3000, 1.0, 256
# a rank that waits longer than this on a collective fails the run
TIMEOUT_S = 120


def check(ok, message):
    if not ok:
        raise RuntimeError(message)


def evaluate(mesh, device, say):
    """The reference example's counts on ``mesh``; returns them as a
    dict (``say`` prints on rank 0)."""
    edges = random_edges(N_V, N_E, seed=0)
    pos = random_layout(N_V, seed=0)
    exact = evaluate_exact(pos, edges, config=EvalConfig(radius=RADIUS),
                           device=device)

    # exact occlusion: replicated columns against the streaming ring
    t0 = time.time()
    occ = int(sharded_occlusion_count(mesh, pos, RADIUS))
    say(f"sharded exact N_c = {occ}  ({time.time() - t0:.2f}s)")
    occ_ring = int(ring_occlusion_count(mesh, pos, RADIUS))
    check(occ_ring == occ == exact.node_occlusion,
          f"ring {occ_ring}, sharded {occ}, exact {exact.node_occlusion}")
    say(f"ring-streamed N_c  = {occ_ring}  (ring of point-to-point sends)")

    # exact crossing, row-sharded over every rank
    t0 = time.time()
    cross = int(sharded_crossing_count(mesh, pos, edges))
    check(cross == exact.edge_crossing,
          f"sharded {cross}, exact {exact.edge_crossing}")
    say(f"sharded exact E_c = {cross}  ({time.time() - t0:.2f}s)")

    # the exact front door over the mesh: N_c, and E_c with E_ca from one
    # crossing-angle sweep, on each rank's rows; M_a and M_l on every rank
    t0 = time.time()
    meshed = evaluate_exact(pos, edges, config=EvalConfig(radius=RADIUS),
                            mesh=mesh)
    check((meshed.node_occlusion, meshed.edge_crossing,
           meshed.crossing_count_for_angle, meshed.minimum_angle,
           meshed.edge_length_variation)
          == (exact.node_occlusion, exact.edge_crossing,
              exact.crossing_count_for_angle, exact.minimum_angle,
              exact.edge_length_variation)
          and abs(meshed.edge_crossing_angle - exact.edge_crossing_angle)
          <= 1e-5 * abs(exact.edge_crossing_angle),
          f"evaluate_exact over the mesh {meshed}, on one device {exact}")
    say(f"evaluate_exact(mesh=...) E_ca = {meshed.edge_crossing_angle:.6f}"
        f"  ({time.time() - t0:.2f}s)")

    # enhanced crossing: strips sharded over every rank (capacities from
    # the planner: undersized budgets drop segments)
    max_segments, cap = gridlib.plan_strips(pos, edges, N_STRIPS)
    segs = gridlib.build_strip_segments(
        torch.from_numpy(pos).to(mesh.device),
        torch.from_numpy(edges).to(mesh.device), N_STRIPS, max_segments)
    buckets = gridlib.bucketize_segments(segs, N_STRIPS, cap=cap)
    (enh,) = sharded_reversal_stats(mesh, buckets)
    overflow = int(buckets.overflow)
    check(overflow == 0, f"segment budget overflow {overflow}")
    err = abs(int(enh) - cross) / max(cross, 1)
    say(f"sharded enhanced E_c = {int(enh)}  (err {100 * err:.2f}% vs "
        f"exact)")
    return {"mesh": list(mesh.axis_shape), "node_occlusion": occ,
            "ring_node_occlusion": occ_ring, "edge_crossing": cross,
            "exact_mesh_crossing_angle": meshed.edge_crossing_angle,
            "enhanced_edge_crossing": int(enh), "overflow": overflow}


def rank_main(rank, world, device, init_method):
    """One rank: join the group, evaluate on a mesh of every rank
    (``(2, world / 2)`` named data and model, as the reference's ``(2,
    4)``, where the count allows it), leave the group."""
    cpu = torch.device(device).type == "cpu"
    dev = "cpu" if cpu else torch.device("cuda", rank)
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        if cpu:
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(dev)
        shape = (2, world // 2) if world >= 4 and world % 2 == 0 \
            else (world,)
        names = ("data", "model") if len(shape) == 2 else ("model",)
        mesh = make_mesh(shape, names, device=dev)

        def say(line):
            if rank == 0:
                print(line, flush=True)

        say(f"mesh: {mesh}")
        counts = evaluate(mesh, dev, say)
        say(f"counts: {json.dumps(counts)}")
    finally:
        dist.destroy_process_group()


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(world, device):
    """Start ``world`` ranks of this script and wait for them; returns the
    first non-zero exit code, or 0."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--device", device, "--world",
         str(world), "--rank", str(r), "--port", str(port)])
        for r in range(world)]
    try:
        codes = [p.wait(timeout=TIMEOUT_S * 3) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return next((c for c in codes if c), 0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu for gloo ranks (default: CUDA, one NCCL rank "
                         "per card)")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: 8 on the CPU, every card on CUDA)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    device = "cpu" if dev.type == "cpu" else "cuda"
    if args.rank is not None:
        return rank_main(args.rank, args.world, device,
                         f"tcp://127.0.0.1:{args.port}")
    world = args.world or (8 if device == "cpu"
                           else torch.cuda.device_count())
    if device == "cuda" and world > torch.cuda.device_count():
        raise SystemExit(f"{world} NCCL ranks need {world} cards; "
                         f"{torch.cuda.device_count()} are visible")
    return launch(world, device)


if __name__ == "__main__":
    sys.exit(main())
