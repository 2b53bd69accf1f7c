"""Shared plumbing of the port's distributed tests
(``test_torch_graph_sharded.py``, ``test_torch_sharded_batched.py``,
``test_torch_distributed.py``): :func:`spawn` runs one scenario function
of this module on ``world`` ranks over gloo on the CPU and returns its
result, and the scenario functions themselves.

The ranks import only the port (no JAX, no reference): the tests hold
their JSON results against the reference's single-device results made in
the test process, and against each other across rank counts.  Every rank
prints its result and :func:`spawn` requires all of them to be equal
(every rank of a mesh gets the same scores).  Each rank holds torch to
one intra-op thread; every process group has a 60 s timeout and every
spawn a time limit of its own, so a hang fails one test instead of the
suite.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT = 240

RANK_MAIN = r"""
import datetime, json, sys
import torch
torch.set_num_threads(1)
import torch.distributed as dist
rank, world, port = (int(a) for a in sys.argv[1:4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
import _torch_dist
out = getattr(_torch_dist, sys.argv[4])(world)
print("RESULT " + json.dumps(out), flush=True)
dist.destroy_process_group()
"""


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(world, scenario):
    """Start ``scenario(world)`` on ``world`` gloo ranks; returns the rank
    processes (see :func:`finish`)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, "-c", RANK_MAIN, str(rank), str(world), str(port),
         scenario], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(world)]


def finish(procs):
    """Wait for the ranks of :func:`start` (each within
    :data:`SPAWN_TIMEOUT`, killed after it) and return rank 0's JSON
    result after checking every rank returned the same."""
    world = len(procs)
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}/{world}:\n{out}\n{err}"
    results = []
    for out, _ in outs:
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")][-1]
        results.append(json.loads(line[len("RESULT "):]))
    for rank, r in enumerate(results[1:], 1):
        assert r == results[0], f"rank {rank} of {world} differs from rank 0"
    return results[0]


def spawn(world, scenario):
    """``scenario(world)``'s result on ``world`` gloo ranks."""
    return finish(start(world, scenario))


def start_worlds(worlds, scenario):
    """Start ``scenario`` at every rank count of ``worlds`` together (each
    count its own process group); :func:`finish_worlds` collects them, so
    the test process can make its reference results meanwhile."""
    return {w: start(w, scenario) for w in worlds}


def finish_worlds(started):
    """``{world: scenario(world)'s result}`` of :func:`start_worlds`."""
    return {w: finish(procs) for w, procs in started.items()}


# ---------------------------------------------------------------------------
# fixtures (numpy only: the test process draws the same ones)
# ---------------------------------------------------------------------------

FAMILIES = ("random", "grid", "cluster", "collinear", "duplicate")
DEVICE = "cpu"
RADIUS = 2.0
N_STRIPS = 32
FIELDS = ("node_occlusion", "edge_crossing", "crossing_count_for_angle",
          "overflow", "minimum_angle", "edge_length_variation",
          "edge_crossing_angle")


def random_graph(n_v, n_e, seed, extent):
    """``(pos, edges, rng)``: uniform positions and distinct random edges
    drawn as the reference's multi-device tests draw them; ``rng`` goes
    on from there."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, extent, (n_v, 2)).astype(np.float32)
    edges = set()
    while len(edges) < n_e:
        v, u = rng.integers(0, n_v, 2)
        if v != u:
            edges.add((min(v, u), max(v, u)))
    return pos, np.array(sorted(edges), np.int32), rng


def graph_sharded_graph():
    """``tests/test_graph_sharded.py``'s layout (seed 11)."""
    return random_graph(300, 600, 11, 80)[:2]


def boundary_column(radius=2.0, n_col=64):
    """A vertical column spaced at 0.9 x the occlusion threshold: it
    crosses every cell row, so under several ranks many occluded pairs
    straddle a shard boundary; exactly ``n_col - 1`` occlusions."""
    col = np.stack([np.full(n_col, 10.0, np.float32),
                    np.arange(n_col, dtype=np.float32) * (0.9 * 2.0 * radius)],
                   axis=1)
    edges = np.array([[i, i + 1] for i in range(n_col - 1)], np.int32)
    return col, edges


def batched_graph(B=6):
    """``tests/test_sharded_batched.py``'s layout and batch (seed 3; B=6
    is no multiple of 4, which exercises the batch padding)."""
    pos, edges, rng = random_graph(150, 300, 3, 80)
    batch = np.stack([pos + rng.normal(0, 1.0, pos.shape).astype(np.float32)
                      for _ in range(B)])
    return batch, edges


def drill_graph():
    """``tests/test_faults.py``'s mesh drills: a layout and 4 jittered
    requests (seed 7)."""
    pos, edges, rng = random_graph(60, 120, 7, 60)
    return [(pos + rng.normal(0, 1.5, pos.shape).astype(np.float32), edges)
            for _ in range(4)]


def distributed_graph():
    """``tests/test_distributed.py``'s layout (seed 0)."""
    return random_graph(300, 600, 0, 100)[:2]


def padded(pos, edges):
    """The serving wire format: a PARK-filled vertex tail and a zero edge
    tail at the next pow2 buckets past the natural sizes."""
    from repro_torch.core.keys import pow2_bucket
    n_v, n_e = pos.shape[-2], edges.shape[0]
    vb, eb = pow2_bucket(n_v + 1), pow2_bucket(n_e + 1)
    pos_p = np.full(pos.shape[:-2] + (vb, 2), -1.0e6, np.float32)
    pos_p[..., :n_v, :] = pos
    edges_p = np.zeros((eb, 2), np.int32)
    edges_p[:n_e] = edges
    return pos_p, edges_p


# ---------------------------------------------------------------------------
# result conversion
# ---------------------------------------------------------------------------

def fetch(res):
    """A result's metric fields as plain Python values (lists for a
    batch)."""
    import torch
    out = {}
    for f in FIELDS:
        v = getattr(res, f)
        if isinstance(v, torch.Tensor):
            v = v.cpu().numpy()
        if v is not None:
            v = np.asarray(v).tolist()
        out[f] = v
    return out


# ---------------------------------------------------------------------------
# scenarios (run on every rank)
# ---------------------------------------------------------------------------

def graph_sharded(world):
    """Twin of ``tests/test_graph_sharded.py``'s multi-device script, plus
    the parity families and the near-parallel layouts."""
    from repro_torch.core import engine
    from repro_torch.core import grid
    from repro_torch.core.keys import EvalConfig
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.distributed.graph_sharded import evaluate_graph_sharded
    from repro_torch.kernels.fixtures import near_parallel_layouts, \
        parity_family
    from repro_torch.launch.session import EvalSession

    pos, edges = graph_sharded_graph()
    n_v, n_e = pos.shape[0], edges.shape[0]
    plan = engine.plan_readability(pos, edges, radius=2.0, n_strips=48,
                                   tier_strips=False)
    mesh = make_mesh((world,), ("graph",), device=DEVICE)
    out = {"single_host": fetch(engine.evaluate_planned(
        plan, pos, edges, device=DEVICE))}

    c0 = grid.CALL_COUNTS["halo_exchanges"]
    out["natural"] = fetch(evaluate_graph_sharded(mesh, plan, pos, edges))
    out["halo_exchanges"] = grid.CALL_COUNTS["halo_exchanges"] - c0

    pos_p, edges_p = padded(pos, edges)
    out["padded"] = fetch(evaluate_graph_sharded(
        mesh, plan, pos_p, edges_p, n_valid_vertices=n_v,
        n_valid_edges=n_e))

    # a strip-only subset: no halo exchange, no occlusion cells
    xplan = engine.plan_readability(pos, edges, radius=2.0, n_strips=48,
                                    tier_strips=False,
                                    metrics=("edge_crossing",))
    c_h = grid.CALL_COUNTS["halo_exchanges"]
    c_c = grid.CALL_COUNTS["cell_builds"]
    xres = evaluate_graph_sharded(mesh, xplan, pos, edges)
    out["crossing_only"] = {"edge_crossing": int(xres.edge_crossing)}
    out["crossing_only_halo"] = grid.CALL_COUNTS["halo_exchanges"] - c_h
    out["crossing_only_cells"] = grid.CALL_COUNTS["cell_builds"] - c_c

    col, cedges = boundary_column()
    cplan = engine.plan_readability(col, cedges, radius=2.0, n_strips=16,
                                    tier_strips=False)
    out["boundary_occlusion"] = int(evaluate_graph_sharded(
        mesh, cplan, col, cedges).node_occlusion)

    # replan-on-overflow: starved strip capacities overflow, the grown
    # plan does not
    starved = dataclasses.replace(
        plan, strip_plans=tuple((ms, 8) for ms, _ in plan.strip_plans),
        strip_tiers=())
    r1 = evaluate_graph_sharded(mesh, starved, pos, edges)
    out["starved_overflow"] = int(r1.overflow)
    grown = engine.replan_on_overflow(starved, pos, edges, r1)
    out["replan"] = fetch(evaluate_graph_sharded(mesh, grown, pos, edges))

    # serving: backend="graph_sharded" rides the session
    sess = EvalSession(EvalConfig(radius=2.0, n_strips=48,
                                  backend="graph_sharded"), mesh=mesh)
    s = sess.evaluate(pos, edges)
    out["session"] = {"node_occlusion": s.node_occlusion,
                      "edge_crossing": s.edge_crossing,
                      "overflow": s.overflow}
    out["session_dispatches"] = sess.stats["graph_sharded_dispatches"]
    out["session_mode"] = sess.health()["dispatch_mode"]

    out["families"] = {}
    for kind in FAMILIES:
        fpos, fedges = parity_family(kind)
        fplan = engine.plan_readability(fpos, fedges, radius=RADIUS,
                                        n_strips=N_STRIPS, tier_strips=False)
        out["families"][kind] = fetch(evaluate_graph_sharded(
            mesh, fplan, fpos, fedges))
    nbatch, nedges = near_parallel_layouts()
    nplan = engine.plan_readability(nbatch, nedges, radius=RADIUS,
                                    n_strips=N_STRIPS, tier_strips=False)
    out["near_parallel"] = [fetch(evaluate_graph_sharded(mesh, nplan, b,
                                                         nedges))
                            for b in nbatch]
    return out


def sharded_batched(world):
    """Twin of ``tests/test_sharded_batched.py``'s multi-device script,
    plus the parity families' sharded-batched cell, the near-parallel
    batch, and (on several ranks) the mesh drills of
    ``tests/test_faults.py``."""
    from repro_torch.core import engine
    from repro_torch.core.keys import EvalConfig
    from repro_torch.distributed.batched import evaluate_layouts_sharded
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.kernels.fixtures import near_parallel_layouts, \
        parity_family
    from repro_torch.launch.session import EvalSession

    batch, edges = batched_graph()
    B, n_v, n_e = batch.shape[0], batch.shape[1], edges.shape[0]
    plan = engine.plan_readability(batch, edges, radius=2.0, n_strips=48)
    mesh = make_mesh((world,), ("batch",), device=DEVICE)
    out = {"natural": fetch(evaluate_layouts_sharded(mesh, plan, batch,
                                                     edges))}
    batch_p, edges_p = padded(batch, edges)
    out["padded"] = fetch(evaluate_layouts_sharded(
        mesh, plan, batch_p, edges_p, n_valid_vertices=n_v,
        n_valid_edges=n_e))
    out["cut"] = fetch(evaluate_layouts_sharded(mesh, plan, batch[:B - 1],
                                                edges))

    starved = dataclasses.replace(
        plan, strip_plans=tuple((ms, 8) for ms, _ in plan.strip_plans),
        strip_tiers=())
    r1 = evaluate_layouts_sharded(mesh, starved, batch, edges)
    ov = r1.overflow.cpu().numpy()
    out["starved_overflow"] = int(ov.max())
    grown = engine.replan_on_overflow(starved, batch[int(ov.argmax())],
                                      edges, r1)
    out["replan"] = fetch(evaluate_layouts_sharded(mesh, grown, batch,
                                                   edges))

    sess = EvalSession(EvalConfig(radius=2.0, n_strips=48), mesh=mesh)
    scores = sess.evaluate_batch([(batch[i], edges) for i in range(B)])
    out["session"] = {
        "edge_crossing": [s.edge_crossing for s in scores],
        "node_occlusion": [s.node_occlusion for s in scores],
        "overflow": [s.overflow for s in scores]}
    out["session_sharded_dispatches"] = sess.stats["sharded_dispatches"]

    out["families"] = {}
    for kind in FAMILIES:
        fpos, fedges = parity_family(kind)
        fbatch = np.stack([fpos, fpos + 0.5, fpos * 0.75]).astype(np.float32)
        fplan = engine.plan_readability(fbatch, fedges, radius=RADIUS,
                                        n_strips=N_STRIPS)
        res = fetch(evaluate_layouts_sharded(mesh, fplan, fbatch, fedges))
        out["families"][kind] = {f: v[0] for f, v in res.items()}
    nbatch, nedges = near_parallel_layouts()
    nplan = engine.plan_readability(nbatch, nedges, radius=RADIUS,
                                    n_strips=N_STRIPS, tier_strips=False)
    res = fetch(evaluate_layouts_sharded(mesh, nplan, nbatch, nedges))
    out["near_parallel"] = [{f: v[i] for f, v in res.items()}
                            for i in range(nbatch.shape[0])]
    if world > 1:
        out["mesh_loss"] = mesh_loss_drill(mesh)
        out["breaker"] = breaker_drill(mesh)
    return out


def _ints(batch):
    return [[s.edge_crossing, s.node_occlusion] if s.ok else None
            for s in batch]


def mesh_loss_drill(mesh):
    """Twin of ``tests/test_faults.py::
    test_mesh_loss_degrades_to_single_host``."""
    from repro_torch.core.keys import EvalConfig
    from repro_torch.launch.faults import FaultPlan
    from repro_torch.launch.session import EvalSession

    reqs = drill_graph()
    config = EvalConfig(radius=2.0, n_strips=48)
    truth = EvalSession(config, device=DEVICE).evaluate_batch(reqs)
    sess = EvalSession(config, mesh=mesh)
    with FaultPlan(mesh_loss_dispatches=0) as fp:
        degraded = sess.evaluate_batch(reqs)
    after_loss = sess.health()
    sess.evaluate_batch(reqs)
    sharded_while_down = sess.stats["sharded_dispatches"]
    sess.restore_mesh()
    restored = sess.evaluate_batch(reqs)
    restored_health = sess.health()
    return {
        "truth": _ints(truth),
        "injected": fp.injected["mesh_loss_dispatches"],
        "degraded_dispatches": sess.stats["degraded_dispatches"],
        "quarantined": sess.stats["quarantined"],
        "sharded_while_down": sharded_while_down,
        "sharded_after_restore": sess.stats["sharded_dispatches"],
        "health_after_loss": {
            "status": after_loss["status"],
            "dispatch_mode": after_loss["dispatch_mode"],
            "mesh_active": after_loss["mesh"]["active"]},
        "health_restored": {
            "status": restored_health["status"],
            "dispatch_mode": restored_health["dispatch_mode"]},
        "degraded": _ints(degraded), "restored": _ints(restored)}


def breaker_drill(mesh):
    """Twin of ``tests/test_faults.py::
    test_breaker_self_heals_and_survives_rejected_probe``."""
    from repro_torch.core.keys import EvalConfig
    from repro_torch.launch.faults import FaultPlan
    from repro_torch.launch.session import EvalSession

    reqs = drill_graph()
    config = EvalConfig(radius=2.0, n_strips=48)
    sess = EvalSession(config, mesh=mesh, probe_interval=2)
    states = [sess.health()["breaker_state"]]
    with FaultPlan(mesh_loss_dispatches=0) as fp:
        r1 = sess.evaluate_batch(reqs)       # mesh loss -> open
    states.append(sess.health()["breaker_state"])
    r2 = sess.evaluate_batch(reqs)           # fused success #2 -> half_open
    states.append(sess.health()["breaker_state"])
    r3 = sess.evaluate_batch(reqs)           # canary probe -> closed
    states.append(sess.health()["breaker_state"])
    health = sess.health()
    s = sess.stats

    sess2 = EvalSession(config, mesh=mesh, probe_interval=1)
    with FaultPlan(mesh_loss_dispatches=0):
        sess2.evaluate_batch(reqs)           # open; fused -> half_open
    with FaultPlan(reject_probes=0) as fpr:
        r_rej = sess2.evaluate_batch(reqs)   # canary rejected -> open
    reopened = sess2.health()["breaker_state"]
    r_heal = sess2.evaluate_batch(reqs)      # next canary passes
    s2 = sess2.stats
    return {
        "states": states,
        "injected": fp.injected["mesh_loss_dispatches"],
        "probes": s["probes"], "auto_restores": s["auto_restores"],
        "breaker_opens": s["breaker_opens"],
        "degraded_dispatches": s["degraded_dispatches"],
        "quarantined": s["quarantined"],
        "sharded_dispatches": s["sharded_dispatches"],
        "health": {"status": health["status"],
                   "dispatch_mode": health["dispatch_mode"],
                   "mesh_active": health["mesh"]["active"]},
        "results": [_ints(r) for r in (r1, r2, r3, r_rej, r_heal)],
        "probe_rejected": fpr.injected["reject_probes"],
        "reopened": reopened,
        "leg2": {"probes": s2["probes"],
                 "auto_restores": s2["auto_restores"],
                 "breaker_opens": s2["breaker_opens"],
                 "degraded_dispatches": s2["degraded_dispatches"],
                 "quarantined": s2["quarantined"],
                 "state": sess2.health()["breaker_state"]}}


def distributed(world):
    """Twin of ``tests/test_distributed.py``'s multi-device script (the
    pairwise drivers on a 2-D mesh where the ranks allow one), plus the
    parity matrix's three mesh cells and the pairwise drivers on every
    family, the near-parallel layouts through the distributed front door,
    the serving mesh policy, a distributed search step, the
    range-partitioned embedding lookup (one axis, and the model axis of
    the 2-D mesh), ``evaluate_exact(mesh=...)`` (:func:`exact_mesh_twin`)
    and, at 4 ranks, ``examples/torch/distributed_eval.py``'s counts."""
    import torch

    from repro_torch.api import Evaluator
    from repro_torch.core import engine
    from repro_torch.core import grid as gridlib
    from repro_torch.core.keys import EvalConfig
    from repro_torch.distributed import pairwise
    from repro_torch.distributed.collectives import sharded_embedding_lookup
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.distributed.gridded import sharded_reversal_stats
    from repro_torch.kernels.ops import crossing_angle_op
    from repro_torch.kernels.fixtures import near_parallel_layouts, \
        parity_family
    from repro_torch.launch.elastic import serving_mesh

    dev = DEVICE
    shape = (2, world // 2) if world >= 4 else (world,)
    names = ("data", "model") if len(shape) == 2 else ("x",)
    mesh2 = make_mesh(shape, names, device=dev)
    pos, edges = distributed_graph()
    out = {"mesh_shape": list(mesh2.axis_shape)}
    out["occlusion"] = int(pairwise.sharded_occlusion_count(mesh2, pos, 2.0))
    out["ring_occlusion"] = int(pairwise.ring_occlusion_count(mesh2, pos,
                                                              2.0))
    out["crossing"] = int(pairwise.sharded_crossing_count(mesh2, pos, edges,
                                                          block=128))
    pos_t = torch.from_numpy(pos)
    edges_t = torch.from_numpy(edges)
    cnt, dsum = pairwise.sharded_crossing_angle_stats(mesh2, pos, edges,
                                                      ideal=1.2, block=128)
    single = crossing_angle_op(pos_t, edges_t, ideal=1.2)
    out["crossing_angle"] = [int(cnt), float(dsum)]
    out["crossing_angle_single"] = [int(single[0]), float(single[1])]
    segs = gridlib.build_strip_segments(pos_t, edges_t, 64, 16384)
    buckets = gridlib.bucketize_segments(segs, 64, cap=128)
    (cnt,) = sharded_reversal_stats(mesh2, buckets)
    out["strip_sharded"] = int(cnt)
    cnt, dsum = sharded_reversal_stats(mesh2, buckets, ideal_angle=1.2)
    single = engine.fused_reversal_stats(buckets, ideal=1.2)
    out["strip_sharded_angle"] = [int(cnt), float(dsum)]
    out["strip_single_angle"] = [int(single[0]), float(single[1])]

    mesh = make_mesh((world,), ("eval",), device=dev)
    cfg = dict(radius=RADIUS, n_strips=N_STRIPS)
    ev = {b: Evaluator(EvalConfig(backend=b, **cfg), mesh=mesh)
          for b in ("distributed", "graph_sharded")}
    out["families"] = {}
    for kind in FAMILIES:
        fpos, fedges = parity_family(kind)
        fbatch = np.stack([fpos, fpos + 0.5, fpos * 0.75]).astype(np.float32)
        member0 = ev["distributed"].evaluate_batch(fbatch, fedges).unbatch()[0]
        out["families"][kind] = {
            "distributed": fetch(ev["distributed"].evaluate(fpos, fedges)),
            "graph_sharded": fetch(ev["graph_sharded"].evaluate(fpos,
                                                                fedges)),
            "sharded_batched": fetch(member0),
            "occlusion": int(pairwise.sharded_occlusion_count(
                mesh2, fpos, RADIUS)),
            "ring_occlusion": int(pairwise.ring_occlusion_count(
                mesh2, fpos, RADIUS)),
            "crossing": int(pairwise.sharded_crossing_count(mesh2, fpos,
                                                            fedges))}
    nbatch, nedges = near_parallel_layouts()
    nev = Evaluator(EvalConfig(backend="distributed", tier_strips=False,
                               **cfg), mesh=mesh)
    out["near_parallel"] = [fetch(nev.evaluate(b, nedges)) for b in nbatch]

    # the serving mesh policy: the whole group, capped and pow2-trimmed
    out["serving_mesh"] = {
        str(shards): [m.size, list(m.axis_names)]
        for shards, m in ((s, serving_mesh("graph", shards=s, device=dev))
                          for s in (None, 1, 2, 3))}
    out["evaluator_mesh"] = Evaluator(
        EvalConfig(backend="distributed"), device=dev)._mesh().size
    out["search"] = search_twin(mesh)

    table, ids = embedding_inputs()
    out["embedding_lookup"] = sharded_embedding_lookup(
        make_mesh((world,), ("model",), device=dev), torch.from_numpy(table),
        torch.from_numpy(ids)).tolist()
    if len(shape) == 2:
        # the table's rows over the model axis of the (2, world/2) mesh,
        # replicated over data: the sum runs over that axis's sub-group
        out["embedding_lookup_2d"] = sharded_embedding_lookup(
            mesh2, torch.from_numpy(table), torch.from_numpy(ids),
            axis="model").tolist()
    out["exact_mesh"] = exact_mesh_twin(mesh, mesh2)
    if world == 4:
        # examples/torch/distributed_eval.py on the same (2, 2) mesh it
        # makes at 4 ranks
        out["distributed_eval"] = distributed_eval_example().evaluate(
            mesh2, dev, lambda line: None)
    return out


# the metric subsets that change evaluate_exact's route over a mesh
EXACT_SUBSETS = {
    "all": None,
    "crossing": ("edge_crossing",),
    "crossing_angle": ("edge_crossing_angle",),
    "occlusion": ("node_occlusion",),
}


def exact_mesh_twin(mesh, mesh2):
    """``evaluate_exact(mesh=...)`` on :func:`distributed_graph` (over the
    2-D mesh where the ranks allow one) and on every parity family, for
    each subset of :data:`EXACT_SUBSETS`: the scores, the
    ``exact.reduce`` spans of the call, and whether a second call gave
    the same E_ca bits."""
    from repro_torch import spans
    from repro_torch.core.keys import EvalConfig
    from repro_torch.core.metrics import evaluate_exact
    from repro_torch.kernels.fixtures import parity_family

    layouts = {"graph": (distributed_graph(), mesh2)}
    for kind in FAMILIES:
        layouts[kind] = (parity_family(kind), mesh)
    out = {}
    for name, ((pos, edges), m) in layouts.items():
        for subset, metrics in EXACT_SUBSETS.items():
            cfg = EvalConfig(radius=RADIUS) if metrics is None else \
                EvalConfig(radius=RADIUS, metrics=metrics)
            spans.enable()
            try:
                res = evaluate_exact(pos, edges, config=cfg, mesh=m)
                recorded = {s.id: s for s in spans.drain().spans}
            finally:
                spans.disable()
            again = evaluate_exact(pos, edges, config=cfg, mesh=m)
            reduces = [s for s in recorded.values()
                       if s.name == "exact.reduce"]
            out[f"{name}/{subset}"] = {
                "scores": fetch(res),
                "reduce_spans": len(reduces),
                "reduce_parents": sorted(recorded[s.parent].name
                                         for s in reduces),
                "reduce_roots": sorted({recorded[s.call].name
                                        for s in reduces}),
                "same_bits": str(again.edge_crossing_angle)
                == str(res.edge_crossing_angle)}
    return out


def embedding_inputs():
    """``(table (64, 8) float32, ids (5, 3) int32)`` from seed 23, the
    shapes of ``tests/test_distributed.py``'s lookup check."""
    rng = np.random.default_rng(23)
    return (rng.normal(size=(64, 8)).astype(np.float32),
            rng.integers(0, 64, (5, 3)).astype(np.int32))


def distributed_eval_example():
    """``examples/torch/distributed_eval.py`` as a module (its ranks are
    not started: the caller runs its ``evaluate`` on its own mesh)."""
    import importlib.util
    path = ROOT / "examples" / "torch" / "distributed_eval.py"
    spec = importlib.util.spec_from_file_location("distributed_eval", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def search_twin(mesh):
    """A distributed search against the single-host search from the same
    restarts (the restarts padded to the mesh size)."""
    from repro_torch.core.keys import EvalConfig
    from repro_torch.kernels.fixtures import parity_family
    from repro_torch.search.gradient import GradientSearch

    pos, edges = parity_family("random")
    out = {}
    for backend in ("distributed", "fused"):
        cfg = EvalConfig(radius=RADIUS, n_strips=N_STRIPS, backend=backend)
        gs = GradientSearch(cfg, steps=4, restarts=2, rescore_every=4,
                            seed=3, mesh=mesh if backend == "distributed"
                            else None, device=DEVICE)
        if backend == "fused":
            pos = out["distributed"]["init_positions"]
        res = gs.run(np.asarray(pos, np.float32), edges)
        out[backend] = {
            "init_positions": res.init_positions.tolist(),
            "positions": res.positions.tolist(),
            "restarts": res.restarts, "improvement": res.improvement,
            "init_scores": [fetch(s) for s in res.init_scores],
            "scores": [fetch(s) for s in res.scores],
            "counters": res.counters,
            "losses": [t["mean_soft_loss"] for t in res.trajectory]}
    return out


# ---------------------------------------------------------------------------
# the LM serving path: decode attention against a sequence-sharded cache
# ---------------------------------------------------------------------------

MERGE_SHAPE = dict(B=2, S=24, H=3, dh=8)
MERGE_POS = 17


def merge_inputs():
    """``(q (B, H, dh), k, v (B, S, H, dh))`` float32 from seed 21."""
    rng = np.random.default_rng(21)
    B, S, H, dh = (MERGE_SHAPE[k] for k in ("B", "S", "H", "dh"))
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    return q, k, v


def merge_decode(world):
    """``merge_decode_attention`` over a ``world``-rank ``model`` axis on
    :func:`merge_inputs`, attending up to :data:`MERGE_POS`."""
    import torch

    from repro_torch.distributed.collectives import merge_decode_attention
    from repro_torch.distributed.compat import make_mesh

    mesh = make_mesh((world,), ("model",), device=DEVICE)
    q, k, v = (torch.from_numpy(a) for a in merge_inputs())
    return merge_decode_attention(mesh, q, k, v, MERGE_POS).tolist()


# ---------------------------------------------------------------------------
# EquiformerV2 with its node state's channels split over the model axis
# ---------------------------------------------------------------------------

def channels_inputs():
    """EquiformerV2's smoke config with ``shard_channels``, its numpy
    parameters (seed 5) and a batch of two graphs (32 nodes, 96 edges,
    the last 8 masked) from seed 6."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import equivariant as eqv

    cfg = dataclasses.replace(get_arch("equiformer-v2").smoke_config,
                              shard_channels=True)
    rng = np.random.default_rng(6)
    n, e = 32, 96
    src = rng.integers(0, n, e)
    dst = (src + rng.integers(1, n, e)) % n
    batch = {"positions": rng.normal(size=(n, 3)).astype(np.float32) * 2,
             "species": rng.integers(0, cfg.n_species, n).astype(np.int32),
             "edge_src": src.astype(np.int32),
             "edge_dst": dst.astype(np.int32),
             "edge_mask": np.arange(e) < e - 8,
             "node_mask": np.ones(n, bool),
             "graph_id": (np.arange(n) >= n // 2).astype(np.int32)}
    return cfg, eqv.numpy_params(cfg, 5), batch


def equiformer_channels(world):
    """EquiformerV2's forward on a ``(1, world)`` ``DeviceMesh`` over the
    gloo ranks, every input replicated and the node state's channels
    split over ``model`` (``shard_channels``): the per-graph energies.
    The ops without a DTensor rule run on replicated inputs."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import equivariant as eqv
    from repro_torch.models.common import params_from_reference
    from repro_torch.roofline.analysis import (ReplicatingCalls,
                                               replicate_fallbacks)

    cfg, params, batch = channels_inputs()
    mesh = init_device_mesh("cpu", (1, world),
                            mesh_dim_names=("data", "model"))

    def rep(t):
        return distribute_tensor(t, mesh, [Replicate(), Replicate()])

    aten = torch.ops.aten
    replicate_fallbacks([aten.index_add.default, aten.scatter_reduce.two])
    tparams = _tree(params_from_reference(params, device=DEVICE), rep)
    tbatch = {k: rep(torch.from_numpy(v)) for k, v in batch.items()}
    with ReplicatingCalls(), implicit_replication():
        energies = eqv.equiformer_forward(tparams, tbatch, cfg, n_graphs=2)
    return energies.full_tensor().tolist()


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree(v, fn) for v in tree)
    return fn(tree)
