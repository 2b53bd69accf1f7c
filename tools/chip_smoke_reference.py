"""Compute the JAX reference constants that ``chip_smoke.py`` embeds.

Runs the JAX package (``repro``) on the CPU on exactly the inputs that
``chip_smoke.py`` builds: the layout-local graph at |V| = 100,000
(``seed=0``, ``frac_long=0.002``), ``radius=0.5``, ``n_strips=512``,
orientation ``both``, all five metrics, and a B=8 batch (member 0 the
layout itself, members 1-7 jittered from ``numpy.random.default_rng(1)``).

``--exact`` computes instead the constants of the exact all-pairs path,
``repro.api.evaluate_exact(pos, edges, config=EvalConfig(radius=0.5),
use_kernels=False)`` on ego-Facebook (``paper_graph("ego-Facebook",
seed=0, scale=1.0)``, ``random_layout(4039, seed=1)``: 4,039 vertices,
88,234 edges).  Besides the op-by-op constants it prints the jitted
values, the reference's float32 deviation sum, and a float64 recount of
that sum in numpy (same float32 pair arithmetic, float64 accumulation),
so the reference's own summation error can be read off.  ``--scale``
shrinks the graph for a quick check.  At full size the op-by-op run
takes about 12-13 minutes of CPU.

The reference runs op by op (``jax.disable_jit()``): under ``jit`` XLA's
CPU backend contracts multiply-adds into FMAs, which round once where
the port (and the reference run eagerly) round each product, and at this
size that flips a few exact strip-boundary ties.  ``--jit`` also prints
the jitted values for comparison.

Usage (from the repository root)::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py [--jit]
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py --exact [--scale S]
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py --serve

``--serve`` computes the constants of ``chip_smoke.py``'s phase (e), op
by op: (e1) the reference's ``ReadabilityServer(EvalConfig(radius=0.5,
n_strips=512))`` on the B=8 batch above as eight requests (one session
dispatch of B=8 on a flat plan from member 0, padded to the pow2 buckets
131072 / 262144), and (e5) ``count_crossings_enhanced``,
``crossing_angle_enhanced`` (``n_strips=512``, ``"both"``) and
``count_occlusions_enhanced`` on the layout alone.  Which constants (e)
reuses, and why they apply:

* (e1) and (e2) are held to ``REFERENCE["batch"]`` (the (b) values) on
  integers: padded == natural (the padded tail is masked out) and flat ==
  tiered (tiers change the bucket layout, never a count), so the
  session's padded flat dispatch counts what (b)'s natural tiered batch
  counts; floats agree at rtol 1e-5 (summation order).  (e2) is the
  kernels backend: its N_c is the exact all-pairs count, equal to the
  gridded count when the grid drops nothing (``overflow == 0``), as (c)
  already shows.  ``--serve`` checks the reference server's op-by-op
  (e1) integers against the (b) constants it is given.
* (e3) is ``evaluate_exact(use_kernels=False)`` behind the server's
  ``method="exact"`` shim, at radius 0.5 and the default ideal angle:
  the very call of (d0), so it is held to ``EXACT_REFERENCE``.
* (e5) has no earlier counterpart and gets its own constants.

It prints one JSON object: the constants ``chip_smoke.py`` holds the card
against.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

import jax

from repro.api import EvalConfig, Evaluator, evaluate_exact
from repro.core import (count_crossings_enhanced, count_occlusions_enhanced,
                        crossing_angle_enhanced)
from repro.core.crossing_angle import crossing_angle_exact
from repro.core.geometry import segment_theta
from repro.core.occlusion import count_occlusions_exact
from repro.graphs.datasets import paper_graph as ref_paper_graph
from repro.graphs.layouts import random_layout as ref_random_layout
from repro.launch.serve import ReadabilityServer
from repro_torch.graphs.datasets import layout_local_graph, paper_graph
from repro_torch.graphs.layouts import random_layout

N_V, SEED, FRAC_LONG = 100_000, 0, 0.002
RADIUS, N_STRIPS, BATCH, JITTER = 0.5, 512, 8, 0.02
FIELDS = ("node_occlusion", "minimum_angle", "edge_length_variation",
          "edge_crossing", "edge_crossing_angle", "crossing_count_for_angle",
          "overflow")


def inputs():
    pos, edges = layout_local_graph(N_V, seed=SEED, frac_long=FRAC_LONG)
    rng = np.random.default_rng(1)
    batch = np.stack([pos] + [
        pos + rng.normal(0, JITTER, pos.shape).astype(np.float32)
        for _ in range(BATCH - 1)]).astype(np.float32)
    return pos, edges, batch


def _row(scores, i=None):
    out = {}
    for f in FIELDS:
        v = getattr(scores, f)
        v = v if i is None else v[i]
        out[f] = int(v) if f in ("node_occlusion", "edge_crossing",
                                 "crossing_count_for_angle", "overflow") \
            else float(v)
    return out


def compute():
    pos, edges, batch = inputs()
    cfg = EvalConfig(radius=RADIUS, n_strips=N_STRIPS)
    t0 = time.perf_counter()
    single = _row(Evaluator(cfg).evaluate(pos, edges))
    t1 = time.perf_counter()
    res = Evaluator(cfg).evaluate_batch(batch, edges)
    batched = [_row(res, i) for i in range(BATCH)]
    t2 = time.perf_counter()
    # backend="kernels": the same flat session plan as "fused" sweeps
    # flat buckets; its N_c is the exact all-pairs count
    kern = _row(Evaluator(EvalConfig(radius=RADIUS, n_strips=N_STRIPS,
                                     backend="kernels")).evaluate(pos,
                                                                  edges))
    t3 = time.perf_counter()
    exact_nc = int(count_occlusions_exact(jax.numpy.asarray(pos), RADIUS))
    t4 = time.perf_counter()
    return dict(fused=single, batch=batched, kernels=kern,
                exact_node_occlusion=exact_nc,
                seconds=dict(fused=t1 - t0, batch=t2 - t1, kernels=t3 - t2,
                             exact=t4 - t3))


def compute_serve():
    """(e1) and (e5), op by op (call under ``jax.disable_jit()``)."""
    pos, edges, batch = inputs()
    t0 = time.perf_counter()
    server = ReadabilityServer(EvalConfig(radius=RADIUS, n_strips=N_STRIPS))
    reports = server.evaluate_batch([(p, edges) for p in batch])
    serve = [_row(r) for r in reports]
    stats = {k: server.stats[k] for k in ("dispatches", "coalesced",
                                          "replans", "plan_misses",
                                          "quarantined", "dispatch_failures")}
    # the (b) constants chip_smoke.py holds (e1) and (e2) to
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import INT_FIELDS, REFERENCE
    same = [all(r[f] == want[f] for f in INT_FIELDS)
            for r, want in zip(serve, REFERENCE["batch"])]
    t1 = time.perf_counter()
    jp, je = jax.numpy.asarray(pos), jax.numpy.asarray(edges)
    ec, ec_ov = count_crossings_enhanced(jp, je, n_strips=N_STRIPS)
    e_ca, count, dev_sum, ca_ov = crossing_angle_enhanced(
        jp, je, n_strips=N_STRIPS)
    nc, nc_ov = count_occlusions_enhanced(jp, RADIUS)
    t2 = time.perf_counter()
    enhanced = dict(
        count_crossings_enhanced=dict(count=int(ec), overflow=int(ec_ov)),
        crossing_angle_enhanced=dict(
            edge_crossing_angle=float(e_ca), count=int(count),
            dev_sum=float(dev_sum), overflow=int(ca_ov)),
        count_occlusions_enhanced=dict(count=int(nc), overflow=int(nc_ov)))
    return dict(serve=serve, serve_stats=stats,
                serve_ints_equal_batch_constants=same, enhanced=enhanced,
                seconds=dict(serve=t1 - t0, enhanced=t2 - t1))


EXACT_DATASET, EXACT_GRAPH_SEED, EXACT_LAYOUT_SEED = "ego-Facebook", 0, 1


def exact_inputs(scale):
    """ego-Facebook at ``scale`` from the port's numpy copies, checked
    equal to the reference's generators."""
    edges, n_v = paper_graph(EXACT_DATASET, seed=EXACT_GRAPH_SEED,
                             scale=scale)
    pos = random_layout(n_v, seed=EXACT_LAYOUT_SEED)
    ref_edges, ref_n_v = ref_paper_graph(EXACT_DATASET,
                                         seed=EXACT_GRAPH_SEED, scale=scale)
    assert n_v == ref_n_v and np.array_equal(edges, ref_edges)
    assert np.array_equal(pos, ref_random_layout(n_v,
                                                 seed=EXACT_LAYOUT_SEED))
    return pos, edges


def recount_deviation_f64(pos, edges, ideal, block=256):
    """The exact crossing count and deviation sum, recounted in numpy:
    the reference's float32 CCW test and per-pair deviation (one rounding
    per op, the reference's own segment angles), summed in float64."""
    x1, y1 = pos[edges[:, 0], 0], pos[edges[:, 0], 1]
    x2, y2 = pos[edges[:, 1], 0], pos[edges[:, 1], 1]
    theta = np.asarray(segment_theta(*(jax.numpy.asarray(a)
                                       for a in (x1, y1, x2, y2))))
    v, u = edges[:, 0], edges[:, 1]
    ideal = np.float32(ideal)
    pi = np.float32(np.pi)

    def cross(px, py, qx, qy, rx, ry):
        return (qx - px) * (ry - py) - (qy - py) * (rx - px)

    def straddle(a, b):
        return ((a <= 0) & (b >= 0)) | ((a >= 0) & (b <= 0))

    e = edges.shape[0]
    count, dev_sum = 0, 0.0
    for i0 in range(0, e, block):
        i1 = min(i0 + block, e)
        a = lambda t: t[i0:i1, None]
        b = lambda t: t[None, i0:]
        d1 = cross(a(x1), a(y1), a(x2), a(y2), b(x1), b(y1))
        d2 = cross(a(x1), a(y1), a(x2), a(y2), b(x2), b(y2))
        d3 = cross(b(x1), b(y1), b(x2), b(y2), a(x1), a(y1))
        d4 = cross(b(x1), b(y1), b(x2), b(y2), a(x2), a(y2))
        shared = ((a(v) == b(v)) | (a(v) == b(u)) | (a(u) == b(v))
                  | (a(u) == b(u)))
        upper = np.arange(i0, i1)[:, None] < np.arange(i0, e)[None, :]
        mask = straddle(d1, d2) & straddle(d3, d4) & ~shared & upper
        d = np.abs(a(theta) - b(theta))
        dev = np.abs(ideal - np.minimum(d, pi - d)) / ideal
        count += int(mask.sum())
        dev_sum += float(dev[mask].sum(dtype=np.float64))
    return count, dev_sum


def compute_exact(pos, edges):
    cfg = EvalConfig(radius=RADIUS)
    t0 = time.perf_counter()
    scores = evaluate_exact(pos, edges, config=cfg, use_kernels=False)
    out = {f: getattr(scores, f) for f in FIELDS}
    out["seconds"] = time.perf_counter() - t0
    return out


def exact_main(scale, with_jit):
    pos, edges = exact_inputs(scale)
    out = {"inputs": dict(dataset=EXACT_DATASET, scale=scale,
                          n_vertices=int(pos.shape[0]),
                          n_edges=int(edges.shape[0]))}
    with jax.disable_jit():
        out["eager"] = compute_exact(pos, edges)
    if with_jit:
        out["jit"] = compute_exact(pos, edges)
        _, count, dev = crossing_angle_exact(jax.numpy.asarray(pos),
                                             jax.numpy.asarray(edges))
        out["jit"]["dev_sum_f32"] = float(dev)
        out["jit"]["count"] = int(count)
    t0 = time.perf_counter()
    count, dev64 = recount_deviation_f64(pos, edges,
                                         EvalConfig().ideal_angle)
    e_ca64 = 1.0 - dev64 / count if count else 1.0
    e_ca = out["eager"]["edge_crossing_angle"]
    out["recount_f64"] = dict(
        count=count, dev_sum=dev64, edge_crossing_angle=e_ca64,
        rel_diff_vs_eager=abs(e_ca - e_ca64) / abs(e_ca64),
        seconds=time.perf_counter() - t0)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jit", action="store_true",
                    help="also print the jitted reference values")
    ap.add_argument("--exact", action="store_true",
                    help="the exact all-pairs path on ego-Facebook")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="graph scale of --exact (1.0: full size)")
    ap.add_argument("--serve", action="store_true",
                    help="phase (e): the server batch and the enhanced "
                         "wrappers at |V| = 100,000")
    args = ap.parse_args()
    if args.serve:
        with jax.disable_jit():
            out = {"eager": compute_serve()}
    elif args.exact:
        out = exact_main(args.scale, args.jit)
    else:
        with jax.disable_jit():
            out = {"eager": compute()}
        if args.jit:
            out["jit"] = compute()
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
