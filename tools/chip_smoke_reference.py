"""Compute the JAX reference constants that ``chip_smoke.py`` embeds.

Runs the JAX package (``repro``) on the CPU on exactly the inputs that
``chip_smoke.py`` builds: the layout-local graph at |V| = 100,000
(``seed=0``, ``frac_long=0.002``), ``radius=0.5``, ``n_strips=512``,
orientation ``both``, all five metrics, and a B=8 batch (member 0 the
layout itself, members 1-7 jittered from ``numpy.random.default_rng(1)``).

The reference runs op by op (``jax.disable_jit()``): under ``jit`` XLA's
CPU backend contracts multiply-adds into FMAs, which round once where
the port (and the reference run eagerly) round each product, and at this
size that flips a few exact strip-boundary ties.  ``--jit`` also prints
the jitted values for comparison.

Usage (from the repository root)::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py [--jit]

It prints one JSON object: the constants ``chip_smoke.py`` holds the card
against.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

import jax

from repro.api import EvalConfig, Evaluator
from repro.core.occlusion import count_occlusions_exact
from repro_torch.graphs.datasets import layout_local_graph

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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jit", action="store_true",
                    help="also print the jitted reference values")
    args = ap.parse_args()
    with jax.disable_jit():
        out = {"eager": compute()}
    if args.jit:
        out["jit"] = compute()
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
