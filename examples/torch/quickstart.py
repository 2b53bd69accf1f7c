"""Quickstart on the PyTorch port: evaluate the readability of a graph
layout through the one front door, as ``examples/quickstart.py`` does
with the JAX package.  A frozen :class:`repro_torch.api.EvalConfig`
drives every path (exact reference, fused engine, metric subsets) and
every path returns the same typed ``ReadabilityScores``.

Runs on the CUDA device; ``--device cpu`` runs it on the CPU.
``--precision bfloat16`` evaluates the fused engine in bfloat16 (an
approximation: counts drift from float32 by far more than rounding).

  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""

import argparse

from repro_torch.api import EvalConfig, Evaluator, evaluate_exact
from repro_torch.graphs.datasets import random_edges
from repro_torch.graphs.layouts import random_layout

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: CUDA)")
ap.add_argument("--precision", default="float32",
                choices=("float32", "bfloat16"))
args = ap.parse_args()

# a random graph with a random layout (the paper's evaluation setting)
n_vertices, n_edges = 500, 1200
edges = random_edges(n_vertices, n_edges, seed=0)
pos = random_layout(n_vertices, seed=0)

config = EvalConfig(n_strips=512, precision=args.precision)

# exact algorithms (paper S3.1): all-pairs sweeps, the reference (float32)
exact = evaluate_exact(pos, edges, config=config, device=args.device)
print("exact    :", exact.asdict())

# enhanced algorithms (paper S3.2) via the fused engine: the Evaluator
# plan-caches per topology, so repeated calls never re-plan
evaluator = Evaluator(config, device=args.device)
enhanced = evaluator.evaluate(pos, edges)
print("enhanced :", enhanced.asdict())
print("normalized [0,1] view:",
      {k: round(v, 4) for k, v in enhanced.normalized().asdict().items()
       if isinstance(v, float)})

if args.precision == "float32":
    assert exact.node_occlusion == enhanced.node_occlusion  # Table 3
err = abs(exact.edge_crossing - enhanced.edge_crossing) \
    / max(exact.edge_crossing, 1)
print(f"edge-crossing approximation error: {100 * err:.2f}% "
      f"(paper Table 3: ~1.5%)")

# metric subsets are pruned: a crossing-only config plans no occlusion
# grid and builds zero cell buckets
crossing_only = Evaluator(EvalConfig(n_strips=512,
                                     metrics=("edge_crossing",),
                                     precision=args.precision),
                          device=args.device)
fast = crossing_only.evaluate(pos, edges)
assert fast.edge_crossing == enhanced.edge_crossing
assert fast.node_occlusion is None
print(f"crossing-only config: E_c={fast.edge_crossing} "
      f"(same count, smaller program)")
