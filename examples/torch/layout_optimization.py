"""End-to-end driver on the PyTorch port: readability-in-the-loop layout
optimization, as ``examples/layout_optimization.py`` does with the JAX
package.

1. **FR + batched scoring**: Fruchterman-Reingold from several random
   starts, every checkpoint of every trajectory scored in ONE
   :meth:`repro_torch.api.Evaluator.evaluate_batch` call.
2. **Gradient-guided search**: :meth:`repro_torch.api.Evaluator.search`
   descends the soft relaxations of the same metrics with AdamW from the
   best FR layout; exact re-scores select the winner, and the
   before/after ``normalized()`` scores are printed.

Runs on the CUDA device; ``--device cpu`` runs it on the CPU.

  PYTHONPATH=src python examples/torch/layout_optimization.py --n 400 --iters 200
"""

import argparse
import time

import numpy as np

from repro_torch.api import EvalConfig, Evaluator
from repro_torch.graphs.datasets import random_edges
from repro_torch.graphs.layouts import fruchterman_reingold, random_layout
from repro_torch.search import batch_objectives


def print_normalized(tag, scores):
    norm = scores.normalized()
    print(f"{tag}: N_c={norm.node_occlusion:.3f} "
          f"M_a={norm.minimum_angle:.3f} "
          f"M_l={norm.edge_length_variation:.3f} "
          f"E_c={norm.edge_crossing:.3f} "
          f"E_ca={norm.edge_crossing_angle:.3f}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--edges", type=int, default=800)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--check-every", type=int, default=40)
    ap.add_argument("--starts", type=int, default=2,
                    help="independent random initializations")
    ap.add_argument("--n-strips", type=int, default=256)
    ap.add_argument("--search-steps", type=int, default=80)
    ap.add_argument("--search-restarts", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    ap.add_argument("--out", default="best_layout.npy")
    args = ap.parse_args()

    edges = random_edges(args.n, args.edges, seed=0)
    evaluator = Evaluator(EvalConfig(n_strips=args.n_strips),
                          device=args.device)

    # phase 1: optimize; collect every checkpoint of every trajectory
    t0 = time.time()
    candidates, labels = [], []
    for start in range(args.starts):
        pos = random_layout(args.n, seed=start)
        done = 0
        while done < args.iters:
            pos = fruchterman_reingold(pos, edges, n_iter=args.check_every,
                                       block=256, device=evaluator.device)
            done += args.check_every
            candidates.append(pos.cpu().numpy())
            labels.append((start, done))
    t_opt = time.time() - t0

    # plan once over the whole candidate batch, evaluate in one call
    batch = np.stack(candidates).astype(np.float32)
    t0 = time.time()
    plan = evaluator.plan(batch, edges)
    batch_scores = evaluator.evaluate_batch(batch, edges, plan=plan)
    reports = batch_scores.unbatch()
    objectives = batch_objectives(batch_scores)
    t_eval = time.time() - t0

    for (start, it), report, obj in zip(labels, reports, objectives):
        print(f"start {start} iter {it:4d}: "
              f"E_c={report.edge_crossing:6d} "
              f"N_c={report.node_occlusion:5d} "
              f"M_a={report.minimum_angle:.3f} "
              f"E_ca={report.edge_crossing_angle:.3f} "
              f"objective={obj:.3f}")
    best_i = int(np.argmax(objectives))
    print(f"best FR layout: start {labels[best_i][0]} "
          f"iter {labels[best_i][1]} (objective {objectives[best_i]:.3f}); "
          f"optimize {t_opt:.1f}s + batched eval of "
          f"{len(candidates)} candidates {t_eval:.1f}s")

    # phase 2: gradient-guided search from the FR winner
    t0 = time.time()
    result = evaluator.search(candidates[best_i], edges,
                              steps=args.search_steps,
                              restarts=args.search_restarts)
    t_search = time.time() - t0
    print_normalized("before search (exact, normalized)", reports[best_i])
    print_normalized("after  search (exact, normalized)", result.best_scores)
    print(f"objective {np.max(result.init_objectives):.3f} -> "
          f"{result.best_objective:.3f} "
          f"(+{result.improvement:.3f}) in {result.steps} steps x "
          f"{result.restarts} restarts, {t_search:.1f}s "
          f"({result.counters['rescores']} exact re-scores)")
    np.save(args.out, result.best_positions)
    print(f"saved -> {args.out}")


if __name__ == "__main__":
    main()
