#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs a
CUDA device and the ``src/repro_torch`` sources beside it, and fails
(non-zero exit, no result line) without either.  It imports nothing of
JAX or of the JAX package.

Phases (any failed check raises):

1. **Build** the hand-written kernels (four sources) from
   ``src/repro_torch/kernels/csrc`` with ``nvcc`` for ``sm_90a`` (one
   compiler per source, started together) and print the card's name and
   power limit.
2. **Kernel vs plain on the card**: the strip-reversal kernel at every
   ``(rows, cap)`` slab the main path below hands it and on an
   adversarial slab (ties, shared endpoints, a cap above one staging
   window, invalid rows) and on slabs whose valid slots are no prefix
   (:func:`masked_slabs`); the occlusion-pair kernel at the main path's
   padded size, at the exact path's, on exact ``d2 == (2r)^2`` pairs and
   on the tile layouts of :func:`occlusion_tile_cases`; the
   segment-crossing and crossing-angle
   kernels on the adversarial layouts and the tile layouts of
   ``repro_torch.kernels.fixtures`` and at the exact path's size.
   Integers equal, deviation sums at rtol 1e-5.
3. **Main path at full size**: the layout-local graph at |V| = 100,000
   (about 2e5 edges), ``radius=0.5``, ``n_strips=512``, both
   orientations, all five metrics, through the user's entry points:
   (a) ``Evaluator(cfg).evaluate`` (fused, via the session), (b)
   ``.evaluate_batch`` of B=8 layouts (member 0 the layout, 1-7 seeded
   jitter), (c) ``Evaluator(backend="kernels").evaluate``.  Results must
   equal the JAX reference constants below (integers exactly, floats at
   rtol 1e-5) with ``overflow == 0``, both kernels' launch counts
   must have grown, and the shapes each kernel was launched on must be
   the ones checked and timed in phases 2 and 4.
   (d) the exact all-pairs path, ``repro_torch.api.evaluate_exact`` with
   ``use_kernels=False`` and ``True``, on ego-Facebook at its published
   size (4,039 vertices, 88,234 edges, random layout), against the JAX
   reference's op-by-op constants; each call must launch the
   crossing-angle and occlusion-pair kernels once each (the
   crossing-angle kernel's count is E_c), on the shapes checked and
   timed here; (d2) the same call with E_c alone must launch the
   segment-crossing kernel once and nothing else.
   (e) the serving front and the standalone enhanced algorithms:
   (e1) ``ReadabilityServer(EvalConfig(radius=0.5, n_strips=512))``
   serves (b)'s 8 layouts as 8 requests in one session dispatch of B=8 on
   a flat plan (integers equal to (b)'s constants: padded == natural and
   flat == tiered; a second round is a plan hit with no replan); (e2) the
   same on ``backend="kernels"``; (e3) ``ReadabilityServer(method=
   "exact")`` on (d)'s inputs (``EXACT_REFERENCE``); (e4) fault drills
   with the port's ``FaultPlan`` on the |V| = 10,000 layout-local graph
   of ``benchmarks/serve_bench.py`` (a failed B=8 dispatch split and
   retried, a NaN request quarantined alone, a cancelled and two shed
   requests, a hung chunk expired by the watchdog), each counter equal to
   ``FaultPlan.injected`` and every other slot's integers equal to an
   unfaulted run; (e5) ``count_crossings_enhanced``,
   ``crossing_angle_enhanced`` and ``count_occlusions_enhanced`` at |V| =
   100,000 against ``ENHANCED_REFERENCE``.  Outside the drills any error
   slot or failure counter fails the run: split-and-retry would otherwise
   hide a kernel that fails to launch.
   (f) the incremental path at full width: an ``EvalSession(cfg,
   update_dirty_threshold=1.0)`` registers (a)'s layout and one interior
   vertex is dragged for 20 frames (:func:`drag_moves`).  Every frame
   must take the delta path (``flags["incremental"]``, ``delta_hits`` + 1,
   no fallback), build nothing (``grid.CALL_COUNTS`` all 0), launch the
   strip-reversal kernel once per orientation on its dirty strips, have
   ``overflow == 0`` and equal a from-scratch ``sess.evaluate`` of the
   moved layout (integers exactly, floats at rtol 1e-5); the last frame
   equals ``DRAG_REFERENCE``.  The front door (``Evaluator(cfg)``)
   replays the first 3 frames on the delta path, and a move of the
   extremal vertex must fall back, counted, with a right result.  Phase
   2 checks the kernel at every slab the drag hands it, captured by a
   rehearsal of the drag on the plain version, and again with the
   invalid slots of each dirty-strip slab filled with garbage and one
   row emptied.
   (g) the differentiable path and the gradient search: (g1)
   ``examples/layout_optimization.py`` at its own settings (FR on
   ``random_edges(400, 800)`` from 2 random starts, 200 iterations
   checkpointed every 40, all checkpoints scored in one
   ``evaluate_batch``, then ``Evaluator.search`` from the winner, 80 steps
   x 4 restarts); (g2) ``GradientSearch(EvalConfig(radius=0.5,
   n_strips=512), **SEARCH_KNOBS)`` on the |V| = 100,000 layout (8
   restarts, 10 steps, re-scores every 5).  Every reported exact score
   (``scores`` and ``init_scores``) must equal the port's own
   ``evaluate_batch`` of the returned layouts, positions be finite, no
   restart end below its start, every re-score launch the strip-reversal
   kernel, and every such launch equal its plain version on the same slab
   (captured during the run); (g2)'s first soft loss, gradient norm and
   gradient rows at ``DIGEST_VERTICES`` must equal ``SEARCH_REFERENCE``
   at ``SEARCH_TOLERANCE``.
   (h) the distributed paths (``repro_torch.distributed``) on (a)'s
   layout and (b)'s batch: (h1) ``evaluate_graph_sharded`` on a one-rank
   NCCL group (a flat plan; integers equal to the single-device fused
   engine's and (a)'s constants; one halo exchange, none for an E_c /
   E_ca-only plan), (h3) ``evaluate_layouts_sharded`` of (b)'s batch
   ((b)'s constants), (h4) ``Evaluator(backend="distributed").evaluate``
   (N_c through the occlusion-pair kernel on a row range, E_c / E_ca
   through the strip-reversal kernel; (a)'s constants) and (h6) the
   session's mesh drills (``backend="graph_sharded"``, a lost mesh, the
   canary probe and auto-restore, a rejected probe; each counter what
   ``FaultPlan`` injected, every result the fused one); then on
   ``H_WORLD`` ranks over gloo, each a process on the one card: (h2) the
   graph-sharded evaluation (equal to (h1)), (h3) with a cut of
   ``H_CUT`` layouts, (h4) and (h5) ``sharded_crossing_count`` on (d)'s
   layout (kernel 3 on half the rows each; (d)'s E_c).  Every
   strip-reversal launch of (h) is held against the plain version, and
   every row-range launch (kernel, size, rows) is checked, timed and
   bounded.  Times of two ranks on one card are no speedup.
   (i) the main path at ``precision="bfloat16"`` on (a)'s layout and
   (b)'s batch: (i1) fused ``evaluate``, (i2) ``evaluate_batch`` B=8,
   (i3) ``backend="kernels"``, (i4) ``ReadabilityServer`` on the 8
   requests, against ``BF16_REFERENCE`` (the reference run op by op in
   bfloat16; integers equal, floats at ``BF16_RTOL``).  The fused paths
   launch the bfloat16 instantiation of the strip-reversal kernel; the
   kernels route launches the occlusion-pair kernel's bfloat16
   instantiation and sweeps float32 buckets, as the reference's wrapper
   casts them.  Every bfloat16 launch is captured and held against its
   plain version on the card, then each launched shape is timed and
   bounded (bfloat16 bytes), and each path's median is printed beside
   its float32 counterpart's.
   (j) the LM serving path: (j1) the five LM smoke configs at
   ``dtype=float32`` with parameters from ``numpy_params(cfg,
   LM_SEED)``, ``lm_generate``'s greedy tokens equal to
   ``LM_REFERENCE`` and the prefill logits at ``LM_RTOL``; (j2) qwen3-4b
   at its published width and depth in bfloat16 (float32 parameters
   from a CUDA generator, cast at each use): prefill of
   ``LM_FULL_BATCH`` x ``LM_FULL_PROMPT`` tokens, ``lm_generate`` of
   ``LM_FULL_NEW`` tokens, the last decode's logits against a fresh
   prefill of the extended sequence (``LM_BF16_REL_L2``), prefill and
   per-token decode times and peak memory; (j3)
   ``merge_decode_attention`` on a one-rank NCCL group against float32
   unsharded attention over (j2)'s layer-0 cache.
   (k) LM training (``repro_torch.launch.train``), float32 products with
   TF32 off where it says float32: (k1) the five LM smoke configs at
   ``dtype=float32`` from ``numpy_params(cfg, TRAIN_SEED)``, three
   ``build_lm_trainer`` steps on ``TokenStream`` batches (the second with
   ``grad_accum=2``), loss and grad norm per step against
   ``TRAIN_REFERENCE["smoke"]`` at ``TRAIN_RTOL``; then
   ``launch.train.main`` on qwen3-4b ``--smoke``: 4 steps straight, and 2
   steps with a checkpoint, a fresh ``main`` that resumes from it and 2
   more, every loss against the straight run's at
   ``TRAIN_RESUME_RTOL``; (k2a) qwen3-4b at its published width with 2
   layers at float32: ``loss_fn``'s total and
   xent and the gradient's global norm against
   ``TRAIN_REFERENCE["full_2l"]``; (k2) qwen3-4b at its published width
   and ``FULL_TRAIN_LAYERS`` layers, bfloat16 products on float32
   parameters and AdamW state, remat on, the loss in 16 chunks, a
   sequence of 4096 (train_4k) and a global batch cut from 256 to
   ``FULL_TRAIN_ACCUM`` micro-batches of one: ``FULL_TRAIN_STEPS`` steps
   on one batch, the last with int8-compressed gradients; losses finite
   and falling, the step time (CUDA events), tokens per second, MFU
   against the H100 SXM's dense bfloat16 peak, and peak memory beside
   the 16 bytes per parameter of its state.
   (l) the GNN and recsys families (``repro_torch.models.gnn``,
   ``.recsys``, ``graphs.sampler``), float32 with TF32 off, every
   kernel's launch count set to 0 before and required to be 0 after (no
   kernel of the port lies on these paths): (l1) the smoke configs of
   gcn-cora, graphsage-reddit (full graph, and on a fanout block fed in)
   and xdeepfm with parameters from ``numpy_params(cfg, GNN_SEED)`` on
   :func:`gnn_smoke_batch`'s inputs (masked edges and nodes, a seed
   without neighbours): logits, loss, gradient norm and ``GNN_STEPS``
   in-place AdamW steps' losses, and xdeepfm's retrieval scores, against
   ``GNN_REFERENCE`` at ``TRAIN_RTOL``; (l2) gcn-cora at ``full_graph_sm``
   (Cora's 2,708 nodes, 10,556 edges, 1,433 features, 7 classes;
   synthetic features and labels), its logits against the port on the
   CPU, the forward and a training step timed; (l3) graphsage-reddit at
   ``minibatch_lg`` (1,024 seeds, fanout 15-10, 602 features, 41
   classes) sampled on the card from a graph of Reddit's size (232,965
   nodes, 114,615,892 CSR entries, drawn in bulk), every unmasked
   neighbour of the first 64 seeds adjacent, sampling, forward and a
   training step timed apart; (l4) xdeepfm at its published config
   (91,020,160 table rows, 1,000,000 items) initialised on the card:
   ``serve_p99`` (512 rows) equal to the same rows of ``serve_bulk``
   (262,144 rows, the CIN in chunks), ``retrieval_cand`` against a
   float64 recount, two ``train_batch`` steps (65,536 rows) on one
   ``ClickLogStream`` batch with the second loss below the first; the
   latencies and peak memory.
   (m) the equivariant family (``repro_torch.models.so3``,
   ``.equivariant``), float32 with TF32 off, every kernel's launch count
   set to 0 before and required to be 0 after: (m1) the smoke configs of
   nequip and equiformer-v2 (full and compact eSCN) with parameters from
   ``numpy_params(cfg, GNN_SEED)`` on :func:`eqv_smoke_batch`'s padded
   batch (several edge chunks, masked self-loops and padding, a node
   without incoming edges, three graphs): energies, NequIP's forces, the
   loss, gradient norm and ``GNN_STEPS`` in-place AdamW steps' losses
   against ``EQV_REFERENCE`` at ``TRAIN_RTOL``; (m2) nequip and (m3)
   equiformer-v2 at their published configs on ``molecule`` (128 graphs
   of 30 nodes and 64 bonds, padded to 4,096 node and 16,384 edge
   slots), parameters drawn on the card: the first 16 graphs' energies
   against the port on the CPU (float32; bound twice that route's
   distance from a float64 run), invariance under a rotation and
   translation, (m3) compact against full eSCN, ``AdamWConfig()`` steps
   with the second loss below the first; forward and step times, peak
   memory and model FLOP/s by ``src/repro/launch/cells.py``'s formula.
   (n) the dry run and the roofline (``repro_torch.launch.cells``,
   ``.dryrun``, ``roofline.analysis``): (n1) ``python -m
   repro_torch.launch.dryrun`` in ``DRYRUN_JOBS`` child processes on
   this machine's cores, every cell of ``all_cells()`` and the three
   readability shapes traced over 256 fake ranks (16 x 16) on fake CUDA
   tensors, nothing allocated, the four skipped cells recorded with
   their reasons, then ``N1_MULTI_POD`` (one cell of each family) over
   512 (2 x 16 x 16): a line per cell (flops, per-device peak, whether it
   fits 80 GB, the dominant roofline term, trace seconds), failing if a
   cell fails or a child exits with another code than 0; (n2) the cells
   that fit one card (``N2_CELLS``: xdeepfm's four shapes, nequip and
   equiformer-v2 on ``molecule``, gcn-cora on ``full_graph_sm``,
   graphsage-reddit on ``minibatch_lg``, the readability shapes at
   ego-Facebook's size, both predicates for ``exact_crossing``) run for
   real on a one-rank mesh with inputs and weights from ``N2_SEED``,
   once to warm up and ``N2_RUNS`` times (CUDA events, median), float32
   with TF32 off and every kernel's launch count 0; each held to its
   trace on a (1, 1) fake mesh (``--trace-one-rank``, a child process):
   argument bytes equal to the byte, the median at least ``compute_s``;
   the readability counts equal to kernels 2r and 3r on the whole row
   range and kernel 1 on the same buckets (its deviation sum at rtol
   1e-5), those launches made after the timed runs.
4. **Timings**: median of 5 CUDA-event-timed runs after a warm-up, for
   (a)-(e3) and (e5); for (f), over 2 replays of the drag on fresh
   sessions, the median and p95 of a frame's ``update`` (host clock; the
   call returns host scores), ``register_layout`` and its priming alone,
   a warm full ``sess.evaluate`` of the dragged layout, and the
   synchronizing CUDA calls of one frame
   (``torch.cuda.set_sync_debug_mode``); for (g2), one search step's
   forward and backward beside one ``evaluate_layouts`` of the same batch
   and plan, the search's wall time and peak memory, and for (g1), FR's
   time per iteration; for each kernel at each shape
   launched in one pass of (a)-(g), its time alone on the device
   (median, min and max of 21
   readings of back-to-back launches of its C entry, whose outputs are
   then held against the wrapper's result), its wrapper's time, its plain
   version's and its bound, counted from the operations these inputs
   need, on the data phase 2 checked at that shape; a kernel's numbers
   are summed over its launches in the pass.

The last lines are a ``{"kernels": [...]}`` JSON line (the four kernels
over (a)-(g), the row-range launches of kernels 2 and 3 over (h) as
``occlusion_pairs_rows`` and ``segment_crossing_rows``, and the bfloat16
instantiations of kernels 1 and 2 over (i) as ``strip_reversal_bf16``
and ``occlusion_pairs_bf16``; each entry's ``launches_l``,
``launches_m`` and ``launches_n`` are its counts in (l), (m) and (n2)'s
cell runs, 0), the card line from ``nvidia-smi``, and ``{"ok": true,
"device": {...}}``.  ``python3 chip_smoke.py --rank R --world W --port
P`` is one rank of (h)'s gloo group, which the script starts itself;
``python3 chip_smoke.py --trace-one-rank OUT`` is (n2)'s one-rank
traces, in a process of their own (a fake process group).
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

N_V, SEED, FRAC_LONG = 100_000, 0, 0.002
RADIUS, N_STRIPS, BATCH, JITTER = 0.5, 512, 8, 0.02
RTOL = 1e-5
REPEATS = 5
# one H100 SXM (NVIDIA data sheet): HBM3 rate, and the FP32 pipe's issue
# rate (67 TFLOP/s counts an FMA as two operations: 132 SMs x 128 lanes
# x 1.98 GHz = 33.5e12 simple operations per second)
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 33.5e12
# operations the functions need on these inputs, on the valid slots only:
# a test that only some pairs reach is charged to those pairs, counted by
# the plain versions (the shared-endpoint mask left out where it says so).
# Strip reversal, per unordered pair {i, j} of valid slots of a row: the
# reversal in either order is 4 float compares (the ANDs folded into
# predicate-combining compares) and one predicate op joining the two
# orders: 5.  Per reversing pair (shared endpoints included): the 4 int
# compares for shared endpoints, folded: 4.  Per crossing (a reversal
# without a shared endpoint): one add to the count, and the deviation
# sub, sub, min, sub, div, add (abs is a free source modifier): 7.
# Occlusion, per unordered valid pair: 2 sub, 2 mul, 1 add, 1 compare: 6
# (the i < j order is the choice of unordered pairs); per occluded pair,
# one add to the count.
# Crossing test, per unordered pair of valid edges: the differences
# p2 - p1, q2 - p1, q1 - p2 (6 sub; q - p of each segment is per edge),
# four cross products (8 mul, 4 sub), the two straddle tests (3 each: a
# min, a max and one compare pair folded into a predicate op), one
# predicate op to join them: 25.  Per straddling pair (shared endpoints
# included): 4 int compares for shared endpoints, folded: 4.  Per
# crossing: one add to the count; and with the angle the deviation sub,
# sub, min, sub, mul, add: 6.
REV_OPS_PER_UNORDERED_PAIR = 5
REV_OPS_PER_REVERSAL = 4
REV_OPS_PER_CROSSING = 7
OCC_OPS_PER_PAIR = 6
OCC_OPS_PER_OCCLUSION = 1
CROSS_OPS_PER_UNORDERED_PAIR = 25
CROSS_OPS_PER_STRADDLE = 4
CROSS_OPS_PER_CROSSING = 1
ANGLE_OPS_PER_CROSSING = 6
# device time of a kernel alone: readings of back-to-back launches of its
# C entry, queued behind a sleep of about 2 ms (at the H100's 1.98 GHz)
# so that the host's enqueue does not pace them
DEVICE_READINGS = 21
SLEEP_CYCLES = 4_000_000
# repeats of the plain all-pairs versions at the exact path's size (each
# call takes about a second)
EXACT_PLAIN_REPEATS = 3

# the exact path's inputs: ego-Facebook at its published size (paper
# Table 1), the inputs of benchmarks/table3_accuracy.py at scale 1.0
EXACT_DATASET, EXACT_GRAPH_SEED, EXACT_LAYOUT_SEED = "ego-Facebook", 0, 1
EXACT_RADIUS = 0.5

# JAX reference constants for exactly these inputs, made on the CPU with
#   PYTHONPATH=src JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py
# (the reference run op by op; see that script's note on jit and FMA).
REFERENCE = {
    "fused": {
        "node_occlusion": 1538901,
        "minimum_angle": 0.7792223691940308,
        "edge_length_variation": 0.013489088974893093,
        "edge_crossing": 34534,
        "edge_crossing_angle": 0.7175037860870361,
        "crossing_count_for_angle": 34534,
        "overflow": 0,
    },
    "kernels": {
        "node_occlusion": 1538901,
        "minimum_angle": 0.7792223691940308,
        "edge_length_variation": 0.013489088974893093,
        "edge_crossing": 34534,
        "edge_crossing_angle": 0.7175037860870361,
        "crossing_count_for_angle": 34534,
        "overflow": 0,
    },
    "batch": [
        {
            "node_occlusion": 1538901,
            "minimum_angle": 0.7792223691940308,
            "edge_length_variation": 0.013489087112247944,
            "edge_crossing": 34534,
            "edge_crossing_angle": 0.7175037860870361,
            "crossing_count_for_angle": 34534,
            "overflow": 0,
        },
        {
            "node_occlusion": 1534049,
            "minimum_angle": 0.7613797187805176,
            "edge_length_variation": 0.013448505662381649,
            "edge_crossing": 34857,
            "edge_crossing_angle": 0.7166274189949036,
            "crossing_count_for_angle": 34857,
            "overflow": 0,
        },
        {
            "node_occlusion": 1533864,
            "minimum_angle": 0.7615199685096741,
            "edge_length_variation": 0.013448857702314854,
            "edge_crossing": 34533,
            "edge_crossing_angle": 0.7159731388092041,
            "crossing_count_for_angle": 34533,
            "overflow": 0,
        },
        {
            "node_occlusion": 1533890,
            "minimum_angle": 0.7615078687667847,
            "edge_length_variation": 0.013448761776089668,
            "edge_crossing": 34699,
            "edge_crossing_angle": 0.7175784111022949,
            "crossing_count_for_angle": 34699,
            "overflow": 0,
        },
        {
            "node_occlusion": 1534278,
            "minimum_angle": 0.7615787982940674,
            "edge_length_variation": 0.013448711484670639,
            "edge_crossing": 34570,
            "edge_crossing_angle": 0.718038022518158,
            "crossing_count_for_angle": 34570,
            "overflow": 0,
        },
        {
            "node_occlusion": 1534058,
            "minimum_angle": 0.7615923881530762,
            "edge_length_variation": 0.013449139893054962,
            "edge_crossing": 34598,
            "edge_crossing_angle": 0.7178776264190674,
            "crossing_count_for_angle": 34598,
            "overflow": 0,
        },
        {
            "node_occlusion": 1534240,
            "minimum_angle": 0.7617049217224121,
            "edge_length_variation": 0.013448338955640793,
            "edge_crossing": 34674,
            "edge_crossing_angle": 0.7166961431503296,
            "crossing_count_for_angle": 34674,
            "overflow": 0,
        },
        {
            "node_occlusion": 1534117,
            "minimum_angle": 0.7615830898284912,
            "edge_length_variation": 0.013448375277221203,
            "edge_crossing": 34660,
            "edge_crossing_angle": 0.7163858413696289,
            "crossing_count_for_angle": 34660,
            "overflow": 0,
        },
    ],
}
# phase (e4): the drills' graph, benchmarks/serve_bench.py's largest size
# and strip count (make_graph(10000): seed 0, frac_long 0.02), B = 8 (member
# 0 the layout, 1-7 jittered from numpy.random.default_rng(2)); a hung
# chunk's members carry DRILL_DEADLINE and the server DRILL_TIMEOUT
DRILL_N_V, DRILL_FRAC_LONG, DRILL_N_STRIPS = 10_000, 0.02, 128
DRILL_DEADLINE, DRILL_TIMEOUT, DRILL_HANG_SECONDS = 1.0, 2.0, 10.0
# phase (f): DRAG_FRAMES moves of one vertex of the |V| = 100,000 layout,
# each a step of N(0, DRAG_STEP) per coordinate from
# numpy.random.default_rng(DRAG_SEED) (benchmarks/serve_bench.py's drag);
# the front door replays the first DRAG_FRONT frames, and the forced
# fallback moves the vertex of largest x by DRAG_FALLBACK_STEP outward
DRAG_FRAMES, DRAG_STEP, DRAG_SEED = 20, 0.2, 5
DRAG_FRONT, DRAG_FALLBACK_STEP = 3, 0.05
# phase (g): the layout-generation loop of examples/layout_optimization.py
# at its own settings (random_edges(400, 800, seed=0), FR from
# random_layout(400, seed=s) for s < FR_STARTS, FR_ITERS iterations
# checkpointed every FR_CHECK with block FR_BLOCK, the checkpoints scored
# in one evaluate_batch at n_strips FR_N_STRIPS, then Evaluator.search from
# the winner), and (g2) the search at full width on the |V| = 100,000
# layout.  (g2)'s jitter is 0.001 of the layout's extent (a tenth of a
# unit, a third of the lattice spacing): docs/search.md's default of 0.05
# (5 units) scatters restarts 1-7 over the layout, and the plan's strip
# caps grow from 592 to 14,104 (phase (g) prints the caps of both).
FR_N, FR_EDGES, FR_STARTS, FR_ITERS, FR_CHECK, FR_BLOCK = 400, 800, 2, 200, 40, 256
FR_N_STRIPS, FR_SEARCH_STEPS, FR_SEARCH_RESTARTS = 256, 80, 4
SEARCH_KNOBS = dict(steps=10, restarts=8, rescore_every=5, jitter=0.001,
                    seed=0)
# (g2)'s peak learning rate: a tenth of the default 0.01 of the extent.
# AdamW's first updates are about lr * sign(g) on every coordinate, and the
# default (1.0 unit, three lattice spacings) scatters the layout within a
# few steps: the step-5 re-score then replans to strip caps of thousands
# and each later soft step takes minutes on the H100.
SEARCH_PEAK_LR = 0.1
# JAX reference constants of phase (g2): repro.core.soft.soft_loss summed
# over restart 0 of the search's batch, under the plan of that batch, at
# the starting temperature 0.05, and jax.value_and_grad of it (the loss,
# the gradient's L2 norm and its rows at DIGEST_VERTICES), made on the CPU
# with
#   PYTHONPATH=src JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py --search
# (op by op), which also recounts them with the port in float64.
SEARCH_REFERENCE = {
    "loss": 0.5776817798614502,
    "grad_norm": 0.0231400510297869,
    "rows": (
        (5.1071392590529285e-06, -9.433088962396141e-06),
        (6.055552148609422e-06, 3.4484564821468666e-05),
        (-5.790282739326358e-05, -2.6789972253027372e-05),
        (-3.711605677381158e-05, 6.922780812601559e-06),
        (-2.9762382837361656e-05, -4.630103285307996e-05),
        (3.743722481885925e-05, 1.1809226634795777e-05),
        (-1.8132459445041604e-05, 4.225003067404032e-05),
        (6.784422294003889e-05, 3.294555426691659e-05),
        (8.176201049536758e-07, 4.655510201700963e-05),
        (-4.793890911969356e-05, -3.23895292240195e-05),
        (-0.00019384181359782815, 5.624353070743382e-05),
        (-1.1128420737804845e-05, -4.054954115417786e-05),
        (1.64872981258668e-05, -2.4522737476218026e-06),
        (-1.9222994524170645e-05, -1.838449747992854e-06),
        (-3.6092398659093305e-05, 3.607284088502638e-05),
        (-8.89534112502588e-06, 7.707133590884041e-06),
    ),
    # the same loss and gradient recounted with the port in float64 on the
    # CPU: the reference's float32 values are off by these (the port's
    # float32 CPU route by the same, to three digits)
    "float64": {
        "loss": 0.5776811761897346,
        "grad_norm": 0.023137678709087395,
        "loss_rel_diff": 1.0449911482267385e-06,
        "grad_norm_rel_diff": 0.00010253062674666215,
        "rows_max_abs_diff_over_max_row": 1.0542189156138235e-05,
    },
}
# (g2)'s tolerances, from that recount: a float32 route is off the float64
# values by 1.0e-6 (loss), 1.03e-4 (gradient norm) and 1.05e-5 of the
# largest digest row (rows); a route on the card sums and rounds its own
# way, so two float32 routes may differ by twice that.  The loss keeps
# rtol 1e-4 (a margin of 50), the norm takes rtol 3e-4 (1.5 times twice
# its float32 error) and the rows an absolute 1e-4 of the largest row (a
# margin of 5).
SEARCH_TOLERANCE = {"loss_rtol": 1e-4, "norm_rtol": 3e-4,
                    "rows_atol_frac": 1e-4}
# the vertices whose gradient rows (g2) holds against the reference
DIGEST_VERTICES = tuple(int(round(i * (N_V - 1) / 15)) for i in range(16))

# timed replays of the drag (phase 4), each on a fresh session
DRAG_REPLAYS = 2
# phase (h): (h2)-(h5) run on H_WORLD ranks over gloo, every rank a
# process of its own on the one card (NCCL refuses two ranks on one
# device), so their times are no speedup; (h3) also evaluates the first
# H_CUT layouts of (b)'s batch, which the ranks pad with copies of layout
# 0; each rank process must end within H_TIMEOUT seconds
H_WORLD, H_CUT, H_TIMEOUT = 2, 7, 600

# JAX reference constants of phase (f): the reference's EvalSession(cfg,
# update_dirty_threshold=1.0) on the |V| = 100,000 layout after the 20
# moves of drag_moves (the last update's scores, and a from-scratch
# evaluate of the final layout), made on the CPU with
#   PYTHONPATH=src JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py --drag
# (op by op; every frame took the reference's delta path)
DRAG_REFERENCE = {
    "update": {
        "node_occlusion": 1538904,
        "minimum_angle": 0.7792065143585205,
        "edge_length_variation": 0.013488225638866425,
        "edge_crossing": 34571,
        "edge_crossing_angle": 0.7176024317741394,
        "crossing_count_for_angle": 34571,
        "overflow": 0,
    },
    "scratch": {
        "node_occlusion": 1538904,
        "minimum_angle": 0.7792065143585205,
        "edge_length_variation": 0.013488225638866425,
        "edge_crossing": 34571,
        "edge_crossing_angle": 0.7176024317741394,
        "crossing_count_for_angle": 34571,
        "overflow": 0,
    },
}

# JAX reference constants of repro.api.evaluate_exact(pos, edges,
# config=EvalConfig(radius=0.5), use_kernels=False) on the exact path's
# inputs, made on the CPU with
#   PYTHONPATH=src JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py --exact
# (op by op; both routes of the port are held to them)
EXACT_REFERENCE = {
    "node_occlusion": 2533,
    "minimum_angle": 0.01865684986114502,
    "edge_length_variation": 0.0015983630437403917,
    "edge_crossing": 900016170,
    "edge_crossing_angle": 0.7149947881698608,
    "crossing_count_for_angle": 900016170,
    "overflow": 0,
}

# JAX reference constants of phase (e5): repro.core's
# count_crossings_enhanced / crossing_angle_enhanced (n_strips=512, "both")
# and count_occlusions_enhanced (radius 0.5) on the |V| = 100,000 layout,
# made on the CPU with
#   PYTHONPATH=src JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py --serve
# (op by op).  The same run served (b)'s batch through the reference's
# ReadabilityServer as (e1) does and found its integers equal to
# REFERENCE["batch"], which (e1) and (e2) are held to; (e3) is (d0)'s call
# and is held to EXACT_REFERENCE.
ENHANCED_REFERENCE = {
    "count_crossings_enhanced": {"count": 34534, "overflow": 0},
    "crossing_angle_enhanced": {
        "edge_crossing_angle": 0.7175037860870361,
        "count": 34534,
        "dev_sum": 9755.7255859375,
        "overflow": 0,
    },
    "count_occlusions_enhanced": {"count": 1538901, "overflow": 0},
}

# (i): the reference's op-by-op bfloat16 run of (a)-(b)'s inputs
#   PYTHONPATH=src JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py --bf16
# Floats are held at two bfloat16 ulps (2^-7 relative): sums run in
# another order than the reference's and round to bfloat16.
BF16_RTOL = 2.0 ** -7
BF16_REFERENCE = {'fused': {'node_occlusion': 1284307,
           'minimum_angle': 0.484375,
           'edge_length_variation': 0.013074737973511219,
           'edge_crossing': 30403,
           'edge_crossing_angle': 0.78125,
           'crossing_count_for_angle': 30403,
           'overflow': 0},
 'batch': [{'node_occlusion': 1284307,
            'minimum_angle': 0.484375,
            'edge_length_variation': 0.013074737973511219,
            'edge_crossing': 1727,
            'edge_crossing_angle': 0.8203125,
            'crossing_count_for_angle': 1727,
            'overflow': 78017},
           {'node_occlusion': 1286212,
            'minimum_angle': 0.47265625,
            'edge_length_variation': 0.012934901751577854,
            'edge_crossing': 1938,
            'edge_crossing_angle': 0.8203125,
            'crossing_count_for_angle': 1938,
            'overflow': 79840},
           {'node_occlusion': 1286859,
            'minimum_angle': 0.47265625,
            'edge_length_variation': 0.012934901751577854,
            'edge_crossing': 1955,
            'edge_crossing_angle': 0.8203125,
            'crossing_count_for_angle': 1955,
            'overflow': 79681},
           {'node_occlusion': 1286485,
            'minimum_angle': 0.47265625,
            'edge_length_variation': 0.012934901751577854,
            'edge_crossing': 1900,
            'edge_crossing_angle': 0.81640625,
            'crossing_count_for_angle': 1900,
            'overflow': 79656},
           {'node_occlusion': 1286534,
            'minimum_angle': 0.47265625,
            'edge_length_variation': 0.012934901751577854,
            'edge_crossing': 1915,
            'edge_crossing_angle': 0.81640625,
            'crossing_count_for_angle': 1915,
            'overflow': 80295},
           {'node_occlusion': 1286543,
            'minimum_angle': 0.47265625,
            'edge_length_variation': 0.012934901751577854,
            'edge_crossing': 1933,
            'edge_crossing_angle': 0.8125,
            'crossing_count_for_angle': 1933,
            'overflow': 80042},
           {'node_occlusion': 1286773,
            'minimum_angle': 0.47265625,
            'edge_length_variation': 0.012934901751577854,
            'edge_crossing': 1953,
            'edge_crossing_angle': 0.81640625,
            'crossing_count_for_angle': 1953,
            'overflow': 80099},
           {'node_occlusion': 1286194,
            'minimum_angle': 0.47265625,
            'edge_length_variation': 0.012934901751577854,
            'edge_crossing': 1978,
            'edge_crossing_angle': 0.8203125,
            'crossing_count_for_angle': 1978,
            'overflow': 79903}],
 'kernels': {'node_occlusion': 1284382,
             'minimum_angle': 0.484375,
             'edge_length_variation': 0.013074737973511219,
             'edge_crossing': 30403,
             'edge_crossing_angle': 0.7818988561630249,
             'crossing_count_for_angle': 30403,
             'overflow': 0},
 'serve': [{'node_occlusion': 1284307,
            'minimum_angle': 0.484375,
            'edge_length_variation': 0.013074737973511219,
            'edge_crossing': 30403,
            'edge_crossing_angle': 0.78125,
            'crossing_count_for_angle': 30403,
            'overflow': 0},
           {'node_occlusion': 1286212,
            'minimum_angle': 0.47265625,
            'edge_length_variation': 0.012934901751577854,
            'edge_crossing': 30853,
            'edge_crossing_angle': 0.78125,
            'crossing_count_for_angle': 30853,
            'overflow': 0},
           {'node_occlusion': 1286859,
            'minimum_angle': 0.47265625,
            'edge_length_variation': 0.012934901751577854,
            'edge_crossing': 31311,
            'edge_crossing_angle': 0.78125,
            'crossing_count_for_angle': 31311,
            'overflow': 0},
           {'node_occlusion': 1286485,
            'minimum_angle': 0.47265625,
            'edge_length_variation': 0.012934901751577854,
            'edge_crossing': 31198,
            'edge_crossing_angle': 0.78125,
            'crossing_count_for_angle': 31198,
            'overflow': 0},
           {'node_occlusion': 1286534,
            'minimum_angle': 0.47265625,
            'edge_length_variation': 0.012934901751577854,
            'edge_crossing': 31884,
            'edge_crossing_angle': 0.78125,
            'crossing_count_for_angle': 31884,
            'overflow': 0},
           {'node_occlusion': 1286543,
            'minimum_angle': 0.47265625,
            'edge_length_variation': 0.012934901751577854,
            'edge_crossing': 31545,
            'edge_crossing_angle': 0.78125,
            'crossing_count_for_angle': 31545,
            'overflow': 0},
           {'node_occlusion': 1286773,
            'minimum_angle': 0.47265625,
            'edge_length_variation': 0.012934901751577854,
            'edge_crossing': 32102,
            'edge_crossing_angle': 0.78125,
            'crossing_count_for_angle': 32102,
            'overflow': 0},
           {'node_occlusion': 1286194,
            'minimum_angle': 0.47265625,
            'edge_length_variation': 0.012934901751577854,
            'edge_crossing': 31854,
            'edge_crossing_angle': 0.78125,
            'crossing_count_for_angle': 31854,
            'overflow': 0}]}
# per crossing, the bfloat16 deviation's four roundings (a convert and a
# widening each) on top of REV_OPS_PER_CROSSING
REV_OPS_BF16_ROUNDING = 8

# (j1): the five LM smoke configs at float32 (tools/chip_smoke_reference.py
# --lm): lm_generate's tokens and the prefill logits' first 8 entries and
# norm per row.  Float32 products on the card run in full float32
# (TF32 off) in another summation order: rtol 1e-4, atol 1e-5.
LM_SEED, LM_BATCH, LM_PROMPT, LM_NEW = 0, 2, 16, 8
LM_RTOL, LM_ATOL = 1e-4, 1e-5
LM_REFERENCE = {'codeqwen1.5-7b': {'tokens': [[42, 110, 15, 88, 88, 94, 110, 42],
                               [110, 110, 110, 110, 81, 84, 81, 84]],
                    'prefill_logits_head': [[-1.427754521369934,
                                             2.01348614692688,
                                             0.9796618223190308,
                                             0.9103478789329529,
                                             -1.2241079807281494,
                                             0.5565658211708069,
                                             -0.2401045709848404,
                                             -2.127638816833496],
                                            [-0.22779570519924164,
                                             -0.7448955178260803,
                                             0.6789475083351135,
                                             -0.3486896753311157,
                                             -1.1200276613235474,
                                             -1.0491267442703247,
                                             0.4199399948120117,
                                             -0.6879891753196716]],
                    'prefill_logits_norm': [11.597836209393575,
                                            11.400999175569634]},
 'internlm2-20b': {'tokens': [[8, 69, 101, 79, 99, 62, 8, 87],
                              [17, 126, 68, 88, 116, 100, 126, 15]],
                   'prefill_logits_head': [[-0.7389188408851624,
                                            1.5042724609375,
                                            0.49700719118118286,
                                            0.42805200815200806,
                                            2.3623578548431396,
                                            -0.1544264405965805,
                                            0.7458085417747498,
                                            -0.6975319981575012],
                                           [-1.2960243225097656,
                                            -2.5112674236297607,
                                            -0.22893299162387848,
                                            0.7384325861930847,
                                            0.4493400752544403,
                                            0.36397552490234375,
                                            0.6657441258430481,
                                            -0.4795270264148712]],
                   'prefill_logits_norm': [10.392465844381244,
                                           10.018171055279065]},
 'qwen3-4b': {'tokens': [[45, 45, 45, 45, 45, 45, 45, 45],
                         [14, 103, 18, 2, 18, 2, 18, 2]],
              'prefill_logits_head': [[1.5704635381698608,
                                       -1.4145756959915161,
                                       0.8614832758903503,
                                       -1.03648841381073,
                                       0.1737363040447235,
                                       1.5111080408096313,
                                       -0.4172775149345398,
                                       0.8273610472679138],
                                      [0.3451894521713257,
                                       -0.6854243874549866,
                                       1.2098339796066284,
                                       0.6658368706703186,
                                       1.247939109802246,
                                       -0.263495534658432,
                                       0.6515786051750183,
                                       -0.5024695992469788]],
              'prefill_logits_norm': [11.7309503093634, 10.964649217087638]},
 'qwen2-moe-a2.7b': {'tokens': [[98, 125, 51, 25, 13, 5, 113, 7],
                                [41, 11, 122, 113, 113, 122, 122, 122]],
                     'prefill_logits_head': [[-0.8956657648086548,
                                              -1.0456881523132324,
                                              1.3850188255310059,
                                              -0.30147239565849304,
                                              -0.2698873281478882,
                                              0.430183470249176,
                                              1.1575989723205566,
                                              0.9238046407699585],
                                             [0.6380589008331299,
                                              -2.1757473945617676,
                                              0.34896692633628845,
                                              1.5834403038024902,
                                              -0.8293048739433289,
                                              -0.24257104098796844,
                                              0.4925926625728607,
                                              0.29234814643859863]],
                     'prefill_logits_norm': [11.109318661125911,
                                             11.372087669898827]},
 'llama4-scout-17b-a16e': {'tokens': [[120, 33, 84, 45, 45, 45, 45, 96],
                                      [95, 116, 65, 59, 79, 106, 82, 18]],
                           'prefill_logits_head': [[0.795693039894104,
                                                    -0.6522175073623657,
                                                    -1.1207534074783325,
                                                    -1.3239738941192627,
                                                    -0.04738558828830719,
                                                    -2.3678877353668213,
                                                    0.867202639579773,
                                                    0.4081200063228607],
                                                   [-0.21198774874210358,
                                                    -0.5306887030601501,
                                                    -0.4257929027080536,
                                                    -1.6279425621032715,
                                                    0.41749462485313416,
                                                    -0.09630225598812103,
                                                    -0.2384946048259735,
                                                    -0.1684015393257141]],
                           'prefill_logits_norm': [11.519824446110267,
                                                   10.000899048585115]}}
# (j2): qwen3-4b at its published size, bfloat16: B x P prompt tokens,
# N new ones; the last decode's logits against a fresh prefill, at a
# relative L2 distance per row of at most LM_BF16_REL_L2 (the two
# routes round bfloat16 products in another order over 36 layers).
LM_FULL_BATCH, LM_FULL_PROMPT, LM_FULL_NEW = 4, 512, 32
LM_BF16_REL_L2 = 0.05
# (j3): bfloat16 scores and probabilities against float32 attention
LM_MERGE_ATOL = 0.05

# (k1): three trainer steps of each LM smoke config at float32 on
# TokenStream(vocab, TRAIN_SEQ, TRAIN_BATCH, seed=TRAIN_SEED) batches, the
# step i with grad_accum TRAIN_ACCUM[i], AdamWConfig(**TRAIN_OPT); then
# launch.train.main with TRAIN_MAIN_ARGS, 4 steps against 2 + resume + 2.
TRAIN_SEED, TRAIN_BATCH, TRAIN_SEQ = 0, 4, 32
TRAIN_ACCUM = (1, 2, 1)
TRAIN_OPT = dict(peak_lr=3e-3, warmup_steps=2, total_steps=3)
TRAIN_MAIN_ARGS = ["--arch", "qwen3-4b", "--smoke", "--batch", "4",
                   "--seq", "32", "--lr", "1e-3", "--seed", "0"]
# float32 products on the card (TF32 off) summed in another order than
# the reference's on the CPU.  Two runs of main on the card may differ in
# the embedding's backward (index_put_ with accumulate sorts the token ids
# without a stable order unless deterministic algorithms are on, so the
# adds of a repeated id may come in another order), so the losses of two
# runs are held at TRAIN_RESUME_RTOL, not bit for bit
TRAIN_RTOL, TRAIN_RESUME_RTOL = 1e-4, 1e-5
# (k2a): one TokenStream batch of FULL_2L_BATCH x FULL_2L_SEQ
FULL_2L_BATCH, FULL_2L_SEQ = 2, 128
# JAX reference constants of (k1) and (k2a), made on the CPU with
#   PYTHONPATH=src JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py --train
# (the reference's jitted build_lm_trainer and loss_fn on the same numpy
# parameters and TokenStream batches)
TRAIN_REFERENCE = {'smoke': {'codeqwen1.5-7b': {'loss': [5.423582077026367,
                                       5.298740386962891,
                                       5.102720260620117],
                              'grad_norm': [10.427703857421875,
                                            12.085379600524902,
                                            9.18924331665039]},
           'internlm2-20b': {'loss': [5.389583110809326,
                                      5.261530876159668,
                                      5.0801262855529785],
                             'grad_norm': [9.725687980651855,
                                           8.911918640136719,
                                           11.265782356262207]},
           'qwen3-4b': {'loss': [5.372411727905273,
                                 5.158551216125488,
                                 5.101534843444824],
                        'grad_norm': [10.029040336608887,
                                      11.05087947845459,
                                      9.245591163635254]},
           'qwen2-moe-a2.7b': {'loss': [5.338861465454102,
                                        5.291921615600586,
                                        5.0810418128967285],
                               'grad_norm': [9.898399353027344,
                                             11.975287437438965,
                                             8.249823570251465]},
           'llama4-scout-17b-a16e': {'loss': [5.298683166503906,
                                              5.2311601638793945,
                                              5.1954145431518555],
                                     'grad_norm': [12.143720626831055,
                                                   10.167556762695312,
                                                   9.73021125793457]}},
 'full_2l': {'loss': 12.472524642944336,
             'xent': 12.472524642944336,
             'tokens': 254.0,
             'grad_norm': 16.466293334960938}}
# (k2): qwen3-4b at full width, train_4k's sequence, the global batch of
# 256 cut to FULL_TRAIN_ACCUM micro-batches of 1; FULL_TRAIN_STEPS steps on
# one batch at peak lr FULL_TRAIN_LR (warmup 1), the last one compressed
FULL_TRAIN_LAYERS, FULL_TRAIN_SEQ = 36, 4096
FULL_TRAIN_ACCUM, FULL_TRAIN_STEPS, FULL_TRAIN_LR = 4, 4, 1e-4
# H100 SXM dense bfloat16 tensor-core peak (NVIDIA data sheet), FLOP/s
BF16_PEAK_FLOPS = 989.4e12
# (l): the GNN and recsys families.  (l1) the smoke configs at float32 on
# numpy_params(cfg, GNN_SEED) and gnn_smoke_batch's inputs: a forward,
# then GNN_STEPS in-place AdamW steps (AdamWConfig(**GNN_OPT), the
# reference's smoke-test optimizer), against GNN_REFERENCE at TRAIN_RTOL
GNN_SEED, GNN_STEPS = 0, 3
GNN_OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
GNN_CASES = ("gcn-cora", "graphsage-reddit", "graphsage-sampled", "xdeepfm")
# (l2) gcn-cora at src/repro/launch/cells.py's full_graph_sm (Cora's
# published size), padded to multiples of 512 as the cell pads it
CORA_NODES, CORA_EDGES, CORA_FEAT, CORA_CLASSES = 2_708, 10_556, 1_433, 7
# (l3) graphsage-reddit at minibatch_lg (1,024 seeds, fanout 15-10) on a
# graph of Reddit's size as PyG's Reddit dataset gives it: 232,965 nodes,
# 114,615,892 directed CSR entries from 57,307,946 undirected edge rows
REDDIT_NODES, REDDIT_ROWS, REDDIT_FEAT, REDDIT_CLASSES = \
    232_965, 57_307_946, 602, 41
REDDIT_SEEDS, REDDIT_FANOUT, REDDIT_CHECKED = 1_024, (15, 10), 64
# (l2), (l3) training steps timed (median), at GNN_FULL_LR
GNN_FULL_STEPS, GNN_FULL_LR = 5, 1e-3
# (l4) xdeepfm at its published config: serve_p99, serve_bulk,
# retrieval_cand and two train_batch steps on one ClickLogStream batch
XDFM_P99, XDFM_BULK, XDFM_TRAIN, XDFM_STEPS, XDFM_LR = \
    512, 262_144, 65_536, 2, 1e-4
# the bulk call's first XDFM_P99 logits against the p99 call's, and the
# retrieval scores against a float64 recount, each within this fraction
# of the largest magnitude
XDFM_SAME_RTOL, XDFM_SCORES_RTOL = 1e-5, 1e-4
# JAX reference constants of (l1), made on the CPU with
#   PYTHONPATH=src JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py --gnn
# (the reference's modules op by op on the same numpy parameters and
# inputs; logits in full, the retrieval scores' first 16 and L2 norm;
# about 40 s of CPU)
GNN_REFERENCE = {'gcn-cora': {'logits': [0.5069126486778259,
                         0.30858391523361206,
                         0.5167175531387329,
                         0.20222531259059906,
                         0.12843400239944458,
                         0.12352809309959412,
                         0.023561708629131317,
                         -0.13402006030082703,
                         -0.21766583621501923,
                         0.6963360905647278,
                         0.7624636888504028,
                         0.6009795665740967,
                         0.26846110820770264,
                         0.29911473393440247,
                         0.28203508257865906,
                         0.7515414953231812,
                         0.6545933485031128,
                         0.778952956199646,
                         0.628263533115387,
                         0.8320399522781372,
                         0.5622397661209106,
                         0.19551680982112885,
                         0.1428006887435913,
                         -0.04258570820093155,
                         0.5414441227912903,
                         0.2256172001361847,
                         0.38362085819244385,
                         0.1610967367887497,
                         -0.015183672308921814,
                         -0.024486854672431946,
                         0.626350998878479,
                         0.7780171632766724,
                         0.5784364938735962,
                         0.33516108989715576,
                         0.5735591650009155,
                         0.16420282423496246,
                         0.6498379707336426,
                         0.5271283984184265,
                         0.4538233280181885,
                         0.48547232151031494,
                         0.4454801082611084,
                         0.4423828125,
                         0.30134689807891846,
                         0.38474178314208984,
                         0.28356704115867615,
                         0.9054617285728455,
                         0.9196819067001343,
                         0.9186059832572937,
                         0.373573899269104,
                         0.29540708661079407,
                         0.3441631495952606,
                         0.8434723019599915,
                         1.4481092691421509,
                         0.6730536222457886,
                         0.5122132301330566,
                         0.11226841807365417,
                         0.2784304618835449,
                         0.3453454077243805,
                         0.16130557656288147,
                         0.1860344409942627,
                         0.5530000329017639,
                         0.8028269410133362,
                         0.48462092876434326,
                         0.3987501859664917,
                         0.5329477787017822,
                         0.1930522918701172,
                         0.5409538745880127,
                         0.5816630125045776,
                         0.39367589354515076,
                         0.6418664455413818,
                         0.7763572335243225,
                         0.6312234401702881,
                         0.5628334283828735,
                         0.24650132656097412,
                         0.35476821660995483,
                         0.6034422516822815,
                         0.5195701122283936,
                         0.38997265696525574,
                         0.5366145968437195,
                         0.3377962112426758,
                         0.4874223470687866,
                         0.3546313941478729,
                         0.6407322287559509,
                         0.25248876214027405,
                         0.5966191291809082,
                         0.8202356100082397,
                         0.5773006677627563,
                         0.7064810991287231,
                         0.6864351630210876,
                         0.5637692213058472,
                         0.33650052547454834,
                         0.3484429717063904,
                         0.27386826276779175,
                         0.37925437092781067,
                         0.5958449840545654,
                         0.18726235628128052,
                         -0.019378384575247765,
                         0.18170738220214844,
                         -0.21597149968147278,
                         0.012113191187381744,
                         0.010357864201068878,
                         -0.12204340100288391,
                         0.30696922540664673,
                         -0.11053073406219482,
                         0.2092539370059967,
                         0.008927807211875916,
                         -0.07921193540096283,
                         -0.4737377464771271,
                         0.42984241247177124,
                         -0.2067367434501648,
                         0.2854228615760803,
                         0.586378812789917,
                         0.7160104513168335,
                         0.4046970009803772,
                         0.4148140549659729,
                         0.3165162205696106,
                         0.4146021008491516,
                         1.0254731178283691,
                         1.3123044967651367,
                         0.9535680413246155],
              'loss': 1.1270427703857422,
              'grad_norm': 0.2332545667886734,
              'losses': [1.1270427703857422,
                         1.126181960105896,
                         1.1244760751724243]},
 'graphsage-reddit': {'logits': [0.061182886362075806,
                                 0.5269701480865479,
                                 0.04732475429773331,
                                 -0.2871233820915222,
                                 0.6986367702484131,
                                 0.22218601405620575,
                                 0.8844122886657715,
                                 0.9142128229141235,
                                 0.2516483664512634,
                                 0.5696433782577515,
                                 1.433576226234436,
                                 0.6045078039169312,
                                 0.7828153371810913,
                                 1.5382338762283325,
                                 -0.9429519176483154,
                                 -0.5860534906387329,
                                 1.3653632402420044,
                                 -1.4810975790023804,
                                 0.05344662070274353,
                                 1.3073534965515137,
                                 -0.5911542177200317,
                                 0.5409705638885498,
                                 1.1907589435577393,
                                 0.35087525844573975,
                                 -0.7702559232711792,
                                 2.233591079711914,
                                 -0.4489533603191376,
                                 0.614109218120575,
                                 2.049973249435425,
                                 1.2418015003204346,
                                 1.038767695426941,
                                 1.1130414009094238,
                                 -0.3783385157585144,
                                 0.788045346736908,
                                 1.699204444885254,
                                 0.548793613910675,
                                 -0.11609017848968506,
                                 2.0060038566589355,
                                 -0.24969933927059174,
                                 -0.4735102653503418,
                                 1.4982339143753052,
                                 1.118186116218567,
                                 1.3808963298797607,
                                 1.0713375806808472,
                                 0.008668676018714905,
                                 -0.26559317111968994,
                                 1.3967945575714111,
                                 -2.1199114322662354,
                                 0.1441653072834015,
                                 0.31779447197914124,
                                 -0.33533963561058044,
                                 0.32049721479415894,
                                 1.2635327577590942,
                                 -1.1913467645645142,
                                 0.06913493573665619,
                                 0.4489617943763733,
                                 0.32669809460639954,
                                 -0.6117128133773804,
                                 1.7849583625793457,
                                 -1.5203701257705688,
                                 0.4080187678337097,
                                 1.1689437627792358,
                                 -0.2852834463119507,
                                 0.3542637526988983,
                                 0.77228844165802,
                                 -0.3456043601036072,
                                 -0.44994544982910156,
                                 1.4329242706298828,
                                 0.20172113180160522,
                                 0.6188272833824158,
                                 1.1134381294250488,
                                 1.3115383386611938,
                                 0.7749525308609009,
                                 1.1055443286895752,
                                 -0.5582435131072998,
                                 1.3099344968795776,
                                 2.2219886779785156,
                                 -1.0568711757659912,
                                 -0.7810872197151184,
                                 0.35050463676452637,
                                 -1.2881224155426025,
                                 -0.2883530855178833,
                                 1.4680393934249878,
                                 -0.29301947355270386,
                                 -0.3657287359237671,
                                 1.2569488286972046,
                                 -1.6142672300338745,
                                 0.45800602436065674,
                                 1.4489701986312866,
                                 1.4394036531448364,
                                 0.47580617666244507,
                                 1.367830514907837,
                                 1.1686067581176758,
                                 0.7366524934768677,
                                 1.237418293952942,
                                 0.5853755474090576,
                                 -0.680099606513977,
                                 1.1985886096954346,
                                 -0.0029415488243103027,
                                 1.168813705444336,
                                 1.1761988401412964,
                                 0.054930709302425385,
                                 0.5452252626419067,
                                 0.805075466632843,
                                 -0.27774032950401306,
                                 0.269908607006073,
                                 2.011012077331543,
                                 1.0654784440994263,
                                 0.8641863465309143,
                                 1.4471001625061035,
                                 0.1310652494430542,
                                 0.3885420560836792,
                                 1.4028451442718506,
                                 0.23594355583190918,
                                 -0.36272209882736206,
                                 0.17556987702846527,
                                 -0.7253037095069885,
                                 -0.22118216753005981,
                                 2.370245933532715,
                                 -2.36877703666687],
                      'loss': 1.5011401176452637,
                      'grad_norm': 1.1199244260787964,
                      'losses': [1.5011401176452637,
                                 1.495403528213501,
                                 1.4840643405914307]},
 'graphsage-sampled': {'logits': [-0.0794057548046112,
                                  0.3012251853942871,
                                  -0.28446757793426514,
                                  -0.5971021056175232,
                                  2.2381129264831543,
                                  1.3212627172470093,
                                  0.8974559903144836,
                                  0.925190806388855,
                                  -0.06829306483268738,
                                  -0.5046334266662598,
                                  0.8799571990966797,
                                  0.395330011844635,
                                  -0.4388168156147003,
                                  0.703548789024353,
                                  -0.1638558804988861,
                                  1.2456707954406738,
                                  1.1028764247894287,
                                  -0.09852947294712067,
                                  -0.5704609751701355,
                                  0.7636750936508179,
                                  -1.2642114162445068,
                                  0.4454335570335388,
                                  0.6520783305168152,
                                  -0.3623192608356476],
                       'loss': 1.1632715463638306,
                       'grad_norm': 1.4546698331832886,
                       'losses': [1.1632715463638306,
                                  1.1557620763778687,
                                  1.1408623456954956]},
 'xdeepfm': {'logits': [0.02236831746995449,
                        -0.01491298247128725,
                        -0.009100478142499924,
                        -0.03100842610001564,
                        -0.012694540433585644,
                        -0.018722575157880783,
                        0.0058674681931734085,
                        -0.03628986328840256,
                        -0.0382717102766037,
                        -0.024631429463624954,
                        -0.005294016562402248,
                        -0.012418553233146667,
                        0.0015511875972151756,
                        0.005017413757741451,
                        -0.009461138397455215,
                        -0.02796490490436554,
                        -0.02897360920906067,
                        0.039014916867017746,
                        -0.043043289333581924,
                        0.0077209859155118465,
                        0.02155131846666336,
                        -0.005956460256129503,
                        0.039206989109516144,
                        -0.026112383231520653,
                        0.009544402360916138,
                        -0.038217198103666306,
                        -0.002610811498016119,
                        0.028823889791965485,
                        -0.0067909411154687405,
                        0.030983032658696175,
                        -0.019469644874334335,
                        -0.046153128147125244],
             'scores_head': [-0.0001311398227699101,
                             0.00015741233073640615,
                             -9.096325084101409e-05,
                             5.718014654121362e-05,
                             0.00025602258392609656,
                             4.454495501704514e-05,
                             0.00014903185365255922,
                             -7.724409806542099e-05,
                             0.00012681380030699074,
                             3.635548637248576e-05,
                             0.00014778960030525923,
                             -7.040234049782157e-05,
                             -1.878372313512955e-05,
                             -3.3141914173029363e-06,
                             -5.912039341637865e-05,
                             0.00015523785259574652],
             'scores_norm': 0.0024169766398335324,
             'loss': 0.6923440098762512,
             'grad_norm': 0.22646033763885498,
             'losses': [0.6923440098762512,
                        0.6906144022941589,
                        0.6872937679290771]}}
# (m): the equivariant family, float32 with TF32 off.  (m1) the smoke
# configs (EQV_CASES: nequip, equiformer-v2 in both eSCN layouts) at
# numpy_params(cfg, GNN_SEED) on eqv_smoke_batch's padded batch: energies,
# NequIP's forces, the loss, its gradient's norm and GNN_STEPS in-place
# AdamW steps (AdamWConfig(**GNN_OPT)) against EQV_REFERENCE at TRAIN_RTOL
EQV_CASES = ("nequip", "equiformer-v2", "equiformer-v2-compact")
# (m2) nequip and (m3) equiformer-v2 at their published configs on the
# molecule shape as src/repro/launch/cells.py builds it: 128 graphs of 30
# nodes and 64 edges (batch_molecules), padded to 4,096 node and 16,384
# edge slots, energies of 128 graphs against random targets
MOL_GRAPHS, MOL_NODES_PER, MOL_EDGES_PER = 128, 30, 64
MOL_NODE_SLOTS, MOL_EDGE_SLOTS = 4_096, 16_384
# the card's energies of the first MOL_CHECKED graphs against the port on
# the CPU on the sub-batch of those graphs
MOL_CHECKED = 16
# tests/test_equivariant.py's invariance bars and
# tests/test_perf_variants.py's compact-vs-full rtol
EQV_INV_RTOL, EQV_INV_ATOL, EQV_COMPACT_RTOL = 2e-4, 1e-4, 1e-4
# AdamWConfig() training steps on one batch (the first two losses
# compared), timed after the first
EQV_STEPS = 1 + REPEATS
# the H100 SXM's float32 peak outside the tensor cores (NVIDIA's data
# sheet, at the 700 W limit)
F32_PEAK_FLOPS = 67e12
# JAX reference constants of (m1), made on the CPU with
#   PYTHONPATH=src JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py \
#       --equivariant
# (the reference's modules op by op on the same numpy parameters and
# inputs; NequIP's forces on the nodes where the reference's are finite:
# on a node with a self-loop jnp.arctan2's gradient at (0, 0) makes them
# NaN, where the port's are finite)
EQV_REFERENCE = {'nequip': {'energies': [1.4295440912246704,
                         0.8198665976524353,
                         1.155815601348877],
            'forces_rows': [0,
                            1,
                            2,
                            5,
                            7,
                            8,
                            9,
                            12,
                            13,
                            16,
                            18,
                            20,
                            21,
                            24,
                            27,
                            28,
                            31],
            'forces': [-0.010676843114197254,
                       0.02547013759613037,
                       0.005541201680898666,
                       -6.504086195491254e-05,
                       -0.0007607439765706658,
                       -0.0021837048698216677,
                       0.0052356598898768425,
                       -0.012821605429053307,
                       -0.0005219483282417059,
                       -0.03216275945305824,
                       -0.020455239340662956,
                       -0.017000187188386917,
                       0.010937555693089962,
                       0.004987149033695459,
                       -0.011191878467798233,
                       0.014589304104447365,
                       0.0055474527180194855,
                       -0.004484066739678383,
                       -0.010713223367929459,
                       0.0034357954282313585,
                       0.013429573737084866,
                       0.007146607618778944,
                       0.002902999520301819,
                       -0.0016871665138751268,
                       -0.00014026154531165957,
                       -8.92235038918443e-05,
                       -0.0003398418193683028,
                       0.0012383242137730122,
                       0.0012167454697191715,
                       8.729454566491768e-05,
                       -0.000393084017559886,
                       -0.0048770844005048275,
                       0.01020335778594017,
                       -0.014449607580900192,
                       0.012548239901661873,
                       -0.01828731968998909,
                       0.013472060672938824,
                       -0.004922086372971535,
                       -0.005766577087342739,
                       -0.0008685585926286876,
                       5.392407183535397e-05,
                       -0.000316592282615602,
                       -0.0007737134583294392,
                       -0.008882991969585419,
                       -0.012653893791139126,
                       -0.013452330604195595,
                       0.0027503613382577896,
                       0.005271113011986017,
                       -0.0,
                       -0.0,
                       -0.0],
            'loss': 0.9977597594261169,
            'grad_norm': 26.991823196411133,
            'losses': [0.9977597594261169,
                       0.8473234176635742,
                       0.5949775576591492]},
 'equiformer-v2': {'energies': [-0.6047521233558655,
                                -0.8722313642501831,
                                -0.6957927942276001],
                   'loss': 1.2084933519363403,
                   'grad_norm': 37.65044021606445,
                   'losses': [1.2084933519363403,
                              0.862981379032135,
                              0.41064807772636414]},
 'equiformer-v2-compact': {'energies': [-0.6047521233558655,
                                        -0.8722313642501831,
                                        -0.6957927942276001],
                           'loss': 1.2084933519363403,
                           'grad_norm': 37.65044021606445,
                           'losses': [1.2084933519363403,
                                      0.862981379032135,
                                      0.41064807772636414]}}
INT_FIELDS = ("node_occlusion", "edge_crossing", "crossing_count_for_angle",
              "overflow")
FLOAT_FIELDS = ("minimum_angle", "edge_length_variation",
                "edge_crossing_angle")


class CheckFailed(RuntimeError):
    pass


def check(ok, message):
    if not ok:
        raise CheckFailed(message)


def drag_moves(pos, frames=DRAG_FRAMES):
    """(f)'s drag: the vertex nearest the centre of the bounding box (a
    small move of it keeps the strip domain) and its position after each
    frame."""
    import numpy as np
    c = (pos.min(axis=0) + pos.max(axis=0)) / 2
    v = int(np.argmin(((pos - c) ** 2).sum(axis=1)))
    rng = np.random.default_rng(DRAG_SEED)
    cur, targets = pos[v].copy(), []
    for _ in range(frames):
        cur = cur + rng.normal(0, DRAG_STEP, 2).astype(np.float32)
        targets.append(cur.copy())
    return v, targets


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def resource_usage(name, log):
    """Registers, shared memory and spills of ``csrc/<name>.cu``'s
    kernels: from ptxas's lines in ``log`` (its build in this process),
    else as ``cuobjdump -res-usage`` reads them from the built library
    (LOCAL is the spill space)."""
    import re
    lines = [line.split(":", 1)[-1].strip() for line in log.splitlines()
             if "registers" in line or "spill" in line]
    if lines:
        return "; ".join(lines)
    from repro_torch.kernels._build import library_path, nvcc_path
    out = subprocess.run(
        [str(Path(nvcc_path()).parent / "cuobjdump"), "-res-usage",
         str(library_path(name))], capture_output=True, text=True,
        timeout=60).stdout
    found = re.findall(r"REG:\d+ STACK:\d+ SHARED:\d+ LOCAL:\d+", out)
    return "; ".join(found) + " (cuobjdump)" if found else "not reported"


def cuda_ms(fn, repeats=REPEATS, inner=1):
    """Median over ``repeats`` of the CUDA-event time of ``inner`` calls of
    ``fn``, per call, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def inputs():
    import numpy as np
    from repro_torch.graphs.datasets import layout_local_graph
    pos, edges = layout_local_graph(N_V, seed=SEED, frac_long=FRAC_LONG)
    rng = np.random.default_rng(1)
    batch = np.stack([pos] + [
        pos + rng.normal(0, JITTER, pos.shape).astype(np.float32)
        for _ in range(BATCH - 1)]).astype(np.float32)
    return pos, edges, batch


def session_padding(pos, edges):
    """The session's padded request: pow2 buckets, PARK rows."""
    import numpy as np
    from repro_torch.core.keys import pow2_bucket
    from repro_torch.launch.session import PARK
    vb, eb = pow2_bucket(pos.shape[0]), pow2_bucket(edges.shape[0])
    pos_p = np.full((vb, 2), PARK, np.float32)
    pos_p[:pos.shape[0]] = pos
    edges_p = np.zeros((eb, 2), np.int32)
    edges_p[:edges.shape[0]] = edges
    return pos_p, edges_p


def reversal_slabs(plan, pos, edges, n_e, dev, *, flat_buckets=False):
    """The ``(rows, cap)`` slabs the engine hands the strip-reversal kernel
    for ``pos`` ``(B, V, 2)`` under ``plan``, built with the engine's own
    functions: per tier and orientation, or the flat buckets of the
    kernels route."""
    import torch
    from repro_torch.core import engine
    from repro_torch.core import grid as gridlib
    pos_t = torch.as_tensor(pos, device=dev)
    edges_t = torch.as_tensor(edges, device=dev)
    ev = torch.arange(edges_t.shape[0], device=dev) < n_e
    B = pos_t.shape[0]
    slabs = []
    for axis_i, (axis, (ms, cap)) in enumerate(zip(plan.axes,
                                                   plan.strip_plans)):
        if B == 1:
            segs = gridlib.build_strip_segments(
                pos_t[0], edges_t, plan.n_strips, ms, axis=axis,
                edge_valid=ev)
            if flat_buckets:
                b = gridlib.bucketize_segments(segs, plan.n_strips, cap)
                slabs.append((f"axis{axis} flat", [
                    b.yl, b.yr, b.theta, b.v.to(torch.int32),
                    b.u.to(torch.int32), b.valid]))
                continue
            segs = segs._replace(**{f: getattr(segs, f)[None] for f in (
                "strip", "yl", "yr", "theta", "v", "u", "valid")})
        else:
            segs = gridlib.build_strip_segments_batched(
                pos_t, edges_t, plan.n_strips, ms, axis=axis, edge_valid=ev)
        for _, args in engine.tier_slabs(plan, axis_i, segs, B)[0]:
            slabs.append((f"axis{axis} tier{args[0].shape[1]}", list(args)))
    return slabs


def adversarial_slab(dev):
    """Ties, shared endpoints, a cap above one shared-memory tile (256)
    and all-invalid rows."""
    import numpy as np
    import torch
    rng = np.random.default_rng(5)
    rows, cap = 6, 1100
    yl = np.round(rng.uniform(0, 20, (rows, cap))).astype(np.float32)
    yr = np.round(rng.uniform(0, 20, (rows, cap))).astype(np.float32)
    th = rng.uniform(0, np.pi, (rows, cap)).astype(np.float32)
    v = rng.integers(0, 40, (rows, cap)).astype(np.int32)
    u = rng.integers(0, 40, (rows, cap)).astype(np.int32)
    ok = rng.random((rows, cap)) < 0.9
    ok[1] = False
    ok[4] = False
    return [torch.from_numpy(a).to(dev) for a in (yl, yr, th, v, u, ok)]


def boundary_fixture(dev):
    """Pairs at exactly d2 == (2r)^2 (not occluded under the strict '<'),
    one nudged inside and one coincident pair, padded to one tile."""
    import numpy as np
    import torch
    from repro_torch.kernels.fixtures import boundary_points
    from repro_torch.kernels.occlusion_pairs import TILE
    pts = boundary_points(RADIUS)
    x = np.zeros(TILE, np.float32)
    y = np.zeros(TILE, np.float32)
    ok = np.zeros(TILE, bool)
    x[:len(pts)], y[:len(pts)], ok[:len(pts)] = pts[:, 0], pts[:, 1], True
    return [torch.from_numpy(a).to(dev) for a in (x, y, ok)]


def masked_slabs(dev):
    """The strip slabs of ``repro_torch.kernels.fixtures`` whose valid
    slots are no prefix, or whose extents differ from row to row (the
    kernel finds each row's extent on the device): the last slot alone or
    with the first, interior gaps, one-slot rows between all-invalid
    ones, short and full rows mixed at cap 256, and rows of 2,500 slots
    (three staging windows of the kernel)."""
    import torch
    from repro_torch.kernels.fixtures import (STRIP_SLABS, WIDE_STRIP_SLABS,
                                              strip_slab)
    return {name: [torch.from_numpy(a).to(dev) for a in strip_slab(**spec)]
            for name, spec in {**STRIP_SLABS, **WIDE_STRIP_SLABS}.items()
            if "mask" in spec}


def occlusion_tile_cases(dev):
    """The occlusion layouts of ``repro_torch.kernels.fixtures``: dense
    points (many occluding pairs) laid out against the kernel's tiles: an
    all-invalid tile between valid ones, one valid vertex in the last
    tile (on top of vertex 0), and n of exactly one tile."""
    import torch
    from repro_torch.kernels.fixtures import OCCLUSION_CASES, occlusion_case
    cases = {}
    for name in OCCLUSION_CASES:
        pos, ok = occlusion_case(name, RADIUS)
        cases[name] = [torch.from_numpy(a).to(dev)
                       for a in (pos[:, 0].copy(), pos[:, 1].copy(), ok)]
    return cases


def compare_reversal(label, args, ideal):
    import torch
    from repro_torch.kernels.strip_reversal import (
        strip_reversal_rows, strip_reversal_rows_plain)
    cnt, dev = strip_reversal_rows(*args, ideal=ideal)
    torch.cuda.synchronize()
    pc, pd = strip_reversal_rows_plain(*args, ideal=ideal)
    torch.cuda.synchronize()
    check(torch.equal(cnt, pc), f"strip_reversal counts differ on {label}")
    err = float((dev.double() - pd.double()).abs().max()) if dev.numel() \
        else 0.0
    ok = torch.allclose(dev.double(), pd.double(), rtol=RTOL, atol=0.0)
    check(ok, f"strip_reversal deviation sums differ on {label} "
              f"(max abs err {err})")
    return err


def distinct_ids(shape, dev):
    """Vertex ids under which no two slots share an endpoint: v = slot,
    u = -1 - slot.  The plain versions count geometric reversals and
    straddling pairs with them."""
    import torch
    idx = torch.arange(shape[-1], dtype=torch.int32, device=dev)
    idx = idx.expand(shape).contiguous()
    return idx, -1 - idx


def bound(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes > t_ops else "operations"


def reversal_bound_ms(args):
    """The least time for one slab: input bytes read once and outputs
    written once over HBM, or the operations these inputs need over the
    FP32 issue rate: the unordered pairs between each row's valid slots,
    the endpoint test on reversing pairs and the count and deviation on
    crossings."""
    from repro_torch.kernels.strip_reversal import strip_reversal_rows_plain
    import torch
    yl, yr, th, v, u, ok = args
    rows, cap = yl.shape
    n_valid = ok.sum(dim=1, dtype=torch.float64)
    pairs = float((n_valid * (n_valid - 1) / 2).sum())
    reversals = float(strip_reversal_rows_plain(
        yl, yr, th, *distinct_ids(yl.shape, yl.device), ok, ideal=1.0,
        with_angle=False)[0].sum())
    crossings = float(strip_reversal_rows_plain(
        *args, ideal=1.0, with_angle=False)[0].sum())
    ops = (REV_OPS_PER_UNORDERED_PAIR * pairs
           + REV_OPS_PER_REVERSAL * reversals
           + REV_OPS_PER_CROSSING * crossings)
    return bound(rows * cap * (5 * 4 + 1) + rows * (8 + 4), ops)


def occlusion_bound_ms(x, ok, occluded):
    n = x.shape[0]
    nv = float(ok.sum())
    ops = (OCC_OPS_PER_PAIR * nv * (nv - 1) / 2
           + OCC_OPS_PER_OCCLUSION * occluded)
    return bound(n * 9 + 8, ops)


def exact_inputs():
    from repro_torch.graphs.datasets import paper_graph
    from repro_torch.graphs.layouts import random_layout
    edges, n_v = paper_graph(EXACT_DATASET, seed=EXACT_GRAPH_SEED)
    return random_layout(n_v, seed=EXACT_LAYOUT_SEED), edges


def edge_arrays(pos, edges, valid, dev):
    """The crossing kernels' padded edge arrays of a layout on ``dev``,
    as the exact path builds them."""
    import torch
    from repro_torch.kernels.ops import _edge_arrays
    return _edge_arrays(torch.as_tensor(pos, device=dev),
                        torch.as_tensor(edges, device=dev),
                        None if valid is None
                        else torch.as_tensor(valid, device=dev))


def compare_crossing(label, args, ideal):
    """Both crossing kernels against their plain versions.  Returns
    (count error, abs deviation error, crossings)."""
    import torch
    from repro_torch.kernels.crossing_angle_sum import (
        crossing_angle_plain, crossing_angle_stats)
    from repro_torch.kernels.segment_crossing import (crossing_count,
                                                      crossing_count_plain)
    x1, y1, x2, y2, th, v, u, ok = args
    got = int(crossing_count(x1, y1, x2, y2, v, u, ok))
    torch.cuda.synchronize()
    want = int(crossing_count_plain(x1, y1, x2, y2, v, u, ok))
    check(got == want,
          f"segment_crossing {got} != plain {want} on {label}")
    cnt, dsum = crossing_angle_stats(*args, ideal=ideal)
    torch.cuda.synchronize()
    p_cnt, p_dsum = crossing_angle_plain(*args, ideal=ideal)
    check(int(cnt) == int(p_cnt) == want,
          f"crossing_angle_sum count {int(cnt)}, plain {int(p_cnt)}, "
          f"crossings {want} on {label}")
    dev_err = abs(float(dsum) - float(p_dsum))
    check(dev_err <= RTOL * abs(float(p_dsum)),
          f"crossing_angle_sum deviation {float(dsum)!r} != plain "
          f"{float(p_dsum)!r} on {label}")
    return abs(got - want), dev_err, want


def crossing_bound_ms(n, n_valid, straddles, crossings, angle):
    """The least time for one crossing sweep: the edge arrays read once
    and the scalar outputs written once over HBM, or the operations these
    inputs need over the FP32 issue rate: the straddle tests on the
    unordered pairs of valid edges, the endpoint test on straddling pairs
    and the count (and deviation) on crossings."""
    pairs = n_valid * (n_valid - 1) / 2
    ops = (CROSS_OPS_PER_UNORDERED_PAIR * pairs
           + CROSS_OPS_PER_STRADDLE * straddles
           + CROSS_OPS_PER_CROSSING * crossings)
    nbytes = n * (4 * 4 + 2 * 4 + 1) + 8
    if angle:
        ops += ANGLE_OPS_PER_CROSSING * crossings
        nbytes += n * 4 + 8
    return bound(nbytes, ops)


def raw_launcher(name, args, *, ideal=1.0, radius=None, fn=None,
                 rows=None):
    """A call of kernel ``name``'s C entry (or of ``fn``, a variant's entry
    of the same signature) on ``args`` (the wrapper's arguments) into
    outputs allocated once: the kernel alone, without the wrapper's
    checks, allocations and sums, and not counted in the wrapper's
    launches.  ``rows`` is the row range of a row-range launch of the
    occlusion-pair or segment-crossing kernel (default: every row).
    ``launch.result()`` reduces the outputs as the wrapper does, so that
    :func:`time_kernel` can hold what was timed against the wrapper's
    result.  The crossing kernels' outputs are zeroed and hold a partial
    for every tile of the square grid, so that a variant that writes the
    tiles below the diagonal fits too."""
    import torch
    from repro_torch.kernels._build import entry
    fn = fn or entry(name)
    dev = args[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    n = args[0].shape[0]
    row0, row1 = (0, n) if rows is None else rows
    if name == "strip_reversal":
        rows, cap = args[0].shape
        outs = (torch.empty(rows, dtype=torch.int64, device=dev),
                torch.empty(rows, dtype=torch.float32, device=dev))
        tail = (rows, cap, float(ideal), 1)
    elif name == "occlusion_pairs":
        from repro_torch.kernels.occlusion_pairs import (
            TILE, _threshold, row_tile_count)
        outs = (torch.empty(row_tile_count(n // TILE, row0 // TILE,
                                           (row1 - row0) // TILE),
                            dtype=torch.int32, device=dev),)
        tail = (n, row0, row1, float(_threshold(radius, torch.empty(0))))
    else:
        from repro_torch.kernels.crossing_angle_sum import _ideal_and_recip
        from repro_torch.kernels.segment_crossing import TILE
        outs = tuple(torch.zeros((n // TILE) ** 2, dtype=dt, device=dev)
                     for dt in (torch.int32, torch.float32))
        if name == "segment_crossing":
            args = args[:4] + args[5:]            # no theta
            outs = outs[:1]
            tail = (n, row0, row1)
        else:
            tail = (n, *(float(t) for t in _ideal_and_recip(ideal)))
    ptrs = [a.data_ptr() for a in args] + list(tail) + [
        o.data_ptr() for o in outs] + [stream]

    def launch():
        err = fn(*ptrs)
        if err != 0:
            raise CheckFailed(f"{name} launch failed: cudaError {err}")

    def result():
        if name == "strip_reversal":
            return outs
        if name == "crossing_angle_sum":
            return (outs[0].sum(dtype=torch.int64),
                    outs[1].sum(dtype=torch.float64))
        return outs[0].sum(dtype=torch.int64)
    launch.result = result
    return launch


def check_same_result(label, got, want):
    """The outputs of a :func:`raw_launcher` against the wrapper's result
    on the same arguments: integers equal, floats at rtol :data:`RTOL`."""
    import torch
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    check(len(got) == len(want), f"{label}: {len(got)} outputs timed, the "
                                 f"wrapper returns {len(want)}")
    for g, w in zip(got, want):
        if w.dtype.is_floating_point:
            same = (g.shape == w.shape and torch.allclose(
                g.double(), w.double(), rtol=RTOL, atol=0.0))
        else:
            same = g.dtype == w.dtype and torch.equal(g, w)
        check(same, f"{label}: the timed launches of the C entry differ "
                    f"from the wrapper's result (sums "
                    f"{float(g.double().sum())!r} and "
                    f"{float(w.double().sum())!r})")


def device_ms(launch, launches):
    """Device time of one launch of ``launch`` (a :func:`raw_launcher`):
    CUDA events around ``launches`` back-to-back launches queued behind a
    sleep, over :data:`DEVICE_READINGS` readings.  Returns (median, min,
    max) per launch."""
    import torch
    launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(DEVICE_READINGS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(launches):
            launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times), min(times), max(times)


class rehearsing:
    """Within the block, every launch of the strip-reversal kernel runs
    its plain version instead, and a copy of its arguments is kept in
    ``self.slabs`` as ``(label, args)``: the slabs a path hands the
    kernel, found without launching it."""

    def __init__(self, mod):
        self.mod = mod
        self.slabs = []

    def __enter__(self):
        from repro_torch.kernels.strip_reversal import (
            strip_reversal_rows_plain)
        self.launch = self.mod._launch

        def plain(yl, yr, theta, v, u, valid, ideal, with_angle):
            args = [t.clone() for t in (yl, yr, theta, v, u, valid)]
            self.slabs.append((f"(f) launch {len(self.slabs)}", args))
            return strip_reversal_rows_plain(*args, ideal=ideal,
                                             with_angle=with_angle)
        self.mod._launch = plain
        return self

    def __exit__(self, *exc):
        self.mod._launch = self.launch


def garbage_slab(args):
    """A copy of a dirty-strip slab with its invalid slots filled with
    values a sweep must never read (NaN, +-inf, huge ordinates, endpoint
    ids of valid slots) and its last row emptied: the kernel must count
    0 there and the same as on ``args`` elsewhere."""
    import torch
    yl, yr, th, v, u, ok = [t.clone() for t in args]
    ok[-1] = False
    bad = ~ok
    junk = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e30],
                        device=yl.device)
    pick = torch.arange(bad.numel(), device=yl.device).reshape(bad.shape) % 4
    for t in (yl, yr, th):
        t[bad] = junk[pick][bad]
    v[bad] = v[0, 0].clone()
    u[bad] = u[0, 0].clone()
    return [yl, yr, th, v, u, ok]


def drag_path(cfg, pos, edges, *, scratch=True):
    """Phase (f): register ``pos``, drag :func:`drag_moves`' vertex for
    ``DRAG_FRAMES`` frames through ``EvalSession.update`` (each frame's
    counters, launches and, with ``scratch``, a from-scratch evaluation
    of the moved layout), replay the first ``DRAG_FRONT`` frames through
    ``Evaluator(cfg)``, then move the extremal vertex to force a
    fallback."""
    import numpy as np
    from repro_torch.api import Evaluator
    from repro_torch.core import grid as gridlib
    from repro_torch.kernels.strip_reversal import strip_reversal_rows
    from repro_torch.launch.session import EvalSession
    v, targets = drag_moves(pos)
    sess = EvalSession(cfg, update_dirty_threshold=1.0)
    first = sess.register_layout("drag", pos, edges)
    cur = np.array(pos, copy=True)
    frames = []
    for tgt in targets:
        before = sess.stats
        gridlib.reset_call_counts()
        launched = strip_reversal_rows.LAUNCHES
        got = sess.update("drag", [v], [tgt])
        after = sess.stats
        frame = dict(
            got=got, launches=strip_reversal_rows.LAUNCHES - launched,
            counts=dict(gridlib.CALL_COUNTS),
            hits=after["delta_hits"] - before["delta_hits"],
            fallbacks=after["delta_fallbacks"] - before["delta_fallbacks"])
        cur[v] = tgt
        if scratch:
            frame["scratch"] = sess.evaluate(cur, edges)
        frames.append(frame)
    front_ev = Evaluator(cfg)
    front_ev.register_layout("drag", pos, edges)
    front = [front_ev.update("drag", [v], [t])
             for t in targets[:DRAG_FRONT]]
    u = int(np.argmax(cur[:, 0]))
    tgt = cur[u] + np.float32([DRAG_FALLBACK_STEP, 0.0])
    before = sess.stats
    fallback = sess.update("drag", [u], [tgt])
    after = sess.stats
    cur[u] = tgt
    out = dict(vertex=v, first=first, frames=frames, front=front,
               fallback=fallback, final=cur, session=sess,
               fallback_counted=(after["delta_fallbacks"]
                                 - before["delta_fallbacks"],
                                 after["delta_hits"] - before["delta_hits"]))
    if scratch:
        out["fallback_scratch"] = sess.evaluate(cur, edges)
    return out


def same_scores(label, got, want):
    """Two score records: integers equal, floats at rtol :data:`RTOL`."""
    for f in INT_FIELDS:
        check(int(getattr(got, f)) == int(getattr(want, f)),
              f"{label}: {f} = {int(getattr(got, f))}, want "
              f"{int(getattr(want, f))}")
    for f in FLOAT_FIELDS:
        g, w = float(getattr(got, f)), float(getattr(want, f))
        check(abs(g - w) <= RTOL * abs(w),
              f"{label}: {f} = {g!r}, want {w!r} (rtol {RTOL})")


def check_drag(drag):
    """(f)'s checks (see the module docstring)."""
    idle = {"strip_builds": 0, "reversal_sweeps": 0, "cell_builds": 0,
            "vertex_sorts": 0, "halo_exchanges": 0}
    frames = drag["frames"]
    check(len(frames) == DRAG_FRAMES, f"(f) {len(frames)} frames")
    for i, fr in enumerate(frames):
        got = fr["got"]
        label = f"(f) frame {i}"
        check(got.flags == {"incremental": True},
              f"{label}: flags {got.flags}, want the delta path")
        check((fr["hits"], fr["fallbacks"]) == (1, 0),
              f"{label}: delta_hits +{fr['hits']}, delta_fallbacks "
              f"+{fr['fallbacks']}")
        check(fr["counts"] == idle, f"{label}: built {fr['counts']}")
        check(fr["launches"] == 2, f"{label}: strip_reversal launched "
                                   f"{fr['launches']} times, want 2")
        check(got.overflow == 0, f"{label}: overflow {got.overflow}")
        same_scores(f"{label} vs from scratch", got, fr["scratch"])
    check_scores("(f) last frame", frames[-1]["got"],
                 DRAG_REFERENCE["update"])
    check_scores("(f) last frame from scratch", frames[-1]["scratch"],
                 DRAG_REFERENCE["scratch"])
    for i, got in enumerate(drag["front"]):
        check(got.flags == {"incremental": True},
              f"(f) front door frame {i}: flags {got.flags}")
        same_scores(f"(f) front door frame {i}", got, frames[i]["got"])
    fb = drag["fallback"]
    check(drag["fallback_counted"] == (1, 0)
          and not (fb.flags or {}).get("incremental"),
          f"(f) extremal move: (fallbacks, hits) "
          f"{drag['fallback_counted']}, flags {fb.flags}")
    check(fb.overflow == 0, f"(f) fallback overflow {fb.overflow}")
    same_scores("(f) fallback vs from scratch", fb,
                drag["fallback_scratch"])


class recording_launches:
    """Within the block, every kernel launch through the listed kernel
    modules appends ``(kernel, shape of its first argument)``
    to ``self.seen[-1]``; ``step()`` opens a new list."""

    def __init__(self, *mods):
        self.mods = mods
        self.seen = []

    def step(self):
        self.seen.append([])

    def __enter__(self):
        self.launches = {mod: mod._launch for mod in self.mods}
        for mod in self.mods:
            mod._launch = self._recorder(mod)
        return self

    def _recorder(self, mod):
        name = mod.__name__.rsplit(".", 1)[1]
        launch = self.launches[mod]

        def recording_launch(*args):
            self.seen[-1].append((name, tuple(args[0].shape)))
            return launch(*args)
        return recording_launch

    def __exit__(self, *exc):
        for mod, launch in self.launches.items():
            mod._launch = launch


def check_scores(label, got, want):
    for f in INT_FIELDS:
        check(int(getattr(got, f)) == want[f],
              f"{label}: {f} = {int(getattr(got, f))}, reference {want[f]}")
    for f in FLOAT_FIELDS:
        g = float(getattr(got, f))
        check(abs(g - want[f]) <= RTOL * abs(want[f]),
              f"{label}: {f} = {g!r}, reference {want[f]!r} (rtol {RTOL})")


def padded_batch(batch, edges):
    """The session's padded requests of a ``(B, V, 2)`` batch of one graph:
    ``((B, V_pad, 2) positions, (E_pad, 2) edges)``."""
    import numpy as np
    return (np.stack([session_padding(p, edges)[0] for p in batch]),
            session_padding(batch[0], edges)[1])


FAILURE_COUNTERS = ("dispatch_failures", "quarantined", "chunk_splits",
                    "degraded_dispatches", "watchdog_abandoned", "expired",
                    "shed", "cancelled", "saturated")


def check_clean(label, reports, stats):
    """Outside the drills every slot evaluated and no failure counter
    moved: the session's split-and-retry would otherwise turn a kernel
    that fails to launch into quarantined slots of a run that passes."""
    bad = [(i, r.error) for i, r in enumerate(reports) if not r.ok]
    check(not bad, f"{label}: error slots {bad}")
    moved = {k: stats[k] for k in FAILURE_COUNTERS if stats[k]}
    check(not moved, f"{label}: failure counters moved: {moved}")


def same_ints(label, got, want):
    for f in INT_FIELDS:
        check(getattr(got, f) == getattr(want, f),
              f"{label}: {f} = {getattr(got, f)}, unfaulted run "
              f"{getattr(want, f)}")


def drill_inputs():
    import numpy as np
    from repro_torch.graphs.datasets import layout_local_graph
    pos, edges = layout_local_graph(DRILL_N_V, seed=SEED,
                                    frac_long=DRILL_FRAC_LONG)
    rng = np.random.default_rng(2)
    batch = np.stack([pos] + [
        pos + rng.normal(0, JITTER, pos.shape).astype(np.float32)
        for _ in range(BATCH - 1)]).astype(np.float32)
    return pos, edges, batch


def drill_clean(cfg, reqs):
    """(e4)'s unfaulted run: one dispatch of B = 8, no failure counter."""
    from repro_torch.launch.serve import ReadabilityServer
    server = ReadabilityServer(cfg)
    out = server.evaluate_batch(reqs)
    check_clean("(e4) unfaulted", out, server.stats)
    return out


def run_drills(cfg, reqs, clean):
    """(e4): each drill on a fresh server under the port's ``FaultPlan``;
    the counter that certifies each fault equals what the plan injected,
    every other failure counter stays 0, and every slot the fault does not
    own equals the unfaulted run ``clean`` on integers.  Returns
    ``{drill: (injected, counters)}``."""
    from repro_torch.core.validate import (DeadlineExceededError,
                                           InvalidInputError,
                                           OverloadedError)
    from repro_torch.launch.admission import CancelToken
    from repro_torch.launch.faults import FaultPlan
    from repro_torch.launch.serve import ReadabilityServer

    def drill(name, owned, plan_kw, server_kw=None, **call):
        server = ReadabilityServer(cfg, **(server_kw or {}))
        t0 = time.perf_counter()
        with FaultPlan(**plan_kw) as fp:
            out = server.evaluate_batch(reqs, **call)
        seconds = time.perf_counter() - t0
        stats = server.stats
        for i, r in enumerate(out):
            if i not in owned:
                check(r.ok, f"(e4) {name}: slot {i} failed: {r.error}")
                same_ints(f"(e4) {name} slot {i}", r, clean[i])
        counters = {k: stats[k] for k in FAILURE_COUNTERS}
        print(f"(e4) {name}: {seconds:.3f} s, injected "
              f"{ {k: v for k, v in fp.injected.items() if v} }, counters "
              f"{ {k: v for k, v in counters.items() if v} }", flush=True)
        return out, dict(fp.injected), counters

    def only(counters, **want):
        check(counters == {**{k: 0 for k in FAILURE_COUNTERS}, **want},
              f"(e4) counters {counters}, want {want} and no others")

    done = {}
    # a failed coalesced dispatch: split, every member retried alone
    out, inj, cnt = drill("fail_dispatches=[0]", (),
                          dict(fail_dispatches=[0]))
    check(inj["fail_dispatches"] == 1, f"(e4) injected {inj}")
    only(cnt, dispatch_failures=inj["fail_dispatches"], chunk_splits=1)
    done["fail"] = (inj, cnt)
    # a poisoned request: quarantined to its own slot
    out, inj, cnt = drill("nan_requests=[3]", (3,), dict(nan_requests=[3]))
    check(isinstance(out[3].error, InvalidInputError)
          and out[3].error.request_index == 3, f"(e4) slot 3: {out[3]}")
    only(cnt, quarantined=inj["nan_requests"])
    check(inj["nan_requests"] == 1, f"(e4) injected {inj}")
    done["nan"] = (inj, cnt)
    # a cancelled request and a queue bound of 6: three own slots fail
    tokens = [CancelToken() for _ in reqs]
    tokens[2].cancel()
    out, inj, cnt = drill("cancel + max_queue=6", (2, 6, 7), {},
                          dict(max_queue=BATCH - 2), cancel=tokens)
    check(out[2].cancelled and out[6].shed and out[7].shed
          and isinstance(out[6].error, OverloadedError),
          f"(e4) cancel/shed slots: {out[2].error}, {out[6].error}, "
          f"{out[7].error}")
    check(not any(inj.values()), f"(e4) injected {inj}")
    only(cnt, cancelled=1, shed=2)
    done["cancel_shed"] = (inj, cnt)
    # a hung chunk of 4 with a deadline: the watchdog abandons it, its
    # members expire, the next chunk of 4 is served
    t0 = time.perf_counter()
    out, inj, cnt = drill(
        "hang_dispatches=[0]", (0, 1, 2, 3),
        dict(hang_dispatches=[0], hang_seconds=DRILL_HANG_SECONDS),
        dict(max_coalesce=4, dispatch_timeout=DRILL_TIMEOUT),
        deadline=[DRILL_DEADLINE] * 4 + [None] * 4)
    check(time.perf_counter() - t0 < DRILL_HANG_SECONDS,
          "(e4) the hang was not cut by the watchdog")
    check(all(isinstance(out[i].error, DeadlineExceededError)
              for i in range(4)), f"(e4) hung slots: {out[:4]}")
    check(inj["hang_dispatches"] == 1, f"(e4) injected {inj}")
    only(cnt, watchdog_abandoned=inj["hang_dispatches"], expired=4,
         dispatch_failures=1, chunk_splits=1)
    done["hang"] = (inj, cnt)
    return done


def sync_sites(call):
    """The synchronizing CUDA calls of ``call()``, each as the innermost
    ``file:line`` of this checkout on the Python stack
    (``torch.cuda.set_sync_debug_mode("warn")``)."""
    import traceback
    import warnings
    import torch
    sites, inside = [], []

    def show(message, category, filename, lineno, *rest):
        if not inside or "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1]
                if str(ROOT) in f.filename]
        f = ours[-1] if ours else traceback.extract_stack()[-2]
        sites.append(f"{Path(f.filename).name}:{f.lineno}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        inside.append(True)
        try:
            call()
        finally:
            inside.clear()
            torch.cuda.set_sync_debug_mode("default")
    return sites


def time_drag(cfg, pos, edges):
    """Phase 4 for (f): ``DRAG_REPLAYS`` replays of the drag, each on a
    fresh session: ``register_layout``, its priming alone, every frame's
    ``update`` (host clock: the call returns host scores), then a warm
    full ``sess.evaluate`` of the dragged layout, and the synchronizing
    CUDA calls of one frame (``file:line`` of the Python caller)."""
    import numpy as np
    import torch
    from repro_torch.launch.session import EvalSession
    v, targets = drag_moves(pos)
    out = dict(register=[], prime=[], frames=[], syncs=[])
    for replay in range(DRAG_REPLAYS):
        sess = EvalSession(cfg, update_dirty_threshold=1.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.register_layout("drag", pos, edges)
        torch.cuda.synchronize()
        out["register"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        sess._prime_layout(sess._layouts["drag"])
        torch.cuda.synchronize()
        out["prime"].append((time.perf_counter() - t0) * 1e3)
        for i, tgt in enumerate(targets):
            if replay == 0 and i == 1:
                out["syncs"] = sync_sites(
                    lambda: sess.update("drag", [v], [tgt]))
                continue
            t0 = time.perf_counter()
            sess.update("drag", [v], [tgt])
            out["frames"].append((time.perf_counter() - t0) * 1e3)
    cur = np.array(pos, copy=True)
    cur[v] = targets[-1]
    out["evaluate"] = cuda_ms(lambda: sess.evaluate(cur, edges))
    return out


def occlusion_args(pos_p, n_valid, dev):
    """The occlusion-pair kernel's padded x, y and valid arrays of a padded
    layout, as ``ops.occlusion_count_op`` builds them."""
    import torch
    from repro_torch.kernels.occlusion_pairs import TILE
    n_pad = -(-pos_p.shape[0] // TILE) * TILE
    x = torch.zeros(n_pad, device=dev)
    y = torch.zeros(n_pad, device=dev)
    ok = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    x[:pos_p.shape[0]] = torch.from_numpy(pos_p[:, 0].copy()).to(dev)
    y[:pos_p.shape[0]] = torch.from_numpy(pos_p[:, 1].copy()).to(dev)
    ok[:n_valid] = True
    return x, y, ok


class capturing:
    """Within the block, every launch of the strip-reversal kernel keeps a
    copy of its arguments and of the kernel's result in ``self.slabs`` as
    ``(label, args, (count, dev))``, so that each launch of a path can be
    held against the plain version afterwards."""

    def __init__(self, mod, path):
        self.mod, self.path = mod, path
        self.slabs = []

    def __enter__(self):
        self.launch = self.mod._launch

        def keep(*args):
            cnt, dev = self.launch(*args)
            self.slabs.append((f"({self.path}) launch {len(self.slabs)}",
                               [t.clone() for t in args[:6]],
                               (cnt.clone(), dev.clone())))
            return cnt, dev
        self.mod._launch = keep
        return self

    def __exit__(self, *exc):
        self.mod._launch = self.launch


def check_captured(slabs, ideal):
    """Each captured launch's result against the plain version on the
    same slab: counts equal, deviation sums at rtol :data:`RTOL`.
    Returns the largest absolute deviation error."""
    import torch
    from repro_torch.kernels.strip_reversal import strip_reversal_rows_plain
    err = 0.0
    for label, args, (cnt, dev) in slabs:
        pc, pd = strip_reversal_rows_plain(*args, ideal=ideal)
        torch.cuda.synchronize()
        check(torch.equal(cnt, pc), f"strip_reversal counts differ on {label}")
        check(torch.allclose(dev.double(), pd.double(), rtol=RTOL, atol=0.0),
              f"strip_reversal deviation sums differ on {label}")
        if dev.numel():
            err = max(err, float((dev.double() - pd.double()).abs().max()))
    return err


class counting_rescores:
    """Within the block, each exact re-score of a ``GradientSearch``
    appends the strip-reversal launches it made to ``self.launches``."""

    def __enter__(self):
        from repro_torch.kernels.strip_reversal import strip_reversal_rows
        from repro_torch.search.gradient import GradientSearch
        self.cls, self.launches = GradientSearch, []
        self.rescore = GradientSearch._exact_rescore
        rescore = self.rescore

        def counted(gs, *args):
            before = strip_reversal_rows.LAUNCHES
            out = rescore(gs, *args)
            self.launches.append(strip_reversal_rows.LAUNCHES - before)
            return out
        GradientSearch._exact_rescore = counted
        return self

    def __exit__(self, *exc):
        self.cls._exact_rescore = self.rescore


def check_search(label, result, edges, cfg):
    """(g)'s checks of one search: every reported exact score (``scores``
    and ``init_scores``) equals the port's own ``evaluate_batch`` of the
    returned layouts on the card (integers equal, floats at rtol
    :data:`RTOL`), positions are finite, and the best objective is no
    worse than the best start."""
    import numpy as np
    from repro_torch.api import Evaluator
    check(np.isfinite(result.positions).all(), f"{label}: non-finite layout")
    check(result.best_objective >= float(np.max(result.init_objectives)),
          f"{label}: best objective {result.best_objective} below the "
          f"best start {float(np.max(result.init_objectives))}")
    check(np.all(result.objectives >= result.init_objectives),
          f"{label}: a restart ended below its start")
    ev = Evaluator(cfg)
    for which, batch, scores in (("final", result.positions, result.scores),
                                 ("init", result.init_positions,
                                  result.init_scores)):
        again = ev.evaluate_batch(batch, edges).unbatch()
        for i, (got, want) in enumerate(zip(scores, again)):
            same_scores(f"{label} {which} restart {i}", got, want)


def layout_generation():
    """(g1): examples/layout_optimization.py at its defaults on the card:
    FR from ``FR_STARTS`` random starts, every checkpoint scored in one
    ``evaluate_batch``, then ``Evaluator.search`` from the winner.
    Returns the FR time per iteration (host clock around synchronized
    FR calls), the checkpoint scores and the search result."""
    import numpy as np
    import torch
    from repro_torch.api import EvalConfig, Evaluator
    from repro_torch.graphs.datasets import random_edges
    from repro_torch.graphs.layouts import fruchterman_reingold, random_layout
    from repro_torch.search import batch_objectives
    edges = random_edges(FR_N, FR_EDGES, seed=0)
    candidates, fr_s = [], 0.0
    for start in range(FR_STARTS):
        pos = torch.from_numpy(random_layout(FR_N, seed=start)).cuda()
        for _ in range(FR_ITERS // FR_CHECK):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pos = fruchterman_reingold(pos, edges, n_iter=FR_CHECK,
                                       block=FR_BLOCK)
            torch.cuda.synchronize()
            fr_s += time.perf_counter() - t0
            candidates.append(pos.cpu().numpy())
    batch = np.stack(candidates).astype(np.float32)
    check(np.isfinite(batch).all(), "(g1) FR produced non-finite layouts")
    cfg = EvalConfig(n_strips=FR_N_STRIPS)
    ev = Evaluator(cfg)
    plan = ev.plan(batch, edges)
    scores = ev.evaluate_batch(batch, edges, plan=plan)
    objectives = batch_objectives(scores)
    best = int(np.argmax(objectives))
    result = ev.search(candidates[best], edges, steps=FR_SEARCH_STEPS,
                       restarts=FR_SEARCH_RESTARTS)
    return dict(edges=edges, cfg=cfg, scores=scores, objectives=objectives,
                best=best, result=result,
                fr_ms_per_iter=fr_s * 1e3 / (FR_STARTS * FR_ITERS))


def search_opt():
    """(g2)'s optimizer: ``GradientSearch``'s default schedule with the
    peak learning rate :data:`SEARCH_PEAK_LR`."""
    from repro_torch.optim.adamw import AdamWConfig
    steps = SEARCH_KNOBS["steps"]
    return AdamWConfig(peak_lr=SEARCH_PEAK_LR,
                       warmup_steps=max(1, min(10, steps // 10)),
                       total_steps=steps, min_lr_frac=0.1, weight_decay=0.0,
                       clip_norm=1.0)


def search_digest(cfg, pos, edges):
    """(g2)'s first soft loss and gradient, as the search makes them:
    restart 0 of its batch under its plan, at its starting temperature,
    on the card.  Returns ``(loss, grad (V, 2) on the host)``."""
    import torch
    from repro_torch.core import engine, soft
    from repro_torch.search import GradientSearch
    gs = GradientSearch(cfg, **SEARCH_KNOBS)
    batch, edges_v, _ = gs._init_batch(pos, edges)
    plan = engine.plan_readability(batch, edges_v, **cfg.plan_kwargs())
    p = torch.from_numpy(batch[:1]).cuda().requires_grad_(True)
    loss = soft.soft_loss(plan, p, torch.from_numpy(edges_v).cuda(),
                          gs._temperature_at(0)).sum()
    grad, = torch.autograd.grad(loss, p)
    return loss.item(), grad[0].cpu().numpy()


def check_digest(loss, grad):
    """(g2)'s digest against ``SEARCH_REFERENCE`` at the tolerances stated
    there."""
    import numpy as np
    want = SEARCH_REFERENCE
    norm = float(np.sqrt(np.sum(np.square(grad.astype(np.float64)))))
    rows = grad[list(DIGEST_VERTICES)]
    w_rows = np.asarray(want["rows"], np.float64)
    tol = SEARCH_TOLERANCE
    check(abs(loss - want["loss"]) <= tol["loss_rtol"] * abs(want["loss"]),
          f"(g2) soft loss {loss!r}, reference {want['loss']!r}")
    check(abs(norm - want["grad_norm"]) <= tol["norm_rtol"]
          * want["grad_norm"],
          f"(g2) gradient norm {norm!r}, reference {want['grad_norm']!r}")
    row_err = float(np.max(np.abs(rows - w_rows)))
    check(row_err <= tol["rows_atol_frac"] * float(np.max(np.abs(w_rows))),
          f"(g2) gradient rows off by {row_err!r} (max |row| "
          f"{float(np.max(np.abs(w_rows)))!r})")
    return norm, row_err


def search_step_times(cfg, pos, edges):
    """Phase 4 for (g2): one search step's forward and backward (the
    summed soft loss and ``torch.autograd.grad`` over the 8-restart
    batch) and one exact ``evaluate_layouts`` of the same batch and plan,
    each the median of :data:`REPEATS` CUDA-event-timed calls; their
    ratio is ``benchmarks/search_bench.py``'s ``step_over_eval_ratio``.
    Also the synchronizing CUDA calls of one whole search step (forward,
    backward and AdamW update): the search waits on the device only at
    its re-scores."""
    import torch
    from repro_torch.core import engine, soft
    from repro_torch.optim import adamw
    from repro_torch.search import GradientSearch
    gs = GradientSearch(cfg, **SEARCH_KNOBS)
    batch, edges_v, _ = gs._init_batch(pos, edges)
    plan = engine.plan_readability(batch, edges_v, **cfg.plan_kwargs())
    p = torch.from_numpy(batch).cuda()
    e = torch.from_numpy(edges_v).cuda()
    tau = torch.full((), gs._temperature_at(0), device="cuda")

    def step():
        leaf = p.detach().requires_grad_(True)
        loss = soft.soft_loss(plan, leaf, e, tau).sum()
        torch.autograd.grad(loss, leaf)

    state = adamw.init_state({"pos": p})
    syncs = sync_sites(lambda: gs.step(plan, search_opt(), p, state, e, tau))
    return (cuda_ms(step), cuda_ms(lambda: engine.evaluate_layouts(
        plan, p, e)), syncs)


def search_paths(cfg, pos, edges, ideal, kernel_mods, run_counted,
                 sub_launches, rev_checked):
    """Drive (g1) and (g2), each with the launch counts set to 0 just
    before it and read just after (``run_counted``).  Each search's
    kernel launches are captured and held against the plain version after
    the run (their slabs depend on where the layouts moved), and their
    shapes join ``rev_checked``.  Returns ``(searches, (g2)'s digest, the
    digest's seconds, the largest deviation error)``."""
    import torch
    from repro_torch.kernels import strip_reversal as strip_reversal_mod
    from repro_torch.search import GradientSearch
    g_err = 0.0
    searches = {}
    for key, run in (("g1", layout_generation), ("g2", lambda: GradientSearch(
            cfg, opt=search_opt(), **SEARCH_KNOBS).run(pos, edges))):
        if key == "g2":
            t0 = time.perf_counter()
            digest = search_digest(cfg, pos, edges)
            digest_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with recording_launches(*kernel_mods) as rec, \
                capturing(strip_reversal_mod, key) as cap, \
                counting_rescores() as rescores:
            out = run_counted(key, rec, run)
        torch.cuda.synchronize()
        searches[key] = dict(out=out, seconds=time.perf_counter() - t0,
                             rescores=rescores.launches)
        print(f"({key}) ran in {searches[key]['seconds']:.2f} s; its "
              f"{len(cap.slabs)} kernel launches on "
              f"{sorted(set(tuple(a[0].shape) for _, a, _ in cap.slabs))}",
              flush=True)
        if key == "g2":
            searches[key]["peak"] = torch.cuda.max_memory_allocated()
        check(sub_launches[key][1:] == (0, 0, 0)
              and sub_launches[key][0] == len(cap.slabs) > 0,
              f"({key}) launched {sub_launches[key]}")
        check(rescores.launches and min(rescores.launches) > 0,
              f"({key}) re-scores launched the strip-reversal kernel "
              f"{rescores.launches} times each")
        g_err = max(g_err, check_captured(cap.slabs, ideal))
        for label, args, _ in cap.slabs:
            rev_checked.setdefault(tuple(args[0].shape), (label, args))
    return searches, digest, digest_s, g_err


# ---------------------------------------------------------------------------
# phase (h): the distributed paths
# ---------------------------------------------------------------------------

def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_group(backend, rank, world, port):
    """One process group of ``world`` ranks with a time limit, so that a
    hung rank fails the run instead of hanging it."""
    import datetime
    import torch.distributed as dist
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))


class recording_rows:
    """Within the block, every launch of the occlusion-pair and
    segment-crossing kernels appends ``(kernel, n, row0, row1)`` to
    ``self.seen``."""

    def __enter__(self):
        from repro_torch.kernels import occlusion_pairs, segment_crossing
        self.mods = {"occlusion_pairs": occlusion_pairs,
                     "segment_crossing": segment_crossing}
        self.launches = {k: m._launch for k, m in self.mods.items()}
        self.seen = []
        for name, mod in self.mods.items():
            mod._launch = self._recorder(name, self.launches[name])
        return self

    def _recorder(self, name, launch):
        def recording_launch(*args):
            self.seen.append((name, int(args[0].shape[0]), int(args[-2]),
                              int(args[-1])))
            return launch(*args)
        return recording_launch

    def __exit__(self, *exc):
        for name, mod in self.mods.items():
            mod._launch = self.launches[name]


def h_counters():
    """The wrappers whose launches (h) counts, by kernel name."""
    from repro_torch.kernels.occlusion_pairs import (occlusion_pairs,
                                                     occlusion_pairs_rows)
    from repro_torch.kernels.segment_crossing import (crossing_count,
                                                      crossing_count_rows)
    from repro_torch.kernels.strip_reversal import strip_reversal_rows
    return {"strip_reversal": strip_reversal_rows,
            "occlusion_pairs": occlusion_pairs,
            "occlusion_pairs_rows": occlusion_pairs_rows,
            "segment_crossing": crossing_count,
            "segment_crossing_rows": crossing_count_rows}


def h_run(runs, key, call):
    """Run one (h) path with every counted wrapper's launches set to 0 just
    before it, and keep its result and the launches read just after."""
    from repro_torch.core import grid
    counters = h_counters()
    for fn in counters.values():
        fn.LAUNCHES = 0
    halo = grid.CALL_COUNTS["halo_exchanges"]
    out = call()
    runs[key] = dict(out=out, launches={k: fn.LAUNCHES
                                        for k, fn in counters.items()},
                     halo=grid.CALL_COUNTS["halo_exchanges"] - halo)
    return out


def h_paths(world, dev, cfg, pos, edges, batch, flat, tiered, exact=None):
    """(h)'s runs on this rank of a ``world``-rank group: the graph-sharded
    evaluation of (a)'s layout on a flat plan and of its E_c / E_ca-only
    subset ((h1) on one rank, (h2) on several), the batch-sharded (b)
    batch and, on several ranks, its ``H_CUT``-layout cut ((h3)),
    ``Evaluator(backend="distributed").evaluate`` ((h4)) and, with
    ``exact`` on several ranks, the row-sharded exact E_c of (d)'s layout
    ((h5)).  Host results, launches and halo exchanges per run, the
    row-range launches and the captured strip-reversal launches."""
    import dataclasses as dc
    from repro_torch.api import Evaluator
    from repro_torch.core.scores import host_batch, scores_from_result
    from repro_torch.distributed.batched import evaluate_layouts_sharded
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.distributed.graph_sharded import evaluate_graph_sharded
    from repro_torch.distributed.pairwise import sharded_crossing_count
    from repro_torch.kernels import strip_reversal as strip_reversal_mod

    n_v, n_e = pos.shape[0], edges.shape[0]
    gmesh = make_mesh((world,), ("graph",), device=dev)
    bmesh = make_mesh((world,), ("batch",), device=dev)
    emesh = make_mesh((world,), ("eval",), device=dev)
    xflat = dc.replace(flat, metrics=("edge_crossing", "edge_crossing_angle"))
    dist_ev = Evaluator(dc.replace(cfg, backend="distributed"), mesh=emesh)
    runs = {}
    h = "h1" if world == 1 else "h2"
    with recording_rows() as rows, \
            capturing(strip_reversal_mod, "h") as cap:
        h_run(runs, h, lambda: scores_from_result(
            evaluate_graph_sharded(gmesh, flat, pos, edges), n_v, n_e))
        h_run(runs, h + " E_c/E_ca only", lambda: scores_from_result(
            evaluate_graph_sharded(gmesh, xflat, pos, edges), n_v, n_e))
        h_run(runs, "h3", lambda: host_batch(evaluate_layouts_sharded(
            bmesh, tiered, batch, edges), n_v, n_e))
        if world > 1:
            h_run(runs, "h3 cut", lambda: host_batch(
                evaluate_layouts_sharded(bmesh, tiered, batch[:H_CUT],
                                         edges), n_v, n_e))
        h_run(runs, "h4", lambda: dist_ev.evaluate(pos, edges))
        if exact is not None:
            h_run(runs, "h5", lambda: int(sharded_crossing_count(
                emesh, *exact)))
    meshes = {"graph": gmesh, "batch": bmesh, "eval": emesh}
    return runs, rows.seen, cap.slabs, meshes, dist_ev


def h_times(meshes, dist_ev, flat, tiered, pos, edges, batch):
    """Medians of :data:`REPEATS` CUDA-event-timed calls of (h1)/(h2),
    (h3) and (h4) on this rank."""
    from repro_torch.distributed.batched import evaluate_layouts_sharded
    from repro_torch.distributed.graph_sharded import evaluate_graph_sharded
    return {
        "graph_sharded": cuda_ms(lambda: evaluate_graph_sharded(
            meshes["graph"], flat, pos, edges)),
        "batch_sharded": cuda_ms(lambda: evaluate_layouts_sharded(
            meshes["batch"], tiered, batch, edges)),
        "distributed_evaluate": cuda_ms(lambda: dist_ev.evaluate(pos,
                                                                 edges))}


def h_plans(cfg, pos, edges, batch):
    """(a)'s flat plan and (b)'s tiered plan, as the main path makes
    them."""
    from repro_torch.core import engine
    return (engine.plan_readability(pos, edges,
                                    **cfg.plan_kwargs(tier_default=False)),
            engine.plan_readability(batch, edges, **cfg.plan_kwargs()))


def h_host(out):
    """A run's result as JSON-able host values."""
    import numpy as np
    import torch
    if isinstance(out, int):
        return out

    def value(v):
        return np.asarray(v.cpu() if isinstance(v, torch.Tensor)
                          else v).tolist()
    return {f: value(getattr(out, f)) for f in INT_FIELDS + FLOAT_FIELDS}


def distributed_rank(rank, world, port):
    """One rank of (h2)-(h5): gloo over ``world`` ranks, this rank on the
    one card.  Prints one ``RANK`` JSON line: its results, launches, halo
    exchanges, row-range launches, the largest deviation error of its
    captured strip-reversal launches against the plain version, and its
    times."""
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import EvalConfig
    init_group("gloo", rank, world, port)
    dev = torch.device("cuda", 0)
    pos, edges, batch = inputs()
    cfg = EvalConfig(radius=RADIUS, n_strips=N_STRIPS)
    flat, tiered = h_plans(cfg, pos, edges, batch)
    epos, eedges = exact_inputs()
    runs, rows, slabs, meshes, dist_ev = h_paths(
        world, dev, cfg, pos, edges, batch, flat, tiered,
        exact=(epos, eedges))
    err = check_captured(slabs, flat.ideal)
    times = h_times(meshes, dist_ev, flat, tiered, pos, edges, batch)
    out = {"rank": rank, "device": str(meshes["graph"].device),
           "backend": meshes["graph"].backend,
           "runs": {k: dict(out=h_host(r["out"]), launches=r["launches"],
                            halo=r["halo"]) for k, r in runs.items()},
           "rows": rows, "slabs": len(slabs),
           "slab_shapes": sorted({tuple(a[0].shape) for _, a, _ in slabs}),
           "rev_err": err, "times": times}
    print("RANK " + json.dumps(out), flush=True)
    dist.destroy_process_group()
    return 0


def spawn_ranks(world):
    """Run :func:`distributed_rank` on ``world`` ranks (each a fresh
    ``python3 chip_smoke.py --rank``), each under :data:`H_TIMEOUT`;
    every rank is stopped before this returns.  Returns their outputs in
    rank order."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--rank", str(r),
         "--world", str(world), "--port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=H_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"(h) rank {r} of {world} exited "
                                 f"{p.returncode}:\n{out[-4000:]}\n"
                                 f"{err[-4000:]}")
        line = [ln for ln in out.splitlines() if ln.startswith("RANK ")]
        check(bool(line), f"(h) rank {r} printed no result")
        results.append(json.loads(line[-1][len("RANK "):]))
    return results


def check_h_scores(label, got, want):
    """Host values of one (h) run against the main path's constants:
    integers equal, floats at rtol :data:`RTOL`."""
    for f in INT_FIELDS:
        check(int(got[f]) == want[f],
              f"{label}: {f} = {got[f]}, reference {want[f]}")
    for f in FLOAT_FIELDS:
        check(abs(float(got[f]) - want[f]) <= RTOL * abs(want[f]),
              f"{label}: {f} = {got[f]!r}, reference {want[f]!r} "
              f"(rtol {RTOL})")


def h_row_args(kernel, n, pos, epos, eedges, dev):
    """The row-range kernel's arguments at ``n``, as the row-sharded
    drivers pad them: (a)'s vertices for the occlusion count, (d)'s
    edges for the crossing count."""
    import torch
    from repro_torch.kernels.ops import _edge_arrays, _pad1
    if kernel == "occlusion_pairs":
        p = torch.as_tensor(pos, device=dev)
        ok = torch.ones(p.shape[0], dtype=torch.bool, device=dev)
        return [_pad1(p[:, 0].contiguous(), n, 0.0),
                _pad1(p[:, 1].contiguous(), n, 0.0), _pad1(ok, n, False)]
    x1, y1, x2, y2, _, v, u, ok = _edge_arrays(
        torch.as_tensor(epos, device=dev),
        torch.as_tensor(eedges, device=dev), None)
    return [_pad1(a, n, f) for a, f in ((x1, 0.0), (y1, 0.0), (x2, 0.0),
                                         (y2, 0.0), (v, -1), (u, -2),
                                         (ok, False))]


def valid_pairs(ok, rows):
    """Unordered pairs of valid items with the first in ``rows``: what a
    row-range launch must test."""
    import torch
    after = ok.flip(0).to(torch.float64).cumsum(0).flip(0) - ok.double()
    r0, r1 = rows
    return float((after[r0:r1] * ok[r0:r1].double()).sum())


def h_row_kernels(launched, pos, epos, eedges, dev, card):
    """Each row-range launch of (h) (kernel, n, rows) checked once against
    its plain version on the same arguments, then timed: the kernel alone
    on the device, its wrapper, its plain version, and its bound from the
    operations these inputs need on those rows.  Returns the kernels
    line's entries of the two row-range wrappers, summed over their
    launches in (h)."""
    from collections import Counter
    from repro_torch.kernels.occlusion_pairs import (occlusion_pairs_plain,
                                                     occlusion_pairs_rows)
    from repro_torch.kernels.segment_crossing import (crossing_count_plain,
                                                      crossing_count_rows)
    import torch
    rows_seen = Counter(tuple(r) for r in launched)
    entries = {}
    for (kernel, n, r0, r1), count in sorted(rows_seen.items()):
        args = h_row_args(kernel, n, pos, epos, eedges, dev)
        rows = (r0, r1)
        if kernel == "occlusion_pairs":
            radius = RADIUS
            wrapper = lambda: occlusion_pairs_rows(*args, radius, *rows)
            plain = lambda: occlusion_pairs_plain(*args, radius, rows=rows)
            got, want = int(wrapper()), int(plain())
            torch.cuda.synchronize()
            ops = (OCC_OPS_PER_PAIR * valid_pairs(args[2], rows)
                   + OCC_OPS_PER_OCCLUSION * want)
            b_ms, by = bound(n * 9 + 8, ops)
            launch = raw_launcher(kernel, args, radius=radius, rows=rows)
            inner, name = (3 if n > 65536 else 20), "occlusion_pairs_rows"
        else:
            x1, y1, x2, y2, v, u, ok = args
            wrapper = lambda: crossing_count_rows(*args, *rows)
            plain = lambda: crossing_count_plain(*args, rows=rows)
            got, want = int(wrapper()), int(plain())
            torch.cuda.synchronize()
            straddles = int(crossing_count_plain(
                x1, y1, x2, y2, *distinct_ids(v.shape, dev), ok, rows=rows))
            pairs = valid_pairs(ok, rows)
            ops = (CROSS_OPS_PER_UNORDERED_PAIR * pairs
                   + CROSS_OPS_PER_STRADDLE * straddles
                   + CROSS_OPS_PER_CROSSING * want)
            b_ms, by = bound(n * (4 * 4 + 2 * 4 + 1) + 8, ops)
            launch = raw_launcher(kernel, args[:4] + [None] + args[4:],
                                  rows=rows)
            inner, name = 2, "segment_crossing_rows"
        check(got == want, f"(h) {name} {(n,)} rows {rows}: kernel {got}, "
                           f"plain {want}")
        err = float(abs(got - want))
        med, lo, hi = device_ms(launch, inner)
        check_same_result(f"{name} {(n,)} rows {rows}", launch.result(),
                          wrapper())
        w_ms = cuda_ms(wrapper, inner=inner)
        p_ms = cuda_ms(plain, repeats=EXACT_PLAIN_REPEATS)
        print(f"time {name} ({n},) rows [{r0}, {r1}): device {med:.5f} ms "
              f"(min {lo:.5f}, max {hi:.5f}; {DEVICE_READINGS} readings of "
              f"{inner} launches), wrapper {w_ms:.5f} ms, plain {p_ms:.4f} "
              f"ms, bound {b_ms:.5f} ms ({by}); {count} launches in (h); "
              f"{want} pairs counted, equal to the plain version; on {card}",
              flush=True)
        e = entries.setdefault(name, dict(
            launches=0, max_abs_err=0.0, ms=0.0, wrapper_ms=0.0,
            plain_ms=0.0, bound_ms=0.0, by={}))
        e["launches"] += count
        e["max_abs_err"] = max(e["max_abs_err"], err)
        for k, val in (("ms", med), ("wrapper_ms", w_ms), ("plain_ms", p_ms),
                       ("bound_ms", b_ms)):
            e[k] += val * count
        e["by"][by] = e["by"].get(by, 0.0) + b_ms * count
    return entries


def h_drills(mesh, dpos, dedges):
    """(h6): the session's mesh rung on the one-rank mesh
    (``backend="graph_sharded"``, ``probe_interval=2``) through a lost
    mesh, the canary probe and auto-restore, a second loss, a rejected
    probe and the final restore.  Every result equals the fused truth on
    integers; the breaker's states and every counter are the ones the
    injected faults make.  Returns the counters."""
    from repro_torch.api import EvalConfig
    from repro_torch.launch.faults import FaultPlan
    from repro_torch.launch.session import EvalSession
    cfg = EvalConfig(radius=RADIUS, n_strips=DRILL_N_STRIPS,
                     backend="graph_sharded")
    truth = EvalSession(dataclasses.replace(cfg, backend="fused"),
                        device=mesh.device).evaluate(dpos, dedges)
    sess = EvalSession(cfg, mesh=mesh, probe_interval=2)
    loss, reject = dict(mesh_loss_dispatches=0), dict(reject_probes=0)
    steps = ((loss, "open"), ({}, "half_open"), ({}, "closed"),
             (loss, "open"), ({}, "half_open"), (reject, "open"),
             ({}, "half_open"), ({}, "closed"))
    injected = {"mesh_loss_dispatches": 0, "reject_probes": 0}
    for i, (plan, state) in enumerate(steps):
        with FaultPlan(**plan) as fp:
            got = sess.evaluate(dpos, dedges)
        for k in injected:
            injected[k] += fp.injected[k]
        same_ints(f"(h6) step {i}", got, truth)
        check(sess.health()["breaker_state"] == state,
              f"(h6) step {i}: breaker {sess.health()['breaker_state']}, "
              f"want {state}")
    s = sess.stats
    faults_in = injected["mesh_loss_dispatches"] + injected["reject_probes"]
    got = {k: s[k] for k in ("degraded_dispatches", "breaker_opens",
                             "probes", "auto_restores",
                             "graph_sharded_dispatches", "quarantined",
                             "dispatch_failures")}
    want = {"degraded_dispatches": faults_in, "breaker_opens": faults_in,
            "probes": 3, "auto_restores": 2, "graph_sharded_dispatches": 2,
            "quarantined": 0, "dispatch_failures": 0}
    check(injected == {"mesh_loss_dispatches": 2, "reject_probes": 1}
          and got == want, f"(h6) injected {injected}, counters {got}, "
                           f"want {want}")
    check(sess.health()["dispatch_mode"] == "graph_sharded",
          f"(h6) {sess.health()['dispatch_mode']}")
    return got, injected


def distributed_phase(cfg, pos, edges, batch, epos, eedges, dpos, dedges,
                      ev, b_launches, card):
    """(h): the distributed paths.  (h1), (h3), (h4) and (h6) on a one-rank
    NCCL group in this process; (h2)-(h5) on :data:`H_WORLD` ranks over
    gloo, each a process of its own on the one card.  Every check of the
    phase docstring; prints the runs, launches and times.  Returns the
    kernels line's row-range entries and (h)'s strip-reversal launches."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import engine
    t0 = time.perf_counter()
    init_group("nccl", 0, 1, free_port())
    try:
        dev = torch.device("cuda", 0)
        flat, tiered = h_plans(cfg, pos, edges, batch)
        runs, rows, slabs, meshes, dist_ev = h_paths(
            1, dev, cfg, pos, edges, batch, flat, tiered)
        rev_err = check_captured(slabs, flat.ideal)
        print(f"(h) this process: backend {meshes['graph'].backend}, world "
              f"1, rank 0 on {meshes['graph'].device}", flush=True)
        n_axes = len(flat.axes)
        host = {k: h_host(r["out"]) for k, r in runs.items()}
        single = h_host(engine.evaluate_planned(flat, pos, edges,
                                                device=dev))
        for f in INT_FIELDS:
            check(host["h1"][f] == single[f],
                  f"(h1) {f} = {host['h1'][f]}, single-device fused engine "
                  f"{single[f]}")
        check_h_scores("(h1) graph-sharded, 1 rank", host["h1"],
                       REFERENCE["fused"])
        check((runs["h1"]["halo"], runs["h1 E_c/E_ca only"]["halo"])
              == (1, 0), f"(h1) halo exchanges "
                         f"{runs['h1']['halo']} and "
                         f"{runs['h1 E_c/E_ca only']['halo']}, want 1 and 0")
        check(host["h1 E_c/E_ca only"]["edge_crossing"]
              == REFERENCE["fused"]["edge_crossing"], "(h1) E_c only")
        for i in range(BATCH):
            check_h_scores(f"(h3)[{i}] batch-sharded, 1 rank",
                           {f: v[i] for f, v in host["h3"].items()},
                           REFERENCE["batch"][i])
        check_h_scores("(h4) distributed, 1 rank", host["h4"],
                       REFERENCE["fused"])
        want_l = {"h1": dict(strip_reversal=n_axes),
                  "h1 E_c/E_ca only": dict(strip_reversal=n_axes),
                  "h3": dict(strip_reversal=b_launches),
                  "h4": dict(strip_reversal=n_axes, occlusion_pairs_rows=1)}
        for k, want in want_l.items():
            got = {n: c for n, c in runs[k]["launches"].items() if c}
            check(got == want, f"({k}) launched {got}, want {want}")
        drills, injected = h_drills(meshes["graph"], dpos, dedges)
        print(f"(h6) mesh drills on the one-rank NCCL mesh: injected "
              f"{injected}, counters {drills}", flush=True)

        ranks = spawn_ranks(H_WORLD)
        for r in ranks:
            launched = {k: {n: c for n, c in v["launches"].items() if c}
                        for k, v in r["runs"].items()}
            print(f"(h) rank {r['rank']} of {H_WORLD}: backend "
                  f"{r['backend']} on {r['device']}; launches {launched}; "
                  f"strip_reversal slabs {r['slab_shapes']}", flush=True)
            check(r["backend"] == "gloo", f"(h) rank backend {r['backend']}")
            check(all(r["runs"][k]["out"] == ranks[0]["runs"][k]["out"]
                      for k in r["runs"]),
                  f"(h) rank {r['rank']}'s results differ from rank 0's")
            out = {k: v["out"] for k, v in r["runs"].items()}
            lab = f"rank {r['rank']} of {H_WORLD}"
            for f in INT_FIELDS:
                check(out["h2"][f] == host["h1"][f],
                      f"(h2) {lab}: {f} = {out['h2'][f]}, (h1) "
                      f"{host['h1'][f]}")
            for f in FLOAT_FIELDS:
                check(abs(out["h2"][f] - host["h1"][f])
                      <= RTOL * abs(host["h1"][f]),
                      f"(h2) {lab}: {f} = {out['h2'][f]!r}, (h1) "
                      f"{host['h1'][f]!r}")
            check((r["runs"]["h2"]["halo"],
                   r["runs"]["h2 E_c/E_ca only"]["halo"]) == (1, 0),
                  f"(h2) {lab}: halo exchanges")
            for i in range(BATCH):
                check_h_scores(f"(h3)[{i}] {lab}",
                               {f: v[i] for f, v in out["h3"].items()},
                               REFERENCE["batch"][i])
            for i in range(H_CUT):
                check_h_scores(f"(h3) cut of {H_CUT} [{i}] {lab}",
                               {f: v[i] for f, v in out["h3 cut"].items()},
                               REFERENCE["batch"][i])
            check_h_scores(f"(h4) {lab}", out["h4"], REFERENCE["fused"])
            check(out["h5"] == EXACT_REFERENCE["edge_crossing"],
                  f"(h5) {lab}: E_c {out['h5']}, (d) "
                  f"{EXACT_REFERENCE['edge_crossing']}")
            got_l = {k: {n: c for n, c in v["launches"].items() if c}
                     for k, v in r["runs"].items()}
            check(got_l["h4"].get("occlusion_pairs_rows") == 1
                  and got_l["h5"] == {"segment_crossing_rows": 1}
                  and got_l["h2"] == {"strip_reversal": n_axes}
                  and got_l["h4"].get("strip_reversal") == n_axes,
                  f"(h) {lab} launched {got_l}")
            rev_err = max(rev_err, r["rev_err"])
        rows_all = [tuple(x) for x in rows] + [
            tuple(x) for r in ranks for x in r["rows"]]
        rev_launches = len(slabs) + sum(r["slabs"] for r in ranks)
        print(f"(h) strip_reversal: {rev_launches} launches in (h) "
              f"({len(slabs)} here, {[r['slabs'] for r in ranks]} on the "
              f"ranks), each "
              f"equal to its plain version (max abs dev err {rev_err}); "
              f"row-range launches {sorted(rows_all)}", flush=True)
        print("distributed paths: ok, (h1)-(h6) equal to the JAX reference "
              f"constants (ints exact, floats rtol {RTOL}), one halo "
              "exchange per graph-sharded evaluation, none without N_c",
              flush=True)

        times = h_times(meshes, dist_ev, flat, tiered, pos, edges, batch)
        base = {
            "graph_sharded": cuda_ms(lambda: engine.evaluate_planned(
                flat, pos, edges, device=dev)),
            "batch_sharded": cuda_ms(lambda: engine.evaluate_layouts(
                tiered, batch, edges, device=dev)),
            "distributed_evaluate": cuda_ms(lambda: ev.evaluate(pos, edges))}
        labels = {"graph_sharded": ("(h1) evaluate_graph_sharded",
                                    "evaluate_planned, same flat plan"),
                  "batch_sharded": (f"(h3) evaluate_layouts_sharded B={BATCH}",
                                    "evaluate_layouts, same plan"),
                  "distributed_evaluate": (
                      "(h4) Evaluator(backend='distributed').evaluate",
                      "(a) Evaluator(cfg).evaluate")}
        for k, (what, single_what) in labels.items():
            print(f"time {what}, 1 rank (NCCL): {times[k]:.3f} ms; single "
                  f"device {single_what}: {base[k]:.3f} ms (medians of "
                  f"{REPEATS}, CUDA events) on {card}", flush=True)
        for r in ranks:
            print(f"time rank {r['rank']} of {H_WORLD} (gloo, both ranks on "
                  f"the one card, so no speedup): "
                  f"{ {k: round(v, 3) for k, v in r['times'].items()} } ms "
                  f"(medians of {REPEATS}, CUDA events) on {card}",
                  flush=True)
        entries = h_row_kernels(rows_all, pos, epos, eedges, dev, card)
        check(set(entries) == {"occlusion_pairs_rows",
                               "segment_crossing_rows"},
              f"(h) row-range kernels launched: {sorted(entries)}")
    finally:
        dist.destroy_process_group()
    print(f"time (h) the distributed phase: {time.perf_counter() - t0:.2f} "
          f"s (wall, the ranks' start and the row-range timings included)",
          flush=True)
    return entries, rev_launches


# ---------------------------------------------------------------------------
# (i) the main path at precision="bfloat16"
# ---------------------------------------------------------------------------

class capturing_bf16:
    """Within the block, every launch of the bfloat16 instantiation of the
    strip-reversal or occlusion-pair kernel keeps a copy of its arguments
    and of the kernel's result in ``self.launches`` as ``(kernel, args,
    result)``; float32 launches pass through, counted in
    ``self.float32``."""

    def __init__(self, rev_mod, occ_mod):
        from collections import Counter
        self.mods = {"strip_reversal": rev_mod, "occlusion_pairs": occ_mod}
        self.launches = []
        self.float32 = Counter()

    def __enter__(self):
        import torch
        self.saved = {k: m._launch for k, m in self.mods.items()}

        def keeper(name, launch):
            def keep(*args):
                out = launch(*args)
                if args[0].dtype == torch.bfloat16:
                    res = tuple(t.clone() for t in out) \
                        if isinstance(out, tuple) else out.clone()
                    self.launches.append(
                        (name, [a.clone() if isinstance(a, torch.Tensor)
                                else a for a in args], res))
                else:
                    self.float32[name] += 1
                return out
            return keep
        for k, m in self.mods.items():
            m._launch = keeper(k, self.saved[k])
        return self

    def __exit__(self, *exc):
        for k, m in self.mods.items():
            m._launch = self.saved[k]


def check_bf16_scores(label, got, want):
    """Integers equal to the reference's bfloat16 run, floats within
    :data:`BF16_RTOL`."""
    for f in INT_FIELDS:
        check(int(getattr(got, f)) == want[f],
              f"{label}: {f} = {int(getattr(got, f))}, reference {want[f]}")
    for f in FLOAT_FIELDS:
        g = float(getattr(got, f))
        check(abs(g - want[f]) <= BF16_RTOL * abs(want[f]),
              f"{label}: {f} = {g!r}, reference {want[f]!r} (rtol "
              f"{BF16_RTOL})")


def reversal_bound_bf16_ms(args):
    """:func:`reversal_bound_ms` for a bfloat16 slab: 2-byte ordinates and
    angles, and the deviation's four roundings to bfloat16 per crossing
    (a convert and a widening each)."""
    import torch
    from repro_torch.kernels.strip_reversal import strip_reversal_rows_plain
    yl, yr, th, v, u, ok = args
    rows, cap = yl.shape
    n_valid = ok.sum(dim=1, dtype=torch.float64)
    pairs = float((n_valid * (n_valid - 1) / 2).sum())
    reversals = float(strip_reversal_rows_plain(
        yl, yr, th, *distinct_ids(yl.shape, yl.device), ok, ideal=1.0,
        with_angle=False)[0].sum())
    crossings = float(strip_reversal_rows_plain(
        *args, ideal=1.0, with_angle=False)[0].sum())
    ops = (REV_OPS_PER_UNORDERED_PAIR * pairs
           + REV_OPS_PER_REVERSAL * reversals
           + (REV_OPS_PER_CROSSING + REV_OPS_BF16_ROUNDING) * crossings)
    return bound(rows * cap * (3 * 2 + 2 * 4 + 1) + rows * (8 + 4), ops)


def bf16_kernel_rows(captured, ideal, card):
    """Each captured bfloat16 launch held against the plain version on the
    same arguments (counts equal, deviation partials at rtol
    :data:`RTOL`); then each launched shape timed alone on the device,
    through its wrapper and as the plain version, with its bound.  Returns
    the kernels line's two bfloat16 entries."""
    import torch
    from repro_torch.kernels._build import entry
    from repro_torch.kernels.occlusion_pairs import (occlusion_pairs,
                                                     occlusion_pairs_plain)
    from repro_torch.kernels.strip_reversal import (
        strip_reversal_rows, strip_reversal_rows_plain)
    err = {"strip_reversal": 0.0, "occlusion_pairs": 0.0}
    shapes = {}
    for name, args, res in captured:
        if name == "strip_reversal":
            yl, yr, th, v, u, ok, ideal_, with_angle = args
            pc, pd = strip_reversal_rows_plain(yl, yr, th, v, u, ok,
                                               ideal=ideal_,
                                               with_angle=with_angle)
            torch.cuda.synchronize()
            check(torch.equal(res[0], pc), f"(i) strip_reversal_bf16 "
                  f"counts differ at {tuple(yl.shape)}")
            check(torch.allclose(res[1].double(), pd.double(), rtol=RTOL,
                                 atol=0.0),
                  f"(i) strip_reversal_bf16 deviations differ at "
                  f"{tuple(yl.shape)}")
            if pd.numel():
                err[name] = max(err[name], float(
                    (res[1].double() - pd.double()).abs().max()))
            key = (name, tuple(yl.shape))
            shapes.setdefault(key, [0, [yl, yr, th, v, u, ok]])
        else:
            x, y, ok, radius, row0, row1 = args
            want = occlusion_pairs_plain(x, y, ok, radius, rows=(row0, row1))
            check(int(res) == int(want),
                  f"(i) occlusion_pairs_bf16 {int(res)} != plain {int(want)}")
            key = (name, tuple(x.shape))
            shapes.setdefault(key, [0, [x, y, ok], radius, int(want)])
        shapes[key][0] += 1
    entries = {}
    for (name, shape), item in sorted(shapes.items()):
        n, args = item[0], item[1]
        if name == "strip_reversal":
            launch = raw_launcher(name, args, ideal=ideal,
                                  fn=entry("strip_reversal_bf16"))

            def wrapper():
                return strip_reversal_rows(*args, ideal=ideal)

            def plain():
                return strip_reversal_rows_plain(*args, ideal=ideal)
            b_ms, by = reversal_bound_bf16_ms(args)
            inner = 20
        else:
            radius, occluded = item[2], item[3]
            launch = raw_launcher(name, args, radius=radius,
                                  fn=entry("occlusion_pairs_bf16"))

            def wrapper():
                return occlusion_pairs(*args, radius)

            def plain():
                return occlusion_pairs_plain(*args, radius)
            nv = float(args[2].sum())
            b_ms, by = bound(shape[0] * 5 + 8,
                             OCC_OPS_PER_PAIR * nv * (nv - 1) / 2
                             + OCC_OPS_PER_OCCLUSION * occluded)
            inner = 3 if shape[0] > 65536 else 20
        med, lo, hi = device_ms(launch, inner)
        check_same_result(f"{name}_bf16 {shape}", launch.result(), wrapper())
        w_ms = cuda_ms(wrapper, inner=inner)
        p_ms = cuda_ms(plain)
        print(f"time {name}_bf16 (i) {shape}: device {med:.5f} ms (min "
              f"{lo:.5f}, max {hi:.5f}; {DEVICE_READINGS} readings of "
              f"{inner} launches), wrapper {w_ms:.5f} ms, plain {p_ms:.4f} "
              f"ms, bound {b_ms:.5f} ms ({by}); {n} launches in (i) on "
              f"{card}", flush=True)
        e = entries.setdefault(name, dict(launches=0, ms=0.0, wrapper_ms=0.0,
                                          plain_ms=0.0, bound_ms=0.0, by={}))
        e["launches"] += n
        for k, val in (("ms", med), ("wrapper_ms", w_ms), ("plain_ms", p_ms),
                       ("bound_ms", b_ms)):
            e[k] += n * val
        e["by"][by] = e["by"].get(by, 0.0) + n * b_ms
    out = []
    for name in ("strip_reversal", "occlusion_pairs"):
        check(name in entries, f"(i) launched no bfloat16 {name}")
        e = entries[name]
        out.append(dict(
            name=f"{name}_bf16", route="cuda",
            source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=("src/repro/kernels/strip_reversal.py:25"
                      if name == "strip_reversal"
                      else "src/repro/kernels/occlusion_pairs.py:30"),
            launches=e["launches"], max_abs_err=err[name], ms=e["ms"],
            wrapper_ms=e["wrapper_ms"], plain_ms=e["plain_ms"],
            bound_ms=e["bound_ms"], bound_by=max(e["by"], key=e["by"].get),
            library_ms=None))
    return out


def bf16_phase(cfg, pos, edges, batch, ideal, card):
    """(i): the main path at ``precision="bfloat16"`` on (a)'s layout and
    (b)'s batch, against :data:`BF16_REFERENCE` (integers equal, floats at
    :data:`BF16_RTOL`); every bfloat16 launch of kernels 1 and 2 held
    against its plain version; each path's median beside its float32
    counterpart.  Returns the kernels line's bfloat16 entries."""
    import torch
    from repro_torch.api import Evaluator
    from repro_torch.kernels import occlusion_pairs as occ_mod
    from repro_torch.kernels import strip_reversal as rev_mod
    from repro_torch.launch.serve import ReadabilityServer
    bcfg = dataclasses.replace(cfg, precision="bfloat16")
    kcfg = dataclasses.replace(bcfg, backend="kernels")
    reqs = [(p, edges) for p in batch]
    evs = {"fused": Evaluator(bcfg), "kernels": Evaluator(kcfg),
           "server": ReadabilityServer(bcfg)}
    calls = {"i1": lambda ev: ev.evaluate(pos, edges),
             "i2": lambda ev: ev.evaluate_batch(batch, edges),
             "i3": lambda ev: ev.evaluate(pos, edges),
             "i4": lambda ev: ev.evaluate_batch(reqs)}
    which = {"i1": "fused", "i2": "fused", "i3": "kernels", "i4": "server"}
    rev, occ = rev_mod.strip_reversal_rows, occ_mod.occlusion_pairs
    runs, launches = {}, {}
    with capturing_bf16(rev_mod, occ_mod) as cap:
        for key, call in calls.items():
            rev.LAUNCHES_BF16 = occ.LAUNCHES_BF16 = 0
            runs[key] = call(evs[which[key]])
            launches[key] = (rev.LAUNCHES_BF16, occ.LAUNCHES_BF16)
    print(f"(i) bfloat16 launches (strip_reversal_bf16, "
          f"occlusion_pairs_bf16) per path: {launches}; float32 launches "
          f"(the kernels route sweeps float32 buckets, as the reference "
          f"casts them): {dict(cap.float32)}", flush=True)
    check(all(launches[k][0] > 0 for k in ("i1", "i2", "i4")),
          f"(i) fused paths launched {launches}")
    # the session replans when the bfloat16 layout outgrows the plan made
    # from its float32 coordinates, as the reference's does: each
    # evaluation launches kernel 2 once
    check(launches["i3"][1] >= 1 and cap.float32["strip_reversal"]
          == 2 * launches["i3"][1],
          f"(i3) launched {launches['i3']} and float32 {dict(cap.float32)}")
    want = BF16_REFERENCE
    check_bf16_scores("(i1) fused bf16", runs["i1"], want["fused"])
    for i, r in enumerate(runs["i2"].unbatch()):
        check_bf16_scores(f"(i2)[{i}] batch bf16", r, want["batch"][i])
    check_bf16_scores("(i3) kernels bf16", runs["i3"], want["kernels"])
    for i, r in enumerate(runs["i4"]):
        check(r.ok, f"(i4) request {i}: {r.error}")
        check_bf16_scores(f"(i4)[{i}] server bf16", r, want["serve"][i])
    print(f"(i1) {runs['i1']}")
    print(f"(i3) {runs['i3']}")
    entries = bf16_kernel_rows(cap.launches, ideal, card)
    print("(i) bfloat16 main path: ok, equal to the JAX reference's op-by-op "
          f"bfloat16 constants (ints exact, floats rtol {BF16_RTOL}); every "
          f"bfloat16 launch equal to its plain version", flush=True)

    f32 = {"fused": Evaluator(cfg),
           "kernels": Evaluator(dataclasses.replace(cfg, backend="kernels")),
           "server": ReadabilityServer(cfg)}
    labels = {"i1": "evaluate fused", "i2": f"evaluate_batch B={BATCH}",
              "i3": "evaluate kernels", "i4": f"server, {BATCH} requests"}
    for key, call in calls.items():
        b_ms = cuda_ms(lambda: call(evs[which[key]]))
        f_ms = cuda_ms(lambda: call(f32[which[key]]))
        print(f"time ({key}) {labels[key]}: bfloat16 {b_ms:.3f} ms, float32 "
              f"{f_ms:.3f} ms (medians of {REPEATS}, CUDA events) on {card}",
              flush=True)
    torch.cuda.synchronize()
    return entries


# ---------------------------------------------------------------------------
# (j) the LM serving path
# ---------------------------------------------------------------------------

def lm_prompt(vocab, batch, length, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (batch, length)).astype(np.int32)


def lm_smoke_phase(dev):
    """(j1): the five LM smoke configs at ``dtype=float32``, parameters from
    ``numpy_params(cfg, LM_SEED)``: ``lm_generate``'s tokens equal to
    :data:`LM_REFERENCE`'s, the prefill logits' head and norms at
    :data:`LM_RTOL`."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.launch.serve import lm_generate
    from repro_torch.models.transformer import (Transformer, numpy_params,
                                                params_from_reference)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch in configs.ARCH_IDS[:5]:
        cfg = dataclasses.replace(configs.get_arch(arch).smoke_config,
                                  dtype=torch.float32)
        model = Transformer(cfg, device=dev)
        model.load_state_dict(params_from_reference(
            numpy_params(cfg, LM_SEED)))
        prompt = torch.from_numpy(lm_prompt(
            cfg.vocab_size, LM_BATCH, LM_PROMPT, LM_SEED + 1)).to(dev)
        _, logits = model.prefill(prompt, model.init_cache(LM_BATCH,
                                                           LM_PROMPT))
        tokens = lm_generate(model, prompt, LM_NEW).cpu().numpy()
        want = LM_REFERENCE[arch]
        check(tokens.tolist() == want["tokens"],
              f"(j1) {arch}: tokens {tokens.tolist()}, reference "
              f"{want['tokens']}")
        logits = logits.double().cpu().numpy()
        head_ok = np.allclose(logits[:, :8], want["prefill_logits_head"],
                              rtol=LM_RTOL, atol=LM_ATOL)
        norm = np.linalg.norm(logits, axis=1)
        norm_ok = np.allclose(norm, want["prefill_logits_norm"],
                              rtol=LM_RTOL)
        check(head_ok and norm_ok,
              f"(j1) {arch}: prefill logits {logits[:, :8].tolist()} "
              f"(norms {norm.tolist()}), reference "
              f"{want['prefill_logits_head']} ({want['prefill_logits_norm']})")
        err = float(np.abs(logits[:, :8]
                           - np.asarray(want["prefill_logits_head"])).max())
        print(f"(j1) {arch}: {LM_NEW} greedy tokens equal, prefill logits "
              f"within rtol {LM_RTOL} (max abs err {err!r})", flush=True)


def lm_full_phase(dev, card):
    """(j2): qwen3-4b at its published width and depth in bfloat16:
    prefill of B x P tokens, ``lm_generate`` of :data:`LM_FULL_NEW`
    tokens, the last decode's logits against a fresh prefill of the
    extended sequence.  (j3): ``merge_decode_attention`` on a one-rank
    NCCL group against unsharded decode attention on layer 0's cache."""
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.distributed.collectives import merge_decode_attention
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.launch.serve import lm_generate
    from repro_torch.models.transformer import Transformer, kv_cache_bytes
    cfg = configs.get_arch("qwen3-4b").config
    B, P, N = LM_FULL_BATCH, LM_FULL_PROMPT, LM_FULL_NEW
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    model = Transformer(cfg, device=dev).init_params(gen)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           device=dev)
    torch.cuda.synchronize()
    print(f"(j2) {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.param_count() / 1e9:.3f} B parameters (float32, "
          f"{sum(p.numel() for p in model.parameters()) * 4 / 2 ** 30:.3f} "
          f"GiB), made in {time.perf_counter() - t0:.2f} s; KV cache at "
          f"B={B}, {P + N} positions: "
          f"{kv_cache_bytes(cfg, B, P + N) / 2 ** 30:.3f} GiB", flush=True)

    def prefill():
        return model.prefill(prompt, model.init_cache(B, P + N))

    cache, logits = prefill()
    check(bool(torch.isfinite(logits[:, :cfg.vocab_size].float()).all()),
          "(j2) prefill logits are not finite")
    prefill_ms = cuda_ms(prefill, repeats=3)
    # the generation, timed on the host clock around synchronized calls
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cache = model.init_cache(B, P + N)
    cache, logits = model.prefill(prompt, cache)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out, step_ms = [nxt], []
    for _ in range(N - 1):
        s0 = time.perf_counter()
        nxt, last_logits, cache = model.decode_step(nxt, cache)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - s0) * 1e3)
        out.append(nxt)
    tokens = torch.stack(out, dim=1)
    total_s = time.perf_counter() - t1
    check(torch.equal(tokens, lm_generate(model, prompt, N)),
          "(j2) lm_generate differs from its own prefill + decode loop")
    peak = torch.cuda.max_memory_allocated()
    # the last decode's logits against a fresh prefill of the prompt and
    # the first N - 1 generated tokens
    ext = torch.cat([prompt, tokens[:, :N - 1].long()], dim=1)
    _, fresh = model.prefill(ext, model.init_cache(B, P + N))
    a, b = last_logits.double(), fresh.double()
    rel = float(((a - b).norm(dim=1) / b.norm(dim=1)).max())
    agree = float((a.argmax(dim=1) == b.argmax(dim=1)).double().mean())
    check(rel <= LM_BF16_REL_L2,
          f"(j2) last decode vs fresh prefill: relative L2 {rel!r} > "
          f"{LM_BF16_REL_L2}")
    print(f"(j2) last decode logits against a fresh prefill of {P + N - 1} "
          f"tokens: max relative L2 {rel!r} (bound {LM_BF16_REL_L2}), "
          f"argmax agreement {agree!r}", flush=True)
    print(f"time (j2) {cfg.name} bfloat16: prefill B={B} x {P} tokens "
          f"{prefill_ms:.3f} ms (median of 3, CUDA events); generate {N} "
          f"tokens {total_s:.3f} s (prefill {(t2 - t1) * 1e3:.3f} ms, decode "
          f"per token median {statistics.median(step_ms):.3f} ms, min "
          f"{min(step_ms):.3f}, max {max(step_ms):.3f}; host clock); peak "
          f"memory allocated {peak / 2 ** 30:.3f} GiB on {card}", flush=True)

    # (j3) the sequence-sharded decode merge on one NCCL rank
    init_group("nccl", 0, 1, free_port())
    try:
        mesh = make_mesh((1,), ("model",), device=dev)
        S = cache["pos"]
        k, v = cache["k"][0, :, :S], cache["v"][0, :, :S]
        q = torch.randn(B, cfg.n_kv_heads, cfg.d_head, generator=gen,
                        device=dev).to(cfg.dtype)
        got = merge_decode_attention(mesh, q, k, v, S - 1)
        s = torch.einsum("bhd,bthd->bht", q.float(), k.float()) \
            * cfg.d_head ** -0.5
        want = torch.einsum("bht,bthd->bhd", torch.softmax(s, dim=-1),
                            v.float())
        err = float((got.float() - want).abs().max())
        check(got.shape == want.shape and err <= LM_MERGE_ATOL,
              f"(j3) merge_decode_attention off by {err!r}")
        print(f"(j3) merge_decode_attention on a one-rank NCCL group, "
              f"(B, H, dh) = {tuple(got.shape)} against {S} positions: max "
              f"abs err {err!r} against float32 unsharded attention (atol "
              f"{LM_MERGE_ATOL})", flush=True)
    finally:
        dist.destroy_process_group()
    del model, cache
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# (k) LM training
# ---------------------------------------------------------------------------

def lm_train_smoke_phase(dev):
    """(k1): three trainer steps of each LM smoke config at float32
    against :data:`TRAIN_REFERENCE`, then ``launch.train.main``'s resume
    on qwen3-4b ``--smoke``."""
    import math

    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch import train
    from repro_torch.models.transformer import (Transformer, numpy_params,
                                                params_from_reference)
    from repro_torch.optim import adamw
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opt_cfg = adamw.AdamWConfig(**TRAIN_OPT)
    for arch in configs.ARCH_IDS[:5]:
        cfg = dataclasses.replace(configs.get_arch(arch).smoke_config,
                                  dtype=torch.float32).with_mesh(1)
        model = Transformer(cfg, device=dev)
        model.load_state_dict(params_from_reference(
            numpy_params(cfg, TRAIN_SEED)))
        opt_state = adamw.init_state(model.param_tree())
        steps = {a: train.build_lm_trainer(model, opt_cfg, grad_accum=a)
                 for a in set(TRAIN_ACCUM)}
        stream = TokenStream(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                             seed=TRAIN_SEED)
        got = {"loss": [], "grad_norm": []}
        for a in TRAIN_ACCUM:
            m = steps[a](opt_state, stream.next_batch())
            for k in got:
                got[k].append(float(m[k]))
        want = TRAIN_REFERENCE["smoke"][arch]
        err = max(abs(g / w - 1) for k in got
                  for g, w in zip(got[k], want[k]))
        check(all(np.allclose(got[k], want[k], rtol=TRAIN_RTOL, atol=0)
                  for k in got),
              f"(k1) {arch}: {got}, reference {want}")
        print(f"(k1) {arch}: {len(TRAIN_ACCUM)} steps (grad_accum "
              f"{TRAIN_ACCUM}), loss {got['loss']}, grad norm "
              f"{got['grad_norm']}: within rtol {TRAIN_RTOL} of the "
              f"reference's trainer (max rel err {err!r})", flush=True)
        del model, opt_state, steps

    with tempfile.TemporaryDirectory() as d:
        args = TRAIN_MAIN_ARGS + ["--device", str(dev)]
        straight = train.main(args + ["--steps", "4"])
        ck = ["--checkpoint-dir", d, "--checkpoint-every", "2"]
        first = train.main(args + ["--steps", "2"] + ck)
        resumed = train.main(args + ["--steps", "4"] + ck)
    check(len(first) == len(resumed) == 2
          and all(math.isfinite(x) for x in straight)
          and all(math.isclose(x, y, rel_tol=TRAIN_RESUME_RTOL)
                  for x, y in zip(first + resumed, straight)),
          f"(k1) main: straight {straight}, 2 steps {first}, resumed "
          f"{resumed}")
    print(f"(k1) launch.train.main qwen3-4b --smoke: 4 steps {straight}; 2 "
          f"steps, checkpoint, resume, 2 steps {first} + {resumed} (every "
          f"loss within rtol {TRAIN_RESUME_RTOL})", flush=True)


def lm_train_full_2l_phase(dev):
    """(k2a): qwen3-4b at its published width with 2 layers at float32:
    the loss, xent and gradient norm against
    :data:`TRAIN_REFERENCE`'s ``full_2l``."""
    import math

    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models.transformer import (Transformer, loss_fn,
                                                numpy_params,
                                                params_from_reference)
    from repro_torch.optim import adamw
    t0 = time.perf_counter()
    cfg = dataclasses.replace(configs.get_arch("qwen3-4b").config,
                              n_layers=2, dtype=torch.float32)
    model = Transformer(cfg, device=dev)
    model.load_state_dict(params_from_reference(
        numpy_params(cfg, TRAIN_SEED)))
    batch = TokenStream(cfg.vocab_size, FULL_2L_SEQ, FULL_2L_BATCH,
                        seed=TRAIN_SEED).next_batch()
    total, mets = loss_fn(model, {k: torch.from_numpy(v).to(dev)
                                  for k, v in batch.items()})
    total.backward()
    norm = adamw.global_norm(adamw._map(lambda p: p.grad,
                                        model.param_tree()))
    got = dict(loss=float(total.detach()),
               xent=float(mets["xent"].detach()),
               tokens=float(mets["tokens"]), grad_norm=float(norm))
    want = TRAIN_REFERENCE["full_2l"]
    check(got["tokens"] == want["tokens"]
          and all(math.isclose(got[k], want[k], rel_tol=TRAIN_RTOL)
                  for k in ("loss", "xent", "grad_norm")),
          f"(k2a) {got}, reference {want}")
    print(f"(k2a) {cfg.name} at d {cfg.d_model}, vocab {cfg.vocab_size}, 2 "
          f"layers, float32 ({cfg.param_count() / 1e9:.3f} B parameters), "
          f"{FULL_2L_BATCH} x {FULL_2L_SEQ} tokens: loss {got['loss']!r}, "
          f"xent {got['xent']!r}, gradient norm {got['grad_norm']!r}; "
          f"reference {want['loss']!r}, {want['xent']!r}, "
          f"{want['grad_norm']!r} (rtol {TRAIN_RTOL}); "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    del model, total, mets
    torch.cuda.empty_cache()


def full_train_setup(dev):
    """(k2)'s model (parameters from a CUDA generator), AdamW state,
    gradients (zeros), batch on the device, and its two trainers (plain
    and int8-compressed)."""
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch.train import build_lm_trainer
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(configs.get_arch("qwen3-4b").config,
                              n_layers=FULL_TRAIN_LAYERS, loss_chunks=16,
                              remat=True)
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    model = Transformer(cfg, device=dev).init_params(gen)
    opt_state = adamw.init_state(model.param_tree())
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    batch = TokenStream(cfg.vocab_size, FULL_TRAIN_SEQ, FULL_TRAIN_ACCUM,
                        seed=TRAIN_SEED).next_batch()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    opt_cfg = adamw.AdamWConfig(peak_lr=FULL_TRAIN_LR, warmup_steps=1,
                                total_steps=FULL_TRAIN_STEPS)
    trainers = {c: build_lm_trainer(model, opt_cfg,
                                    grad_accum=FULL_TRAIN_ACCUM, compress=c)
                for c in (False, True)}
    return cfg, model, opt_state, batch, trainers


def lm_train_full_phase(dev, card):
    """(k2): qwen3-4b at full width and :data:`FULL_TRAIN_LAYERS` layers,
    bfloat16 products, float32 parameters and AdamW state, remat, the
    loss in 16 chunks: :data:`FULL_TRAIN_STEPS` steps on one batch of
    ``FULL_TRAIN_ACCUM`` x ``FULL_TRAIN_SEQ`` tokens, the last with int8
    gradient compression.  Prints losses, step time, tokens per second,
    MFU and peak memory."""
    import math

    import torch
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model, opt_state, batch, trainers = full_train_setup(dev)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.param_count() + 2 * cfg.n_layers * cfg.d_model
          + cfg.n_layers * 2 * cfg.d_head + cfg.d_model,
          f"(k2) {n_params} parameters")
    state_gib = 16 * cfg.param_count() / 2 ** 30
    torch.cuda.synchronize()
    print(f"(k2) {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, vocab "
          f"{cfg.vocab_size}, {cfg.param_count():,} parameters; float32 "
          f"parameters, gradients and AdamW m, v: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB allocated "
          f"(reckoned {state_gib:.2f} GiB; {held / 2 ** 30:.3f} GiB held by "
          f"earlier phases), made in {time.perf_counter() - t0:.2f} s",
          flush=True)
    tokens = FULL_TRAIN_ACCUM * FULL_TRAIN_SEQ
    losses, norms, step_ms = [], [], []
    for i in range(FULL_TRAIN_STEPS):
        compress = i == FULL_TRAIN_STEPS - 1
        step = trainers[compress]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m = step(opt_state, batch)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        print(f"(k2) step {i + 1}{' (int8 gradients)' if compress else ''}"
              f": loss {losses[-1]!r}, grad norm {norms[-1]!r}, lr "
              f"{float(m['lr']):.3e}, {step_ms[-1]:.1f} ms", flush=True)
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses + norms)
          and losses[2] < losses[0],
          f"(k2) losses {losses}, grad norms {norms}")
    ms = statistics.median(step_ms)
    matmul_params = cfg.param_count() - cfg.vocab_size * cfg.d_model
    flops = (6 * matmul_params * tokens + 12 * cfg.n_layers * cfg.n_heads
             * cfg.d_head * FULL_TRAIN_SEQ * tokens)
    mfu = flops / (ms / 1e3) / BF16_PEAK_FLOPS
    print(f"time (k2) {cfg.name} training, {cfg.n_layers} layers, "
          f"{FULL_TRAIN_ACCUM} x {FULL_TRAIN_SEQ} tokens per step "
          f"(grad_accum {FULL_TRAIN_ACCUM}): step median {ms:.1f} ms (min "
          f"{min(step_ms):.1f}, max {max(step_ms):.1f}; {len(step_ms)} steps, "
          f"CUDA events), {tokens / (ms / 1e3):.1f} tokens/s, MFU "
          f"{mfu:.4f} ({flops:.4e} model FLOP per step: 6 x {matmul_params:,} "
          f"matmul parameters x tokens + 12 x L x H x dh x S x tokens for "
          f"attention, over the H100 SXM dense bfloat16 peak "
          f"{BF16_PEAK_FLOPS / 1e12:.1f} TFLOP/s); peak memory allocated "
          f"{peak / 2 ** 30:.3f} GiB against {state_gib:.2f} GiB of "
          f"float32 state, on {card}", flush=True)
    del model, opt_state, trainers, batch, m
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase (l): the GNN and recsys families
# ---------------------------------------------------------------------------

def gnn_smoke_batch(case, cfg):
    """(l1)'s inputs of ``case`` as numpy arrays from
    ``numpy.random.default_rng(GNN_SEED)``, for ``cfg`` (either package's
    smoke config; ``tools/chip_smoke_reference.py --gnn`` feeds the
    reference the same): 40 nodes and 120 random edges with 12 edges and
    4 nodes masked; a fanout block of 8 seeds with random masks (seed 0
    without neighbours, ``m2 &= m1``); 32 rows of xDeepFM ids."""
    import numpy as np
    rng = np.random.default_rng(GNN_SEED)
    if case == "xdeepfm":
        ids = rng.integers(0, 64, (32, cfg.n_fields)) + cfg.field_offsets
        return {"ids": ids.astype(np.int32),
                "labels": rng.integers(0, 2, 32).astype(np.float32)}
    if case == "graphsage-sampled":
        (f1, f2), d, B = cfg.sample_sizes, cfg.d_in, 8
        m1 = rng.random((B, f1)) < 0.7
        m1[0] = False
        return {"x0": rng.normal(size=(B, d)).astype(np.float32),
                "x1": rng.normal(size=(B, f1, d)).astype(np.float32),
                "x2": rng.normal(size=(B, f1, f2, d)).astype(np.float32),
                "m1": m1,
                "m2": (rng.random((B, f1, f2)) < 0.6) & m1[:, :, None],
                "labels": rng.integers(0, cfg.n_classes, B).astype(np.int32)}
    n, e = 40, 120
    return {"node_feat": rng.normal(size=(n, cfg.d_in)).astype(np.float32),
            "edge_src": rng.integers(0, n, e).astype(np.int32),
            "edge_dst": rng.integers(0, n, e).astype(np.int32),
            "edge_mask": np.arange(e) < e - 12,
            "node_mask": np.arange(n) < n - 4,
            "labels": rng.integers(0, cfg.n_classes, n).astype(np.int32)}


def gnn_model(case, cfg, batch):
    """``(forward(params), loss_of(out))`` of ``case`` on ``batch`` (a
    dict of tensors), as the reference's smoke tests train it."""
    from repro_torch.models import gnn, recsys
    if case == "xdeepfm":
        return (lambda p: recsys.xdeepfm_logits(p, batch["ids"], cfg),
                lambda out: recsys.bce_loss(out, batch["labels"]))
    fwd = {"gcn-cora": gnn.gcn_forward,
           "graphsage-reddit": gnn.sage_forward_full,
           "graphsage-sampled": gnn.sage_forward_sampled}[case]
    mask = batch.get("node_mask", batch["labels"] >= 0)
    return (lambda p: fwd(p, batch, cfg),
            lambda out: gnn.node_classification_loss(out, batch["labels"],
                                                     mask)[0])


def inplace_trainer(params, opt_cfg):
    """A training step over ``params`` (a tree of float32 tensors, made
    leaves that require a gradient, each with a zero ``.grad``):
    ``step(loss_fn)`` runs ``loss_fn(params)``'s backward and the
    in-place AdamW step (``apply_updates_``), zeroes the gradients, and
    returns ``(loss, metrics)``."""
    import torch
    from repro_torch.optim import adamw
    leaves = adamw._leaves(params)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = torch.zeros_like(p)
    state = adamw.init_state(params)

    def step(loss_fn):
        loss = loss_fn(params)
        loss.backward()
        m = adamw.apply_updates_(params, adamw._map(lambda p: p.grad, params),
                                 state, opt_cfg)
        for p in leaves:
            p.grad.zero_()
        return loss.detach(), m

    return step


def timed_steps(step, loss_fn, n):
    """``n`` calls of ``step(loss_fn)``, each between CUDA events: the
    losses, the metrics and the milliseconds of each."""
    import torch
    losses, metrics, ms = [], [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss, m = step(loss_fn)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(loss))
        metrics.append(m)
    return losses, metrics, ms


def near(got, want, rtol):
    """Every element of ``got`` within ``rtol`` times ``want``'s largest
    magnitude; returns ``(ok, max abs err, that bound)``."""
    import numpy as np
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    tol = rtol * float(np.abs(want).max())
    return got.shape == want.shape and err <= tol, err, tol


def gnn_smoke_phase(dev):
    """(l1): the three architectures' smoke configs at float32 (four
    cases: GraphSAGE full-graph and on a fanout block) against
    :data:`GNN_REFERENCE`."""
    import math

    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import gnn, recsys
    from repro_torch.models.common import params_from_reference
    from repro_torch.optim import adamw
    opt_cfg = adamw.AdamWConfig(**GNN_OPT)
    for case in GNN_CASES:
        arch = "graphsage-reddit" if case == "graphsage-sampled" else case
        cfg = configs.get_arch(arch).smoke_config
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in gnn_smoke_batch(case, cfg).items()}
        mod = recsys if case == "xdeepfm" else gnn
        params = params_from_reference(mod.numpy_params(cfg, GNN_SEED),
                                       device=dev)
        forward, loss_of = gnn_model(case, cfg, batch)
        with torch.no_grad():
            logits = forward(params).cpu().numpy()
            scores = None if case != "xdeepfm" else recsys.retrieval_scores(
                params, batch["ids"][:1], cfg)[0].cpu().numpy()
        step = inplace_trainer(params, opt_cfg)
        losses, metrics, _ = timed_steps(step, lambda p: loss_of(forward(p)),
                                         GNN_STEPS)
        want = GNN_REFERENCE[case]
        ok, err, tol = near(logits.reshape(-1), want["logits"], TRAIN_RTOL)
        scalars = {"loss": losses[0],
                   "grad_norm": float(metrics[0]["grad_norm"])}
        ok = ok and all(math.isclose(scalars[k], want[k],
                                     rel_tol=TRAIN_RTOL) for k in scalars)
        ok = ok and np.allclose(losses, want["losses"], rtol=TRAIN_RTOL,
                                atol=0)
        note = ""
        if scores is not None:
            s_ok, s_err, _ = near(scores[:16], want["scores_head"],
                                  TRAIN_RTOL)
            norm = float(np.linalg.norm(scores.astype(np.float64)))
            ok = ok and s_ok and math.isclose(norm, want["scores_norm"],
                                              rel_tol=TRAIN_RTOL)
            note = (f"; retrieval scores {scores.shape}, norm {norm!r} "
                    f"(reference {want['scores_norm']!r})")
        check(ok, f"(l1) {case}: logits err {err} (bound {tol}), "
                  f"{scalars}, losses {losses}; reference {want}")
        print(f"(l1) {case} ({cfg.name}): logits {logits.shape} within "
              f"{err:.3e} of the reference (bound {tol:.3e}), loss "
              f"{scalars['loss']!r}, grad norm {scalars['grad_norm']!r}, "
              f"{GNN_STEPS} steps' losses {losses} (rtol {TRAIN_RTOL})"
              f"{note}", flush=True)


def cora_inputs(dev):
    """(l2)'s config, padded batch (numpy, and as tensors on ``dev``) and
    parameters (from a generator on ``dev``)."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.graphs.datasets import random_edges
    from repro_torch.graphs.format import pad_graph_batch
    from repro_torch.models import gnn
    cfg = configs.get_arch("gcn-cora").config
    check((cfg.d_in, cfg.n_classes) == (CORA_FEAT, CORA_CLASSES),
          f"(l2) {cfg}")
    rng = np.random.default_rng(GNN_SEED)
    edges = random_edges(CORA_NODES, CORA_EDGES, seed=GNN_SEED)
    host = pad_graph_batch(
        rng.normal(size=(CORA_NODES, CORA_FEAT)).astype(np.float32), edges,
        rng.integers(0, CORA_CLASSES, CORA_NODES), pad_multiple=512)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    gen = torch.Generator(device=dev).manual_seed(GNN_SEED)
    return cfg, host, batch, gnn.init_gcn_params(cfg, gen)


def gnn_cora_phase(dev, card):
    """(l2): gcn-cora at full_graph_sm, synthetic features and labels;
    the logits against the port on the CPU, the forward and a training
    step timed."""
    import numpy as np
    import torch
    from repro_torch.models import gnn
    from repro_torch.optim import adamw
    t0 = time.perf_counter()
    cfg, host, batch, params = cora_inputs(dev)
    with torch.no_grad():
        logits = gnn.gcn_forward(params, batch, cfg)
        on_cpu = gnn.gcn_forward(adamw._map(torch.Tensor.cpu, params),
                                 {k: torch.from_numpy(v)
                                  for k, v in host.items()}, cfg)
        fwd_ms = cuda_ms(lambda: gnn.gcn_forward(params, batch, cfg))
    ok, err, tol = near(logits.cpu().numpy(), on_cpu.numpy(), TRAIN_RTOL)
    check(ok and bool(torch.isfinite(logits).all()),
          f"(l2) logits on the card vs the CPU: err {err} (bound {tol})")
    _, loss_of = gnn_model("gcn-cora", cfg, batch)
    step = inplace_trainer(params, adamw.AdamWConfig(
        peak_lr=GNN_FULL_LR, warmup_steps=1, total_steps=GNN_FULL_STEPS))
    losses, _, ms = timed_steps(
        step, lambda p: loss_of(gnn.gcn_forward(p, batch, cfg)),
        GNN_FULL_STEPS)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"(l2) losses {losses}")
    print(f"(l2) gcn-cora full_graph_sm: {CORA_NODES} nodes, {CORA_EDGES} "
          f"edges (padded to {host['node_mask'].size}, "
          f"{host['edge_mask'].size}), {CORA_FEAT} features, "
          f"{CORA_CLASSES} classes; logits {tuple(logits.shape)} within "
          f"{err:.3e} of the port on the CPU (bound {tol:.3e}); losses "
          f"{losses}; {time.perf_counter() - t0:.2f} s", flush=True)
    print(f"time (l2) gcn-cora full_graph_sm: forward {fwd_ms:.3f} ms "
          f"(median of {REPEATS}), training step (forward, backward, "
          f"in-place AdamW) {statistics.median(ms):.3f} ms (median of "
          f"{GNN_FULL_STEPS}; min {min(ms):.3f}, max {max(ms):.3f}), CUDA "
          f"events, on {card}", flush=True)


def reddit_graph(dev):
    """(l3)'s graph on the device: ``REDDIT_ROWS`` undirected edge rows
    drawn uniformly (``random_edges``' Python set loop cannot draw 5.7e7
    in a run's time: pairs are drawn in bulk with numpy, self-loops
    dropped, repeats kept), ``to_csr``'s int32 ``indptr`` and
    ``indices``, float32 features and int32 labels from a CUDA
    generator."""
    import numpy as np
    import torch
    from repro_torch.graphs.datasets import to_csr
    rng = np.random.default_rng(GNN_SEED)
    pairs = rng.integers(0, REDDIT_NODES, (REDDIT_ROWS + REDDIT_ROWS // 1000,
                                           2), dtype=np.int32)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]][:REDDIT_ROWS]
    check(pairs.shape[0] == REDDIT_ROWS, f"(l3) {pairs.shape} edge rows")
    indptr, indices = to_csr(pairs, REDDIT_NODES)
    del pairs
    gen = torch.Generator(device=dev).manual_seed(GNN_SEED)
    feats = torch.randn((REDDIT_NODES, REDDIT_FEAT), generator=gen,
                        device=dev)
    labels = torch.randint(0, REDDIT_CLASSES, (REDDIT_NODES,),
                           generator=gen, device=dev, dtype=torch.int32)
    return (torch.from_numpy(indptr).to(dev),
            torch.from_numpy(indices).to(dev), feats, labels, gen)


def check_adjacent(indptr, indices, seeds, nbr, mask):
    """On the device: every unmasked ``nbr[b, j]`` lies in seed ``b``'s
    CSR row, and seeds with neighbours have no masked slot."""
    import torch
    start = indptr[seeds.long()].long()
    deg = indptr[seeds.long() + 1].long() - start
    span = torch.arange(int(deg.max()), device=deg.device)
    valid = span[None] < deg[:, None]
    adj = indices[torch.where(valid, start[:, None] + span[None], 0)]
    hit = ((adj[:, None, :] == nbr[:, :, None]) & valid[:, None, :]).any(-1)
    return bool(((hit | ~mask).all() & (mask.all(-1) == (deg > 0)).all())
                .item())


def gnn_reddit_phase(dev, card):
    """(l3): graphsage-reddit at minibatch_lg on a Reddit-sized graph on
    the device: sampling, the forward and a training step timed apart;
    the first seeds' samples held to the CSR."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.graphs.sampler import (sample_fanout_batch,
                                            sample_neighbors)
    from repro_torch.models import gnn
    from repro_torch.optim import adamw
    t0 = time.perf_counter()
    cfg = configs.get_arch("graphsage-reddit").config
    cfg = dataclasses.replace(cfg, d_in=REDDIT_FEAT, n_classes=REDDIT_CLASSES)
    indptr, indices, feats, labels, gen = reddit_graph(dev)
    check(int(indptr[-1]) == indices.numel() == 2 * REDDIT_ROWS,
          f"(l3) CSR of {indices.numel()} entries")
    torch.cuda.synchronize()
    made_s = time.perf_counter() - t0
    seeds = torch.randperm(REDDIT_NODES, generator=gen, device=dev)[
        :REDDIT_SEEDS].to(torch.int32)

    def sample():
        return sample_fanout_batch(indptr, indices, feats, labels, seeds,
                                   gen, REDDIT_FANOUT)

    batch = sample()
    nbr, mask = sample_neighbors(indptr, indices, seeds[:REDDIT_CHECKED],
                                 REDDIT_FANOUT[0], gen)
    check(check_adjacent(indptr, indices, seeds[:REDDIT_CHECKED], nbr, mask),
          "(l3) a sampled neighbour is not adjacent to its seed")
    sample_ms = cuda_ms(sample)
    params = gnn.init_sage_params(cfg, gen)
    with torch.no_grad():
        logits = gnn.sage_forward_sampled(params, batch, cfg)
        fwd_ms = cuda_ms(lambda: gnn.sage_forward_sampled(params, batch, cfg))
    check(tuple(logits.shape) == (REDDIT_SEEDS, REDDIT_CLASSES)
          and bool(torch.isfinite(logits).all()), f"(l3) logits {logits}")
    _, loss_of = gnn_model("graphsage-sampled", cfg, batch)
    step = inplace_trainer(params, adamw.AdamWConfig(
        peak_lr=GNN_FULL_LR, warmup_steps=1, total_steps=GNN_FULL_STEPS))
    losses, _, ms = timed_steps(
        step, lambda p: loss_of(gnn.sage_forward_sampled(p, batch, cfg)),
        GNN_FULL_STEPS)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"(l3) losses {losses}")
    f1, f2 = REDDIT_FANOUT
    print(f"(l3) graphsage-reddit minibatch_lg: {REDDIT_NODES:,} nodes, "
          f"{indices.numel():,} CSR entries ({REDDIT_ROWS:,} undirected "
          f"rows), {REDDIT_FEAT} features, {REDDIT_CLASSES} classes; CSR "
          f"{(indptr.numel() + indices.numel()) * 4 / 1e6:.0f} MB and "
          f"features {feats.numel() * 4 / 1e6:.0f} MB on the card, made in "
          f"{made_s:.2f} s; {REDDIT_SEEDS} seeds, fanout {f1}-{f2}: every "
          f"unmasked neighbour of the first {REDDIT_CHECKED} seeds adjacent; "
          f"losses {losses}", flush=True)
    print(f"time (l3) graphsage-reddit minibatch_lg: sampling "
          f"{sample_ms:.3f} ms, forward {fwd_ms:.3f} ms (medians of "
          f"{REPEATS}), training step {statistics.median(ms):.3f} ms "
          f"(median of {GNN_FULL_STEPS}; min {min(ms):.3f}, max "
          f"{max(ms):.3f}), CUDA events, on {card}", flush=True)
    del indptr, indices, feats, labels, batch, params, step
    torch.cuda.empty_cache()


def xdeepfm_phase(dev, card):
    """(l4): xdeepfm at its published config (91,020,160 table rows)
    initialised on the card: serve_p99, serve_bulk (the CIN in chunks),
    retrieval_cand and :data:`XDFM_STEPS` in-place training steps at
    train_batch on ``ClickLogStream`` batches."""
    import math

    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import ClickLogStream
    from repro_torch.models import recsys
    from repro_torch.optim import adamw
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = configs.get_arch("xdeepfm").config
    params = recsys.init_xdeepfm_params(
        cfg, torch.Generator(device=dev).manual_seed(GNN_SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in adamw._leaves(params))
    print(f"(l4) xdeepfm: {cfg.n_fields} fields, {cfg.total_vocab:,} table "
          f"rows at embed_dim {cfg.embed_dim}, CIN {tuple(cfg.cin_layers)}, "
          f"MLP {tuple(cfg.mlp_dims)}, {cfg.n_items:,} items: {n_params:,} "
          f"float32 parameters "
          f"({torch.cuda.memory_allocated() - held:,} bytes), made in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    def ids_of(batch_size, seed):
        b = ClickLogStream(cfg.field_vocabs, batch_size,
                           seed=seed).next_batch()
        return (torch.from_numpy(b["ids"]).to(dev),
                torch.from_numpy(b["labels"]).to(dev))

    ids, _ = ids_of(XDFM_BULK, GNN_SEED)
    p99 = ids[:XDFM_P99]
    with torch.no_grad():
        bulk = recsys.xdeepfm_logits(params, ids, cfg)
        small = recsys.xdeepfm_logits(params, p99, cfg)
        scores = recsys.retrieval_scores(params, ids[:1], cfg)
        u = recsys._dnn(recsys._lookup(params, ids[:1], cfg), params, cfg) \
            @ params["user_proj"]
        scores64 = u.double() @ params["item_embed"].double().T
        times = {"serve_p99": cuda_ms(
                     lambda: recsys.xdeepfm_logits(params, p99, cfg)),
                 "serve_bulk": cuda_ms(
                     lambda: recsys.xdeepfm_logits(params, ids, cfg)),
                 "retrieval_cand": cuda_ms(
                     lambda: recsys.retrieval_scores(params, ids[:1], cfg))}
    same, same_err, same_tol = near(small.cpu().numpy(),
                                    bulk[:XDFM_P99].cpu().numpy(),
                                    XDFM_SAME_RTOL)
    s_ok, s_err, s_tol = near(scores.cpu().numpy(), scores64.cpu().numpy(),
                              XDFM_SCORES_RTOL)
    check(same and s_ok and tuple(scores.shape) == (1, cfg.n_items)
          and bool(torch.isfinite(bulk).all())
          and bool(torch.isfinite(scores).all()),
          f"(l4) serve_p99 vs serve_bulk err {same_err} (bound {same_tol}); "
          f"scores vs float64 err {s_err} (bound {s_tol})")
    serve_peak = torch.cuda.max_memory_allocated()
    del bulk, scores64
    ids, labels = ids_of(XDFM_TRAIN, GNN_SEED + 1)
    step = inplace_trainer(params, adamw.AdamWConfig(
        peak_lr=XDFM_LR, warmup_steps=1, total_steps=XDFM_STEPS))
    losses, metrics, ms = timed_steps(
        step, lambda p: recsys.bce_loss(recsys.xdeepfm_logits(p, ids, cfg),
                                        labels), XDFM_STEPS)
    norms = [float(m["grad_norm"]) for m in metrics]
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses + norms)
          and losses[1] < losses[0], f"(l4) losses {losses}, norms {norms}")
    chunk = recsys.cin_chunk_rows(cfg)
    print(f"(l4) serve_p99's {XDFM_P99} logits within {same_err:.3e} of the "
          f"same rows of serve_bulk's {XDFM_BULK:,} (bound {same_tol:.3e}); "
          f"retrieval scores (1, {cfg.n_items:,}) within {s_err:.3e} of a "
          f"float64 recount (bound {s_tol:.3e}); {XDFM_STEPS} train_batch "
          f"steps of {XDFM_TRAIN:,} rows on one batch: losses {losses}, grad "
          f"norms {norms}; the CIN in chunks of {chunk:,} rows", flush=True)
    print(f"time (l4) xdeepfm: serve_p99 {times['serve_p99']:.3f} ms, "
          f"serve_bulk {times['serve_bulk']:.3f} ms, retrieval_cand "
          f"{times['retrieval_cand']:.3f} ms (medians of {REPEATS}), "
          f"train_batch step (forward, backward, in-place AdamW) "
          f"{statistics.median(ms):.3f} ms (min {min(ms):.3f}, max "
          f"{max(ms):.3f} of {XDFM_STEPS}), CUDA events; peak memory "
          f"allocated {serve_peak / 2 ** 30:.3f} GiB serving and "
          f"{peak / 2 ** 30:.3f} GiB training ({held / 2 ** 30:.3f} GiB "
          f"held by earlier phases), on {card}", flush=True)
    del params, step, ids, labels
    torch.cuda.empty_cache()


def kernel_counters():
    """Every kernel wrapper's launch counters, by kernel line name:
    ``{name: (wrapper, counter attribute, ...)}``."""
    from repro_torch.kernels.crossing_angle_sum import crossing_angle_stats
    from repro_torch.kernels.occlusion_pairs import (occlusion_pairs,
                                                     occlusion_pairs_rows)
    from repro_torch.kernels.segment_crossing import (crossing_count,
                                                      crossing_count_rows)
    from repro_torch.kernels.strip_reversal import strip_reversal_rows
    return {"strip_reversal": (strip_reversal_rows, "LAUNCHES",
                               "LAUNCHES_BF16"),
            "occlusion_pairs": (occlusion_pairs, "LAUNCHES",
                                "LAUNCHES_BF16"),
            "occlusion_pairs_rows": (occlusion_pairs_rows, "LAUNCHES",
                                     "LAUNCHES_BF16"),
            "segment_crossing": (crossing_count, "LAUNCHES"),
            "segment_crossing_rows": (crossing_count_rows, "LAUNCHES"),
            "crossing_angle_sum": (crossing_angle_stats, "LAUNCHES")}


def no_kernel_phase(label, run):
    """``run()`` with float32 products and TF32 off, every kernel's launch
    count set to 0 before and required to be 0 after (no kernel of the
    port lies on these paths).  Returns those counts."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = kernel_counters()
    for fn, *names in counters.values():
        for name in names:
            setattr(fn, name, 0)
    run()
    launches = {k: sum(getattr(fn, name) for name in names)
                for k, (fn, *names) in counters.items()}
    check(not any(launches.values()), f"({label}) kernel launches "
                                      f"{launches}")
    print(f"({label}) kernel launches: {launches}", flush=True)
    return launches


def gnn_phase(dev, card):
    """(l): (l1)-(l4), float32 products with TF32 off, with every kernel's
    launch count set to 0 before and read after: no kernel of the port
    lies on these paths.  Returns those counts."""
    def run():
        t0 = time.perf_counter()
        check(GNN_REFERENCE is not None, "(l) GNN_REFERENCE is not set")
        gnn_smoke_phase(dev)
        gnn_cora_phase(dev, card)
        gnn_reddit_phase(dev, card)
        xdeepfm_phase(dev, card)
        print(f"time (l) the GNN and recsys phase: "
              f"{time.perf_counter() - t0:.2f} s (wall)", flush=True)
    return no_kernel_phase("l", run)


# ---------------------------------------------------------------------------
# phase (m): the equivariant family
# ---------------------------------------------------------------------------

# the node-indexed arrays of a molecule batch (the others are per edge,
# and targets per graph)
NODE_KEYS = ("positions", "species", "node_mask", "graph_id")


def molecule_batch(rng, *, n_graphs, nodes_per, edges_per, n_nodes, n_edges):
    """``graphs.format.batch_molecules`` of ``n_graphs`` graphs padded to
    ``n_nodes`` node and ``n_edges`` edge slots (numpy), with random
    ``targets`` (n_graphs,): padded nodes masked, padded edges masked and
    running from the first padded node to itself; the batch's own
    self-loops masked (``edge_mask = src != dst``)."""
    import numpy as np
    from repro_torch.graphs.format import batch_molecules
    b, _ = batch_molecules(rng, n_graphs=n_graphs, nodes_per=nodes_per,
                           edges_per=edges_per)
    n, e = b["positions"].shape[0], b["edge_src"].shape[0]
    check(n < n_nodes and e <= n_edges, f"{n} nodes, {e} edges")
    out = {}
    for k, v in b.items():
        out[k] = np.zeros((n_nodes if k in NODE_KEYS else n_edges,
                           *v.shape[1:]), v.dtype)
        out[k][:v.shape[0]] = v
    out["edge_src"][e:] = n
    out["edge_dst"][e:] = n
    out["targets"] = rng.normal(size=(n_graphs,)).astype(np.float32)
    return out


def eqv_smoke_batch():
    """(m1)'s inputs (numpy, from ``default_rng(GNN_SEED)``; ``tools/
    chip_smoke_reference.py --equivariant`` feeds the reference the
    same): 3 molecules of 10 nodes and 90 edges padded to 32 nodes and
    512 edges (4 chunks at the smoke configs' 128), node 1 without an
    incoming edge (its edges go to node 0)."""
    import numpy as np
    b = molecule_batch(np.random.default_rng(GNN_SEED), n_graphs=3,
                       nodes_per=10, edges_per=90, n_nodes=32, n_edges=512)
    b["edge_dst"][b["edge_dst"] == 1] = 0
    b["edge_mask"] &= b["edge_src"] != b["edge_dst"]
    return b


def eqv_model(case, batch):
    """``(cfg, forward(params), loss_of(energies))`` of ``case`` (an
    ``EQV_CASES`` name or an arch id) at its smoke config on ``batch``
    (a dict of tensors)."""
    import dataclasses as dc
    from repro_torch import configs
    from repro_torch.models import equivariant as eqv
    arch = case.removesuffix("-compact")
    cfg = configs.get_arch(arch).smoke_config
    if case.endswith("-compact"):
        cfg = dc.replace(cfg, compact_escn=True)
    return (cfg,) + eqv_forward(cfg, batch)


def eqv_forward(cfg, batch):
    """``(forward(params), loss_of(energies))`` of ``cfg`` on ``batch``."""
    from repro_torch.models import equivariant as eqv
    fwd = (eqv.nequip_forward if "nequip" in cfg.name
           else eqv.equiformer_forward)
    n_graphs = batch["targets"].shape[0]
    return (lambda p: fwd(p, batch, cfg, n_graphs=n_graphs),
            lambda out: eqv.energy_loss(out, batch["targets"]))


def forces_of(cfg, params, batch):
    """``-dE/dpos`` of the summed energies (autograd)."""
    import torch
    pos = batch["positions"].detach().clone().requires_grad_()
    forward, _ = eqv_forward(cfg, dict(batch, positions=pos))
    (grad,) = torch.autograd.grad(forward(params).sum(), pos)
    return -grad


def eqv_smoke_phase(dev):
    """(m1): the smoke configs against :data:`EQV_REFERENCE`."""
    import math

    import numpy as np
    import torch
    from repro_torch.models import equivariant as eqv
    from repro_torch.models.common import params_from_reference
    from repro_torch.optim import adamw
    check(EQV_REFERENCE is not None, "(m) EQV_REFERENCE is not set")
    host = eqv_smoke_batch()
    for case in EQV_CASES:
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        cfg, forward, loss_of = eqv_model(case, batch)
        params = params_from_reference(eqv.numpy_params(cfg, GNN_SEED),
                                       device=dev)
        with torch.no_grad():
            energies = forward(params).cpu().numpy()
        want = EQV_REFERENCE[case]
        ok, err, tol = near(energies, want["energies"], TRAIN_RTOL)
        note = ""
        if "forces" in want:
            forces = forces_of(cfg, params, batch).cpu().numpy()
            rows = want["forces_rows"]
            f_ok, f_err, f_tol = near(forces[rows].reshape(-1),
                                      want["forces"], TRAIN_RTOL)
            ok = ok and f_ok and bool(np.isfinite(forces).all())
            note = (f"; forces on {len(rows)} of {len(forces)} nodes within "
                    f"{f_err:.3e} (bound {f_tol:.3e}), all finite")
        step = inplace_trainer(params, adamw.AdamWConfig(**GNN_OPT))
        losses, metrics, _ = timed_steps(step, lambda p: loss_of(forward(p)),
                                         GNN_STEPS)
        scalars = {"loss": losses[0],
                   "grad_norm": float(metrics[0]["grad_norm"])}
        ok = ok and all(math.isclose(scalars[k], want[k],
                                     rel_tol=TRAIN_RTOL) for k in scalars)
        ok = ok and np.allclose(losses, want["losses"], rtol=TRAIN_RTOL,
                                atol=0)
        check(ok, f"(m1) {case}: energies err {err} (bound {tol}){note}, "
                  f"{scalars}, losses {losses}; reference {want}")
        print(f"(m1) {case} ({cfg.name}): energies {energies.shape} within "
              f"{err:.3e} of the reference (bound {tol:.3e}){note}; loss "
              f"{scalars['loss']!r}, grad norm {scalars['grad_norm']!r}, "
              f"{GNN_STEPS} steps' losses {losses} (rtol {TRAIN_RTOL})",
              flush=True)


def equivariant_flops(arch, cfg, n_edges, n_nodes):
    """The model FLOP of one training step by
    ``src/repro/launch/cells.py``'s ``_equivariant_flops``."""
    C = cfg.d_hidden
    if arch == "nequip":
        per_edge = sum(2 * (2 * l1 + 1) * (2 * l2 + 1) * (2 * l3 + 1) * C
                       for (l1, l2, l3) in cfg.paths) \
            + 2 * cfg.n_rbf * cfg.radial_hidden \
            + 2 * cfg.radial_hidden * len(cfg.paths) * C
        per_node = 2 * ((cfg.l_max + 1) ** 2) * C * C * 2
        return 3.0 * cfg.n_layers * (n_edges * per_edge + n_nodes * per_node)
    rot = 2 * sum((2 * l + 1) ** 2 for l in range(cfg.l_max + 1)) * C * 2
    so2 = 2 * ((cfg.l_max + 1) * C) ** 2 \
        + sum(4 * 2 * ((cfg.l_max + 1 - m) * C) ** 2
              for m in range(1, cfg.m_max + 1))
    per_node = 2 * ((cfg.l_max + 1) ** 2) * C * C * 6
    return 3.0 * cfg.n_layers * (n_edges * (rot + so2) + n_nodes * per_node)


def molecule_host():
    """(m2)/(m3)'s padded molecule batch (numpy) and the sub-batch of its
    first :data:`MOL_CHECKED` graphs (their nodes and edges come first)."""
    import numpy as np
    host = molecule_batch(np.random.default_rng(GNN_SEED),
                          n_graphs=MOL_GRAPHS, nodes_per=MOL_NODES_PER,
                          edges_per=MOL_EDGES_PER, n_nodes=MOL_NODE_SLOTS,
                          n_edges=MOL_EDGE_SLOTS)
    n, e = MOL_CHECKED * MOL_NODES_PER, MOL_CHECKED * MOL_EDGES_PER
    sub = {k: v[:n if k in NODE_KEYS else e] for k, v in host.items()}
    sub["targets"] = host["targets"][:MOL_CHECKED]
    return host, sub


def cpu_energies(cfg, params, sub, dtype):
    """The port's energies of ``sub`` on the CPU at ``dtype`` (the
    config's and the parameters')."""
    import dataclasses as dc

    import torch
    from repro_torch.optim import adamw
    cfg = dc.replace(cfg, dtype=dtype)
    p = adamw._map(lambda t: t.detach().to("cpu", dtype), params)
    b = {k: torch.from_numpy(v) for k, v in sub.items()}
    if dtype == torch.float64:
        b["positions"] = b["positions"].double()
    forward, _ = eqv_forward(cfg, b)
    with torch.no_grad():
        return forward(p).double().numpy()


def eqv_full_phase(dev, card, arch):
    """(m2) nequip or (m3) equiformer-v2 at its published config on the
    padded molecule batch: the card against the port on the CPU (float32,
    bound by float64) on the first graphs, invariance, (m3) compact against
    full, training steps, times, peak memory and model FLOP/s."""
    import dataclasses as dc

    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import equivariant as eqv
    from repro_torch.models import so3
    from repro_torch.optim import adamw
    label = "m2" if arch == "nequip" else "m3"
    t0 = time.perf_counter()
    cfg = configs.get_arch(arch).config
    host, sub = molecule_host()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    init = (eqv.init_nequip_params if arch == "nequip"
            else eqv.init_equiformer_params)
    params = init(cfg, torch.Generator(device=dev).manual_seed(GNN_SEED))
    n_params = sum(p.numel() for p in adamw._leaves(params))
    layouts = {"full": cfg}
    if arch == "equiformer-v2":
        layouts["compact"] = dc.replace(cfg, compact_escn=True)
    fwds = {k: eqv_forward(c, batch) for k, c in layouts.items()}
    forward, loss_of = fwds["full"]
    with torch.no_grad():
        energies = forward(params)
        e_card = energies[:MOL_CHECKED].double().cpu().numpy()
        rng = np.random.default_rng(GNN_SEED + 1)
        a, b, g = rng.uniform(-np.pi, np.pi, 3)
        R = torch.tensor(so3._rot_z(a) @ so3._rot_y(b) @ so3._rot_z(g),
                         dtype=torch.float32, device=dev)
        shift = torch.tensor(rng.normal(size=3) * 3, dtype=torch.float32,
                             device=dev)
        moved = dict(batch, positions=batch["positions"] @ R.T + shift)
        e_moved = eqv_forward(cfg, moved)[0](params)
        compact = (fwds["compact"][0](params) if "compact" in fwds
                   else None)
    e32 = cpu_energies(cfg, params, sub, torch.float32)
    e64 = cpu_energies(cfg, params, sub, torch.float64)
    dist = float(np.abs(e32 - e64).max())
    err = float(np.abs(e_card - e32).max())
    err64 = float(np.abs(e_card - e64).max())
    check(bool(torch.isfinite(energies).all())
          and tuple(energies.shape) == (MOL_GRAPHS,) and err <= 2 * dist,
          f"({label}) energies of the first {MOL_CHECKED} graphs: card vs "
          f"CPU float32 {err} (bound {2 * dist}), vs CPU float64 {err64}")
    inv = torch.allclose(energies, e_moved, rtol=EQV_INV_RTOL,
                         atol=EQV_INV_ATOL)
    inv_err = float((energies - e_moved).abs().max())
    check(inv, f"({label}) rotated and translated: max diff {inv_err}")
    note = ""
    if compact is not None:
        # within EQV_COMPACT_RTOL of the largest energy: a graph whose
        # energy is near 0 would hold an element-wise bar to the noise of
        # index_add's atomics (both layouts sum in no fixed order)
        c_ok, c_err, c_tol = near(compact.cpu().numpy(),
                                  energies.cpu().numpy(), EQV_COMPACT_RTOL)
        c_rel = float(((compact - energies).abs()
                       / energies.abs().clamp_min(1e-30)).max())
        check(c_ok, f"(m3) compact vs full: err {c_err} (bound {c_tol})")
        note = (f"; compact eSCN equals full within {c_err:.3e} (bound "
                f"{c_tol:.3e}: rtol {EQV_COMPACT_RTOL} of the largest; "
                f"element-wise {c_rel:.3e} relative, smallest |energy| "
                f"{float(energies.abs().min()):.3e})")
    print(f"({label}) {arch} at its published config ({cfg.n_layers} "
          f"layers, {cfg.d_hidden} channels, l_max {cfg.l_max}; {n_params:,} "
          f"parameters) on molecule: {MOL_GRAPHS} graphs x {MOL_NODES_PER} "
          f"nodes, {MOL_EDGES_PER} edges, padded to {MOL_NODE_SLOTS} / "
          f"{MOL_EDGE_SLOTS} slots; energies of the first {MOL_CHECKED} "
          f"graphs within {err:.3e} of the port on the CPU in float32 "
          f"(bound {2 * dist:.3e}: twice that route's distance {dist:.3e} "
          f"from the port in float64; the card's {err64:.3e}); rotated and "
          f"translated within {inv_err:.3e} (rtol {EQV_INV_RTOL}, atol "
          f"{EQV_INV_ATOL}){note}", flush=True)

    times = {}
    with torch.no_grad():
        for k, (fwd_k, _) in fwds.items():
            times[f"forward {k}"] = cuda_ms(lambda f=fwd_k: f(params))
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step = inplace_trainer(params, adamw.AdamWConfig())
    losses, metrics, ms = timed_steps(step, lambda p: loss_of(forward(p)),
                                      EQV_STEPS)
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)) and losses[1] < losses[0],
          f"({label}) losses {losses}")
    times["step full"] = statistics.median(ms[1:])
    spread = f"min {min(ms[1:]):.3f}, max {max(ms[1:]):.3f}"
    if "compact" in fwds:
        _, _, c_ms = timed_steps(
            step, lambda p: fwds["compact"][1](fwds["compact"][0](p)),
            EQV_STEPS)
        times["step compact"] = statistics.median(c_ms[1:])
    flops = equivariant_flops(arch, cfg, MOL_EDGE_SLOTS, MOL_NODE_SLOTS)
    rate = flops / (times["step full"] * 1e-3)
    print(f"({label}) {EQV_STEPS} AdamWConfig() steps on one batch: losses "
          f"{losses}, grad norms "
          f"{[float(m['grad_norm']) for m in metrics]}; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    print(f"time ({label}) {arch} molecule: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
          + f" (forwards median of {REPEATS}, steps median of "
          f"{EQV_STEPS - 1} after the first; full step {spread}), CUDA "
          f"events; peak memory allocated {peak / 2 ** 30:.3f} GiB "
          f"({held / 2 ** 30:.3f} GiB held before the steps); model "
          f"FLOP per step {flops:.4g} (cells.py's formula): "
          f"{rate / 1e12:.3f} TFLOP/s, {rate / F32_PEAK_FLOPS:.4f} of the "
          f"H100 SXM's float32 non-tensor peak ({F32_PEAK_FLOPS / 1e12:.0f} "
          f"TFLOP/s), on {card}", flush=True)
    del params, step, batch, fwds, moved
    torch.cuda.empty_cache()


def equivariant_phase(dev, card):
    """(m): (m1)-(m3), float32 products with TF32 off, with every
    kernel's launch count set to 0 before and read after.  Returns those
    counts."""
    def run():
        t0 = time.perf_counter()
        eqv_smoke_phase(dev)
        eqv_full_phase(dev, card, "nequip")
        eqv_full_phase(dev, card, "equiformer-v2")
        print(f"time (m) the equivariant phase: "
              f"{time.perf_counter() - t0:.2f} s (wall)", flush=True)
    return no_kernel_phase("m", run)


# ---------------------------------------------------------------------------
# phase (n): the dry run and the roofline
# ---------------------------------------------------------------------------

# (n2): the cells that fit one card, run for real on a one-rank mesh (a
# third entry is the readability cell's predicate)
N2_CELLS = (("xdeepfm", "serve_p99"), ("xdeepfm", "serve_bulk"),
            ("xdeepfm", "retrieval_cand"), ("xdeepfm", "train_batch"),
            ("nequip", "molecule"), ("equiformer-v2", "molecule"),
            ("gcn-cora", "full_graph_sm"),
            ("graphsage-reddit", "minibatch_lg"),
            ("readability", "exact_occlusion"),
            ("readability", "exact_crossing", "sign"),
            ("readability", "exact_crossing", "bool"),
            ("readability", "enhanced_crossing"))
N2_DATASET = "ego-Facebook"
N2_SEED = 23
N2_RUNS = 5
# (n1) on the 2x16x16 mesh: one cell of each family
N1_MULTI_POD = ("qwen3-4b:train_4k,qwen2-moe-a2.7b:decode_32k,"
                "gcn-cora:full_graph_sm,nequip:molecule,xdeepfm:train_batch,"
                "readability:exact_crossing")
# dry-run child processes (the card's machine has 8 cores): the 16x16
# run's, the 2x16x16 run's beside it, and the one-rank traces' one
DRYRUN_JOBS = 6
MULTI_POD_JOBS = 2
DRYRUN_TIMEOUT = 420


def n2_cell(entry, mesh):
    from repro_torch.launch.cells import make_cell
    arch, shape, *pred = entry
    patch = None
    if arch == "readability":
        patch = {"dataset": N2_DATASET, "predicate": (pred or ["sign"])[0]}
    return make_cell(arch, shape, mesh, config_patch=patch)


def n2_label(entry):
    return ":".join(entry)


def one_rank_traces(out):
    """(n2)'s cells traced on a (1, 1) mesh over a fake group of one rank
    (``chip_smoke.py --trace-one-rank OUT``, a process of its own):
    argument and peak bytes and the roofline terms of each, to ``OUT``."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.cells import trace_cell
    from repro_torch.launch.mesh import make_host_mesh, start_fake_group
    from repro_torch.roofline.analysis import terms_of
    start_fake_group(1)
    mesh = make_host_mesh((1, 1))
    res = {}
    for entry in N2_CELLS:
        cell = n2_cell(entry, mesh)
        cost = trace_cell(cell, mesh)
        t = terms_of(cost, cell.meta, arch=entry[0], shape=entry[1],
                     mesh_name="1x1", chips=1)
        res[n2_label(entry)] = dict(
            argument_bytes=cost["argument_bytes"],
            peak_bytes=cost["peak_bytes"], flops=cost["flops"],
            bytes=cost["bytes accessed"], compute_s=t.compute_s,
            memory_s=t.memory_s, dominant=t.dominant,
            trace_s=cost["trace_s"], trips=cost["trips"])
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def start_child(args, log, jobs=None):
    """``python ARGS OUT`` in a child process on this machine's cores
    (``python -m repro_torch.launch.dryrun --jobs JOBS ARGS --out OUT``
    when ``jobs`` is given), its output to ``log``; returns ``(process,
    OUT, start time)``."""
    import os
    out = Path(tempfile.mkdtemp(prefix="dryrun_")) / "records.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, *args, str(out)]
    if jobs is not None:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--jobs",
               str(jobs), *args, "--out", str(out)]
    f = open(log, "w")
    # a session of its own: stopping it stops the dry run's own children
    proc = subprocess.Popen(cmd, env=env, stdout=f, stderr=subprocess.STDOUT,
                            start_new_session=True)
    proc.log_file = f
    return proc, out, time.perf_counter()


def stop_child(proc):
    """Kill a :func:`start_child` process and every process it started."""
    import os
    import signal
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def finish_child(child):
    """Wait for a :func:`start_child` process (within
    ``DRYRUN_TIMEOUT`` of its start); its exit code, parsed output and
    seconds."""
    proc, out, t0 = child
    try:
        proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT
                              - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        stop_child(proc)
    proc.log_file.close()
    seconds = time.perf_counter() - t0
    return (proc.returncode, json.loads(out.read_text())
            if out.is_file() else [], seconds)


def dryrun_full_phase(card, tmp, children):
    """(n1): every cell of ``all_cells()`` and the three readability
    shapes traced over 256 fake ranks (16 x 16), and one cell of each
    family over 512 (2 x 16 x 16), by the children ``children`` started;
    a line per cell."""
    rc, records, seconds = finish_child(children["pod"])
    traced = [r for r in records if r["status"] != "skipped"]
    for r in traced:
        if r["status"] != "ok":
            print(f"(n1) {r['arch']} x {r['shape']}: {r['status']} "
                  f"{r.get('error', '')[:300]}", flush=True)
            continue
        print(f"(n1) {r['mesh']} {r['arch']} x {r['shape']}: flops "
              f"{r['flops']:.4e}, peak {r['peak_bytes'] / 2 ** 30:.3f} GiB "
              f"per device, fits 80 GB {r['fits_80gb']}, dominant "
              f"{r['dominant']} (compute {r['compute_s']:.4e} s, memory "
              f"{r['memory_s']:.4e} s, collective {r['collective_s']:.4e} "
              f"s), trace {r['trace_s']:.2f} s, replicated "
              f"{r['replicated_ops']}", flush=True)
    skipped = [r for r in records if r["status"] == "skipped"]
    for r in skipped:
        print(f"(n1) skipped {r['arch']} x {r['shape']}: {r['reason']}")
    ok = [r for r in traced if r["status"] == "ok"]
    print(f"time (n1) dry run on 16x16: {seconds:.2f} s (wall, "
          f"{DRYRUN_JOBS} processes), {len(ok)} ok of {len(traced)}, "
          f"{len(skipped)} skipped, rc {rc}", flush=True)
    if rc != 0 or len(ok) != 39 or len(skipped) != 4:
        print((tmp / "pod.log").read_text()[-6000:], flush=True)
    check(rc == 0 and len(ok) == len(traced) == 39 and len(skipped) == 4,
          f"(n1) the 16x16 dry run: rc {rc}, {len(ok)} ok of "
          f"{len(traced)} traced, {len(skipped)} skipped")
    rc2, multi, seconds2 = finish_child(children["multi"])
    multi = [r for r in multi if r["status"] != "skipped"]
    for r in multi:
        print(f"(n1) {r['mesh']} {r['arch']} x {r['shape']}: "
              f"{r['status']} flops {r.get('flops', 0):.4e}, peak "
              f"{r.get('peak_bytes', 0) / 2 ** 30:.3f} GiB, fits "
              f"{r.get('fits_80gb')}, dominant {r.get('dominant')}",
              flush=True)
    n_multi = len(N1_MULTI_POD.split(","))
    if rc2 != 0:
        print((tmp / "multi.log").read_text()[-6000:], flush=True)
    check(rc2 == 0 and len(multi) == n_multi
          and all(r["status"] == "ok" for r in multi),
          f"(n1) the 2x16x16 dry run: rc {rc2}, {len(multi)} records")
    print(f"time (n1) dry run on 2x16x16: {seconds2:.2f} s (wall, "
          f"{MULTI_POD_JOBS} processes, beside the 16x16 run) on {card}",
          flush=True)


def tensor_bytes(tree):
    """Bytes of the distinct storages under a nest of tensors."""
    import torch
    seen, total = set(), 0

    def walk(t):
        nonlocal total
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                total += st.nbytes()
    walk(tree)
    return total


def n2_readability_counts(entry, cell, args, mesh):
    """The readability cell's count against the hand-written kernels on
    the same inputs: kernel 2 on the whole row range, kernel 3 on it, or
    kernel 1 on the buckets (the deviation sum too, ``with_angle``)."""
    import torch
    from repro_torch.distributed.gridded import lower_sharded_reversal
    from repro_torch.kernels.occlusion_pairs import occlusion_pairs_rows
    from repro_torch.kernels.segment_crossing import crossing_count_rows
    from repro_torch.kernels.strip_reversal import strip_reversal_rows
    shape = entry[1]
    if shape == "exact_occlusion":
        x, y, ok = args[3:]
        got = int(cell.fn(*args))
        want = int(occlusion_pairs_rows(x, y, ok, 0.5, 0, x.shape[0]))
        check(got == want, f"(n2) {n2_label(entry)}: {got} pairs, kernel "
                           f"{want}")
        return f"{got} occluded pairs = occlusion_pairs_rows"
    if shape == "exact_crossing":
        sh, rep = args
        got = int(cell.fn(sh, rep))
        want = int(crossing_count_rows(*rep, 0, rep[0].shape[0]))
        check(got == want, f"(n2) {n2_label(entry)}: {got} crossings, "
                           f"kernel {want}")
        return f"{got} crossings = crossing_count_rows"
    n_strips, cap = args[0].shape
    fn, _ = lower_sharded_reversal(mesh, n_strips, cap, with_angle=True)
    cnt, dev_sum = fn(*args)
    kc, kd = strip_reversal_rows(*args, ideal=1.0, with_angle=True)
    got, want = int(cnt), int(kc.sum())
    d_got = float(dev_sum)
    d_want = float(kd.to(torch.float64).sum())
    check(got == int(cell.fn(*args)[0]) == want,
          f"(n2) {n2_label(entry)}: {got} reversals, kernel {want}")
    check(abs(d_got - d_want) <= 1e-5 * abs(d_want),
          f"(n2) {n2_label(entry)}: deviation {d_got}, kernel {d_want}")
    return (f"{got} reversals = strip_reversal_rows, deviation sum "
            f"{d_got:.6f} vs {d_want:.6f}")


def dryrun_real_phase(dev, card, tmp, child):
    """(n2): the cells that fit one card, each run once to warm up and
    ``N2_RUNS`` times (CUDA events, median) on a one-rank mesh; their
    argument bytes held to the one-rank traces' (the child ``child``
    started; to the byte), the median to at least ``compute_s``; the
    readability counts held to the kernels'."""
    import torch
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.launch.cells import readability_args, real_args
    rc, traces, seconds = finish_child(child)
    if rc != 0:
        print((tmp / "one_rank.log").read_text()[-6000:], flush=True)
    check(rc == 0 and bool(traces), f"(n2) the one-rank traces: rc {rc}")
    print(f"time (n2) one-rank traces: {seconds:.2f} s (wall, beside "
          f"(n1))", flush=True)
    mesh = make_mesh((1, 1), ("data", "model"), device=dev)
    pending = []

    def run():
        for entry in N2_CELLS:
            label = n2_label(entry)
            cell = n2_cell(entry, mesh)
            gen = torch.Generator().manual_seed(N2_SEED)
            args = (readability_args(cell, mesh, dev, gen)
                    if entry[0] == "readability"
                    else real_args(cell, dev, gen))
            tr = traces[label]
            got_bytes = tensor_bytes(args)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cell.fn(*args)
            torch.cuda.synchronize()
            ms = []
            for _ in range(N2_RUNS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                cell.fn(*args)
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
            med = statistics.median(ms)
            peak = torch.cuda.max_memory_allocated()
            bound = max(tr["compute_s"], tr["memory_s"]) * 1e3
            print(f"(n2) {label}: median {med:.3f} ms of {N2_RUNS} (CUDA "
                  f"events; min {min(ms):.3f}, max {max(ms):.3f}), "
                  f"compute_s {tr['compute_s'] * 1e3:.4f} ms, memory_s "
                  f"{tr['memory_s'] * 1e3:.4f} ms, measured / max "
                  f"{med / bound:.2f}; argument bytes {got_bytes} "
                  f"(traced {tr['argument_bytes']}; remat trips run "
                  f"{tr['trips']['run']}, replayed "
                  f"{tr['trips']['replayed']}); peak allocated "
                  f"{peak / 2 ** 30:.3f} GiB, traced peak "
                  f"{tr['peak_bytes'] / 2 ** 30:.3f} GiB on {card}",
                  flush=True)
            check(got_bytes == tr["argument_bytes"],
                  f"(n2) {label}: argument bytes {got_bytes}, traced "
                  f"{tr['argument_bytes']}")
            check(med >= tr["compute_s"] * 1e3,
                  f"(n2) {label}: {med:.4f} ms beats compute_s "
                  f"{tr['compute_s'] * 1e3:.4f} ms: a flop count is wrong")
            if entry[0] == "readability":
                pending.append((entry, cell, args))
            else:
                del args
            torch.cuda.empty_cache()
    launches = no_kernel_phase("n", run)
    for entry, cell, args in pending:
        print(f"(n2) {n2_label(entry)}: "
              f"{n2_readability_counts(entry, cell, args, mesh)}",
              flush=True)
    return launches


def dryrun_phase(dev, card):
    """(n): (n1) the dry run over fake ranks at full size, (n2) the cells
    that fit one card, run for real and held to their roofline.  Returns
    (n2)'s kernel launch counts (0: the comparisons run after)."""
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="n_"))
    # the three traces share the machine's cores, all at once
    children = {
        "pod": start_child([], tmp / "pod.log", jobs=DRYRUN_JOBS),
        "multi": start_child(["--multi-pod", "--cell", N1_MULTI_POD],
                             tmp / "multi.log", jobs=MULTI_POD_JOBS),
        "one_rank": start_child([str(ROOT / "chip_smoke.py"),
                                 "--trace-one-rank"], tmp / "one_rank.log")}
    try:
        dryrun_full_phase(card, tmp, children)
        launches = dryrun_real_phase(dev, card, tmp, children["one_rank"])
    finally:
        # a failed check leaves no child running
        for proc, _, _ in children.values():
            stop_child(proc)
    print(f"time (n) the dry-run phase: {time.perf_counter() - t0:.2f} s "
          f"(wall)", flush=True)
    return launches


def main() -> int:
    import torch
    if sys.argv[1:2] == ["--rank"]:
        # a rank of phase (h)'s gloo group, started by spawn_ranks
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        return distributed_rank(int(args["--rank"]), int(args["--world"]),
                                int(args["--port"]))
    if sys.argv[1:2] == ["--trace-one-rank"]:
        # (n2)'s one-rank traces, in a process of their own
        return one_rank_traces(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run it from "
              "the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))

    import warnings
    from collections import Counter

    import numpy as np

    from repro_torch.api import EvalConfig, Evaluator, evaluate_exact
    from repro_torch.core import (count_crossings_enhanced,
                                  count_occlusions_enhanced,
                                  crossing_angle_enhanced, engine)
    from repro_torch.kernels import _build
    from repro_torch.kernels import crossing_angle_sum as crossing_angle_mod
    from repro_torch.kernels import occlusion_pairs as occlusion_pairs_mod
    from repro_torch.kernels import segment_crossing as segment_crossing_mod
    from repro_torch.kernels import strip_reversal as strip_reversal_mod
    from repro_torch.kernels.crossing_angle_sum import (
        crossing_angle_plain, crossing_angle_stats)
    from repro_torch.kernels.fixtures import FIXTURES, TILE_LAYOUTS
    from repro_torch.kernels.occlusion_pairs import (
        occlusion_pairs, occlusion_pairs_plain)
    from repro_torch.kernels.segment_crossing import (crossing_count,
                                                      crossing_count_plain)
    from repro_torch.kernels.strip_reversal import (
        strip_reversal_rows, strip_reversal_rows_plain)
    from repro_torch.launch.serve import ReadabilityServer
    from repro_torch.search import GradientSearch

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    report = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          f"{', '.join(report)}", flush=True)
    ptxas = {name: resource_usage(name, log)
             for name, (seconds, log) in report.items()}
    for name, usage in ptxas.items():
        print(f"  ptxas {name}: {usage}")

    # -- inputs and the main path's kernel shapes --------------------------
    pos, edges, batch = inputs()
    n_v, n_e = pos.shape[0], edges.shape[0]
    cfg = EvalConfig(radius=RADIUS, n_strips=N_STRIPS)
    kcfg = dataclasses.replace(cfg, backend="kernels")
    print(f"graph: |V| = {n_v}, |E| = {n_e}, batch {BATCH}", flush=True)
    flat = engine.plan_readability(pos, edges,
                                   **cfg.plan_kwargs(tier_default=False))
    tiered = engine.plan_readability(batch, edges, **cfg.plan_kwargs())
    pos_p, edges_p = session_padding(pos, edges)
    batch_p, _ = padded_batch(batch, edges)
    ideal = flat.ideal
    # phase (e4)'s graph, served on a flat plan from member 0 as the
    # session plans it, in chunks of B = 8, 4, 2 and 1
    dpos, dedges, dbatch = drill_inputs()
    dcfg = EvalConfig(radius=RADIUS, n_strips=DRILL_N_STRIPS)
    dplan = engine.plan_readability(dpos, dedges,
                                    **dcfg.plan_kwargs(tier_default=False))
    dbatch_p, dedges_p = padded_batch(dbatch, dedges)
    print(f"drill graph: |V| = {dpos.shape[0]}, |E| = {dedges.shape[0]}, "
          f"n_strips {DRILL_N_STRIPS}", flush=True)
    slabs = {
        "a": reversal_slabs(flat, pos_p[None], edges_p, n_e, dev),
        "b": reversal_slabs(tiered, batch, edges, n_e, dev),
        "c": reversal_slabs(flat, pos_p[None], edges_p, n_e, dev,
                            flat_buckets=True),
        "e1": reversal_slabs(flat, batch_p, edges_p, n_e, dev),
        "e2": [item for i in range(BATCH) for item in reversal_slabs(
            flat, batch_p[i:i + 1], edges_p, n_e, dev, flat_buckets=True)],
        "e4": [item for width in (8, 4, 2, 1) for item in reversal_slabs(
            dplan, dbatch_p[:width], dedges_p, dedges.shape[0], dev)],
    }
    # (f): every slab the drag hands the kernel, from a rehearsal of the
    # drag on the plain version (the from-scratch evaluations left out:
    # their slabs are (a)'s)
    t0 = time.perf_counter()
    with rehearsing(strip_reversal_mod) as rehearsal:
        drag_path(cfg, pos, edges, scratch=False)
    slabs["f"] = rehearsal.slabs
    f_shapes = Counter(tuple(args[0].shape) for _, args in slabs["f"])
    print(f"shape (f) strip_reversal: {dict(f_shapes)} (slabs per shape "
          f"in one drag; rehearsal {time.perf_counter() - t0:.2f} s)",
          flush=True)
    occ_x, occ_y, occ_ok = occlusion_args(pos_p, n_v, dev)
    n_pad = occ_x.shape[0]
    for path, items in slabs.items():
        if path == "f":
            continue
        for label, args in items:
            per_row = args[5].sum(dim=1, dtype=torch.float64)
            print(f"shape ({path}) strip_reversal {label}: "
                  f"{tuple(args[0].shape)}, valid slots per row: mean "
                  f"{float(per_row.mean()):.1f}, max {int(per_row.max())}",
                  flush=True)
    print(f"shape (c), (e2) occlusion_pairs: ({n_pad},)", flush=True)

    # the exact path's inputs and kernel shapes
    epos, eedges = exact_inputs()
    xcfg = EvalConfig(radius=EXACT_RADIUS)
    print(f"exact graph: {EXACT_DATASET}, |V| = {epos.shape[0]}, "
          f"|E| = {eedges.shape[0]}", flush=True)
    xargs = edge_arrays(epos, eedges, None, dev)
    e_pad = xargs[0].shape[0]
    xocc_x, xocc_y, xocc_ok = occlusion_args(epos, epos.shape[0], dev)
    x_pad = xocc_x.shape[0]
    print(f"shape (d2) segment_crossing: ({e_pad},); (d), (e3) "
          f"crossing_angle_sum: ({e_pad},); occlusion_pairs: ({x_pad},)",
          flush=True)

    # -- 2. kernel vs plain ------------------------------------------------
    # each kernel's checked shapes, with the arguments first checked there
    # (phase 4 times each launched shape on them)
    rev_checked, occ_checked = {}, {}
    rev_err = 0.0
    for path, items in slabs.items():
        for label, args in items:
            rev_err = max(rev_err, compare_reversal(f"({path}) {label}",
                                                    args, ideal))
            rev_checked.setdefault(tuple(args[0].shape),
                                   (f"({path}) {label}", args))
    # (f)'s dirty-strip slabs again, their invalid slots full of garbage
    # and one row emptied
    for label, args in slabs["f"]:
        if args[0].shape[0] < N_STRIPS:
            rev_err = max(rev_err, compare_reversal(
                f"{label} garbage", garbage_slab(args), ideal))
    rev_err = max(rev_err, compare_reversal("adversarial",
                                            adversarial_slab(dev), ideal))
    for label, args in masked_slabs(dev).items():
        rev_err = max(rev_err, compare_reversal(label, args, ideal))
    got = occlusion_pairs(occ_x, occ_y, occ_ok, RADIUS)
    torch.cuda.synchronize()
    want = occlusion_pairs_plain(occ_x, occ_y, occ_ok, RADIUS)
    check(int(got) == int(want),
          f"occlusion_pairs {int(got)} != plain {int(want)} at n={n_pad}")
    occ_checked[(n_pad,)] = ("(c)", (occ_x, occ_y, occ_ok), RADIUS,
                             int(want))
    # (e2) launches the same shape on the jittered members
    e2_occ = occlusion_args(batch_p[BATCH - 1], n_v, dev)
    got_e2 = int(occlusion_pairs(*e2_occ, RADIUS))
    torch.cuda.synchronize()
    want_e2 = int(occlusion_pairs_plain(*e2_occ, RADIUS))
    check(got_e2 == want_e2, f"occlusion_pairs {got_e2} != plain {want_e2} "
                             f"on (e2) member {BATCH - 1}")
    fx = boundary_fixture(dev)
    got_b = int(occlusion_pairs(*fx, RADIUS))
    torch.cuda.synchronize()
    want_b = int(occlusion_pairs_plain(*fx, RADIUS))
    check(got_b == want_b == 2,
          f"occlusion_pairs boundary fixture gave {got_b}, plain {want_b}, "
          "want 2")
    got_x = int(occlusion_pairs(xocc_x, xocc_y, xocc_ok, EXACT_RADIUS))
    torch.cuda.synchronize()
    want_x = int(occlusion_pairs_plain(xocc_x, xocc_y, xocc_ok,
                                       EXACT_RADIUS))
    check(got_x == want_x,
          f"occlusion_pairs {got_x} != plain {want_x} at n={x_pad}")
    occ_checked[(x_pad,)] = ("(d)", (xocc_x, xocc_y, xocc_ok), EXACT_RADIUS,
                             want_x)
    occ_err = float(max(abs(int(got) - int(want)), abs(got_e2 - want_e2),
                        abs(got_b - want_b), abs(got_x - want_x)))
    for label, case in occlusion_tile_cases(dev).items():
        got_t = int(occlusion_pairs(*case, RADIUS))
        torch.cuda.synchronize()
        want_t = int(occlusion_pairs_plain(*case, RADIUS))
        check(got_t == want_t and want_t > 0,
              f"occlusion_pairs {got_t} != plain {want_t} on {label}")
    cross_err, angle_err = 0.0, 0.0
    for name, make in {**FIXTURES, **TILE_LAYOUTS}.items():
        c_err, d_err, _ = compare_crossing(name, edge_arrays(*make(), dev),
                                           xcfg.ideal_angle)
        cross_err, angle_err = max(cross_err, c_err), max(angle_err, d_err)
    c_err, d_err, crossings = compare_crossing(f"(d) ({e_pad},)", xargs,
                                               xcfg.ideal_angle)
    cross_err, angle_err = max(cross_err, c_err), max(angle_err, d_err)
    cross_checked = {(e_pad,): ("(d)", xargs)}
    print(f"kernel vs plain: ok (strip_reversal max abs dev err {rev_err}, "
          f"occlusion_pairs {int(got)}, {got_e2} and {got_x} pairs, max abs "
          f"err {occ_err}; segment_crossing {crossings} crossings, max abs "
          f"err {cross_err}; crossing_angle_sum max abs dev err "
          f"{angle_err})", flush=True)

    # -- 3. main path ------------------------------------------------------
    ev = Evaluator(cfg)
    kev = Evaluator(kcfg)
    # record the shapes the main path launches each kernel on, to hold
    # them against the shapes checked and timed here
    kernel_mods = (strip_reversal_mod, occlusion_pairs_mod,
                   segment_crossing_mod, crossing_angle_mod)
    counters = (strip_reversal_rows, occlusion_pairs, crossing_count,
                crossing_angle_stats)
    names = ("strip_reversal", "occlusion_pairs", "segment_crossing",
             "crossing_angle_sum")
    for fn in counters:
        fn.LAUNCHES = 0
    runs = {}
    launches = {}
    seen_shapes = {}
    with recording_launches(*kernel_mods) as rec:
        for path, call in (("a", lambda: ev.evaluate(pos, edges)),
                           ("b", lambda: ev.evaluate_batch(batch, edges)),
                           ("c", lambda: kev.evaluate(pos, edges))):
            before = (strip_reversal_rows.LAUNCHES, occlusion_pairs.LAUNCHES)
            rec.step()
            runs[path] = call()
            launches[path] = (strip_reversal_rows.LAUNCHES - before[0],
                              occlusion_pairs.LAUNCHES - before[1])
            seen_shapes[path] = sorted(rec.seen[-1])
    total_launches = Counter({"strip_reversal": strip_reversal_rows.LAUNCHES,
                              "occlusion_pairs": occlusion_pairs.LAUNCHES})
    print(f"launches per path (strip_reversal, occlusion_pairs): "
          f"{launches}", flush=True)
    for path in ("a", "b", "c"):
        planned = sorted([("strip_reversal", tuple(args[0].shape))
                          for _, args in slabs[path]]
                         + [("occlusion_pairs", (n_pad,))] * (path == "c"))
        check(seen_shapes[path] == planned,
              f"({path}) launched the kernels on {seen_shapes[path]}, the "
              f"shapes checked and timed here are {planned}")
    check(total_launches["strip_reversal"] > 0
          and total_launches["occlusion_pairs"] > 0,
          f"main path launched {dict(total_launches)}")
    check(launches["a"] == (len(slabs["a"]), 0)
          and launches["b"] == (len(slabs["b"]), 0)
          and launches["c"] == (len(slabs["c"]), 1),
          f"launches {launches} do not match the planned slabs")
    a, b, c = runs["a"], runs["b"].unbatch(), runs["c"]
    for f in INT_FIELDS:
        check(getattr(a, f) == getattr(b[0], f) == getattr(c, f),
              f"{f}: (a) {getattr(a, f)} (b)[0] {getattr(b[0], f)} "
              f"(c) {getattr(c, f)}")
    check(a.overflow == 0 and c.overflow == 0
          and all(r.overflow == 0 for r in b), "overflow")
    check_scores("(a) fused", a, REFERENCE["fused"])
    check_scores("(c) kernels", c, REFERENCE["kernels"])
    for i, r in enumerate(b):
        check_scores(f"(b)[{i}] batch", r, REFERENCE["batch"][i])
    for k in ("a", "c"):
        print(f"({k}) {runs[k]}")
    print(f"(b)[0] {b[0]}")
    print("main path: ok, equal to the JAX reference constants "
          f"(ints exact, floats rtol {RTOL})", flush=True)

    # (d) and (e): each run with the counts set to 0 just before it and
    # read just after
    sub_launches = {}

    def run_counted(key, rec, call):
        for fn in counters:
            fn.LAUNCHES = 0
        rec.step()
        out = call()
        sub_launches[key] = tuple(fn.LAUNCHES for fn in counters)
        seen_shapes[key] = sorted(rec.seen[-1])
        total_launches.update(dict(zip(names, sub_launches[key])))
        return out

    # with both crossing metrics asked, the crossing-angle sweep's count
    # is E_c: the all-metrics call launches no segment_crossing, (d2)'s
    # E_c-only call launches it alone
    exact_planned = sorted([("crossing_angle_sum", (e_pad,)),
                            ("occlusion_pairs", (x_pad,))])
    xruns = {}
    with recording_launches(*kernel_mods) as rec:
        for uk in (False, True):
            xruns[uk] = run_counted(f"d{int(uk)}", rec, lambda: evaluate_exact(
                epos, eedges, config=xcfg, use_kernels=uk))
            check(seen_shapes[f"d{int(uk)}"] == exact_planned,
                  f"(d) use_kernels={uk} launched the kernels on "
                  f"{seen_shapes[f'd{int(uk)}']}, the shapes checked and "
                  f"timed here are {exact_planned}")
        ec_only = run_counted("d2", rec, lambda: evaluate_exact(
            epos, eedges, config=dataclasses.replace(
                xcfg, metrics=("edge_crossing",))))
    print("launches in (d) (strip_reversal, occlusion_pairs, "
          f"segment_crossing, crossing_angle_sum): "
          f"{[sub_launches[k] for k in ('d0', 'd1', 'd2')]}", flush=True)
    for uk in (False, True):
        got_launches = sub_launches[f"d{int(uk)}"]
        check(got_launches == (0, 1, 0, 1),
              f"(d) use_kernels={uk} launched {got_launches}, want one "
              "occlusion_pairs and one crossing_angle_sum launch")
        check(xruns[uk].overflow == 0, "(d) overflow")
        check_scores(f"(d) exact use_kernels={uk}", xruns[uk],
                     EXACT_REFERENCE)
        print(f"(d) use_kernels={uk} {xruns[uk]}")
    check(sub_launches["d2"] == (0, 0, 1, 0)
          and seen_shapes["d2"] == [("segment_crossing", (e_pad,))],
          f"(d2) E_c alone launched {sub_launches['d2']} on "
          f"{seen_shapes['d2']}")
    check(ec_only.edge_crossing == EXACT_REFERENCE["edge_crossing"]
          and ec_only.edge_crossing_angle is None,
          f"(d2) E_c alone {ec_only}")
    print(f"(d2) E_c alone {ec_only.edge_crossing}")
    print("exact path: ok, equal to the JAX reference constants "
          f"(ints exact, floats rtol {RTOL})", flush=True)

    # (e) the serving front and the standalone enhanced algorithms
    reqs = [(p, edges) for p in batch]
    dreqs = [(p, dedges) for p in dbatch]
    server = ReadabilityServer(cfg)
    kserver = ReadabilityServer(kcfg)
    with warnings.catch_warnings(record=True) as shim_warnings:
        warnings.simplefilter("always")
        xserver = ReadabilityServer(method="exact")
    check(any(issubclass(w.category, DeprecationWarning)
              for w in shim_warnings),
          "(e3) ReadabilityServer(method='exact') did not warn")

    def enhanced():
        return (count_crossings_enhanced(pos, edges, n_strips=N_STRIPS),
                crossing_angle_enhanced(pos, edges, n_strips=N_STRIPS),
                count_occlusions_enhanced(pos, RADIUS))

    with recording_launches(*kernel_mods) as rec:
        e1 = run_counted("e1", rec, lambda: [
            server.evaluate_batch(reqs) for _ in range(2)])
        e2 = run_counted("e2", rec, lambda: kserver.evaluate_batch(reqs))
        e3 = run_counted("e3", rec, lambda: xserver.evaluate(epos, eedges))
        drills = run_counted("e4", rec, lambda: run_drills(
            dcfg, dreqs, drill_clean(dcfg, dreqs)))
        e5 = run_counted("e5", rec, enhanced)
    print("launches in (e) (strip_reversal, occlusion_pairs, "
          f"segment_crossing, crossing_angle_sum): "
          f"{ {k: v for k, v in sub_launches.items() if k[0] == 'e'} }",
          flush=True)

    # (e1) one dispatch of B = 8 per round, the second round a plan hit
    s1 = server.stats
    check_clean("(e1)", e1[0] + e1[1], s1)
    check((s1["dispatches"], s1["coalesced"], s1["plan_misses"],
           s1["plan_hits"], s1["replans"]) == (2, 2 * BATCH, 1, 1, 0),
          f"(e1) stats {s1}")
    for rnd in (0, 1):
        for i, r in enumerate(e1[rnd]):
            check(r.overflow == 0, f"(e1) overflow on {i}")
            check_scores(f"(e1) round {rnd} [{i}]", r, REFERENCE["batch"][i])
    e1_slab = [("strip_reversal", tuple(args[0].shape))
               for _, args in slabs["e1"]]
    check(seen_shapes["e1"] == sorted(e1_slab * 2),
          f"(e1) launched {seen_shapes['e1']}, planned {e1_slab} per round")
    # (e2) the kernels backend: one dispatch, each member on flat buckets
    # and the all-pairs occlusion count
    s2 = kserver.stats
    check_clean("(e2)", e2, s2)
    check((s2["dispatches"], s2["coalesced"]) == (1, BATCH),
          f"(e2) stats {s2}")
    for i, r in enumerate(e2):
        check(r.overflow == 0, f"(e2) overflow on {i}")
        check_scores(f"(e2) [{i}]", r, REFERENCE["batch"][i])
    e2_planned = sorted([("strip_reversal", tuple(args[0].shape))
                         for _, args in slabs["e2"]]
                        + [("occlusion_pairs", (n_pad,))] * BATCH)
    check(seen_shapes["e2"] == e2_planned,
          f"(e2) launched {seen_shapes['e2']}, planned {e2_planned}")
    # (e3) the exact method of the legacy mirror is (d0)'s call
    check(e3.ok and e3.overflow == 0, f"(e3) {e3}")
    check_scores("(e3) server method='exact'", e3, EXACT_REFERENCE)
    check(sub_launches["e3"] == (0, 1, 0, 1)
          and seen_shapes["e3"] == exact_planned,
          f"(e3) launched {sub_launches['e3']} on {seen_shapes['e3']}")
    # (e4) the drills launched only shapes checked in phase 2
    check(sub_launches["e4"][0] > 0, f"(e4) launched {sub_launches['e4']}")
    # (e5) the enhanced wrappers
    (ec, ec_ov), (e_ca, ca_count, ca_dev, ca_ov), (nc, nc_ov) = e5
    want5 = ENHANCED_REFERENCE
    for label, got5, want in (
            ("count_crossings_enhanced", (ec, ec_ov),
             want5["count_crossings_enhanced"]),
            ("crossing_angle_enhanced", (ca_count, ca_ov),
             want5["crossing_angle_enhanced"]),
            ("count_occlusions_enhanced", (nc, nc_ov),
             want5["count_occlusions_enhanced"])):
        check((int(got5[0]), int(got5[1])) == (want["count"],
                                               want["overflow"]),
              f"(e5) {label}: ({int(got5[0])}, {int(got5[1])}), reference "
              f"({want['count']}, {want['overflow']})")
    for f, g in (("edge_crossing_angle", e_ca), ("dev_sum", ca_dev)):
        w = want5["crossing_angle_enhanced"][f]
        check(abs(float(g) - w) <= RTOL * abs(w),
              f"(e5) crossing_angle_enhanced {f} = {float(g)!r}, reference "
              f"{w!r} (rtol {RTOL})")
    e5_planned = sorted([("strip_reversal", tuple(args[0].shape))
                         for _, args in slabs["c"]] * 2)
    check(seen_shapes["e5"] == e5_planned,
          f"(e5) launched {seen_shapes['e5']}, planned {e5_planned}")
    print(f"(e1)[0] {e1[0][0]}")
    print(f"(e3) {e3}")
    print(f"(e5) E_c {int(ec)}, E_ca {float(e_ca)!r} over {int(ca_count)} "
          f"crossings, N_c {int(nc)}; drills passed: {sorted(drills)}")
    print("serving front and enhanced algorithms: ok, equal to the JAX "
          f"reference constants (ints exact, floats rtol {RTOL})",
          flush=True)

    # (f) the incremental path: a drag at full width
    check(DRAG_REFERENCE is not None, "(f) DRAG_REFERENCE is not set")
    with recording_launches(*kernel_mods) as rec:
        drag = run_counted("f", rec, lambda: drag_path(cfg, pos, edges))
    check_drag(drag)
    f_rows = Counter(shape[0] for k, shape in seen_shapes["f"]
                     if k == "strip_reversal")
    check(sub_launches["f"][1:] == (0, 0, 0),
          f"(f) launched {sub_launches['f']}")
    print(f"launches in (f) (strip_reversal, occlusion_pairs, "
          f"segment_crossing, crossing_angle_sum): {sub_launches['f']}; "
          f"strip_reversal rows per launch: {dict(f_rows)}", flush=True)
    print(f"(f) vertex {drag['vertex']}, last frame {drag['frames'][-1]['got']}")
    print(f"(f) session stats: { {k: drag['session'].stats[k] for k in ('updates', 'delta_hits', 'delta_fallbacks')} }")
    print(f"incremental path: ok, {DRAG_FRAMES} frames on the delta path, "
          f"equal to from-scratch evaluations and to the JAX reference "
          f"constants (ints exact, floats rtol {RTOL}); the front door and "
          f"the forced fallback right", flush=True)

    # (g) the differentiable path and the gradient search
    check(SEARCH_REFERENCE is not None, "(g2) SEARCH_REFERENCE is not set")
    searches, digest, digest_s, g_err = search_paths(
        cfg, pos, edges, ideal, kernel_mods, run_counted, sub_launches,
        rev_checked)
    gen = searches["g1"]["out"]
    g1, g2 = gen["result"], searches["g2"]["out"]
    check(np.isfinite(np.asarray(gen["objectives"])).all()
          and int(np.max(gen["scores"].overflow)) == 0,
          "(g1) FR checkpoint scores")
    check_search("(g1)", g1, gen["edges"], gen["cfg"])
    check_search("(g2)", g2, edges, cfg)
    digest_norm, digest_err = check_digest(*digest)
    print(f"(g1) FR: {FR_STARTS} starts x {FR_ITERS} iterations, "
          f"{len(gen['objectives'])} checkpoints scored in one "
          f"evaluate_batch, best {gen['best']} (objective "
          f"{gen['objectives'][gen['best']]:.6f}); search {g1.steps} steps x "
          f"{g1.restarts} restarts: objective "
          f"{float(np.max(g1.init_objectives)):.6f} -> "
          f"{g1.best_objective:.6f} (improvement {g1.improvement:.6f}), "
          f"counters {g1.counters}, strip_reversal launches per re-score "
          f"{searches['g1']['rescores']}", flush=True)
    print(f"(g2) search at |V| = {n_v}, {SEARCH_KNOBS}, peak lr "
          f"{SEARCH_PEAK_LR}: objective "
          f"{float(np.max(g2.init_objectives)):.6f} -> "
          f"{g2.best_objective:.6f} (improvement {g2.improvement:.6f}), "
          f"counters {g2.counters}, strip_reversal launches per re-score "
          f"{searches['g2']['rescores']}; first soft loss {digest[0]!r}, "
          f"gradient norm {digest_norm!r}, digest rows off by "
          f"{digest_err!r} (reference {SEARCH_REFERENCE['loss']!r}, "
          f"{SEARCH_REFERENCE['grad_norm']!r})", flush=True)
    caps = {}
    for jitter in (SEARCH_KNOBS["jitter"], 0.05):
        gs = GradientSearch(cfg, **{**SEARCH_KNOBS, "jitter": jitter})
        plan_j = engine.plan_readability(*gs._init_batch(pos, edges)[:2],
                                         **cfg.plan_kwargs())
        caps[jitter] = [cap for _, cap in plan_j.strip_plans]
    print(f"(g2) the search plan's strip caps per orientation: {caps} by "
          "jitter (docs/search.md's default is 0.05)", flush=True)
    print(f"differentiable path and search: ok, every reported score equal "
          f"to evaluate_batch of its layout (ints exact, floats rtol {RTOL}), "
          f"no restart worse than its start, (g2)'s first loss and gradient "
          f"equal to the JAX reference constants ({SEARCH_TOLERANCE}), "
          f"strip_reversal launched by every re-score and equal to its "
          f"plain version on every launch (max abs dev err {g_err})",
          flush=True)

    # every launched shape was checked in phase 2
    launched = Counter(item for shapes in seen_shapes.values()
                       for item in shapes)
    checked = {"strip_reversal": rev_checked, "occlusion_pairs": occ_checked,
               "segment_crossing": cross_checked,
               "crossing_angle_sum": cross_checked}
    unchecked = sorted(k for k in launched if k[1] not in checked[k[0]])
    check(not unchecked, f"launched on shapes not checked in phase 2: "
                         f"{unchecked}")
    check(sum(launched.values()) == sum(total_launches.values()),
          f"recorded launches {dict(launched)}, counted "
          f"{dict(total_launches)}")

    # (h) the distributed paths, with their own launch counts and checks
    row_entries, h_rev_launches = distributed_phase(
        cfg, pos, edges, batch, epos, eedges, dpos, dedges, ev,
        launches["b"][0], card)

    # (i) the main path in bfloat16, with its own launch counts and checks
    bf16_entries = bf16_phase(cfg, pos, edges, batch, ideal, card)
    # (j) the LM serving path
    t0 = time.perf_counter()
    lm_smoke_phase(dev)
    lm_full_phase(dev, card)
    print(f"time (j) the LM phase: {time.perf_counter() - t0:.2f} s (wall)",
          flush=True)
    # (k) LM training; (j2)'s model and cache are freed
    t0 = time.perf_counter()
    check(TRAIN_REFERENCE is not None, "(k) TRAIN_REFERENCE is not set")
    lm_train_smoke_phase(dev)
    lm_train_full_2l_phase(dev)
    lm_train_full_phase(dev, card)
    print(f"time (k) the LM training phase: {time.perf_counter() - t0:.2f} "
          f"s (wall)", flush=True)
    # (l) the GNN and recsys families; (k2)'s model and state are freed
    gnn_launches = gnn_phase(dev, card)
    # (m) the equivariant family
    eqv_launches = equivariant_phase(dev, card)
    # (n) the dry run over fake ranks and the cells that fit one card
    dry_launches = dryrun_phase(dev, card)

    # -- 4. timings --------------------------------------------------------
    path_ms = {
        "a": cuda_ms(lambda: ev.evaluate(pos, edges)),
        "b": cuda_ms(lambda: ev.evaluate_batch(batch, edges)),
        "c": cuda_ms(lambda: kev.evaluate(pos, edges)),
    }
    for uk in (False, True):
        path_ms[f"d{int(uk)}"] = cuda_ms(lambda: evaluate_exact(
            epos, eedges, config=xcfg, use_kernels=uk))
    path_ms["e1"] = cuda_ms(lambda: server.evaluate_batch(reqs))
    path_ms["e2"] = cuda_ms(lambda: kserver.evaluate_batch(reqs))
    path_ms["e3"] = cuda_ms(lambda: xserver.evaluate(epos, eedges))
    path_ms["e5"] = cuda_ms(enhanced)
    drag_times = time_drag(cfg, pos, edges)
    for k, label in (("a", "evaluate fused"), ("b", f"evaluate_batch B={BATCH}"),
                     ("c", "evaluate kernels"),
                     ("d0", "evaluate_exact use_kernels=False"),
                     ("d1", "evaluate_exact use_kernels=True"),
                     ("e1", f"server fused, {BATCH} requests"),
                     ("e2", f"server kernels, {BATCH} requests"),
                     ("e3", "server method='exact'"),
                     ("e5", "enhanced E_c + E_ca + N_c")):
        print(f"time ({k}) {label}: {path_ms[k]:.3f} ms "
              f"(median of {REPEATS}, CUDA events) on {card}", flush=True)

    t = drag_times
    frame_ms = sorted(t["frames"])
    p95 = frame_ms[min(len(frame_ms) - 1,
                       int(0.95 * (len(frame_ms) - 1) + 0.5))]
    print(f"time (f) update, one dragged frame: median "
          f"{statistics.median(frame_ms):.3f} ms, p95 {p95:.3f} ms, min "
          f"{frame_ms[0]:.3f}, max {frame_ms[-1]:.3f} ({len(frame_ms)} "
          f"frames of {DRAG_REPLAYS} replays, host clock) on {card}",
          flush=True)
    print(f"time (f) register_layout: {statistics.median(t['register']):.3f} "
          f"ms, of which priming {statistics.median(t['prime']):.3f} ms "
          f"(medians of {DRAG_REPLAYS}, host clock); warm full "
          f"sess.evaluate of the dragged layout {t['evaluate']:.3f} ms "
          f"(median of {REPEATS}, CUDA events) on {card}", flush=True)
    print(f"(f) synchronizing CUDA calls in one frame: {len(t['syncs'])} "
          f"{dict(Counter(t['syncs']))}", flush=True)
    step_ms, eval_ms, step_syncs = search_step_times(cfg, pos, edges)
    check(not step_syncs, f"(g2) a search step synchronized with the "
                          f"device at {step_syncs}")
    print(f"time (g2) search step forward+backward, B={SEARCH_KNOBS['restarts']}"
          f" at |V| = {n_v}: {step_ms:.3f} ms; one evaluate_layouts of the "
          f"same batch and plan: {eval_ms:.3f} ms; step_over_eval_ratio "
          f"{step_ms / eval_ms:.3f} (medians of {REPEATS}, CUDA events) on "
          f"{card}; synchronizing CUDA calls in one step: {len(step_syncs)}",
          flush=True)
    g2s = searches["g2"]
    print(f"time (g2) the search, {SEARCH_KNOBS['steps']} steps and "
          f"{len(g2s['rescores'])} exact re-scores: {g2s['seconds']:.3f} s; "
          f"the digest's loss and gradient {digest_s * 1e3:.3f} ms (host "
          f"clock); peak memory allocated {g2s['peak'] / 2 ** 30:.3f} GiB "
          f"on {card}", flush=True)
    print(f"time (g1) FR at |V| = {FR_N}: {gen['fr_ms_per_iter']:.4f} ms per "
          f"iteration (host clock over {FR_STARTS * FR_ITERS} iterations in "
          f"calls of {FR_CHECK}); the whole loop, FR, scoring and a search of "
          f"{FR_SEARCH_STEPS} steps: {searches['g1']['seconds']:.3f} s on "
          f"{card}", flush=True)

    def time_kernel(name, label, shape, launch, launches, wrapper, plain,
                    bound_and_by, plain_repeats=REPEATS, note=""):
        """Time one kernel at one shape: the kernel alone on the device
        (its outputs then held against the wrapper's result), its wrapper
        (inner launches), its plain version; print them with the bound.
        Returns a dict of those numbers."""
        med, lo, hi = device_ms(launch, launches)
        check_same_result(f"{name} {label} {shape}", launch.result(),
                          wrapper())
        w_ms = cuda_ms(wrapper, inner=launches)
        p_ms = cuda_ms(plain, repeats=plain_repeats)
        b_ms, by = bound_and_by
        print(f"time {name} {label} {shape}: device {med:.5f} ms (min "
              f"{lo:.5f}, max {hi:.5f}; {DEVICE_READINGS} readings of "
              f"{launches} launches), wrapper {w_ms:.5f} ms, plain "
              f"{p_ms:.4f} ms, bound {b_ms:.5f} ms ({by}) on {card}{note}",
              flush=True)
        return dict(ms=med, wrapper_ms=w_ms, plain_ms=p_ms, bound_ms=b_ms,
                    bound_by=by)

    def total(name, time_shape):
        """One kernel's numbers summed over its launches in the pass: each
        launched shape timed once (``time_shape``) and counted as often
        as it was launched."""
        rows_ = []
        for (k, shape), n in sorted(launched.items()):
            if k == name:
                row = time_shape(shape)
                print(f"  {name} {shape}: {n} launches in the pass")
                rows_ += [row] * n
        by = {}
        for r in rows_:
            by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + r["bound_ms"]
        out = {k: sum(r[k] for r in rows_)
               for k in ("ms", "wrapper_ms", "plain_ms", "bound_ms")}
        out["bound_by"] = max(by, key=by.get)
        return out

    def time_reversal(shape):
        label, args = rev_checked[shape]
        return time_kernel(
            "strip_reversal", label, shape,
            raw_launcher("strip_reversal", args, ideal=ideal), 20,
            lambda: strip_reversal_rows(*args, ideal=ideal),
            lambda: strip_reversal_rows_plain(*args, ideal=ideal),
            reversal_bound_ms(args))

    def time_occlusion(shape):
        label, args, radius, occluded = occ_checked[shape]
        return time_kernel(
            "occlusion_pairs", label, shape,
            raw_launcher("occlusion_pairs", list(args), radius=radius),
            3 if shape[0] > 65536 else 20,
            lambda: occlusion_pairs(*args, radius),
            lambda: occlusion_pairs_plain(*args, radius),
            occlusion_bound_ms(args[0], args[2], occluded))

    x1, y1, x2, y2, th, v, u, ok = xargs
    n_valid = float(ok.sum())
    straddles = int(crossing_count_plain(x1, y1, x2, y2,
                                         *distinct_ids(v.shape, dev), ok))
    torch.cuda.synchronize()
    print(f"(d) straddling pairs (shared endpoints included): {straddles}, "
          f"crossings {crossings}", flush=True)

    def time_crossing(shape):
        return time_kernel(
            "segment_crossing", cross_checked[shape][0], shape,
            raw_launcher("segment_crossing", list(xargs)), 2,
            lambda: crossing_count(x1, y1, x2, y2, v, u, ok),
            lambda: crossing_count_plain(x1, y1, x2, y2, v, u, ok),
            crossing_bound_ms(e_pad, n_valid, straddles, crossings,
                              angle=False),
            plain_repeats=EXACT_PLAIN_REPEATS)

    def time_angle(shape):
        return time_kernel(
            "crossing_angle_sum", cross_checked[shape][0], shape,
            raw_launcher("crossing_angle_sum", list(xargs),
                         ideal=xcfg.ideal_angle), 2,
            lambda: crossing_angle_stats(*xargs, ideal=xcfg.ideal_angle),
            lambda: crossing_angle_plain(*xargs, ideal=xcfg.ideal_angle),
            crossing_bound_ms(e_pad, n_valid, straddles, crossings,
                              angle=True),
            plain_repeats=EXACT_PLAIN_REPEATS,
            note=f"; ptxas {ptxas['crossing_angle_sum']}")

    rev = total("strip_reversal", time_reversal)
    occ = total("occlusion_pairs", time_occlusion)
    cross = total("segment_crossing", time_crossing)
    angle = total("crossing_angle_sum", time_angle)

    kernels = [
        dict(name="strip_reversal", route="cuda",
             source="src/repro_torch/kernels/csrc/strip_reversal.cu",
             replaces="src/repro/kernels/strip_reversal.py:25",
             launches=total_launches["strip_reversal"], max_abs_err=rev_err,
             **rev, library_ms=None),
        dict(name="occlusion_pairs", route="cuda",
             source="src/repro_torch/kernels/csrc/occlusion_pairs.cu",
             replaces="src/repro/kernels/occlusion_pairs.py:30",
             launches=total_launches["occlusion_pairs"], max_abs_err=occ_err,
             **occ, library_ms=None),
        dict(name="segment_crossing", route="cuda",
             source="src/repro_torch/kernels/csrc/segment_crossing.cu",
             replaces="src/repro/kernels/segment_crossing.py:39",
             launches=total_launches["segment_crossing"],
             max_abs_err=cross_err, **cross, library_ms=None),
        dict(name="crossing_angle_sum", route="cuda",
             source="src/repro_torch/kernels/csrc/crossing_angle_sum.cu",
             replaces="src/repro/kernels/crossing_angle_sum.py:27",
             launches=total_launches["crossing_angle_sum"],
             max_abs_err=angle_err, **angle, library_ms=None),
    ]
    for name, src_name in (("occlusion_pairs_rows", "occlusion_pairs"),
                           ("segment_crossing_rows", "segment_crossing")):
        where = next(k["replaces"] for k in kernels if k["name"] == src_name)
        e = row_entries[name]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src_name}.cu",
            replaces=where, launches=e["launches"],
            max_abs_err=e["max_abs_err"], ms=e["ms"],
            wrapper_ms=e["wrapper_ms"], plain_ms=e["plain_ms"],
            bound_ms=e["bound_ms"], bound_by=max(e["by"], key=e["by"].get),
            library_ms=None))
    kernels += bf16_entries
    for k in kernels:
        # no kernel runs on (l) or (m): their launches, counted in those runs
        k["launches_l"] = gnn_launches.get(k["name"], 0)
        k["launches_m"] = eqv_launches.get(k["name"], 0)
        k["launches_n"] = dry_launches.get(k["name"], 0)
    print("kernel times are summed over every launch of one pass of "
          "(a)-(g), the row-range entries over (h)'s launches (parent and "
          "ranks), the bfloat16 entries over (i)'s; launches are counted "
          "in those runs, launches_l in (l)'s, launches_m in (m)'s, "
          "launches_n in (n2)'s cell runs "
          "(strip_reversal's "
          f"{h_rev_launches} launches in (h) are checked there and not "
          "added); ms is the kernel alone on the device (median), "
          "wrapper_ms the wrapper's call", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
