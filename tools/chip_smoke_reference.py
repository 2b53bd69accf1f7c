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
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py --drag
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py --search
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py --near-parallel
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py --bf16
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py --lm
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py --train
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py --gnn
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py --equivariant

``--drag`` computes the constants of ``chip_smoke.py``'s phase (f), op by
op: the reference's ``EvalSession(EvalConfig(radius=0.5, n_strips=512),
update_dirty_threshold=1.0)`` registers the |V| = 100,000 layout and
replays (f)'s 20 moves of one vertex (``chip_smoke.drag_moves``: the
vertex nearest the centre of the bounding box, steps of N(0, 0.2) from
``numpy.random.default_rng(5)``); it prints the last ``update``'s scores
and a from-scratch ``evaluate`` of the final layout, whose integers must
be equal, and the session counters (every frame on the delta path).

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

``--search`` computes the constants of ``chip_smoke.py``'s phase (g2), op
by op: the search's restart batch as ``repro.search.GradientSearch``
draws it (``chip_smoke.SEARCH_KNOBS``: 8 restarts, ``jitter`` 0.001 of the
layout's extent, ``seed`` 0) from the |V| = 100,000 layout, the plan of
that batch (``EvalConfig(radius=0.5, n_strips=512)``), and
``jax.value_and_grad`` of ``repro.core.soft.soft_loss`` summed over
restart 0 (the unperturbed layout) at the starting temperature 0.05: the
loss, the gradient's L2 norm and the gradient rows of
``chip_smoke.DIGEST_VERTICES``.  It also recounts the same loss and
gradient with the port in float64 on the CPU and prints how far the
reference's float32 values are from the recount; ``chip_smoke.py``'s
tolerances rest on that (``SEARCH_REFERENCE["float64"]``).  About 10
minutes of CPU and 10 GB.

``--bf16`` computes the constants of ``chip_smoke.py``'s phase (i), op
by op: the inputs above at ``EvalConfig(radius=0.5, n_strips=512,
precision="bfloat16")``: fused ``evaluate``, ``evaluate_batch`` of the
B=8 batch, ``backend="kernels"`` ``evaluate``, and the reference's
``ReadabilityServer`` on the batch as eight requests.  About 6 minutes
of CPU and 4 GB.

``--lm`` computes the constants of phase (j1): for each of the five LM
smoke configs at ``dtype=float32``, parameters from
``repro_torch.models.transformer.numpy_params(cfg, LM_SEED)`` (the port's
numpy draw, handed to the reference as its pytree) and a ``(2, 16)``
prompt from ``numpy.random.default_rng(LM_SEED + 1)``: the reference's
``lm_generate`` tokens (8 new), the first 8 prefill logits of each row
and each row's L2 norm of the prefill logits.  About half a minute.

``--train`` computes the constants of phase (k): (k1) for each of the
five LM smoke configs at ``dtype=float32``, parameters from
``numpy_params(cfg, TRAIN_SEED)``, the reference's jitted
``build_lm_trainer`` for three steps on the ``TokenStream`` batches of
``(TRAIN_BATCH, TRAIN_SEQ)`` (the second step with ``grad_accum=2``;
the constants are ``chip_smoke.py``'s):
loss and grad norm per step; (k2a) qwen3-4b at its published width with
2 layers at ``float32``, ``numpy_params(cfg, TRAIN_SEED)`` and one
``TokenStream`` batch of ``FULL_2L_BATCH`` x ``FULL_2L_SEQ``: the
jitted ``loss_fn``'s total and xent and the global norm of its gradient.
About a minute of CPU and 15 GB (the 2-layer model's 0.96 B float32
parameters, its gradient and their copies).

``--gnn`` computes the constants of phase (l1), op by op: for each of
``chip_smoke.GNN_CASES`` (gcn-cora and graphsage-reddit full-graph,
graphsage-reddit on a fanout block, xdeepfm) at the smoke config,
parameters from the port's numpy draw (``repro_torch.models.gnn`` /
``.recsys`` ``numpy_params(cfg, GNN_SEED)``) and
``chip_smoke.gnn_smoke_batch``'s inputs: the logits, the loss, the
gradient's global norm, ``GNN_STEPS`` AdamW steps' losses
(``AdamWConfig(**GNN_OPT)``), and xdeepfm's retrieval scores for the
first row (the first 16 and the L2 norm).  About 40 s of CPU.

``--equivariant`` computes the constants of phase (m1), op by op: for
each of ``chip_smoke.EQV_CASES`` (nequip, equiformer-v2 and
equiformer-v2 with ``compact_escn``) at the smoke config, parameters
from the port's numpy draw (``repro_torch.models.equivariant.
numpy_params(cfg, GNN_SEED)``) and ``chip_smoke.eqv_smoke_batch``'s
inputs: the energies, NequIP's forces on the nodes where they are finite
(``forces_rows``; a node with a self-loop has NaN forces in JAX), the
loss, the gradient's global norm and ``GNN_STEPS`` AdamW steps' losses
(``AdamWConfig(**GNN_OPT)``).  About a minute of CPU.

``--near-parallel`` runs the reference's engine on
``repro_torch.kernels.fixtures.near_parallel_layouts()`` (``RADIUS`` 2.0,
``N_STRIPS`` 32, flat strips; ROADMAP queue 3) twice, jitted and op by
op, single and batched, and prints E_ca, the crossing counts and the
deviation sums of both routes with their relative differences.

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


def compute_bf16():
    """Phase (i): the main path at precision="bfloat16", op by op (call
    under ``jax.disable_jit()``)."""
    pos, edges, batch = inputs()
    cfg = EvalConfig(radius=RADIUS, n_strips=N_STRIPS, precision="bfloat16")
    t0 = time.perf_counter()
    single = _row(Evaluator(cfg).evaluate(pos, edges))
    t1 = time.perf_counter()
    res = Evaluator(cfg).evaluate_batch(batch, edges)
    batched = [_row(res, i) for i in range(BATCH)]
    t2 = time.perf_counter()
    kcfg = EvalConfig(radius=RADIUS, n_strips=N_STRIPS,
                      precision="bfloat16", backend="kernels")
    kern = _row(Evaluator(kcfg).evaluate(pos, edges))
    t3 = time.perf_counter()
    server = ReadabilityServer(cfg)
    serve = [_row(r) for r in server.evaluate_batch(
        [(p, edges) for p in batch])]
    t4 = time.perf_counter()
    return dict(fused=single, batch=batched, kernels=kern, serve=serve,
                seconds=dict(fused=t1 - t0, batch=t2 - t1, kernels=t3 - t2,
                             serve=t4 - t3))


LM_SEED, LM_BATCH, LM_PROMPT, LM_NEW = 0, 2, 16, 8


def compute_lm():
    """Phase (j1): the five LM smoke configs at float32."""
    import dataclasses

    import jax.numpy as jnp
    import torch

    from repro import configs as ref_configs
    from repro.launch.serve import lm_generate
    from repro.models import transformer as ref_tf
    from repro_torch import configs as t_configs
    from repro_torch.models.transformer import numpy_params

    out = {}
    for arch in t_configs.ARCH_IDS[:5]:
        tcfg = dataclasses.replace(t_configs.get_arch(arch).smoke_config,
                                   dtype=torch.float32)
        rcfg = dataclasses.replace(ref_configs.get_arch(arch).smoke_config,
                                   dtype=jnp.float32)
        params = jax.tree.map(jnp.asarray, numpy_params(tcfg, LM_SEED))
        rng = np.random.default_rng(LM_SEED + 1)
        prompt = rng.integers(0, rcfg.vocab_size,
                              (LM_BATCH, LM_PROMPT)).astype(np.int32)
        cache = ref_tf.init_cache(rcfg, LM_BATCH, LM_PROMPT)
        _, logits = jax.jit(lambda p, t, c: ref_tf.prefill(p, t, c, rcfg))(
            params, prompt, cache)
        logits = np.asarray(logits)
        tokens = np.asarray(lm_generate(params, rcfg, prompt, LM_NEW))
        out[arch] = dict(tokens=tokens.tolist(),
                         prefill_logits_head=logits[:, :8].tolist(),
                         prefill_logits_norm=np.linalg.norm(
                             logits.astype(np.float64), axis=1).tolist())
    return out


def compute_train():
    """Phase (k1): three trainer steps of each LM smoke config at float32;
    (k2a): qwen3-4b at full width with 2 layers, one loss and gradient."""
    import dataclasses

    import jax.numpy as jnp
    import torch

    from repro import configs as ref_configs
    from repro.data.pipeline import TokenStream
    from repro.launch.train import build_lm_trainer
    from repro.models import transformer as ref_tf
    from repro.optim import adamw
    from repro_torch import configs as t_configs
    from repro_torch.models.transformer import numpy_params
    k = _smoke()

    out = {"smoke": {}}
    opt_cfg = adamw.AdamWConfig(**k.TRAIN_OPT)
    for arch in t_configs.ARCH_IDS[:5]:
        tcfg = dataclasses.replace(t_configs.get_arch(arch).smoke_config,
                                   dtype=torch.float32)
        rcfg = dataclasses.replace(ref_configs.get_arch(arch).smoke_config,
                                   dtype=jnp.float32).with_mesh(1)
        params = jax.tree.map(jnp.asarray, numpy_params(tcfg, k.TRAIN_SEED))
        state = adamw.init_state(params)
        steps = {a: build_lm_trainer(rcfg, opt_cfg, grad_accum=a)
                 for a in set(k.TRAIN_ACCUM)}
        stream = TokenStream(rcfg.vocab_size, k.TRAIN_SEQ, k.TRAIN_BATCH,
                             seed=k.TRAIN_SEED)
        rows = {"loss": [], "grad_norm": []}
        for a in k.TRAIN_ACCUM:
            batch = jax.tree.map(jnp.asarray, stream.next_batch())
            params, state, m = steps[a](params, state, batch)
            for key in rows:
                rows[key].append(float(m[key]))
        out["smoke"][arch] = rows

    tcfg = dataclasses.replace(t_configs.get_arch("qwen3-4b").config,
                               n_layers=2, dtype=torch.float32)
    rcfg = dataclasses.replace(ref_configs.get_arch("qwen3-4b").config,
                               n_layers=2, dtype=jnp.float32).with_mesh(1)
    t0 = time.perf_counter()
    params = jax.tree.map(jnp.asarray, numpy_params(tcfg, k.TRAIN_SEED))
    batch = jax.tree.map(jnp.asarray, TokenStream(
        rcfg.vocab_size, k.FULL_2L_SEQ, k.FULL_2L_BATCH,
        seed=k.TRAIN_SEED).next_batch())
    (loss, mets), grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_tf.loss_fn(p, b, rcfg), has_aux=True))(params,
                                                               batch)
    out["full_2l"] = dict(loss=float(loss), xent=float(mets["xent"]),
                          tokens=float(mets["tokens"]),
                          grad_norm=float(adamw.global_norm(grads)),
                          seconds=time.perf_counter() - t0)
    return out


def compute_gnn():
    """Phase (l1): the GNN and recsys smoke configs at float32, op by op
    (the caller disables jit)."""
    import jax.numpy as jnp

    from repro import configs as ref_configs
    from repro.models import gnn as ref_gnn
    from repro.models import recsys as ref_recsys
    from repro.optim import adamw
    from repro_torch.models import gnn as t_gnn
    from repro_torch.models import recsys as t_recsys
    k = _smoke()

    opt = adamw.AdamWConfig(**k.GNN_OPT)
    out = {}
    for case in k.GNN_CASES:
        arch = "graphsage-reddit" if case == "graphsage-sampled" else case
        cfg = ref_configs.get_arch(arch).smoke_config
        batch = jax.tree.map(jnp.asarray, k.gnn_smoke_batch(case, cfg))
        if case == "xdeepfm":
            tree = t_recsys.numpy_params(cfg, k.GNN_SEED)

            def forward(p):
                return ref_recsys.xdeepfm_logits(p, batch["ids"], cfg)

            def loss_of(o):
                return ref_recsys.bce_loss(o, batch["labels"])
        else:
            tree = t_gnn.numpy_params(cfg, k.GNN_SEED)
            fwd = {"gcn-cora": ref_gnn.gcn_forward,
                   "graphsage-reddit": ref_gnn.sage_forward_full,
                   "graphsage-sampled": ref_gnn.sage_forward_sampled}[case]
            mask = batch.get("node_mask", batch["labels"] >= 0)

            def forward(p):
                return fwd(p, batch, cfg)

            def loss_of(o):
                return ref_gnn.node_classification_loss(
                    o, batch["labels"], mask)[0]
        params = jax.tree.map(jnp.asarray, tree)
        entry = {"logits": np.asarray(forward(params)).reshape(-1).tolist()}
        if case == "xdeepfm":
            scores = np.asarray(ref_recsys.retrieval_scores(
                params, batch["ids"][:1], cfg))[0]
            entry["scores_head"] = scores[:16].tolist()
            entry["scores_norm"] = float(np.linalg.norm(
                scores.astype(np.float64)))
        state, losses = adamw.init_state(params), []
        for i in range(k.GNN_STEPS):
            loss, grads = jax.value_and_grad(
                lambda p: loss_of(forward(p)))(params)
            if i == 0:
                entry["loss"] = float(loss)
                entry["grad_norm"] = float(adamw.global_norm(grads))
            params, state, _ = adamw.apply_updates(params, grads, state, opt)
            losses.append(float(loss))
        entry["losses"] = losses
        out[case] = entry
    return out


def compute_equivariant():
    """Phase (m1): the equivariant smoke configs at float32, op by op (the
    caller disables jit)."""
    import dataclasses

    import jax.numpy as jnp

    from repro import configs as ref_configs
    from repro.models import equivariant as ref_eqv
    from repro.optim import adamw
    from repro_torch import configs as t_configs
    from repro_torch.models import equivariant as t_eqv
    k = _smoke()

    opt = adamw.AdamWConfig(**k.GNN_OPT)
    host = k.eqv_smoke_batch()
    batch = jax.tree.map(jnp.asarray, host)
    n_graphs = host["targets"].size
    out = {}
    for case in k.EQV_CASES:
        arch = case.removesuffix("-compact")
        cfg = ref_configs.get_arch(arch).smoke_config
        tcfg = t_configs.get_arch(arch).smoke_config
        if case.endswith("-compact"):
            cfg = dataclasses.replace(cfg, compact_escn=True)
        fwd = (ref_eqv.nequip_forward if arch == "nequip"
               else ref_eqv.equiformer_forward)

        def forward(p, b=batch):
            return fwd(p, b, cfg, n_graphs=n_graphs)

        def loss_of(o):
            return ref_eqv.energy_loss(o, batch["targets"])
        params = jax.tree.map(jnp.asarray, t_eqv.numpy_params(
            tcfg, k.GNN_SEED))
        entry = {"energies": np.asarray(forward(params)).tolist()}
        if arch == "nequip":
            forces = -np.asarray(jax.grad(lambda x: forward(
                params, dict(batch, positions=x)).sum())(
                batch["positions"]))
            rows = np.flatnonzero(np.isfinite(forces).all(1))
            entry["forces_rows"] = rows.tolist()
            entry["forces"] = forces[rows].reshape(-1).tolist()
        state, losses = adamw.init_state(params), []
        for i in range(k.GNN_STEPS):
            loss, grads = jax.value_and_grad(
                lambda p: loss_of(forward(p)))(params)
            if i == 0:
                entry["loss"] = float(loss)
                entry["grad_norm"] = float(adamw.global_norm(grads))
            params, state, _ = adamw.apply_updates(params, grads, state, opt)
            losses.append(float(loss))
        entry["losses"] = losses
        out[case] = entry
    return out


def _smoke():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


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
    smoke = _smoke()
    same = [all(r[f] == want[f] for f in smoke.INT_FIELDS)
            for r, want in zip(serve, smoke.REFERENCE["batch"])]
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


def compute_drag():
    """(f), op by op (call under ``jax.disable_jit()``)."""
    from repro.launch.session import EvalSession
    pos, edges, _ = inputs()
    v, targets = _smoke().drag_moves(pos)
    t0 = time.perf_counter()
    sess = EvalSession(EvalConfig(radius=RADIUS, n_strips=N_STRIPS),
                       update_dirty_threshold=1.0)
    sess.register_layout("drag", pos, edges)
    t1 = time.perf_counter()
    flags = []
    for tgt in targets:
        last = sess.update("drag", [v], [tgt])
        flags.append(bool((last.flags or {}).get("incremental", False)))
    t2 = time.perf_counter()
    cur = np.array(pos, copy=True)
    cur[v] = targets[-1]
    scratch = sess.evaluate(cur, edges)
    t3 = time.perf_counter()
    update, full = _row(last), _row(scratch)
    ints = ("node_occlusion", "edge_crossing", "crossing_count_for_angle",
            "overflow")
    return dict(vertex=v, update=update, scratch=full,
                ints_equal=all(update[f] == full[f] for f in ints),
                incremental_frames=sum(flags),
                stats={k: sess.stats[k] for k in (
                    "updates", "delta_hits", "delta_fallbacks")},
                seconds=dict(register=t1 - t0, frames=t2 - t1,
                             scratch=t3 - t2))


def compute_search():
    """(g2)'s first soft loss and gradient digest, op by op, and the
    port's float64 recount of them."""
    from unittest import mock

    import jax.numpy as jnp
    import torch

    from repro.core import engine as ref_engine
    from repro.core import soft as ref_soft
    from repro.search import GradientSearch
    from repro_torch.core import engine as t_engine
    from repro_torch.core import soft as t_soft

    smoke = _smoke()
    pos, edges, _ = inputs()
    cfg = EvalConfig(radius=RADIUS, n_strips=N_STRIPS)
    gs = GradientSearch(cfg, **smoke.SEARCH_KNOBS)
    batch, edges_v, _ = gs._init_batch(pos, edges)
    plan = ref_engine.plan_readability(batch, edges_v, **cfg.plan_kwargs())
    tau = gs._temperature_at(0)
    idx = np.asarray(smoke.DIGEST_VERTICES)
    t0 = time.perf_counter()
    with jax.disable_jit():
        loss, grad = jax.value_and_grad(lambda p: jnp.sum(ref_soft.soft_loss(
            plan, p, edges_v, jnp.float32(tau))))(jnp.asarray(batch[:1]))
    grad = np.asarray(grad)[0]
    t1 = time.perf_counter()
    tplan = t_engine.plan_from_reference(plan)

    def port(dtype):
        p = torch.tensor(batch[:1].astype(dtype), requires_grad=True)
        loss = t_soft.soft_loss(tplan, p, torch.from_numpy(edges_v),
                                tau).sum()
        g, = torch.autograd.grad(loss, p)
        return loss.item(), g[0].numpy()

    loss32, g32 = port(np.float32)
    with mock.patch.object(t_engine.ReadabilityPlan, "dtype",
                           property(lambda self: torch.float64)):
        loss64, g64 = port(np.float64)
    t2 = time.perf_counter()

    def norm(g):
        return float(np.sqrt(np.sum(np.square(g.astype(np.float64)))))

    def off(loss_, g):
        """How far a float32 loss and gradient are from the recount."""
        return dict(
            loss_rel_diff=abs(loss_ - loss64) / abs(loss64),
            grad_norm_rel_diff=abs(norm(g) - norm(g64)) / norm(g64),
            rows_max_abs_diff_over_max_row=float(np.max(np.abs(
                g[idx] - g64[idx]))) / float(np.max(np.abs(g64[idx]))),
            grad_max_abs_diff_over_max=float(np.max(np.abs(g - g64)))
            / float(np.max(np.abs(g64))))

    return dict(
        knobs=smoke.SEARCH_KNOBS, temperature=tau,
        plan=dict(cell_cap=int(plan.cell_cap),
                  strip_plans=[list(map(int, sp)) for sp in plan.strip_plans],
                  tier_caps=[list(map(int, t[0])) for t in plan.strip_tiers]),
        loss=float(loss), grad_norm=norm(grad), vertices=idx.tolist(),
        rows=grad[idx].tolist(),
        float64=dict(loss=loss64, grad_norm=norm(g64),
                     reference_off=off(float(loss), grad),
                     port_cpu_float32_off=off(loss32, g32)),
        seconds=dict(reference=t1 - t0, port=t2 - t1))


def compute_near_parallel():
    """The reference's engine on the near-parallel layouts, jitted and op
    by op (ROADMAP queue 3)."""
    from repro.core import engine as ref_engine
    from repro_torch.kernels.fixtures import near_parallel_layouts

    batch, edges = near_parallel_layouts()
    plan = ref_engine.plan_readability(batch, edges, radius=2.0,
                                       n_strips=32, tier_strips=False)

    def run():
        b = ref_engine.evaluate_layouts(plan, batch, edges)
        singles = [ref_engine.evaluate_planned(plan, p, edges)
                   for p in batch]
        rows = []
        for i in range(batch.shape[0]):
            for label, r in (("batched", jax.tree_util.tree_map(
                    lambda x: x[i], b)), ("single", singles[i])):
                count = int(r.crossing_count_for_angle)
                e_ca = float(r.edge_crossing_angle)
                rows.append(dict(member=i, route=label, count=count,
                                 edge_crossing_angle=e_ca,
                                 dev_sum=(1.0 - e_ca) * count))
        return rows

    jitted = run()
    with jax.disable_jit():
        eager = run()
    for j, e in zip(jitted, eager):
        j["eca_rel_diff_vs_op_by_op"] = abs(
            j["edge_crossing_angle"] - e["edge_crossing_angle"]) / abs(
            e["edge_crossing_angle"])
        j["dev_sum_rel_diff_vs_op_by_op"] = abs(
            j["dev_sum"] - e["dev_sum"]) / abs(e["dev_sum"])
    return dict(jit=jitted, op_by_op=eager,
                agree_at_rtol_1e5=all(
                    j["eca_rel_diff_vs_op_by_op"] <= 1e-5 for j in jitted))


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
    ap.add_argument("--drag", action="store_true",
                    help="phase (f): 20 dragged frames of one vertex at "
                         "|V| = 100,000 through the session's update")
    ap.add_argument("--search", action="store_true",
                    help="phase (g2): the first soft loss and gradient of "
                         "the search at |V| = 100,000")
    ap.add_argument("--bf16", action="store_true",
                    help="phase (i): the main path at precision='bfloat16'")
    ap.add_argument("--lm", action="store_true",
                    help="phase (j1): the five LM smoke configs")
    ap.add_argument("--train", action="store_true",
                    help="phase (k): LM training, the smoke configs and "
                         "qwen3-4b at full width with 2 layers")
    ap.add_argument("--gnn", action="store_true",
                    help="phase (l1): the GNN and recsys smoke configs")
    ap.add_argument("--equivariant", action="store_true",
                    help="phase (m1): the equivariant smoke configs")
    ap.add_argument("--near-parallel", action="store_true",
                    help="the reference's jitted and op-by-op E_ca on the "
                         "near-parallel layouts")
    args = ap.parse_args()
    if args.bf16:
        with jax.disable_jit():
            out = {"eager": compute_bf16()}
    elif args.gnn:
        with jax.disable_jit():
            out = compute_gnn()
    elif args.equivariant:
        with jax.disable_jit():
            out = compute_equivariant()
    elif args.lm:
        out = compute_lm()
    elif args.train:
        out = compute_train()
    elif args.search:
        out = {"eager": compute_search()}
    elif args.near_parallel:
        out = compute_near_parallel()
    elif args.drag:
        with jax.disable_jit():
            out = {"eager": compute_drag()}
    elif args.serve:
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
