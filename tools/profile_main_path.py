"""Where the main path's time goes on the card.

Builds ``chip_smoke.py``'s inputs (the layout-local graph at |V| =
100,000, ``radius=0.5``, ``n_strips=512``, B=8 batch; ego-Facebook for
the exact path) and, for each path -- (a) fused ``evaluate``, (b)
``evaluate_batch`` with the plan made per call (as ``chip_smoke.py``
calls it), (b') the same with the plan made once and passed in, (c)
kernels ``evaluate``, (d) ``evaluate_exact`` with ``use_kernels`` False
and True, (e1)-(e3) ``ReadabilityServer`` fused and kernels on the batch
as 8 requests and ``method="exact"``, (e5) the enhanced wrappers, (f)
one dragged frame of the incremental path (``EvalSession.update`` of one
vertex of the |V| = 100,000 layout, ``chip_smoke.drag_moves``), (g1) one
step of the layout-generation example's search (4 restarts of an FR
layout at |V| = 400) and (g2) one step of ``chip_smoke.py``'s search at
|V| = 100,000 (8 restarts; the soft loss's forward and backward and the
AdamW update) -- prints the wall time,
the device-busy time of a call (the union of the device intervals of a
``torch.profiler`` trace of the device's activity, as
``bench/trace_reader.py`` reads it), the device's idle share of the
traced window, and the ops that take the most device time.  For (e1)
and (f) it also prints the program's spans (:mod:`repro_torch.spans`)
of the calls it runs: the time in each, summed by name within a call,
as medians over the calls -- for (e1) the session's request preparation
(validation, topology hash), its dispatch and the engine's steps within
it, for (f) a frame's probe, the delta's enqueue and the scores' fetch
(which waits for the device), over 20 frames.

``--train`` profiles instead one step of ``chip_smoke.py``'s (k2):
qwen3-4b at full width (``FULL_TRAIN_LAYERS`` layers), 4 micro-batches
of 4096 tokens, bfloat16 products on float32 state, remat, the loss in
16 chunks, the in-place AdamW update; it prints the wall time, the
device time and idle share, the kernels that take the most device time,
and the device time by kind of kernel (matrix products, softmax,
reductions, casts to bfloat16, copies and other casts, other
elementwise).

``--gnn`` profiles instead ``chip_smoke.py``'s (l2)-(l4): gcn-cora's
forward and training step at full_graph_sm, graphsage-reddit's sampling,
forward and training step at minibatch_lg, and xdeepfm's serve_p99,
serve_bulk, retrieval_cand and a train_batch step (the last two
calls also by kind of kernel).

``--equivariant`` profiles instead one training step of each of
``chip_smoke.py``'s (m2) nequip and (m3) equiformer-v2 (both eSCN
layouts) at their published configs on the padded molecule batch
(AdamWConfig() defaults, the in-place trainer): the wall time, the device
time and idle share, the kernels that take the most device time and the
device time by kind of kernel.

Usage (from the repository root, on a CUDA machine)::

    python tools/profile_main_path.py [--train | --gnn | --equivariant]
"""

from __future__ import annotations

import dataclasses
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

RUNS = 3


def profile(label, fn, card, runs=RUNS, top_n=8, width=90):
    """Time ``fn`` and trace ``runs`` calls of it; returns ``[[op name,
    device seconds per call], ...]``, most first."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from bench.trace_reader import read_chrome_trace

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    # the device's activity and the runtime calls, no host operators
    # (which would stretch the window); a synchronisation on each side
    # marks the window in the trace
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/trace.json"
        prof.export_chrome_trace(path)
        trace = read_chrome_trace(path)
    busy = trace.busy_s()
    print(f"{label}: wall {statistics.median(walls):.3f} ms unprofiled "
          f"(median of {runs}), {trace.window_s * 1e3 / runs:.3f} ms "
          f"traced; device {busy * 1e3 / runs:.3f} ms; idle share "
          f"{1 - busy / trace.window_s:.3f} on {card}")
    ops = [[name, sec / runs] for name, sec in
           trace.top_ops(len(trace.device))]
    for name, sec in ops[:top_n]:
        print(f"    {sec * 1e3:9.4f} ms {name[:width]}")
    return ops


def span_split(label, fn, calls=RUNS):
    """Print the program's spans of ``calls`` calls of ``fn``: the time
    in each span, summed by name within a call, as medians over the
    calls (host clock; a span that waits for the device includes it)."""
    from repro_torch import spans
    per_call = []
    spans.enable()
    try:
        for _ in range(calls):
            fn()
            got = {}
            for sp in spans.drain().spans:
                got[sp.name] = got.get(sp.name, 0.0) + (
                    sp.end_ns - sp.start_ns) * 1e-6
            per_call.append(got)
    finally:
        spans.disable()
    names = sorted({n for got in per_call for n in got})
    print(f"    {label} spans (ms, median of {calls} calls): " + ", ".join(
        f"{n} {statistics.median(got.get(n, 0.0) for got in per_call):.3f}"
        for n in names))


# kinds of kernel, by a word of their name (first match wins).  A cast to
# bfloat16 has a kernel of its own; ``direct_copy`` runs both same-type
# copies and the other casts (to float32 among them), which its name
# does not tell apart
KINDS = (("matrix products", ("gemm", "nvjet", "cutlass", "xmma", "sm90")),
         ("softmax", ("softmax",)),
         ("reductions", ("reduce", "norm")),
         ("casts to bfloat16", ("bfloat16_copy",)),
         ("copies and other casts", ("copy", "memcpy", "memset", "cat",
                                     "index")),
         ("other elementwise", ("elementwise", "vectorized", "unrolled")))


def train_profile(card):
    """One step of ``chip_smoke.py``'s (k2), profiled."""
    import torch
    from chip_smoke import full_train_setup

    dev = torch.device("cuda")
    cfg, model, opt_state, batch, trainers = full_train_setup(dev)
    by_kind(profile(f"(k2) {cfg.name} training step, {cfg.n_layers} "
                    f"layers", lambda: trainers[False](opt_state, batch),
                    card, runs=1, top_n=20, width=200))


def gnn_profile(card):
    """``chip_smoke.py``'s (l2)-(l4) at their sizes, profiled: each
    forward, each training step (the in-place trainer, losses not
    read), (l3)'s sampling, and (l4)'s serving calls."""
    import dataclasses

    import torch
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.data.pipeline import ClickLogStream
    from repro_torch.graphs.sampler import sample_fanout_batch
    from repro_torch.models import gnn, recsys
    from repro_torch.optim import adamw

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    opt = adamw.AdamWConfig(peak_lr=cs.GNN_FULL_LR, warmup_steps=1)

    cfg, _, batch, params = cs.cora_inputs(dev)
    with torch.no_grad():
        profile("(l2) gcn-cora forward",
                lambda: gnn.gcn_forward(params, batch, cfg), card)
    _, loss_of = cs.gnn_model("gcn-cora", cfg, batch)
    step = cs.inplace_trainer(params, opt)
    profile("(l2) gcn-cora training step", lambda: step(
        lambda p: loss_of(gnn.gcn_forward(p, batch, cfg))), card)

    cfg = dataclasses.replace(configs.get_arch("graphsage-reddit").config,
                              d_in=cs.REDDIT_FEAT,
                              n_classes=cs.REDDIT_CLASSES)
    indptr, indices, feats, labels, gen = cs.reddit_graph(dev)
    seeds = torch.randperm(cs.REDDIT_NODES, generator=gen, device=dev)[
        :cs.REDDIT_SEEDS].to(torch.int32)

    def sample():
        return sample_fanout_batch(indptr, indices, feats, labels, seeds,
                                   gen, cs.REDDIT_FANOUT)

    profile("(l3) graphsage-reddit sampling", sample, card)
    batch = sample()
    params = gnn.init_sage_params(cfg, gen)
    with torch.no_grad():
        profile("(l3) graphsage-reddit forward",
                lambda: gnn.sage_forward_sampled(params, batch, cfg), card)
    _, loss_of = cs.gnn_model("graphsage-sampled", cfg, batch)
    step = cs.inplace_trainer(params, opt)
    profile("(l3) graphsage-reddit training step", lambda: step(
        lambda p: loss_of(gnn.sage_forward_sampled(p, batch, cfg))), card)
    del indptr, indices, feats, labels, batch, params, step

    cfg = configs.get_arch("xdeepfm").config
    params = recsys.init_xdeepfm_params(
        cfg, torch.Generator(device=dev).manual_seed(cs.GNN_SEED))

    def ids_of(n, seed):
        b = ClickLogStream(cfg.field_vocabs, n, seed=seed).next_batch()
        return (torch.from_numpy(b["ids"]).to(dev),
                torch.from_numpy(b["labels"]).to(dev))

    ids, _ = ids_of(cs.XDFM_BULK, cs.GNN_SEED)
    with torch.no_grad():
        profile(f"(l4) xdeepfm serve_p99 ({cs.XDFM_P99} rows)",
                lambda: recsys.xdeepfm_logits(params, ids[:cs.XDFM_P99],
                                              cfg), card)
        by_kind(profile(f"(l4) xdeepfm serve_bulk ({cs.XDFM_BULK} rows)",
                        lambda: recsys.xdeepfm_logits(params, ids, cfg),
                        card, runs=1))
        profile("(l4) xdeepfm retrieval_cand",
                lambda: recsys.retrieval_scores(params, ids[:1], cfg), card)
    ids, labels = ids_of(cs.XDFM_TRAIN, cs.GNN_SEED + 1)
    step = cs.inplace_trainer(params, dataclasses.replace(
        opt, peak_lr=cs.XDFM_LR))
    by_kind(profile(f"(l4) xdeepfm train_batch step ({cs.XDFM_TRAIN} rows)",
                    lambda: step(lambda p: recsys.bce_loss(
                        recsys.xdeepfm_logits(p, ids, cfg), labels)),
                    card, runs=1, top_n=12))


def equivariant_profile(card):
    """One training step of ``chip_smoke.py``'s (m2) and (m3), profiled."""
    import dataclasses

    import torch
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.models import equivariant as eqv
    from repro_torch.optim import adamw

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    host, _ = cs.molecule_host()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    for arch, init in (("nequip", eqv.init_nequip_params),
                       ("equiformer-v2", eqv.init_equiformer_params)):
        cfg = configs.get_arch(arch).config
        params = init(cfg, torch.Generator(device=dev).manual_seed(
            cs.GNN_SEED))
        step = cs.inplace_trainer(params, adamw.AdamWConfig())
        layouts = [cfg] + ([dataclasses.replace(cfg, compact_escn=True)]
                           if arch == "equiformer-v2" else [])
        for c in layouts:
            forward, loss_of = cs.eqv_forward(c, batch)
            layout = " compact" if getattr(c, "compact_escn", False) else ""
            by_kind(profile(f"({'m2' if arch == 'nequip' else 'm3'}) "
                            f"{arch}{layout} training step", lambda: step(
                                lambda p: loss_of(forward(p))), card,
                            runs=1, top_n=12, width=120))
        del params, step
        torch.cuda.empty_cache()


def by_kind(ops):
    """Print the device time of ``ops`` (``profile``'s) by kind of
    kernel."""
    kinds = {}
    for name, sec in ops:
        kind = next((k for k, words in KINDS
                     if any(w in name.lower() for w in words)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + sec * 1e3
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"    {kind}: {ms:.3f} ms")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_main_path: needs a CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (BATCH, EXACT_RADIUS, N_STRIPS, RADIUS,
                            card_line, exact_inputs, inputs)
    from repro_torch.api import EvalConfig, Evaluator, evaluate_exact

    card = card_line()
    if sys.argv[1:] == ["--train"]:
        train_profile(card)
        return 0
    if sys.argv[1:] == ["--gnn"]:
        gnn_profile(card)
        return 0
    if sys.argv[1:] == ["--equivariant"]:
        equivariant_profile(card)
        return 0
    pos, edges, batch = inputs()
    cfg = EvalConfig(radius=RADIUS, n_strips=N_STRIPS)
    ev = Evaluator(cfg)
    kev = Evaluator(dataclasses.replace(cfg, backend="kernels"))
    plan = ev.plan(batch, edges)
    t0 = time.perf_counter()
    ev.plan(batch, edges)
    print(f"host planning of the B={BATCH} batch: "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
    profile("(a) evaluate fused", lambda: ev.evaluate(pos, edges), card)
    profile(f"(b) evaluate_batch B={BATCH}, plan per call",
            lambda: ev.evaluate_batch(batch, edges), card)
    profile(f"(b') evaluate_batch B={BATCH}, plan passed in",
            lambda: ev.evaluate_batch(batch, edges, plan=plan), card)
    profile("(c) evaluate kernels", lambda: kev.evaluate(pos, edges), card)
    epos, eedges = exact_inputs()
    xcfg = EvalConfig(radius=EXACT_RADIUS)
    for uk in (False, True):
        profile(f"(d) evaluate_exact use_kernels={uk}",
                lambda: evaluate_exact(epos, eedges, config=xcfg,
                                       use_kernels=uk), card)

    import warnings
    from repro_torch.core import (count_crossings_enhanced,
                                  count_occlusions_enhanced,
                                  crossing_angle_enhanced)
    from repro_torch.launch.serve import ReadabilityServer
    reqs = [(p, edges) for p in batch]
    server = ReadabilityServer(cfg)
    kserver = ReadabilityServer(dataclasses.replace(cfg, backend="kernels"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        xserver = ReadabilityServer(method="exact")
    profile(f"(e1) server fused, {BATCH} requests",
            lambda: server.evaluate_batch(reqs), card)
    span_split("(e1)", lambda: server.evaluate_batch(reqs))
    profile(f"(e2) server kernels, {BATCH} requests",
            lambda: kserver.evaluate_batch(reqs), card)
    profile("(e3) server method='exact'",
            lambda: xserver.evaluate(epos, eedges), card)
    profile("(e5) enhanced E_c + E_ca + N_c", lambda: (
        count_crossings_enhanced(pos, edges, n_strips=N_STRIPS),
        crossing_angle_enhanced(pos, edges, n_strips=N_STRIPS),
        count_occlusions_enhanced(pos, RADIUS)), card)
    drag_profile(cfg, pos, edges, card)
    search_profile(cfg, pos, edges, card)
    return 0


def search_profile(cfg, pos, edges, card):
    """(g1) and (g2): one search step each, from the search's own start
    (the same state every call)."""
    import torch
    from chip_smoke import (FR_BLOCK, FR_EDGES, FR_ITERS, FR_N, FR_N_STRIPS,
                            FR_SEARCH_RESTARTS, FR_SEARCH_STEPS, SEARCH_KNOBS,
                            search_opt)
    from repro_torch.api import EvalConfig
    from repro_torch.core import engine
    from repro_torch.graphs.datasets import random_edges
    from repro_torch.graphs.layouts import fruchterman_reingold, random_layout
    from repro_torch.optim import adamw
    from repro_torch.search import GradientSearch

    fr_edges = random_edges(FR_N, FR_EDGES, seed=0)
    fr_pos = fruchterman_reingold(random_layout(FR_N, seed=0), fr_edges,
                                  n_iter=FR_ITERS, block=FR_BLOCK)
    for label, gs, p0, e0 in (
            (f"(g1) search step, {FR_SEARCH_RESTARTS} restarts at |V| = "
             f"{FR_N}", GradientSearch(EvalConfig(n_strips=FR_N_STRIPS),
                                       steps=FR_SEARCH_STEPS,
                                       restarts=FR_SEARCH_RESTARTS),
             fr_pos.cpu().numpy(), fr_edges),
            (f"(g2) search step, {SEARCH_KNOBS['restarts']} restarts at |V| "
             f"= {pos.shape[0]}", GradientSearch(cfg, opt=search_opt(),
                                                 **SEARCH_KNOBS), pos, edges)):
        batch, e, _ = gs._init_batch(p0, e0)
        plan = engine.plan_readability(batch, e, **gs.config.plan_kwargs())
        opt = gs._resolve_opt(gs._extent(batch))
        p, e = engine.device_inputs(batch, e)
        state = adamw.init_state({"pos": p})
        tau = torch.full((), gs._temperature_at(0), device=p.device)
        profile(label, lambda: gs.step(plan, opt, p, state, e, tau), card)


def drag_profile(cfg, pos, edges, card, split_frames=20):
    """(f): a session dragging one vertex; each profiled call is one
    frame (a fresh target each time)."""
    from chip_smoke import drag_moves
    from repro_torch.launch.session import EvalSession
    v, targets = drag_moves(pos, frames=2 * RUNS + 1 + split_frames)
    sess = EvalSession(cfg, update_dirty_threshold=1.0)
    sess.register_layout("drag", pos, edges)
    moves = iter(targets)
    profile("(f) update, one dragged frame",
            lambda: sess.update("drag", [v], [next(moves)]), card)
    span_split("(f)", lambda: sess.update("drag", [v], [next(moves)]),
               calls=split_frames)
    stats = sess.stats
    print(f"    (f) updates {stats['updates']}, delta_hits "
          f"{stats['delta_hits']}, delta_fallbacks {stats['delta_fallbacks']}")


if __name__ == "__main__":
    sys.exit(main())
