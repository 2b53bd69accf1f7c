"""Serving driver: batched readability evaluation on one device
(counterpart of :mod:`repro.launch.serve`).

The paper's system is an evaluation service: graph layouts come in,
readability scores go out.  :class:`ReadabilityServer` is that service, a
thin front over :class:`repro_torch.launch.session.EvalSession`,
configured by ONE frozen :class:`~repro_torch.core.keys.EvalConfig`:

* ``backend="fused"`` / ``"kernels"`` (default ``"fused"``): plan cache
  per (topology, shape bucket, config), pow2 request padding, same-bucket
  coalescing into batched engine calls, bounded replan on overflow, and
  the session's fault layer (admission, deadlines, cancellation, the
  watchdog, dispatch splitting); ``stats`` shows the counters.
* ``backend="eager"``: per-request plan and evaluation, the honest
  baseline.

The old ``ReadabilityServer(method=..., n_strips=..., ...)`` kwarg mirror
stays as a deprecation shim mapping onto ``EvalConfig``
(``method="session"`` -> fused backend, ``"enhanced"`` -> eager backend,
``"exact"`` -> the all-pairs reference path).

:func:`lm_generate` is the LM family's serving loop (prefill, then
greedy decode).

The server runs on CUDA unless ``device="cpu"`` is passed::

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 8
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.api import Evaluator
from repro_torch.core import engine
from repro_torch.core.keys import EvalConfig, warn_once
from repro_torch.core.metrics import evaluate_exact
from repro_torch.core.scores import ReadabilityScores, scores_from_result
from repro_torch.launch.session import EvalSession

# the server's historical default strip count (finer than the engine's
# 64: serving traffic skews larger than unit-test graphs)
DEFAULT_N_STRIPS = 256

_LEGACY_EVAL_KWARGS = ("radius", "ideal_angle", "metrics", "orientation",
                       "use_kernels", "n_strips", "tier_strips")


class ReadabilityServer:
    """Batched readability evaluation with plan caching and shape
    bucketing.

    ``ReadabilityServer(config)`` is the canonical constructor; the
    keyword knobs (``cache_size``, ``vertex_floor``, ``edge_floor``,
    ``max_coalesce``, and the overload knobs ``max_queue``,
    ``max_queue_cost``, ``default_deadline``, ``dispatch_timeout``,
    ``probe_interval``, see :class:`EvalSession`) are serving policy.
    ``device=None`` runs on CUDA and raises without one.  Requests are
    ``(pos, edges)`` pairs.
    """

    def __init__(self, config: EvalConfig = None, *, method: str = None,
                 device=None, cache_size: int = 128,
                 vertex_floor: int = 128, edge_floor: int = 128,
                 max_coalesce: int = 32, max_queue: int = None,
                 max_queue_cost: int = None, default_deadline: float = None,
                 dispatch_timeout: float = None, probe_interval: int = 8,
                 **legacy_kwargs):
        if isinstance(config, str):   # old positional method argument
            method, config = config, None
        self._exact = False
        self._fallback_kernels = False
        if method is not None or legacy_kwargs:
            if config is not None:
                raise TypeError("pass either an EvalConfig or the legacy "
                                "method=/kwarg mirror, not both")
            bad = sorted(set(legacy_kwargs) - set(_LEGACY_EVAL_KWARGS))
            if bad:
                raise TypeError(f"unknown ReadabilityServer kwargs: {bad}")
            warn_once(
                "ReadabilityServer method",
                "ReadabilityServer(method=..., n_strips=..., ...) is "
                "deprecated: pass ReadabilityServer(EvalConfig(...)) — "
                "method='session' maps to backend='fused', 'enhanced' to "
                "backend='eager', 'exact' to the all-pairs reference")
            method = method or "session"
            legacy_kwargs.setdefault("n_strips", DEFAULT_N_STRIPS)
            if method == "session":
                config = EvalConfig.from_legacy(**legacy_kwargs)
            else:
                self._exact = method == "exact"
                self._fallback_kernels = bool(
                    legacy_kwargs.pop("use_kernels", False))
                config = EvalConfig.from_legacy(backend="eager",
                                                **legacy_kwargs)
        self.config = config if config is not None else \
            EvalConfig(n_strips=DEFAULT_N_STRIPS)
        self.device = engine.resolve_device(device)
        self.method = ("exact" if self._exact else
                       "session" if self.config.backend in ("fused",
                                                            "kernels")
                       else "enhanced")
        self.session = (EvalSession(self.config, device=self.device,
                                    cache_size=cache_size,
                                    vertex_floor=vertex_floor,
                                    edge_floor=edge_floor,
                                    max_coalesce=max_coalesce,
                                    max_queue=max_queue,
                                    max_queue_cost=max_queue_cost,
                                    default_deadline=default_deadline,
                                    dispatch_timeout=dispatch_timeout,
                                    probe_interval=probe_interval)
                        if self.method == "session" else None)
        self._evaluator = None
        self._stats = {"requests": 0, "evals": 0}

    @property
    def stats(self):
        """Request counters, merged with the session's plan-cache,
        coalescing, replan and fault-layer counters."""
        s = dict(self._stats)
        if self.session is not None:
            s.update(self.session.stats)
            s["plan_cache_entries"] = len(self.session.plans)
            s["plan_cache_evictions"] = self.session.plans.evictions
        return s

    def _eager_evaluate(self, pos, edges):
        if self._exact:
            return evaluate_exact(pos, edges, config=self.config,
                                  use_kernels=self._fallback_kernels,
                                  device=self.device)
        if self._fallback_kernels:
            # legacy method="enhanced" + use_kernels=True: an eager
            # backend cannot spell kernel routing in the config, so run the
            # engine directly (flat plan per call, flat-bucket sweeps and
            # the all-pairs occlusion count)
            plan = engine.plan_readability(
                pos, edges, **self.config.plan_kwargs(tier_default=False))
            res = engine.evaluate_once(plan, pos, edges, use_kernels=True,
                                       device=self.device)
            return scores_from_result(res, pos.shape[0], edges.shape[0])
        if self._evaluator is None:
            self._evaluator = Evaluator(self.config, device=self.device)
        return self._evaluator.evaluate(pos, edges)

    def evaluate(self, pos, edges) -> ReadabilityScores:
        return self.evaluate_batch([(pos, edges)])[0]

    def evaluate_batch(self, requests, *, deadline=None, cancel=None):
        """Evaluate a list of ``(pos, edges)`` requests.  ``deadline`` /
        ``cancel`` ride through to :meth:`EvalSession.evaluate_batch`
        (session-backed configs only: the eager and exact paths have no
        queue to bound)."""
        self._stats["requests"] += len(requests)
        if self.session is not None:
            reports = self.session.evaluate_batch(requests,
                                                  deadline=deadline,
                                                  cancel=cancel)
        else:
            if deadline is not None or cancel is not None:
                raise ValueError(
                    "deadline/cancel need the session-backed server "
                    "(backend='fused'/'kernels'); the eager and exact "
                    "paths evaluate inline with no queue")
            reports = [
                self._eager_evaluate(np.asarray(pos, np.float32),
                                     np.asarray(edges, np.int32))
                for pos, edges in requests]
        self._stats["evals"] += len(requests)
        return reports


def lm_generate(model, prompt_tokens, n_new: int):
    """Prefill, then a greedy decode loop: the ``n_new`` tokens that
    :class:`~repro_torch.models.transformer.Transformer` ``model`` emits
    after ``prompt_tokens`` ``(B, S)``, as ``(B, n_new)`` int32 (the
    reference's ``lm_generate``; the module carries the config the
    reference passes beside its parameters)."""
    import torch

    tokens = torch.as_tensor(prompt_tokens, device=model.device)
    B, S = tokens.shape
    cache = model.init_cache(B, S + n_new)
    cache, logits = model.prefill(tokens, cache)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [nxt]
    for _ in range(n_new - 1):
        nxt, _, cache = model.decode_step(nxt, cache)
        out.append(nxt)
    return torch.stack(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--backend", default="fused",
                    choices=("fused", "eager", "kernels"),
                    help="EvalConfig backend: 'fused' is the plan-cached "
                         "session path, 'eager' the per-request baseline")
    ap.add_argument("--metrics", default="all",
                    help="comma-separated metric subset, or 'all'")
    ap.add_argument("--rounds", type=int, default=2,
                    help="times the request stream repeats (round 2+ is "
                         "the steady state: all plans cached)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    args = ap.parse_args(argv)

    from repro_torch.graphs.datasets import random_edges
    from repro_torch.graphs.layouts import random_layout

    metrics = (engine.ALL_METRICS if args.metrics == "all"
               else tuple(args.metrics.split(",")))
    config = EvalConfig(n_strips=DEFAULT_N_STRIPS, backend=args.backend,
                        metrics=metrics)
    server = ReadabilityServer(config, device=args.device)
    rounds = max(args.rounds, 1)
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        n_v = int(rng.integers(100, 400))
        n_e = 2 * n_v
        reqs.append((random_layout(n_v, seed=i), random_edges(n_v, n_e,
                                                              seed=i)))
    t0 = time.time()
    for r in range(rounds):
        reports = server.evaluate_batch(
            [(pos + rng.normal(0, 0.1, pos.shape).astype(np.float32), e)
             for pos, e in reqs] if r else reqs)
    dt = time.time() - t0
    for i, r in enumerate(reports):
        parts = [f"req {i}:"]
        for name, fmt in (("node_occlusion", "N_c={}"),
                          ("edge_crossing", "E_c={}")):
            if getattr(r, name) is not None:
                parts.append(fmt.format(getattr(r, name)))
        for name, fmt in (("minimum_angle", "M_a={:.3f}"),
                          ("edge_length_variation", "M_l={:.3f}"),
                          ("edge_crossing_angle", "E_ca={:.3f}")):
            if getattr(r, name) is not None:
                parts.append(fmt.format(getattr(r, name)))
        print(" ".join(parts))
    n_total = args.requests * rounds
    print(f"config: backend={config.backend} metrics={config.metrics} "
          f"digest={config.digest()} device={server.device}")
    print(f"{n_total} requests in {dt:.2f}s "
          f"({dt / n_total * 1e3:.0f} ms/req incl. the first round's "
          "planning)")
    stats = server.stats
    if "plan_hits" in stats:
        print(f"stats: plan_hits={stats['plan_hits']} "
              f"plan_misses={stats['plan_misses']} "
              f"dispatches={stats['dispatches']} "
              f"coalesced={stats['coalesced']} "
              f"replans={stats['replans']} "
              f"cache_entries={stats['plan_cache_entries']}")


if __name__ == "__main__":
    main()
