"""One front door: config-driven readability evaluation on PyTorch
(counterpart of :mod:`repro.api`).

>>> from repro_torch.api import EvalConfig, Evaluator
>>> ev = Evaluator(EvalConfig(radius=0.5, n_strips=128))   # on CUDA
>>> scores = ev.evaluate(pos, edges)            # one layout
>>> batch = ev.evaluate_batch(batch_pos, edges) # B layouts, one pass
>>> scores.normalized()                         # [0, 1] readability view

>>> exact = evaluate_exact(pos, edges, config=EvalConfig(radius=0.5))

Backends served: ``"fused"`` (plan-cached session, shape-bucketed),
``"eager"`` (plan per call), ``"kernels"`` (flat strip buckets and the
exact all-pairs occlusion kernel), ``"distributed"`` (over a mesh of
``torch.distributed`` ranks: row-sharded N_c and strip-sharded E_c /
E_ca for one layout, the batch axis for a batch) and ``"graph_sharded"``
(each layout spatially partitioned over the mesh, through the session's
degradation ladder).  ``precision="bfloat16"`` evaluates in bfloat16
wherever the reference does (the single-layout ``"distributed"`` route
evaluates in float32, as the reference's does).
:meth:`Evaluator.register_layout` / :meth:`Evaluator.update` serve
dynamic layouts (incremental on ``"fused"``); :meth:`Evaluator.search`
runs the gradient layout search (:class:`SearchResult`, exact scores
only).  :func:`evaluator_for` is
the process-wide evaluator cache the deprecated shims map onto.
:func:`evaluate_exact` is the exact all-pairs reference path (paper
S3.1), the ground truth of the enhanced metrics.

**Device rule**: ``Evaluator(config, device=None)`` and
``evaluate_exact(..., device=None)`` run on CUDA and raise when no CUDA
device exists; pass ``device="cpu"`` to run on the CPU.  The device is
not a config field, so ``EvalConfig`` and its ``digest()`` are the
reference's.

**Ranks**: on the mesh backends every rank runs the same program on the
same inputs, one process per rank, and gets the same scores:

>>> import torch.distributed as dist
>>> dist.init_process_group("nccl", init_method="tcp://localhost:29500",
...                         rank=rank, world_size=world)   # each process
>>> ev = Evaluator(EvalConfig(backend="distributed"))      # serving_mesh()
>>> scores = ev.evaluate(pos, edges)
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.engine import ALL_METRICS  # noqa: F401  (re-export)
from repro_torch.core.keys import (EvalConfig, pow2_bucket,  # noqa: F401
                                   pow2_chunks, reset_deprecation_warnings,
                                   topology_hash)
from repro_torch.core.metrics import evaluate_exact  # noqa: F401
from repro_torch.core.scores import (ReadabilityScores,  # noqa: F401
                                     host_batch, scores_from_batch,
                                     scores_from_result)
from repro_torch.core.validate import (BackendUnavailableError,  # noqa: F401
                                       CancelledError, CapacityError,
                                       DeadlineExceededError,
                                       InvalidInputError, OverloadedError,
                                       ReadabilityError, validate_batch,
                                       validate_request)
from repro_torch.launch.admission import CancelToken  # noqa: F401
from repro_torch.launch.session import EvalSession
from repro_torch.search.gradient import GradientSearch, SearchResult
from repro_torch.spans import span

__all__ = [
    "ALL_METRICS", "BackendUnavailableError", "CancelToken",
    "CancelledError", "CapacityError", "DeadlineExceededError", "EvalConfig",
    "EvalSession", "Evaluator", "GradientSearch", "InvalidInputError",
    "OverloadedError", "ReadabilityError", "ReadabilityScores",
    "SearchResult", "evaluate_exact",
    "evaluator_for", "pow2_bucket", "pow2_chunks",
    "reset_deprecation_warnings", "scores_from_batch", "scores_from_result",
    "topology_hash", "validate_batch", "validate_request",
]

SERVED_BACKENDS = ("fused", "eager", "kernels", "distributed",
                   "graph_sharded")
# backends an EvalSession serves (the rest are served by the Evaluator)
SESSION_BACKENDS = ("fused", "kernels", "graph_sharded")


class Evaluator:
    """Config-bound readability evaluator: plan once, evaluate many.

    * :meth:`plan` -- host-side
      :class:`~repro_torch.core.engine.ReadabilityPlan` from concrete data.
    * :meth:`evaluate` -- one layout -> host
      :class:`~repro_torch.core.scores.ReadabilityScores`.  On the fused /
      kernels / graph_sharded backends an internal :class:`EvalSession`
      serves it (plan cache, pow2 shape buckets, auto-replan on overflow,
      and for graph_sharded the mesh rung with its fall-back to fused);
      ``backend="eager"`` plans per call; ``"distributed"`` runs
      :func:`~repro_torch.distributed.gridded.evaluate_sharded` over the
      mesh.
    * :meth:`evaluate_batch` -- ``(B, V, 2)`` candidate layouts of ONE
      graph in one batched pass -> batched host scores (``.unbatch()``);
      on ``"distributed"`` the batch axis splits over the mesh
      (:func:`~repro_torch.distributed.batched.evaluate_layouts_sharded`).
    * :meth:`register_layout` / :meth:`update` -- dynamic layouts: score
      once, then re-score small vertex moves.  ``"fused"`` re-derives only
      the dirty grid cells and strips (the bound session's resident state,
      :mod:`repro_torch.core.incremental`; integer metrics equal a
      from-scratch evaluation); ``"kernels"`` and ``"graph_sharded"``
      delegate to the session, which re-evaluates every update in full;
      ``"eager"`` and ``"distributed"`` keep the layout on the host and
      re-evaluate it in full.
    * :meth:`session` -- a fresh :class:`EvalSession` on the same config,
      device and mesh; ``**knobs`` are its serving-policy knobs, the
      overload knobs (``max_queue``, ``default_deadline``,
      ``dispatch_timeout``, ``probe_interval``, ...) included.
    * :meth:`search` -- gradient-guided layout search from a seed layout
      (:class:`~repro_torch.search.gradient.GradientSearch` on this
      config, device and mesh).

    ``mesh`` is the :class:`~repro_torch.distributed.compat.Mesh` of the
    mesh backends; without one they bring one up on first use
    (:meth:`_mesh`, the serving policy
    :func:`~repro_torch.launch.elastic.serving_mesh`, capped by
    ``EvalConfig.shards``).  With a mesh, ``device`` defaults to
    ``mesh.device``.
    """

    def __init__(self, config: EvalConfig = None, *, mesh=None, device=None,
                 cache_size: int = 128, vertex_floor: int = 128,
                 edge_floor: int = 128, max_coalesce: int = 32,
                 update_dirty_threshold: float = 0.25):
        self.config = config if config is not None else EvalConfig()
        if self.config.backend not in SERVED_BACKENDS:
            raise NotImplementedError(
                f"backend={self.config.backend!r} is not ported to "
                f"repro_torch yet; served: {SERVED_BACKENDS}")
        if device is None and mesh is not None:
            device = mesh.device
        self.device = engine.resolve_device(device)
        self.mesh = mesh
        self._session = None
        self._session_knobs = dict(cache_size=cache_size,
                                   vertex_floor=vertex_floor,
                                   edge_floor=edge_floor,
                                   max_coalesce=max_coalesce,
                                   update_dirty_threshold=update_dirty_threshold)
        # dynamic layouts on the eager and distributed backends: (pos,
        # edges) per layout id, every update a full re-evaluation (the
        # incremental path needs the session's resident state)
        self._layouts = {}

    def __repr__(self):
        return f"Evaluator({self.config!r}, device={str(self.device)!r})"

    def plan(self, pos, edges) -> engine.ReadabilityPlan:
        """Host-side plan for ``pos`` ((V, 2) or a (B, V, 2) batch)."""
        return engine.plan_readability(pos, edges,
                                       **self.config.plan_kwargs())

    def session(self, **knobs) -> EvalSession:
        """A fresh serving session bound to this config, device and mesh
        (a session with a mesh shards coalesced batches over it)."""
        return EvalSession(self.config, device=self.device,
                           **{"mesh": self.mesh, **self._session_knobs,
                              **knobs})

    def _bound_session(self) -> EvalSession:
        if self._session is None:
            self._session = self.session()
        return self._session

    def _mesh(self):
        """This evaluator's mesh, brought up on first use by the serving
        policy (every rank of the default group, capped by
        ``EvalConfig.shards``, trimmed to a power of two)."""
        if self.mesh is None:
            from repro_torch.launch.elastic import serving_mesh
            self.mesh = serving_mesh("eval", shards=self.config.shards,
                                     device=self.device)
        return self.mesh

    def evaluate(self, pos, edges) -> ReadabilityScores:
        """Score one layout; returns host scores (one copy).  Requests are
        checked per ``EvalConfig.validation`` on every backend."""
        backend = self.config.backend
        if backend in SESSION_BACKENDS:
            return self._bound_session().evaluate(pos, edges)
        pos, edges, flags = validate_request(
            pos, edges, mode=self.config.validation)
        pos = np.asarray(pos, np.float32)
        edges = np.asarray(edges, np.int32)
        n_v, n_e = pos.shape[0], edges.shape[0]
        if backend == "distributed" and n_v > 0 and n_e > 0:
            from repro_torch.distributed.gridded import evaluate_sharded
            scores = evaluate_sharded(self._mesh(), pos, edges,
                                      config=self.config)
            return scores if flags is None else scores._replace(flags=flags)
        # eager (and a degenerate distributed request, where a mesh buys
        # nothing): plan from the concrete layout (flat strips) and run
        # the fused program once.  Degenerate requests (V=0 / E=0) pad to
        # one row and mask it via the n_valid scalars.
        plan = engine.plan_readability(
            pos, edges, **self.config.plan_kwargs(tier_default=False))
        valid = {}
        if n_v == 0 or n_e == 0:
            pos, edges = _pad_degenerate(pos[None], edges)
            pos = pos[0]
            valid = dict(n_valid_vertices=n_v, n_valid_edges=n_e)
        res = engine.evaluate_once(plan, pos, edges,
                                   use_kernels=self.config.use_kernels,
                                   device=self.device, **valid)
        scores = scores_from_result(res, n_v, n_e)
        return scores if flags is None else scores._replace(flags=flags)

    # -- dynamic layouts (incremental re-evaluation) ------------------------

    def register_layout(self, layout_id, pos, edges) -> ReadabilityScores:
        """Register a dynamic layout for :meth:`update` streams: validate
        and evaluate ``pos`` once and return its scores.  On the session
        backends the bound :class:`EvalSession` also primes the resident
        partials (``"fused"``); on ``"eager"`` and ``"distributed"`` the
        layout is kept on the host and every update is a full
        re-evaluation."""
        if self.config.backend in SESSION_BACKENDS:
            return self._bound_session().register_layout(layout_id, pos,
                                                         edges)
        scores = self.evaluate(pos, edges)
        self._layouts[layout_id] = (np.array(pos, np.float32, copy=True),
                                    np.array(edges, np.int32, copy=True))
        return scores

    def update(self, layout_id, moved_idx, new_pos) -> ReadabilityScores:
        """Move ``moved_idx`` of a registered layout to ``new_pos`` and
        re-score.  Session backends route through
        :meth:`EvalSession.update` (incremental when the dirty set is
        small; ``scores.flags["incremental"]`` certifies the path taken);
        ``"eager"`` and ``"distributed"`` re-evaluate in full."""
        if self.config.backend in SESSION_BACKENDS:
            return self._bound_session().update(layout_id, moved_idx,
                                                new_pos)
        if layout_id not in self._layouts:
            raise KeyError(f"unknown layout_id {layout_id!r}; "
                           "register_layout() first")
        pos, edges = self._layouts[layout_id]
        moved = np.asarray(moved_idx, np.int64).reshape(-1)
        new_xy = np.asarray(new_pos, np.float32).reshape(-1, 2)
        if moved.size == 0 or moved.size != new_xy.shape[0]:
            raise InvalidInputError(
                "update wants matching non-empty moved_idx / new_pos; "
                f"got {moved.size} indices, {new_xy.shape[0]} positions")
        if self.config.validation != "off":
            if moved.min(initial=0) < 0 or \
                    moved.max(initial=-1) >= pos.shape[0]:
                raise InvalidInputError(
                    f"moved_idx out of range for {pos.shape[0]} vertices")
            if not np.isfinite(new_xy).all():
                raise InvalidInputError("non-finite new_pos in update")
        pos[moved] = new_xy
        return self.evaluate(pos, edges)

    def evaluate_batch(self, batch_pos, edges, *,
                       plan: engine.ReadabilityPlan = None
                       ) -> ReadabilityScores:
        """Score ``(B, V, 2)`` candidate layouts of one graph in one
        batched pass; returns batched host scores (numpy ``(B,)`` fields,
        ``.unbatch()`` for per-layout scores).  Plans from the whole batch
        when ``plan`` is omitted -- hot loops should plan once and pass
        it in."""
        with span("batch"):
            batch_pos = np.asarray(batch_pos, np.float32)
            edges = np.asarray(edges, np.int32)
            if batch_pos.ndim != 3:
                raise ValueError("evaluate_batch wants a (B, V, 2) batch; "
                                 f"got shape {batch_pos.shape}")
            with span("batch.validate"):
                batch_pos, edges, flags = validate_batch(
                    batch_pos, edges, mode=self.config.validation)
            n_v, n_e = batch_pos.shape[1], edges.shape[0]
            backend = self.config.backend
            degenerate = n_v == 0 or n_e == 0
            if backend == "graph_sharded" and not degenerate:
                # spatial partitioning is per layout: each member is the
                # sharded unit, so the batch axis is a loop of graph-sharded
                # dispatches on one flat plan (every rank sweeps the flat top
                # capacity)
                from repro_torch.distributed.graph_sharded import \
                    evaluate_graph_sharded
                if plan is None:
                    with span("batch.plan"):
                        plan = engine.plan_readability(
                            batch_pos, edges,
                            **self.config.plan_kwargs(tier_default=False))
                results = [evaluate_graph_sharded(self._mesh(), plan, member,
                                                  edges)
                           for member in batch_pos]
                res = ReadabilityScores(*(
                    None if results[0][k] is None
                    else torch.stack([r[k] for r in results])
                    for k in range(len(ReadabilityScores._fields))))
                return host_batch(res, n_v, n_e, flags)
            if plan is None:
                with span("batch.plan"):
                    plan = self.plan(batch_pos, edges)
            if backend == "distributed" and not degenerate:
                from repro_torch.distributed.batched import \
                    evaluate_layouts_sharded
                res = evaluate_layouts_sharded(self._mesh(), plan, batch_pos,
                                               edges)
                return host_batch(res, n_v, n_e, flags)
            valid = {}
            if degenerate:
                # pad to the engine's one-row minimum and mask the padding;
                # a mesh buys nothing at this size
                batch_pos, edges = _pad_degenerate(batch_pos, edges)
                valid = dict(n_valid_vertices=n_v, n_valid_edges=n_e)
            res = engine.evaluate_layouts(plan, batch_pos, edges,
                                          use_kernels=self.config.use_kernels,
                                          device=self.device, **valid)
            return host_batch(res, n_v, n_e, flags)

    # -- search -------------------------------------------------------------

    def search(self, pos0, edges, **knobs) -> SearchResult:
        """Gradient-guided layout search from ``pos0`` under this config's
        metric subset and geometry, on this evaluator's device.

        ``pos0`` is a ``(V, 2)`` seed layout (jittered into ``restarts``
        parallel starts) or an explicit ``(B, V, 2)`` restart batch;
        ``knobs`` are :class:`~repro_torch.search.gradient.GradientSearch`
        keywords (``steps``, ``restarts``, ``rescore_every``, ``opt``,
        ``weights``, ``temperature``, ...).  Returns a
        :class:`SearchResult` of exact scores; ``result.best_positions``
        is the winning layout.  On ``"distributed"`` each step splits the
        restarts over this evaluator's mesh."""
        knobs.setdefault("device", self.device)
        knobs.setdefault("mesh", self.mesh)
        return GradientSearch(self.config, **knobs).run(pos0, edges)


def _pad_degenerate(batch_pos, edges):
    """Pad a V=0 / E=0 request to the engine's one-row minimum."""
    B, n_v = batch_pos.shape[0], batch_pos.shape[1]
    n_e = edges.shape[0]
    pos_p = np.zeros((B, max(n_v, 1), 2), np.float32)
    pos_p[:, :n_v] = batch_pos
    edges_p = np.zeros((max(n_e, 1), 2), np.int32)
    edges_p[:n_e] = edges
    return pos_p, edges_p


# ---------------------------------------------------------------------------
# the shared evaluator cache (what the deprecated kwarg mirrors map onto)
# ---------------------------------------------------------------------------

_EVALUATORS: "OrderedDict[tuple, Evaluator]" = OrderedDict()
_EVALUATOR_CACHE_SIZE = 64


def evaluator_for(config: EvalConfig, *, device=None) -> Evaluator:
    """The process-wide :class:`Evaluator` for ``config`` on ``device``.

    Keyed by the (frozen, canonicalized) config and the device, so every
    old call site that spells the same configuration shares one evaluator
    and one plan cache.  A small LRU: configs are few, and the plans
    inside each evaluator's session have their own LRU."""
    key = (config, engine.resolve_device(device))
    ev = _EVALUATORS.get(key)
    if ev is None:
        ev = _EVALUATORS[key] = Evaluator(config, device=key[1])
    _EVALUATORS.move_to_end(key)
    while len(_EVALUATORS) > _EVALUATOR_CACHE_SIZE:
        _EVALUATORS.popitem(last=False)
    return ev
