"""One front door: config-driven readability evaluation on PyTorch
(counterpart of :mod:`repro.api`).

>>> from repro_torch.api import EvalConfig, Evaluator
>>> ev = Evaluator(EvalConfig(radius=0.5, n_strips=128))   # on CUDA
>>> scores = ev.evaluate(pos, edges)            # one layout
>>> batch = ev.evaluate_batch(batch_pos, edges) # B layouts, one pass
>>> scores.normalized()                         # [0, 1] readability view

>>> exact = evaluate_exact(pos, edges, config=EvalConfig(radius=0.5))

Backends served: ``"fused"`` (plan-cached session, shape-bucketed),
``"eager"`` (plan per call) and ``"kernels"`` (flat strip buckets and the
exact all-pairs occlusion kernel).  ``"distributed"``,
``"graph_sharded"`` and ``precision="bfloat16"`` are accepted by
:class:`EvalConfig` (its digest needs them) but raise
``NotImplementedError`` here, as do ``register_layout`` / ``update`` /
``search``: they are still to port.  :func:`evaluator_for` is the
process-wide evaluator cache the deprecated shims map onto.  :func:`evaluate_exact` is the exact
all-pairs reference path (paper S3.1), the ground truth of the enhanced
metrics.

**Device rule**: ``Evaluator(config, device=None)`` and
``evaluate_exact(..., device=None)`` run on CUDA and raise when no CUDA
device exists; pass ``device="cpu"`` to run on the CPU.  The device is
not a config field, so ``EvalConfig`` and its ``digest()`` are the
reference's.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

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

__all__ = [
    "ALL_METRICS", "BackendUnavailableError", "CancelToken",
    "CancelledError", "CapacityError", "DeadlineExceededError", "EvalConfig",
    "EvalSession", "Evaluator", "InvalidInputError", "OverloadedError",
    "ReadabilityError", "ReadabilityScores", "evaluate_exact",
    "evaluator_for", "pow2_bucket", "pow2_chunks",
    "reset_deprecation_warnings", "scores_from_batch", "scores_from_result",
    "topology_hash", "validate_batch", "validate_request",
]

SERVED_BACKENDS = ("fused", "eager", "kernels")


class Evaluator:
    """Config-bound readability evaluator: plan once, evaluate many.

    * :meth:`plan` -- host-side
      :class:`~repro_torch.core.engine.ReadabilityPlan` from concrete data.
    * :meth:`evaluate` -- one layout -> host
      :class:`~repro_torch.core.scores.ReadabilityScores`.  On the fused /
      kernels backends an internal :class:`EvalSession` serves it (plan
      cache, pow2 shape buckets, auto-replan on overflow);
      ``backend="eager"`` plans per call.
    * :meth:`evaluate_batch` -- ``(B, V, 2)`` candidate layouts of ONE
      graph in one batched pass -> batched host scores (``.unbatch()``).
    * :meth:`session` -- a fresh :class:`EvalSession` on the same config
      and device; ``**knobs`` are its serving-policy knobs, the overload
      knobs (``max_queue``, ``default_deadline``, ``dispatch_timeout``,
      ...) included.
    """

    def __init__(self, config: EvalConfig = None, *, device=None,
                 cache_size: int = 128, vertex_floor: int = 128,
                 edge_floor: int = 128, max_coalesce: int = 32):
        self.config = config if config is not None else EvalConfig()
        if self.config.backend not in SERVED_BACKENDS:
            raise NotImplementedError(
                f"backend={self.config.backend!r} is not ported to "
                f"repro_torch yet; served: {SERVED_BACKENDS}")
        if self.config.precision != "float32":
            raise NotImplementedError(
                f"precision={self.config.precision!r} is not ported to "
                "repro_torch yet; it evaluates in float32")
        self.device = engine.resolve_device(device)
        self._session = None
        self._session_knobs = dict(cache_size=cache_size,
                                   vertex_floor=vertex_floor,
                                   edge_floor=edge_floor,
                                   max_coalesce=max_coalesce)

    def __repr__(self):
        return f"Evaluator({self.config!r}, device={str(self.device)!r})"

    def plan(self, pos, edges) -> engine.ReadabilityPlan:
        """Host-side plan for ``pos`` ((V, 2) or a (B, V, 2) batch)."""
        return engine.plan_readability(pos, edges,
                                       **self.config.plan_kwargs())

    def session(self, **knobs) -> EvalSession:
        """A fresh serving session bound to this config and device."""
        return EvalSession(self.config, device=self.device,
                           **{**self._session_knobs, **knobs})

    def _bound_session(self) -> EvalSession:
        if self._session is None:
            self._session = self.session()
        return self._session

    def evaluate(self, pos, edges) -> ReadabilityScores:
        """Score one layout; returns host scores (one copy).  Requests are
        checked per ``EvalConfig.validation`` on every backend."""
        if self.config.backend in ("fused", "kernels"):
            return self._bound_session().evaluate(pos, edges)
        pos, edges, flags = validate_request(
            pos, edges, mode=self.config.validation)
        pos = np.asarray(pos, np.float32)
        edges = np.asarray(edges, np.int32)
        n_v, n_e = pos.shape[0], edges.shape[0]
        # eager: plan from the concrete layout (flat strips) and run the
        # fused program once.  Degenerate requests (V=0 / E=0) pad to one
        # row and mask it via the n_valid scalars.
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

    def evaluate_batch(self, batch_pos, edges, *,
                       plan: engine.ReadabilityPlan = None
                       ) -> ReadabilityScores:
        """Score ``(B, V, 2)`` candidate layouts of one graph in one
        batched pass; returns batched host scores (numpy ``(B,)`` fields,
        ``.unbatch()`` for per-layout scores).  Plans from the whole batch
        when ``plan`` is omitted -- hot loops should plan once and pass
        it in."""
        batch_pos = np.asarray(batch_pos, np.float32)
        edges = np.asarray(edges, np.int32)
        if batch_pos.ndim != 3:
            raise ValueError("evaluate_batch wants a (B, V, 2) batch; "
                             f"got shape {batch_pos.shape}")
        batch_pos, edges, flags = validate_batch(
            batch_pos, edges, mode=self.config.validation)
        n_v, n_e = batch_pos.shape[1], edges.shape[0]
        if plan is None:
            plan = self.plan(batch_pos, edges)
        valid = {}
        if n_v == 0 or n_e == 0:
            batch_pos, edges = _pad_degenerate(batch_pos, edges)
            valid = dict(n_valid_vertices=n_v, n_valid_edges=n_e)
        res = engine.evaluate_layouts(plan, batch_pos, edges,
                                      use_kernels=self.config.use_kernels,
                                      device=self.device, **valid)
        return host_batch(res, n_v, n_e, flags)


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
