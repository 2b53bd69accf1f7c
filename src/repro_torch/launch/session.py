"""Serving session core: plan cache, padded shape buckets, coalescing and
the bounded auto-replan (counterpart of :mod:`repro.launch.session`).

A request is ``(pos, edges)``; the session turns a stream of them into a
small number of engine dispatches::

  request --> validate (:func:`repro_torch.core.validate.validate_request`;
              a malformed request is quarantined to its own slot)
          --> pow2 shape buckets (V, E rounded up by
              :func:`repro_torch.core.keys.pow2_bucket`, padded vertices
              parked at :data:`PARK`, padded edges masked on the device)
          --> :class:`PlanCache` LRU [(topology, buckets, EvalConfig)
              -> ReadabilityPlan], flat strips
          --> same-key requests coalesced into ``(B, V_pad, 2)`` chunks of
              descending pow2 width --> ONE batched engine call each
          --> :class:`~repro_torch.core.scores.ReadabilityScores` per request

A dispatch whose result overflows the plan's capacities replans with
multiplicative growth at most ``max_replan_retries`` times; a result that
still overflows surfaces :class:`~repro_torch.core.validate.CapacityError`
(strict) or a ``saturated`` flag (sanitize) instead of an under-count.

Not ported yet (the reference's fault layer): admission control,
deadlines, cancellation, the hung-dispatch watchdog, dispatch splitting,
the circuit breaker and mesh ladder, fault injection, and the
incremental ``register_layout`` / ``update`` path.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np

from repro_torch.core import engine
from repro_torch.core.keys import EvalConfig, pow2_bucket, topology_hash
from repro_torch.core.scores import (error_scores, scores_from_batch,
                                     scores_from_result)
from repro_torch.core.validate import (CapacityError, InvalidInputError,
                                       validate_request)

# Park coordinate for padded tail vertices, far outside any real layout
# extent; correctness rests on the n_valid masks, not on this value.
PARK = -1.0e6


class PlanCache:
    """Thread-safe LRU cache of ReadabilityPlans keyed by ``(topology
    hash, vertex bucket, edge bucket, EvalConfig)``."""

    def __init__(self, capacity: int = 128):
        self.capacity = int(capacity)
        self._entries: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, key):
        with self._lock:
            plan = self._entries.get(key)
            if plan is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return plan

    def put(self, key, plan) -> None:
        with self._lock:
            self._entries[key] = plan
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1


class EvalSession:
    """Plan-caching, shape-bucketing, request-coalescing evaluator on one
    device.

    ``device=None`` runs on CUDA and raises when there is none (pass
    ``device="cpu"`` for the CPU).  The keyword knobs are serving policy:
    cache size, padding floors, coalescing width and the replan bounds.
    """

    def __init__(self, config: EvalConfig = None, *, device=None,
                 cache_size: int = 128, vertex_floor: int = 128,
                 edge_floor: int = 128, max_coalesce: int = 32,
                 max_replan_retries: int = 2, replan_growth: float = 1.5,
                 growth_ceiling: float = 4.0):
        self.config = config if config is not None else EvalConfig()
        if self.config.backend not in ("fused", "kernels"):
            raise NotImplementedError(
                "repro_torch's EvalSession serves the 'fused' and 'kernels' "
                f"backends; got {self.config.backend!r}")
        if self.config.precision != "float32":
            raise NotImplementedError(
                f"precision={self.config.precision!r} is not ported yet")
        self.device = engine.resolve_device(device)
        self.vertex_floor = int(vertex_floor)
        self.edge_floor = int(edge_floor)
        self.max_coalesce = int(max_coalesce)
        self.max_replan_retries = int(max_replan_retries)
        self.replan_growth = float(replan_growth)
        self.growth_ceiling = float(growth_ceiling)
        self.plans = PlanCache(cache_size)
        self._stats = {"requests": 0, "dispatches": 0, "coalesced": 0,
                       "replans": 0, "quarantined": 0, "sanitized": 0,
                       "saturated": 0}

    @property
    def stats(self):
        """Counter snapshot; plan_hits/plan_misses come from the
        :class:`PlanCache`."""
        s = dict(self._stats)
        s["plan_hits"] = self.plans.hits
        s["plan_misses"] = self.plans.misses
        return s

    # -- request preparation ------------------------------------------------

    def _prepare(self, index, pos, edges):
        """Validate, pad, and key one request (raises
        :class:`InvalidInputError`; the caller quarantines it)."""
        pos, edges, flags = validate_request(
            pos, edges, mode=self.config.validation, index=index)
        if flags:
            self._stats["sanitized"] += 1
        pos = np.asarray(pos, np.float32)
        edges = np.asarray(edges, np.int32)
        n_v, n_e = pos.shape[0], edges.shape[0]
        vb = pow2_bucket(n_v, self.vertex_floor)
        eb = pow2_bucket(n_e, self.edge_floor)
        pos_p = np.full((vb, 2), PARK, np.float32)
        pos_p[:n_v] = pos
        edges_p = np.zeros((eb, 2), np.int32)
        edges_p[:n_e] = edges
        key = (topology_hash(edges, n_v), vb, eb, self.config)
        return key, dict(index=index, pos=pos, edges=edges, pos_p=pos_p,
                         edges_p=edges_p, n_v=n_v, n_e=n_e, flags=flags)

    def _plan_for(self, key, member):
        plan = self.plans.get(key)
        if plan is not None:
            return plan
        # serving plans use the flat strip capacity unless the config
        # says otherwise: its uniform headroom absorbs drifting traffic
        plan = engine.plan_readability(
            member["pos"], member["edges"],
            **self.config.plan_kwargs(tier_default=False))
        self.plans.put(key, plan)
        return plan

    # -- dispatch -----------------------------------------------------------

    def _dispatch(self, plan, chunk):
        """One engine call for a same-key chunk -> list of host scores."""
        self._stats["dispatches"] += 1
        n_v, n_e = chunk[0]["n_v"], chunk[0]["n_e"]
        use_kernels = self.config.use_kernels
        if len(chunk) == 1:
            res = engine.evaluate_planned(
                plan, chunk[0]["pos_p"], chunk[0]["edges_p"], n_v, n_e,
                use_kernels=use_kernels, device=self.device)
            return [scores_from_result(res, n_v, n_e)]
        self._stats["coalesced"] += len(chunk)
        batch = np.stack([c["pos_p"] for c in chunk])
        res = engine.evaluate_layouts(
            plan, batch, chunk[0]["edges_p"], n_v, n_e,
            use_kernels=use_kernels, device=self.device)
        return scores_from_batch(res, n_v, n_e)

    def _run_chunk(self, key, plan, chunk, out):
        """Dispatch one chunk with the bounded replan backoff on overflow
        and the strict/sanitize saturation contract."""
        reports = self._dispatch(plan, chunk)
        attempt = 0
        worst = max(range(len(reports)), key=lambda i: reports[i].overflow)
        while (reports[worst].overflow > 0
               and attempt < self.max_replan_retries):
            # grow the plan from the worst offender's concrete data with
            # multiplicative backoff, and keep it for future traffic
            attempt += 1
            self._stats["replans"] += 1
            growth = min(self.replan_growth ** attempt, self.growth_ceiling)
            plan = engine.replan_on_overflow(
                plan, chunk[worst]["pos"], chunk[worst]["edges"],
                reports[worst], growth=growth)
            self.plans.put(key, plan)
            reports = self._dispatch(plan, chunk)
            worst = max(range(len(reports)),
                        key=lambda i: reports[i].overflow)

        mode = self.config.validation
        for member, report in zip(chunk, reports):
            if report.overflow > 0 and mode != "off":
                # the bounded retries could not cover this layout: never
                # return silently under-counted metrics
                self._stats["saturated"] += 1
                if mode == "strict":
                    report = error_scores(
                        CapacityError(
                            "plan capacities still overflowed after "
                            f"{self.max_replan_retries} replan retries "
                            f"({int(report.overflow)} dropped items)",
                            request_index=member["index"],
                            overflow=int(report.overflow)),
                        member["n_v"], member["n_e"])
                else:
                    merged = dict(report.flags or {})
                    merged["saturated"] = True
                    report = report._replace(flags=merged)
            if member["flags"]:
                merged = dict(report.flags or {})
                merged.update(member["flags"])
                report = report._replace(flags=merged)
            out[member["index"]] = report
        return plan

    # -- public API ---------------------------------------------------------

    def evaluate(self, pos, edges):
        """One request -> one :class:`ReadabilityScores`; a quarantined
        request re-raises its typed error."""
        return self.evaluate_batch([(pos, edges)])[0].raise_for_error()

    def evaluate_batch(self, requests):
        """Evaluate ``[(pos, edges), ...]``; same-topology same-bucket
        requests coalesce into batched dispatches.  Returns scores in
        request order; a malformed request (strict/sanitize validation)
        carries its typed error in its own slot."""
        n = len(requests)
        out = [None] * n
        groups: OrderedDict = OrderedDict()
        for i, (pos, edges) in enumerate(requests):
            try:
                key, member = self._prepare(i, pos, edges)
            except InvalidInputError as err:
                if self.config.validation not in ("strict", "sanitize"):
                    raise
                self._stats["quarantined"] += 1
                out[i] = error_scores(err)
                continue
            groups.setdefault(key, []).append(member)
        self._stats["requests"] += n

        for key, members in groups.items():
            plan = self._plan_for(key, members[0])
            # descending pow2 chunk widths keep the set of batch shapes
            # small
            while members:
                width = min(len(members), self.max_coalesce)
                width = 1 << (width.bit_length() - 1)
                chunk, members = members[:width], members[width:]
                plan = self._run_chunk(key, plan, chunk, out)
        return out
