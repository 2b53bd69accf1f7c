"""Serving session: plan cache, padded shape buckets, coalescing, the
bounded auto-replan and the fault-tolerance layer (counterpart of
:mod:`repro.launch.session`).

A request is ``(pos, edges)``; the session turns a stream of them into a
small number of engine dispatches::

  request --> validate (:func:`repro_torch.core.validate.validate_request`;
              a malformed request is QUARANTINED to its own slot, before
              it can touch a coalesced batch)
          --> admission control (:func:`repro_torch.launch.admission.admit`:
              past ``max_queue`` / ``max_queue_cost`` the excess is SHED,
              oldest-deadline-first, with ``OverloadedError`` in its slot)
          --> pow2 shape buckets (V, E rounded up by
              :func:`repro_torch.core.keys.pow2_bucket`, padded vertices
              parked at :data:`PARK`, padded edges masked on the device)
          --> :class:`PlanCache` LRU [(topology, buckets, EvalConfig)
              -> ReadabilityPlan], flat strips
          --> same-key requests coalesced into ``(B, V_pad, 2)`` chunks of
              descending pow2 width --> ONE batched engine call each
          --> :class:`~repro_torch.core.scores.ReadabilityScores` per request
              (fetched to the host inside the dispatch)

**The fault contract** (the reference's, clause for clause):

* *Poison quarantine* -- validation runs per request before coalescing,
  so a NaN layout or an out-of-range edge list fails only its own slot
  (``quarantined`` counter); :meth:`EvalSession.evaluate` raises instead.
* *Admission control* -- ``max_queue`` / ``max_queue_cost`` bound the
  work one call may enqueue (``shed`` / ``queue_high_watermark``).
* *Deadlines and cancellation* -- queued requests whose deadline passed
  or whose :class:`~repro_torch.launch.admission.CancelToken` fired are
  reaped before their dispatch (``expired`` / ``cancelled``).
* *Hung-dispatch watchdog* -- with a deadline or ``dispatch_timeout`` in
  force every dispatch runs on a worker thread under a wall-clock budget;
  one that outlives it is ABANDONED (``watchdog_abandoned``) into the
  split-and-retry path.  The budget covers device time, since the worker
  fetches the scores to the host before it returns.  An abandoned
  worker's late completion publishes nothing (publish-or-drop under
  ``_publish_lock``).  With no budget in force dispatch is direct.
* *Dispatch splitting* -- an exception out of a coalesced dispatch splits
  the chunk and retries members one by one (``dispatch_failures`` /
  ``chunk_splits``); a single member that still fails gets the error
  quarantined to its slot as ``BackendUnavailableError``.
* *Bounded replan backoff* -- overflow replans with multiplicative growth
  at most ``max_replan_retries`` times; a result that still overflows
  surfaces ``CapacityError`` (strict) or a ``saturated`` flag (sanitize).

Not ported yet: the mesh rungs of the degradation ladder (``mesh=``,
``backend="graph_sharded"``, the breaker's ``probe_interval``; ROADMAP
module item 10) and the incremental ``register_layout`` / ``update`` path
(its ``update_dirty_threshold``; item 8).  They raise
``NotImplementedError``; their counters are present and stay 0, and the
breaker stays closed.  PyTorch runs eagerly, so ``traces`` stays 0 too.
"""

from __future__ import annotations

import threading
from collections import Counter, OrderedDict

import numpy as np

from repro_torch.core import engine
from repro_torch.core.keys import (EvalConfig, pow2_bucket, topology_hash,
                                   warn_once)
from repro_torch.core.scores import (error_scores, scores_from_batch,
                                     scores_from_result)
from repro_torch.core.validate import (BackendUnavailableError,
                                       CancelledError, CapacityError,
                                       DeadlineExceededError,
                                       InvalidInputError, OverloadedError,
                                       ReadabilityError, validate_request)
from repro_torch.launch import admission, faults
from repro_torch.launch.admission import CircuitBreaker

# Park coordinate for padded tail vertices, far outside any real layout
# extent; correctness rests on the n_valid masks, not on this value.
PARK = -1.0e6


class PlanCache:
    """Thread-safe LRU cache of ReadabilityPlans keyed by ``(topology
    hash, vertex bucket, edge bucket, EvalConfig)``: watchdog workers and
    the caller's thread reach it concurrently."""

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
    device, with the fault-tolerance layer (see the module docstring).

    ``EvalSession(config)`` is the canonical constructor.  ``device=None``
    runs on CUDA and raises when there is none (pass ``device="cpu"`` for
    the CPU).  The keyword knobs are serving policy: cache size, padding
    floors, coalescing width, the replan bounds, and the overload knobs,
    all default-off (unset, the session behaves like the unbounded one):

    * ``max_queue`` -- max requests admitted per ``evaluate_batch`` call;
    * ``max_queue_cost`` -- max summed padded work units (vertex bucket +
      edge bucket) admitted at once;
    * ``default_deadline`` -- seconds-from-arrival budget of every request
      that does not carry its own;
    * ``dispatch_timeout`` -- wall-clock guard on each engine dispatch
      even when requests carry no deadline.

    ``mesh=`` and ``probe_interval=`` (mesh serving, ROADMAP module item
    10) and ``update_dirty_threshold=`` (item 8) raise
    ``NotImplementedError`` when given.

    The old per-knob evaluation kwargs (``radius=``, ``n_strips=``, ...)
    are a deprecation shim mapped onto an :class:`EvalConfig`.
    """

    def __init__(self, config: EvalConfig = None, *, device=None,
                 cache_size: int = 128, vertex_floor: int = 128,
                 edge_floor: int = 128, max_coalesce: int = 32,
                 max_replan_retries: int = 2, replan_growth: float = 1.5,
                 growth_ceiling: float = 4.0, max_queue: int = None,
                 max_queue_cost: int = None, default_deadline: float = None,
                 dispatch_timeout: float = None, probe_interval: int = None,
                 update_dirty_threshold: float = None, mesh=None,
                 **legacy_kwargs):
        if legacy_kwargs:
            if config is not None:
                raise TypeError("pass either an EvalConfig or legacy "
                                f"kwargs, not both: {sorted(legacy_kwargs)}")
            warn_once(
                "EvalSession kwargs",
                "EvalSession(radius=..., n_strips=..., ...) is deprecated: "
                "pass EvalSession(EvalConfig(...)) — the config is the one "
                "source of truth shared with the engine and the plan cache")
            config = EvalConfig.from_legacy(**legacy_kwargs)
        self.config = config if config is not None else EvalConfig()
        if self.config.backend not in ("fused", "kernels", "graph_sharded"):
            raise ValueError(
                "EvalSession serves the engine; backend must be 'fused', "
                "'kernels' or 'graph_sharded', got "
                f"{self.config.backend!r} (use repro_torch.api.Evaluator "
                "for the other backends)")
        if (self.config.backend == "graph_sharded" or mesh is not None
                or probe_interval is not None):
            raise NotImplementedError(
                "mesh serving (mesh=, backend='graph_sharded', the "
                "breaker's probe_interval) is not ported to repro_torch "
                "yet (ROADMAP module item 10)")
        if update_dirty_threshold is not None:
            raise NotImplementedError(
                "update_dirty_threshold (incremental re-evaluation) is not "
                "ported to repro_torch yet (ROADMAP module item 8)")
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
        self.max_queue = None if max_queue is None else int(max_queue)
        self.max_queue_cost = (None if max_queue_cost is None
                               else int(max_queue_cost))
        self.default_deadline = (None if default_deadline is None
                                 else float(default_deadline))
        self.dispatch_timeout = (None if dispatch_timeout is None
                                 else float(dispatch_timeout))
        # with no mesh rung nothing records to the breaker: it stays
        # closed and feeds the stats/health() keys
        self.breaker = CircuitBreaker()
        self.plans = PlanCache(cache_size)
        # serializes watchdog abandonment against worker publication: a
        # dispatch the watchdog gave up on never merges into shared state
        self._publish_lock = threading.Lock()
        self._last_abandoned_worker = None
        self._stats = {
            "requests": 0, "dispatches": 0, "coalesced": 0,
            "replans": 0, "traces": 0, "sharded_dispatches": 0,
            "graph_sharded_dispatches": 0,
            "quarantined": 0, "sanitized": 0, "dispatch_failures": 0,
            "chunk_splits": 0, "degraded_dispatches": 0, "saturated": 0,
            "shed": 0, "expired": 0, "cancelled": 0,
            "queue_high_watermark": 0, "watchdog_abandoned": 0,
            "updates": 0, "delta_hits": 0, "delta_fallbacks": 0,
        }

    @property
    def stats(self):
        """Counter snapshot; plan_hits/plan_misses come from the
        :class:`PlanCache` and the breaker counters from the
        :class:`~repro_torch.launch.admission.CircuitBreaker`."""
        s = dict(self._stats)
        s["plan_hits"] = self.plans.hits
        s["plan_misses"] = self.plans.misses
        s.update(self.breaker.counters)
        return s

    def health(self) -> dict:
        """Operational snapshot: the rung the session serves from, the
        breaker state and the counters."""
        state = self.breaker.state
        return {
            "status": "ok",
            "backend": self.config.backend,
            "validation": self.config.validation,
            "breaker_state": state,
            "dispatch_mode": "single-host",
            "mesh": None,
            "plans_cached": len(self.plans),
            "counters": self.stats,
        }

    def restore_mesh(self) -> None:
        """Manual override: force the breaker closed."""
        self.breaker.force_close()

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
                         edges_p=edges_p, n_v=n_v, n_e=n_e, flags=flags,
                         cost=vb + eb, deadline=None, cancel=None,
                         arrival=None)

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

    def _dispatch(self, plan, chunk, stats=None):
        """One engine call for a same-key chunk -> list of host scores.

        ``stats`` defaults to the session's own counters; the watchdog
        passes a private buffer so that an abandoned dispatch's writes can
        be dropped (see :meth:`_guarded_dispatch`)."""
        if stats is None:
            stats = self._stats
        faults.check_dispatch()
        stats["dispatches"] += 1
        n_v, n_e = chunk[0]["n_v"], chunk[0]["n_e"]
        use_kernels = self.config.use_kernels
        if len(chunk) == 1:
            res = engine.evaluate_planned(
                plan, chunk[0]["pos_p"], chunk[0]["edges_p"], n_v, n_e,
                use_kernels=use_kernels, device=self.device)
            reports = [scores_from_result(res, n_v, n_e)]
        else:
            stats["coalesced"] += len(chunk)
            batch = np.stack([c["pos_p"] for c in chunk])
            res = engine.evaluate_layouts(
                plan, batch, chunk[0]["edges_p"], n_v, n_e,
                use_kernels=use_kernels, device=self.device)
            reports = scores_from_batch(res, n_v, n_e)
        return faults.storm_overflow(reports)

    # -- the hung-dispatch watchdog ------------------------------------------

    def _chunk_timeout(self, chunk):
        """Wall-clock budget for one dispatch of ``chunk``: the tighter of
        ``dispatch_timeout`` and the earliest member deadline's remaining
        time; ``None`` (no guard) when neither is in force."""
        limit = self.dispatch_timeout
        now = None
        for m in chunk:
            d = m["deadline"]
            if d is not None:
                if now is None:
                    now = admission.clock()
                remaining = d - now
                limit = remaining if limit is None else min(limit, remaining)
        return limit

    def _guarded_dispatch(self, plan, chunk):
        """Dispatch under the watchdog.  With no budget in force this is a
        direct call.  With one, the dispatch (scores fetched to the host
        included, so the budget covers device time) runs on a daemon
        worker, and a dispatch that outlives its budget is ABANDONED: any
        injected hang is released and :class:`DeadlineExceededError`
        raises into the split-and-retry path.  The watchdog never waits on
        the device.

        An abandoned dispatch may still complete on its worker later.  The
        worker writes into a private stats buffer and publishes it only if
        the watchdog has not abandoned it (checked under ``_publish_lock``,
        which the watchdog holds while marking the abandonment), so a late
        result cannot skew ``stats`` or ``health()``."""
        timeout = self._chunk_timeout(chunk)
        if timeout is None:
            return self._dispatch(plan, chunk)
        start = admission.clock()
        if timeout <= 0:
            raise DeadlineExceededError(
                "dispatch budget already exhausted before launch",
                elapsed=0.0)
        box = {}
        done = threading.Event()
        abandoned = threading.Event()

        def work():
            stats = Counter()
            try:
                box["reports"] = self._dispatch(plan, chunk, stats=stats)
            except BaseException as err:
                box["err"] = err
            finally:
                # publish-or-drop: the abandonment check and the merge are
                # atomic with respect to the watchdog's abandonment mark
                with self._publish_lock:
                    if not abandoned.is_set():
                        for k, v in stats.items():
                            self._stats[k] += v
                done.set()

        worker = threading.Thread(target=work, daemon=True,
                                  name="eval-session-dispatch")
        worker.start()
        if not done.wait(timeout):
            with self._publish_lock:
                abandoned.set()
            self._stats["watchdog_abandoned"] += 1
            # test hook: the tests join the abandoned worker to show that
            # its late completion publishes nothing
            self._last_abandoned_worker = worker
            faults.release_hangs()
            raise DeadlineExceededError(
                f"dispatch exceeded its {timeout:.3f}s wall-clock budget "
                "and was abandoned by the watchdog",
                elapsed=admission.clock() - start)
        if "err" in box:
            raise box["err"]
        return box["reports"]

    # -- queue reaping (deadlines + cancellation) ----------------------------

    def _reap(self, members, out):
        """Drop queued members whose deadline passed or whose cancel token
        fired (each fails only its own slot) and return the live rest.
        Deadline-free members cost no clock read."""
        live = []
        now = None
        for m in members:
            tok = m["cancel"]
            if tok is not None and tok.cancelled:
                self._stats["cancelled"] += 1
                out[m["index"]] = error_scores(
                    CancelledError("request cancelled before dispatch",
                                   request_index=m["index"]),
                    m["n_v"], m["n_e"])
                continue
            d = m["deadline"]
            if d is not None:
                if now is None:
                    now = admission.clock()
                if now >= d:
                    self._stats["expired"] += 1
                    elapsed = (None if m["arrival"] is None
                               else now - m["arrival"])
                    out[m["index"]] = error_scores(
                        DeadlineExceededError(
                            "deadline passed while queued (before "
                            "dispatch)", request_index=m["index"],
                            elapsed=elapsed),
                        m["n_v"], m["n_e"])
                    continue
            live.append(m)
        return live

    def _settle(self, member, report):
        """Attach the member's sanitization flags to its report."""
        if member["flags"]:
            merged = dict(report.flags or {})
            merged.update(member["flags"])
            report = report._replace(flags=merged)
        return report

    def _run_chunk(self, key, plan, chunk, out):
        """Dispatch one chunk with the full fault story: the watchdog,
        split-and-retry on dispatch exceptions, bounded replan backoff on
        overflow, and per-slot errors instead of batch-wide failure."""
        try:
            reports = self._guarded_dispatch(plan, chunk)
            attempt = 0
            worst = max(range(len(reports)),
                        key=lambda i: reports[i].overflow)
            while (reports[worst].overflow > 0
                   and attempt < self.max_replan_retries):
                # grow the plan from the worst offender's concrete data
                # with multiplicative backoff, and keep it for future
                # traffic
                attempt += 1
                self._stats["replans"] += 1
                growth = min(self.replan_growth ** attempt,
                             self.growth_ceiling)
                plan = engine.replan_on_overflow(
                    plan, chunk[worst]["pos"], chunk[worst]["edges"],
                    reports[worst], growth=growth)
                self.plans.put(key, plan)
                reports = self._guarded_dispatch(plan, chunk)
                worst = max(range(len(reports)),
                            key=lambda i: reports[i].overflow)
        except Exception as err:  # an infrastructure failure (a CUDA or
            # allocation error, an injected fault, a watchdog abandonment)
            return self._fail_chunk(key, plan, chunk, out, err)

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
                else:  # sanitize: flag, don't hide
                    merged = dict(report.flags or {})
                    merged["saturated"] = True
                    report = report._replace(flags=merged)
            out[member["index"]] = self._settle(member, report)
        return plan

    def _fail_chunk(self, key, plan, chunk, out, err):
        """A dispatch raised: split the chunk and retry members one by one
        (one poisoned interaction must not take down B-1 innocent
        requests); a single member that still fails has the error
        quarantined to its own slot.  An abandoned chunk lands here too:
        its members are reaped first, so those whose deadline the hang
        burned fail with ``DeadlineExceededError``."""
        self._stats["dispatch_failures"] += 1
        if len(chunk) > 1:
            self._stats["chunk_splits"] += 1
            for member in self._reap(chunk, out):
                plan = self._run_chunk(key, plan, [member], out)
            return plan
        member = chunk[0]
        if isinstance(err, DeadlineExceededError):
            # the watchdog abandoned this member's dispatch (or its budget
            # was gone before launch): a deadline outcome, not a
            # quarantine
            err.request_index = member["index"]
            self._stats["expired"] += 1
            out[member["index"]] = error_scores(err, member["n_v"],
                                                member["n_e"])
            return plan
        if not isinstance(err, ReadabilityError):
            wrapped = BackendUnavailableError(
                f"dispatch failed: {type(err).__name__}: {err}",
                request_index=member["index"])
            wrapped.__cause__ = err
            err = wrapped
        else:
            err.request_index = member["index"]
        self._stats["quarantined"] += 1
        out[member["index"]] = error_scores(err, member["n_v"],
                                            member["n_e"])
        return plan

    # -- public API ---------------------------------------------------------

    def evaluate(self, pos, edges, *, deadline=None, cancel=None):
        """One request -> one :class:`ReadabilityScores`; a quarantined,
        shed or expired request re-raises its typed error.  ``deadline``
        is a seconds-from-now budget, ``cancel`` a
        :class:`~repro_torch.launch.admission.CancelToken`."""
        return self.evaluate_batch(
            [(pos, edges)], deadline=deadline,
            cancel=None if cancel is None else [cancel],
        )[0].raise_for_error()

    def evaluate_batch(self, requests, *, deadline=None, cancel=None):
        """Evaluate ``[(pos, edges), ...]``; same-topology same-bucket
        requests coalesce into batched dispatches.  Returns scores in
        request order.

        ``deadline`` -- seconds-from-arrival budget: a scalar, or a
        per-request sequence (``None`` entries: no deadline); defaults to
        ``default_deadline``.  ``cancel`` -- a per-request sequence of
        :class:`~repro_torch.launch.admission.CancelToken` (or ``None``).

        A malformed request (strict/sanitize validation) carries its typed
        error in its own slot; shedding, expiry and cancellation likewise
        fail only their own slots, in every validation mode."""
        n = len(requests)
        now = (admission.clock()
               if deadline is not None or self.default_deadline is not None
               else None)
        deadlines = admission.resolve_deadlines(
            n, deadline, self.default_deadline, 0.0 if now is None else now)
        if cancel is None:
            tokens = None
        else:
            tokens = list(cancel)
            if len(tokens) != n:
                raise ValueError(f"got {len(tokens)} cancel tokens for "
                                 f"{n} requests")
        out = [None] * n
        prepared = []
        quarantine_modes = ("strict", "sanitize")
        for i, (pos, edges) in enumerate(requests):
            pos = faults.corrupt_request(pos)
            try:
                key, member = self._prepare(i, pos, edges)
            except InvalidInputError as err:
                if self.config.validation not in quarantine_modes:
                    raise
                self._stats["quarantined"] += 1
                out[i] = error_scores(err)
                continue
            member["key"] = key
            member["deadline"] = deadlines[i]
            member["cancel"] = None if tokens is None else tokens[i]
            member["arrival"] = now
            prepared.append(member)
        self._stats["requests"] += n

        # the bounded queue: shed the overload before planning or dispatch
        # spends anything on it
        admitted, shed = admission.admit(
            prepared, max_queue=self.max_queue, max_cost=self.max_queue_cost)
        for m in shed:
            self._stats["shed"] += 1
            out[m["index"]] = error_scores(
                OverloadedError(
                    f"request shed by admission control ({len(prepared)} "
                    f"pending > queue bound)", request_index=m["index"],
                    queue_depth=len(prepared), bound=self.max_queue),
                m["n_v"], m["n_e"])
        if len(admitted) > self._stats["queue_high_watermark"]:
            self._stats["queue_high_watermark"] = len(admitted)

        groups: OrderedDict = OrderedDict()
        for member in admitted:
            groups.setdefault(member["key"], []).append(member)
        for key, members in groups.items():
            try:
                plan = self._plan_for(key, members[0])
            except InvalidInputError:
                raise
            except Exception as err:
                # host planning choked on data that passed (or skipped)
                # validation: fail the group's slots, not the whole call
                if self.config.validation not in quarantine_modes:
                    raise
                for member in members:
                    self._stats["quarantined"] += 1
                    out[member["index"]] = error_scores(
                        InvalidInputError(
                            f"planning failed: {type(err).__name__}: {err}",
                            request_index=member["index"],
                            reason="planning_failed"),
                        member["n_v"], member["n_e"])
                continue
            # descending pow2 chunk widths keep the set of batch shapes
            # small; expired/cancelled members are reaped between
            # dispatches, so a slow neighbour cannot drag a whole group
            # past its deadline unreported
            remaining = self._reap(members, out)
            while remaining:
                width = min(len(remaining), self.max_coalesce)
                width = 1 << (width.bit_length() - 1)
                chunk, remaining = remaining[:width], remaining[width:]
                plan = self._run_chunk(key, plan, chunk, out)
                if remaining:
                    remaining = self._reap(remaining, out)
        return out

    # -- dynamic layouts (ROADMAP module item 8) ------------------------------

    def register_layout(self, layout_id, pos, edges):
        raise NotImplementedError(
            "register_layout / update (incremental re-evaluation) are not "
            "ported to repro_torch yet (ROADMAP module item 8)")

    def update(self, layout_id, moved_idx, new_pos):
        raise NotImplementedError(
            "register_layout / update (incremental re-evaluation) are not "
            "ported to repro_torch yet (ROADMAP module item 8)")
