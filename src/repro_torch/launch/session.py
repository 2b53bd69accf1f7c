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

**Dynamic layouts**: :meth:`EvalSession.register_layout` scores a layout
and, on ``backend="fused"`` with flat strips, primes its device-resident
partials (:mod:`repro_torch.core.incremental`); :meth:`EvalSession.update`
then re-scores small vertex moves from the dirty cells and strips alone
(``updates`` / ``delta_hits`` / ``delta_fallbacks``), and every case the
delta cannot prove sound falls back to a full re-evaluation.

**The mesh rungs of the degradation ladder**: with a ``mesh``
(:class:`~repro_torch.distributed.compat.Mesh`, every rank of it running
the same session on the same requests), ``backend="graph_sharded"``
partitions each layout over the ranks
(:func:`~repro_torch.distributed.graph_sharded.evaluate_graph_sharded`,
``graph_sharded_dispatches``) and a coalesced batch on a mesh of more
than one rank splits its batch axis over them
(:func:`~repro_torch.distributed.batched.evaluate_layouts_sharded`,
``sharded_dispatches``).  A mesh dispatch that fails degrades to the
single-host fused rung within the same dispatch (integer metrics equal)
and opens the :class:`~repro_torch.launch.admission.CircuitBreaker`;
after ``probe_interval`` fused successes the next mesh-eligible dispatch
is a canary probe, whose success closes it again (``probes`` /
``auto_restores``).  Every rank reaches the same rung: results are
summed or gathered over the ranks, and a ``FaultPlan`` is armed alike on
each.  PyTorch runs eagerly, so ``traces`` stays 0.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import Counter, OrderedDict

import numpy as np
import torch

from repro_torch.core import engine, incremental
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
from repro_torch.spans import span

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


class _BreakerBuffer:
    """Write-buffering view of the session's breaker for watchdog workers:
    reads delegate to the live breaker (the worker must see the real
    circuit state to pick its rung), outcome records are kept as events
    that the session replays only if it has not abandoned the dispatch."""

    def __init__(self, breaker):
        self._breaker = breaker
        self.events = []

    def allow(self):
        return self._breaker.allow()

    @property
    def probing(self):
        return self._breaker.probing

    def record_success(self):
        self.events.append("record_success")

    def record_failure(self):
        self.events.append("record_failure")

    def record_fallback_success(self):
        self.events.append("record_fallback_success")


class EvalSession:
    """Plan-caching, shape-bucketing, request-coalescing evaluator, with
    the fault-tolerance layer and the mesh rungs (see the module
    docstring).

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
      even when requests carry no deadline;
    * ``update_dirty_threshold`` -- an :meth:`update` falls back to a full
      re-evaluation when it dirties more than this fraction of the
      vertices, the grid cells or either orientation's strips;
    * ``mesh`` -- the :class:`~repro_torch.distributed.compat.Mesh` of the
      mesh rungs (``backend="graph_sharded"`` brings one up by
      :func:`~repro_torch.launch.elastic.serving_mesh` when none is
      given); the session then runs on ``mesh.device`` unless ``device``
      says otherwise;
    * ``probe_interval`` -- fused successes the open breaker counts before
      it re-probes the mesh.

    The old per-knob evaluation kwargs (``radius=``, ``n_strips=``, ...)
    are a deprecation shim mapped onto an :class:`EvalConfig`.
    """

    def __init__(self, config: EvalConfig = None, *, device=None,
                 cache_size: int = 128, vertex_floor: int = 128,
                 edge_floor: int = 128, max_coalesce: int = 32,
                 max_replan_retries: int = 2, replan_growth: float = 1.5,
                 growth_ceiling: float = 4.0, max_queue: int = None,
                 max_queue_cost: int = None, default_deadline: float = None,
                 dispatch_timeout: float = None, probe_interval: int = 8,
                 update_dirty_threshold: float = 0.25, mesh=None,
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
        if self.config.backend == "graph_sharded" and mesh is None:
            # graph_sharded needs a mesh (it is what the backend means):
            # the serving policy brings one up, capped by config.shards
            from repro_torch.launch.elastic import serving_mesh
            mesh = serving_mesh("graph", shards=self.config.shards,
                                device=device)
        if device is None and mesh is not None:
            device = mesh.device
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
        # incremental updates: past this dirty fraction of the vertices,
        # the grid cells or either orientation's strips the delta's
        # dirty-row rebuild stops being cheaper than the full engine
        self.update_dirty_threshold = float(update_dirty_threshold)
        # registered dynamic layouts (update targets): host records and
        # device-resident partials, each guarded by its own lock
        self._layouts = {}
        self._layouts_lock = threading.Lock()
        # mesh is serving policy, not evaluation semantics: routing over
        # it is transparent to callers (integer metrics equal); a failed
        # mesh dispatch opens the breaker, and the fused rung serves until
        # a canary probe (or restore_mesh()) closes it again
        self.mesh = mesh
        self.breaker = CircuitBreaker(probe_interval)
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
        """Operational snapshot: the rung of the degradation ladder the
        session serves from, the breaker state and the counters."""
        state = self.breaker.state
        mesh_live = self.mesh is not None and state != admission.OPEN
        degraded = self.mesh is not None and state != admission.CLOSED
        if self.config.backend == "graph_sharded" and mesh_live:
            mode = "graph_sharded"
        elif self.mesh is not None and self.mesh.size > 1 and mesh_live:
            mode = "sharded"
        else:
            mode = "single-host"
        return {
            "status": "degraded" if degraded else "ok",
            "backend": self.config.backend,
            "validation": self.config.validation,
            "breaker_state": state,
            "dispatch_mode": mode,
            "mesh": (None if self.mesh is None else
                     {"devices": int(self.mesh.size),
                      "active": state == admission.CLOSED}),
            "plans_cached": len(self.plans),
            "counters": self.stats,
        }

    def restore_mesh(self) -> None:
        """Manual override after an operator's repair: force the breaker
        closed, so the next dispatch climbs straight back to the mesh (no
        canary, no ``auto_restores`` credit)."""
        self.breaker.force_close()

    # -- request preparation ------------------------------------------------

    def _prepare(self, index, pos, edges):
        """Validate, pad, and key one request (raises
        :class:`InvalidInputError`; the caller quarantines it)."""
        with span("session.prepare"):
            with span("session.prepare.validate"):
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
            with span("session.prepare.hash"):
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

    def _dispatch(self, plan, chunk, stats=None, breaker=None):
        """One engine dispatch for a same-key chunk -> list of host scores.

        A mesh dispatch that fails (a lost rank, a collective error, an
        injected mesh loss) degrades to the fused single-host program
        within this dispatch and opens the breaker; integer metrics are
        equal on both rungs, so callers see it only in
        ``degraded_dispatches``.  While the breaker is open each fused
        success feeds its half-open countdown, and a half-open breaker
        makes the next mesh-eligible dispatch the canary probe.

        ``stats`` / ``breaker`` default to the session's own; the watchdog
        passes buffering stand-ins so that an abandoned dispatch's writes
        can be dropped (see :meth:`_guarded_dispatch`)."""
        with span("session.dispatch"):
            if stats is None:
                stats = self._stats
            if breaker is None:
                breaker = self.breaker
            faults.check_dispatch()
            stats["dispatches"] += 1
            n_v, n_e = chunk[0]["n_v"], chunk[0]["n_e"]
            use_kernels = self.config.use_kernels
            if (self.config.backend == "graph_sharded"
                    and self.mesh is not None and breaker.allow()):
                # top rung: each layout spatially partitioned over the mesh
                # (one driver call per member: the graph axis, not the batch
                # axis, is what is sharded); any failure drops to the fused
                # rungs below
                from repro_torch.distributed.graph_sharded import \
                    evaluate_graph_sharded
                try:
                    if breaker.probing:
                        faults.check_probe()
                    faults.check_sharded()
                    results = [evaluate_graph_sharded(
                        self.mesh, plan, c["pos_p"], c["edges_p"],
                        n_valid_vertices=n_v, n_valid_edges=n_e)
                        for c in chunk]
                    reports = [scores_from_result(r, n_v, n_e)
                               for r in results]
                    breaker.record_success()
                    stats["graph_sharded_dispatches"] += len(chunk)
                    if len(chunk) > 1:
                        stats["coalesced"] += len(chunk)
                    return faults.storm_overflow(reports)
                except Exception:
                    breaker.record_failure()
                    stats["degraded_dispatches"] += 1
            if len(chunk) == 1:
                res = engine.evaluate_planned(
                    plan, chunk[0]["pos_p"], chunk[0]["edges_p"], n_v, n_e,
                    use_kernels=use_kernels, device=self.device)
                reports = [scores_from_result(res, n_v, n_e)]
            else:
                stats["coalesced"] += len(chunk)
                batch = np.stack([c["pos_p"] for c in chunk])
                reports = None
                if (self.mesh is not None and self.mesh.size > 1
                        and not use_kernels and breaker.allow()):
                    # scale-out: the coalesced batch axis over the mesh (the
                    # kernels route evaluates members one by one and stays
                    # single-host)
                    from repro_torch.distributed.batched import \
                        evaluate_layouts_sharded
                    try:
                        if breaker.probing:
                            faults.check_probe()
                        faults.check_sharded()
                        res = evaluate_layouts_sharded(
                            self.mesh, plan, batch, chunk[0]["edges_p"],
                            n_valid_vertices=n_v, n_valid_edges=n_e)
                        reports = scores_from_batch(res, n_v, n_e)
                        breaker.record_success()
                        stats["sharded_dispatches"] += 1
                    except Exception:
                        # one rung down: fused single-host, the same batched
                        # body; the breaker re-probes on its own schedule
                        breaker.record_failure()
                        stats["degraded_dispatches"] += 1
                        reports = None
                if reports is None:
                    res = engine.evaluate_layouts(
                        plan, batch, chunk[0]["edges_p"], n_v, n_e,
                        use_kernels=use_kernels, device=self.device)
                    reports = scores_from_batch(res, n_v, n_e)
            if self.mesh is not None:
                # the fused rung served while a mesh exists: feed the open
                # breaker's half-open countdown (a no-op otherwise)
                breaker.record_fallback_success()
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
        worker writes into a private stats buffer and a
        :class:`_BreakerBuffer` and publishes them only if the watchdog has
        not abandoned it (checked under ``_publish_lock``, which the
        watchdog holds while marking the abandonment), so a late result
        cannot skew ``stats`` or ``health()`` or flip the breaker."""
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
            breaker = _BreakerBuffer(self.breaker)
            try:
                box["reports"] = self._dispatch(plan, chunk, stats=stats,
                                                breaker=breaker)
            except BaseException as err:
                box["err"] = err
            finally:
                # publish-or-drop: the abandonment check and the merge are
                # atomic with respect to the watchdog's abandonment mark
                with self._publish_lock:
                    if not abandoned.is_set():
                        for k, v in stats.items():
                            self._stats[k] += v
                        for event in breaker.events:
                            getattr(self.breaker, event)()
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

    # -- dynamic layouts (incremental re-evaluation) --------------------------

    def register_layout(self, layout_id, pos, edges):
        """Register a dynamic layout for :meth:`update` and return its
        full from-scratch scores.

        The layout is evaluated through the normal serving path (plan
        cache, validation, counters), then -- on the ``"fused"`` backend
        with a flat (untiered) plan -- its device-resident partial state
        is primed so that later small moves take the incremental path
        (:mod:`repro_torch.core.incremental`).  Other backends register
        too but serve every update as a full re-evaluation."""
        pos_v, edges_v, _ = validate_request(
            pos, edges, mode=self.config.validation, index=0)
        scores = self.evaluate(pos_v, edges_v)
        pos_v = np.asarray(pos_v, np.float32)
        edges_v = np.asarray(edges_v, np.int32)
        n_v, n_e = pos_v.shape[0], edges_v.shape[0]
        vb = pow2_bucket(n_v, self.vertex_floor)
        eb = pow2_bucket(n_e, self.edge_floor)
        pos_p = np.full((vb, 2), PARK, np.float32)
        pos_p[:n_v] = pos_v
        edges_p = np.zeros((eb, 2), np.int32)
        edges_p[:n_e] = edges_v
        lay = dict(key=(topology_hash(edges_v, n_v), vb, eb, self.config),
                   pos=pos_v.copy(), edges=edges_v, pos_p=pos_p,
                   edges_p=edges_p, n_v=n_v, n_e=n_e, vb=vb, eb=eb,
                   lock=threading.Lock(), plan_r=None, state=None,
                   edges_d=None, vert_cell=None, strips=None)
        self._prime_layout(lay)
        with self._layouts_lock:
            self._layouts[layout_id] = lay
        return scores

    def _prime_layout(self, lay) -> None:
        """Build (or rebuild) the layout's device-resident partials.
        Leaves ``state=None`` -- updates then fall back to a full
        re-evaluation -- when the backend is not the plain fused engine,
        the plan is tiered, or the prime itself overflowed."""
        lay["state"] = None
        if self.config.backend != "fused":
            return
        plan = self._plan_for(lay["key"], lay)
        if any(plan.strip_tiers):
            # tiered strip layouts permute bucket offsets by occupancy;
            # the resident tables assume the flat layout (sessions plan
            # flat by default, so this guards an explicit override)
            return
        inc_nbr, inc_deg, deg_cap = incremental.incidence_table(
            lay["edges"], lay["n_v"], lay["vb"])
        plan_r = dataclasses.replace(plan, resident=("delta", deg_cap))
        if lay["edges_d"] is None:
            lay["edges_d"] = torch.from_numpy(lay["edges_p"]).to(self.device)
        state, aux = incremental.prime_state(
            plan_r, lay["pos_p"], lay["edges_d"], lay["n_v"], lay["n_e"],
            inc_nbr, inc_deg, device=self.device)
        if aux["overflow"] > 0:
            return
        lay["plan_r"] = plan_r
        lay["state"] = state
        # host mirrors the delta planner reads, and writes on commit
        lay["vert_cell"] = np.array(aux["vert_cell"])
        lay["strips"] = [[np.array(s[0]), np.array(s[1]), s[2], s[3], s[4]]
                         for s in aux["strips"]]

    def update(self, layout_id, moved_idx, new_pos):
        """Move a few vertices of a registered layout and re-score it.

        Takes the incremental path when the resident state is live and
        the move stays small (dirty fractions under
        ``update_dirty_threshold``, strip domain unchanged, no bucket
        overflow); integer metrics equal a from-scratch evaluation either
        way, and incremental results carry ``flags={"incremental":
        True}``.  Every other case counts a ``delta_fallbacks`` and
        re-evaluates in full through the serving path (then re-primes).
        Raises ``KeyError`` for an unknown ``layout_id`` and
        :class:`InvalidInputError` (``reason="bad_update"``) for bad
        indices or non-finite coordinates (unless ``validation="off"``)."""
        with self._layouts_lock:
            lay = self._layouts.get(layout_id)
        if lay is None:
            raise KeyError(f"unknown layout_id {layout_id!r}; "
                           "register_layout() it first")
        moved = np.asarray(moved_idx, np.int64).ravel()
        new = np.asarray(new_pos, np.float32).reshape(-1, 2)
        if self.config.validation != "off":
            if len(moved) == 0 or len(moved) != len(new):
                raise InvalidInputError(
                    f"moved_idx ({len(moved)}) and new_pos ({len(new)}) "
                    "must be equal-length and non-empty",
                    reason="bad_update")
            if (moved < 0).any() or (moved >= lay["n_v"]).any():
                raise InvalidInputError(
                    "moved_idx out of range for a layout with "
                    f"{lay['n_v']} vertices", reason="bad_update")
            if not np.isfinite(new).all():
                raise InvalidInputError(
                    "new_pos contains non-finite coordinates",
                    reason="bad_update")
        with span("session.update"), lay["lock"]:
            self._stats["updates"] += 1
            # duplicate indices: the last write wins, as in a drag
            uniq, ridx = np.unique(moved[::-1], return_index=True)
            new_u = new[len(moved) - 1 - ridx]
            scores = self._try_delta(lay, uniq, new_u)
            if scores is not None:
                self._stats["delta_hits"] += 1
                flags = dict(scores.flags or {})
                flags["incremental"] = True
                return scores._replace(flags=flags)
            # fallback: full re-evaluation through the serving path, then
            # re-prime the resident state from the new positions
            self._stats["delta_fallbacks"] += 1
            lay["pos"][uniq] = new_u
            lay["pos_p"][uniq] = new_u
            scores = self.evaluate(lay["pos"], lay["edges"])
            self._prime_layout(lay)
            return scores

    def _try_delta(self, lay, moved, new_xy):
        """Attempt the incremental path; return host scores, or None to
        fall back.  ``moved`` is sorted-unique with ``new_xy`` aligned.
        Catches nothing: a failing kernel raises, it never turns into a
        fallback."""
        state, plan_r = lay["state"], lay["plan_r"]
        if state is None:
            return None
        thr = self.update_dirty_threshold
        n_v, n_e = lay["n_v"], lay["n_e"]
        vb, eb = lay["vb"], lay["eb"]
        if len(moved) > thr * n_v:
            return None
        moved_p = incremental.pad_ids(moved, vb)
        new_xy_p = np.zeros((len(moved_p), 2), np.float32)
        new_xy_p[:len(moved)] = new_xy
        aff = incremental.affected_edges(lay["edges"], moved, n_v)
        aff_p = incremental.pad_ids(aff, eb, floor=16)
        with span("session.update.probe"):
            probe = incremental.delta_probe(
                plan_r, state, lay["edges_d"], n_e, moved_p, new_xy_p,
                aff_p, device=self.device)

        dirty_strips, k = [], len(moved)
        for axis_i, (lo2, hi2, sfn, sln, nsn) in enumerate(probe["axes"]):
            sfo, slo, total, lo, hi = lay["strips"][axis_i]
            if lo2 != lo or hi2 != hi:
                # an extremal vertex moved: every strip boundary shifts
                return None
            ds, old_segs, new_segs = [], 0, 0
            for j, e in enumerate(aff_p):
                if e >= eb:
                    continue
                if slo[e] >= sfo[e]:
                    ds.extend(range(int(sfo[e]), int(slo[e]) + 1))
                    old_segs += int(slo[e]) - int(sfo[e]) + 1
                if sln[j] >= sfn[j]:
                    ds.extend(range(int(sfn[j]), int(sln[j]) + 1))
                    new_segs += int(sln[j]) - int(sfn[j]) + 1
            max_segments = plan_r.strip_plans[axis_i][0]
            if total - old_segs + new_segs > max_segments:
                return None          # the delta would outgrow the plan
            ds = np.unique(np.asarray(ds, np.int64))
            if len(ds) > thr * plan_r.n_strips:
                return None
            dirty_strips.append(
                incremental.pad_ids(ds if len(ds) else [plan_r.n_strips],
                                    plan_r.n_strips))

        dc_p = own_p = np.zeros(0, np.int32)
        if lay["vert_cell"] is not None and \
                "node_occlusion" in plan_r.metrics:
            n_cells = plan_r.grid_nx * plan_r.grid_ny
            dirty = np.unique(np.concatenate(
                [lay["vert_cell"][moved], probe["new_cid"][:k]]))
            if len(dirty) > thr * n_cells:
                return None
            dc_p = incremental.pad_ids(dirty, n_cells)
            own_p = incremental.pad_ids(
                incremental.owner_cells(dirty, plan_r.grid_nx,
                                        plan_r.grid_ny),
                n_cells, floor=16)

        dirty_ma = np.unique(np.concatenate(
            [moved, lay["edges"][aff].reshape(-1).astype(np.int64)]))
        dv_p = incremental.pad_ids(dirty_ma, vb, floor=16)

        with span("session.update.delta"):
            res, new_state = incremental.evaluate_delta(
                plan_r, state, lay["edges_d"], n_e, moved_p, new_xy_p,
                aff_p, dc_p, own_p, tuple(dirty_strips), dv_p,
                device=self.device)
        scores = scores_from_result(res, n_v, n_e)
        if scores.overflow > 0:
            # bucket overflow or a dirty-set miss in the rebuild:
            # membership equality is not guaranteed, so never commit
            return None
        # commit: the device state and the host mirrors the next probe
        # reads
        lay["state"] = new_state
        lay["pos"][moved] = new_xy
        lay["pos_p"][moved] = new_xy
        if lay["vert_cell"] is not None and \
                "node_occlusion" in plan_r.metrics:
            lay["vert_cell"][moved] = probe["new_cid"][:k]
        for axis_i, (lo2, hi2, sfn, sln, nsn) in enumerate(probe["axes"]):
            rec = lay["strips"][axis_i]
            sfo, slo, total = rec[0], rec[1], rec[2]
            live = aff_p < eb
            old = np.where(slo[aff_p[live]] >= sfo[aff_p[live]],
                           slo[aff_p[live]] - sfo[aff_p[live]] + 1, 0)
            newn = np.where(sln[live] >= sfn[live],
                            sln[live] - sfn[live] + 1, 0)
            sfo[aff_p[live]] = sfn[live]
            slo[aff_p[live]] = sln[live]
            rec[2] = total - int(old.sum()) + int(newn.sum())
        return scores
