"""Overload protection primitives: admission control, deadlines, cancel
tokens and the degradation breaker (the port's own copy of
:mod:`repro.launch.admission`; pure Python, no engine, no device).

* **Deadlines** (:func:`resolve_deadlines`) -- per-request wall-clock
  budgets, resolved to absolute :func:`clock` times at call arrival.  A
  request whose deadline passes before its dispatch completes fails its
  own slot with :class:`~repro_torch.core.validate.DeadlineExceededError`.
* **Admission control** (:func:`admit`) -- the bounded queue in front of
  coalescing.  When a burst exceeds ``max_queue`` (request count) or
  ``max_cost`` (summed padded work units), the excess is shed with
  :class:`~repro_torch.core.validate.OverloadedError`, deterministically:
  oldest-deadline-first, ties latest-arrival-first (FIFO drop-tail).  The
  same arrival sequence always sheds the same request set.
* **Cancellation** (:class:`CancelToken`) -- a caller-held flag checked
  before every dispatch; a cancelled request fails its slot with
  :class:`~repro_torch.core.validate.CancelledError` without any engine
  work.
* **The breaker** (:class:`CircuitBreaker`) -- a half-open circuit over a
  mesh rung: a mesh dispatch failure opens it, ``probe_interval``
  single-host successes make it half-open, and the next mesh-eligible
  dispatch is the canary probe.  The port serves one device, so its
  sessions keep the breaker closed; the state machine is here whole so
  that the mesh rung (still to port) plugs into it.

Everything here is host-side policy over plain Python values; the
session (:class:`repro_torch.launch.session.EvalSession`) wires it to
the engine and certifies each clause with counters (``shed`` /
``expired`` / ``cancelled`` / ``queue_high_watermark`` /
``watchdog_abandoned`` / ``probes`` / ``auto_restores``).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

# The one clock the overload layer reads (monotonic: deadlines must not
# jump on NTP steps).  Module-level so tests can monkeypatch time.
clock = time.monotonic

_INF = float("inf")


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------

def resolve_deadlines(n: int, deadline, default: Optional[float],
                      now: float) -> list:
    """Resolve per-request deadline *budgets* (seconds from arrival)
    into absolute :func:`clock` times.

    ``deadline`` is ``None`` (fall back to ``default``, the session
    knob), a scalar (every request gets that budget), or a length-``n``
    sequence of per-request budgets (``None`` entries mean no
    deadline).  Returns a list of absolute times or ``None``s.
    """
    if deadline is None:
        if default is None:
            return [None] * n
        return [now + float(default)] * n
    if isinstance(deadline, (int, float)):
        return [now + float(deadline)] * n
    seq = list(deadline)
    if len(seq) != n:
        raise ValueError(f"got {len(seq)} deadlines for {n} requests")
    return [None if d is None else now + float(d) for d in seq]


# ---------------------------------------------------------------------------
# admission control (the bounded queue in front of coalescing)
# ---------------------------------------------------------------------------

def shed_order(members: Sequence[dict]) -> list:
    """Indices of ``members`` in deterministic shed-priority order.

    Oldest (earliest) deadline first — under overload, the requests
    least likely to finish inside their budget are the cheapest to
    give up.  No deadline sorts as ``+inf`` (shed last).  Ties break
    latest-arrival-first, so a deadline-free burst degrades to plain
    FIFO drop-tail.  Purely a function of the arrival sequence: the
    property tests replay a sequence twice and require identical sheds.
    """
    def key(i):
        d = members[i].get("deadline")
        return (_INF if d is None else d, -i)

    return sorted(range(len(members)), key=key)


def admit(members: Sequence[dict], *, max_queue: Optional[int] = None,
          max_cost: Optional[int] = None):
    """The bounded queue: split ``members`` into (admitted, shed).

    ``max_queue`` bounds how many requests may be pending dispatch at
    once; ``max_cost`` bounds their summed ``member["cost"]`` (the
    session uses padded work units — vertex bucket + edge bucket — so a
    few million-vertex requests exert the same backpressure as many
    small ones).  Shedding follows :func:`shed_order`.  The cost bound
    never sheds the *last* member: a single over-budget request is
    admitted alone (the bound is queue backpressure, not a per-request
    size limit — size limits are validation's job).  Both lists
    preserve arrival order.
    """
    members = list(members)
    over_count = max_queue is not None and len(members) > max_queue
    if not over_count and max_cost is None:
        return members, []
    order = shed_order(members)
    shed: set = set()
    if over_count:
        for i in order:
            if len(members) - len(shed) <= max_queue:
                break
            shed.add(i)
    if max_cost is not None:
        total = sum(m.get("cost", 1) for j, m in enumerate(members)
                    if j not in shed)
        for i in order:
            if total <= max_cost or len(members) - len(shed) <= 1:
                break
            if i in shed:
                continue
            total -= members[i].get("cost", 1)
            shed.add(i)
    admitted = [m for j, m in enumerate(members) if j not in shed]
    return admitted, [members[j] for j in sorted(shed)]


# ---------------------------------------------------------------------------
# cancellation
# ---------------------------------------------------------------------------

class CancelToken:
    """Caller-held cancellation flag for queued requests.

    Pass one per request to ``EvalSession.evaluate_batch(...,
    cancel=...)``; flip it with :meth:`cancel` (from any thread — the
    single bool write is atomic under the GIL).  A request whose token
    is cancelled before its dispatch starts fails its own slot with
    :class:`~repro_torch.core.validate.CancelledError`; a dispatch already in
    flight is not interrupted (that is the watchdog's job, and only
    under a deadline)."""

    __slots__ = ("_cancelled",)

    def __init__(self):
        self._cancelled = False

    def cancel(self) -> None:
        self._cancelled = True

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def __repr__(self):
        return f"CancelToken(cancelled={self._cancelled})"


# ---------------------------------------------------------------------------
# the self-healing degradation breaker
# ---------------------------------------------------------------------------

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """Half-open circuit breaker over the session's mesh rung.

    States (``health()["breaker_state"]``):

    * ``closed`` — the mesh serves (the healthy steady state);
    * ``open`` — a mesh dispatch failed; traffic serves from the fused
      single-host rung (bit-identical integer metrics) while the
      breaker counts successful fused dispatches;
    * ``half_open`` — ``probe_interval`` fused successes accumulated;
      the next mesh-eligible dispatch is the canary probe (``probes``
      counter).  Probe success closes the circuit (``auto_restores``);
      probe failure re-opens it and the count restarts.

    The probe IS a real dispatch: if the canary fails, the degradation
    ladder already re-runs it on the fused rung, so no request is ever
    lost to probing.  ``force_close`` is the manual
    ``restore_mesh()`` override (no ``auto_restores`` credit).
    """

    def __init__(self, probe_interval: int = 8):
        self.probe_interval = max(int(probe_interval), 1)
        self.state = CLOSED
        self._successes_since_open = 0
        self._probing = False
        self.opens = 0
        self.probes = 0
        self.auto_restores = 0

    def allow(self) -> bool:
        """May this dispatch try the mesh rung?  In ``half_open`` the
        answer is yes exactly as the canary probe (counted)."""
        if self.state == OPEN:
            return False
        self._probing = self.state == HALF_OPEN
        if self._probing:
            self.probes += 1
        return True

    @property
    def probing(self) -> bool:
        """True while the current allowed dispatch is the canary."""
        return self._probing

    def record_success(self) -> None:
        """The mesh rung served.  Closes a half-open circuit
        (auto-restore)."""
        if self.state == HALF_OPEN:
            self.state = CLOSED
            self.auto_restores += 1
        self._successes_since_open = 0
        self._probing = False

    def record_failure(self) -> None:
        """The mesh rung failed (real or canary): open the circuit."""
        self.state = OPEN
        self.opens += 1
        self._successes_since_open = 0
        self._probing = False

    def record_fallback_success(self) -> None:
        """A fused single-host dispatch served while the circuit is
        open; after ``probe_interval`` of these the circuit goes
        half-open and the next mesh-eligible dispatch probes."""
        if self.state != OPEN:
            return
        self._successes_since_open += 1
        if self._successes_since_open >= self.probe_interval:
            self.state = HALF_OPEN

    def force_close(self) -> None:
        """Manual override (``restore_mesh()``): trust the mesh now."""
        self.state = CLOSED
        self._successes_since_open = 0
        self._probing = False

    @property
    def counters(self) -> dict:
        return {"breaker_opens": self.opens, "probes": self.probes,
                "auto_restores": self.auto_restores}

    def __repr__(self):
        return (f"CircuitBreaker(state={self.state!r}, "
                f"probe_interval={self.probe_interval}, "
                f"opens={self.opens}, probes={self.probes}, "
                f"auto_restores={self.auto_restores})")
