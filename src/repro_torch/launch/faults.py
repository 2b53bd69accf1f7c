"""Deterministic fault injection for the serving layer (the port's own
copy of :mod:`repro.launch.faults`; pure Python).

:class:`FaultPlan` is a context manager that arms a process-global plan
which the serving session consults at fixed hook points:

* ``corrupt_request`` -- once per request entering
  :meth:`EvalSession.evaluate_batch` (by arrival ordinal while the plan is
  armed); selected requests get a NaN in their positions *before*
  validation, so validation (not test plumbing) must catch the poison.
* ``check_dispatch`` -- at the top of every engine dispatch;
  ``fail_dispatches`` ordinals raise :class:`FaultInjected` (the session
  must split the chunk and retry members individually),
  ``slow_dispatches`` sleep ``slow_seconds`` first (a straggler), and
  ``hang_dispatches`` block until the watchdog abandons the dispatch (or
  ``hang_seconds`` elapses), then raise :class:`FaultInjected`.
* ``check_sharded`` / ``check_probe`` -- before a mesh-sharded dispatch
  and before a breaker canary probe; selected ordinals raise
  :class:`~repro_torch.core.validate.BackendUnavailableError`.  The port
  has no mesh rung yet, so its sessions never reach these two.
* ``storm_overflow`` -- on every dispatch result while armed; forces
  ``overflow`` positive so the replan loop can never converge.

All ordinals are 0-based, counted from the moment the plan is armed, and
assigned under one lock (the watchdog dispatches on worker threads).  The
plan records what it injected in :attr:`FaultPlan.injected`.  With no
plan armed every hook is one ``is None`` check.

The registry is this package's own: a :class:`FaultPlan` of the reference
package arms nothing here, and a test that holds the port against the
reference arms one plan in each package.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from repro_torch.core.validate import BackendUnavailableError

_ACTIVE = None


class FaultInjected(RuntimeError):
    """The generic injected infrastructure failure (stands in for an XLA
    runtime error, an OOM, a device reset, ...)."""


def _ordinals(spec):
    """Normalize a fault-site spec: None/False -> never, True -> always,
    int -> that single ordinal, iterable -> that set of ordinals."""
    if spec is None or spec is False:
        return None
    if spec is True:
        return True
    if isinstance(spec, (int, np.integer)):
        return {int(spec)}
    return {int(x) for x in spec}


def _hit(spec, ordinal: int) -> bool:
    return spec is True or (spec is not None and ordinal in spec)


class FaultPlan:
    """Deterministic fault schedule, armed as a context manager::

        with FaultPlan(nan_requests=[2]) as fp:
            reports = session.evaluate_batch(requests)
        assert fp.injected["nan_requests"] == 1

    Each keyword takes ``True`` (every occurrence), an int ordinal, or an
    iterable of ordinals (0-based, counted while the plan is armed):

    * ``nan_requests`` — poison these request ordinals' positions with
      NaN before validation sees them.
    * ``fail_dispatches`` — raise :class:`FaultInjected` on these engine
      dispatch ordinals.
    * ``slow_dispatches`` — sleep ``slow_seconds`` (default 0.05) at the
      top of these dispatch ordinals (an injected straggler).
    * ``hang_dispatches`` — block these dispatch ordinals until the
      watchdog abandons them (``release_hangs``) or the plan disarms,
      with ``hang_seconds`` (default 20.0) as the safety bound; then
      raise :class:`FaultInjected` into the (discarded) worker.  Note:
      abandoning sets the plan-wide release event, so later hang
      ordinals in the SAME plan release immediately — use one hang per
      plan for precise timing.
    * ``mesh_loss_dispatches`` — raise ``BackendUnavailableError`` on
      these *sharded* dispatch ordinals (simulated mesh loss).
    * ``reject_probes`` — raise ``BackendUnavailableError`` on these
      breaker canary-probe ordinals (the half-open re-probe fails).
    * ``overflow_storms`` — force ``overflow > 0`` on these dispatch
      results (``True`` = every dispatch: the replan loop can never
      converge).
    """

    def __init__(self, *, nan_requests=None, fail_dispatches=None,
                 mesh_loss_dispatches=None, overflow_storms=None,
                 slow_dispatches=None, hang_dispatches=None,
                 reject_probes=None, slow_seconds: float = 0.05,
                 hang_seconds: float = 20.0):
        self.nan_requests = _ordinals(nan_requests)
        self.fail_dispatches = _ordinals(fail_dispatches)
        self.mesh_loss_dispatches = _ordinals(mesh_loss_dispatches)
        self.overflow_storms = _ordinals(overflow_storms)
        self.slow_dispatches = _ordinals(slow_dispatches)
        self.hang_dispatches = _ordinals(hang_dispatches)
        self.reject_probes = _ordinals(reject_probes)
        self.slow_seconds = float(slow_seconds)
        self.hang_seconds = float(hang_seconds)
        self._seen = {"requests": 0, "dispatches": 0, "sharded": 0,
                      "storm_checks": 0, "probes": 0}
        self.injected = {"nan_requests": 0, "fail_dispatches": 0,
                         "mesh_loss_dispatches": 0, "overflow_storms": 0,
                         "slow_dispatches": 0, "hang_dispatches": 0,
                         "reject_probes": 0}
        # ordinal bumps happen under this lock: the watchdog dispatches
        # on worker threads, and two concurrent hooks must never share
        # an ordinal (the injected-counter bumps ride the same lock)
        self._lock = threading.Lock()
        # set by release_hangs() (watchdog abandonment) or __exit__, so
        # injected hangs never outlive the plan by more than a tick
        self._release = threading.Event()

    def _next(self, site: str) -> int:
        with self._lock:
            ordinal = self._seen[site]
            self._seen[site] = ordinal + 1
            return ordinal

    def _bump(self, key: str) -> None:
        with self._lock:
            self.injected[key] += 1

    def __enter__(self):
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a FaultPlan is already armed; nest-free "
                               "by design (determinism)")
        _ACTIVE = self
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = None
        self._release.set()
        return False


def active() -> FaultPlan | None:
    """The armed plan, or None (the steady-state answer)."""
    return _ACTIVE


# ---------------------------------------------------------------------------
# hook points (called by the serving session / distributed driver)
# ---------------------------------------------------------------------------

def corrupt_request(pos):
    """Request-arrival hook: returns ``pos``, NaN-poisoned if this
    request ordinal is selected."""
    p = _ACTIVE
    if p is None:
        return pos
    ordinal = p._next("requests")
    if not _hit(p.nan_requests, ordinal):
        return pos
    p._bump("nan_requests")
    bad = np.array(pos, np.float32, copy=True)
    bad[0 if bad.ndim == 2 else (0, 0)] = np.nan
    return bad


def check_dispatch() -> None:
    """Dispatch hook: hangs, slows, or raises :class:`FaultInjected` on
    selected ordinals."""
    p = _ACTIVE
    if p is None:
        return
    ordinal = p._next("dispatches")
    if _hit(p.hang_dispatches, ordinal):
        p._bump("hang_dispatches")
        # block until abandoned (release_hangs), the plan disarms, or
        # the safety bound elapses — then fail the (discarded) worker
        # instead of running the engine it was pretending to hang
        p._release.wait(p.hang_seconds)
        raise FaultInjected(f"injected hang released (ordinal {ordinal})")
    if _hit(p.slow_dispatches, ordinal):
        p._bump("slow_dispatches")
        time.sleep(p.slow_seconds)
    if _hit(p.fail_dispatches, ordinal):
        p._bump("fail_dispatches")
        raise FaultInjected(f"injected dispatch failure (ordinal {ordinal})")


def check_sharded() -> None:
    """Sharded-dispatch hook: raises ``BackendUnavailableError`` on
    selected ordinals (simulated mesh loss)."""
    p = _ACTIVE
    if p is None:
        return
    ordinal = p._next("sharded")
    if _hit(p.mesh_loss_dispatches, ordinal):
        p._bump("mesh_loss_dispatches")
        raise BackendUnavailableError(
            f"injected mesh loss (sharded dispatch ordinal {ordinal})")


def check_probe() -> None:
    """Breaker canary-probe hook: raises ``BackendUnavailableError`` on
    selected probe ordinals (the half-open re-probe fails and the
    circuit must re-open)."""
    p = _ACTIVE
    if p is None:
        return
    ordinal = p._next("probes")
    if _hit(p.reject_probes, ordinal):
        p._bump("reject_probes")
        raise BackendUnavailableError(
            f"injected probe rejection (probe ordinal {ordinal})")


def release_hangs() -> None:
    """Watchdog hook: un-block any injected hang so the abandoned worker
    thread exits promptly instead of sleeping out ``hang_seconds``."""
    p = _ACTIVE
    if p is not None:
        p._release.set()


def storm_overflow(reports):
    """Result hook: forces ``overflow`` positive on selected dispatch
    results (the overflow storm)."""
    p = _ACTIVE
    if p is None:
        return reports
    ordinal = p._next("storm_checks")
    if not _hit(p.overflow_storms, ordinal):
        return reports
    p._bump("overflow_storms")
    return [r._replace(overflow=max(int(r.overflow or 0), 1))
            for r in reports]
