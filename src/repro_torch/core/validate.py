"""Request validation and the typed error taxonomy (numpy copy of
:mod:`repro.core.validate`; outputs are byte-identical to the reference).

The serving layer is infrastructure other systems block on, and it used
to trust every request completely: a single NaN coordinate poisons the
one-sort bucketing comparator for a whole coalesced batch, out-of-range
edge indices are silently clamped by JAX gathers into plausible-but-wrong
crossing counts (Kwon et al., PAPERS.md, is the cautionary tale — >55%
silent error disqualified their ML scorer), and degenerate requests
(E=0, V<=1) crashed host-side planning with shape errors.  This module
is the one place requests are checked and normalized before they reach
the engine.

**Error taxonomy** (everything the public surface raises deliberately):

* :class:`ReadabilityError` — base class; callers that want "anything
  this library threw on purpose" catch this.
* :class:`InvalidInputError` — the request itself is malformed (NaN/Inf
  positions, edge indices out of range, uninterpretable shapes/dtypes).
  Carries ``request_index`` and ``reason``.
* :class:`CapacityError` — the evaluation could not be completed within
  plan capacities even after bounded replan retries (the result would
  silently under-count).
* :class:`BackendUnavailableError` — the selected execution backend
  failed to dispatch (mesh lost, shard_map error); the degradation
  ladder in :class:`repro_torch.launch.session.EvalSession` falls back to the
  single-host fused engine before this ever reaches a caller.
* :class:`OverloadedError` — admission control shed the request: the
  bounded queue in front of coalescing was full (or over its cost
  budget) and this request lost the deterministic
  oldest-deadline-first shed ordering
  (:mod:`repro.launch.admission`).
* :class:`DeadlineExceededError` — the request's deadline passed
  before its dispatch completed (expired while queued, or its dispatch
  hung past the wall-clock guard and was abandoned by the watchdog).
* :class:`CancelledError` — the request's
  :class:`~repro.launch.admission.CancelToken` was cancelled before
  the request dispatched.

**Validation modes** (``EvalConfig.validation``):

* ``"strict"`` (default) — malformed requests raise
  :class:`InvalidInputError`; inside :meth:`EvalSession.evaluate_batch`
  the error is quarantined to the offending request's slot instead
  (see the session docstring).
* ``"sanitize"`` — malformed *parts* are dropped and the repair is
  recorded in ``flags``: non-finite vertices are removed (their incident
  edges too, indices remapped), out-of-range edges are dropped.  A
  sanitized request is always valid, and sanitizing is idempotent
  (``tests/test_validate.py`` proves both by property).
* ``"off"`` — the pre-validation behavior: dtype coercion only, garbage
  in / garbage (or a crash) out.  The escape hatch for callers that
  have already validated upstream and want zero host-side overhead.

Both ``strict`` and ``sanitize`` also *normalize*: self-loops are
dropped in every mode but ``off`` (they contribute to no metric's pair
budget but used to skew strip planning), and empty/degenerate graphs
(E=0, V<=1) pass through as well-formed requests that the engine's
degenerate-safe planning handles end-to-end.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np

VALIDATION_MODES = ("strict", "sanitize", "off")


# ---------------------------------------------------------------------------
# the error taxonomy
# ---------------------------------------------------------------------------

class ReadabilityError(Exception):
    """Base class for every deliberate error the evaluation surface
    raises; carries an optional ``request_index`` locating the offending
    request inside a batch."""

    def __init__(self, message: str, *, request_index: Optional[int] = None):
        super().__init__(message)
        self.request_index = request_index

    def __str__(self):
        base = super().__str__()
        if self.request_index is None:
            return base
        return f"[request {self.request_index}] {base}"


class InvalidInputError(ReadabilityError):
    """The request is malformed (non-finite positions, out-of-range edge
    indices, uninterpretable shapes).  ``reason`` is a short machine-
    checkable tag (``"non_finite_positions"``, ``"edge_index_range"``,
    ``"bad_shape"``, ``"bad_dtype"``)."""

    def __init__(self, message: str, *, request_index: Optional[int] = None,
                 reason: str = "invalid"):
        super().__init__(message, request_index=request_index)
        self.reason = reason


class CapacityError(ReadabilityError):
    """Plan capacities stayed overflowed after the bounded replan
    retries: returning a result would silently under-count.  ``overflow``
    is the residual dropped-item count from the last attempt."""

    def __init__(self, message: str, *, request_index: Optional[int] = None,
                 overflow: int = 0):
        super().__init__(message, request_index=request_index)
        self.overflow = int(overflow)


class BackendUnavailableError(ReadabilityError):
    """The selected backend could not dispatch (mesh lost, shard_map /
    device failure).  The serving session degrades distributed -> fused
    single-host on this instead of surfacing it; direct backend callers
    see it raised with the original failure chained."""


class OverloadedError(ReadabilityError):
    """Admission control shed this request: the bounded queue in front
    of coalescing (:mod:`repro.launch.admission`) was full or over its
    cost budget.  Shedding is deterministic (oldest-deadline-first, ties
    broken latest-arrival-first), so the same arrival sequence always
    sheds the same request set.  ``queue_depth`` is how many requests
    were competing for admission, ``bound`` the limit that was hit."""

    def __init__(self, message: str, *, request_index: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 bound: Optional[int] = None):
        super().__init__(message, request_index=request_index)
        self.queue_depth = queue_depth
        self.bound = bound


class DeadlineExceededError(ReadabilityError):
    """The request's deadline passed before its evaluation completed:
    it expired while queued behind earlier dispatches, or its own
    dispatch hung past the wall-clock guard and was abandoned by the
    watchdog (the hung program cannot be interrupted, but it no longer
    blocks the queue — every coalesced neighbour keeps draining).
    ``elapsed`` is wall-clock seconds since the request arrived, when
    known."""

    def __init__(self, message: str, *, request_index: Optional[int] = None,
                 elapsed: Optional[float] = None):
        super().__init__(message, request_index=request_index)
        self.elapsed = None if elapsed is None else float(elapsed)


class CancelledError(ReadabilityError):
    """The request's :class:`~repro.launch.admission.CancelToken` was
    cancelled before the request dispatched; the slot fails without any
    engine work."""


# ---------------------------------------------------------------------------
# validated requests
# ---------------------------------------------------------------------------

class ValidatedRequest(NamedTuple):
    """The outcome of :func:`validate_request`.

    ``pos``/``edges`` are the (possibly repaired) contiguous host arrays
    (float32 ``(V, 2)``, int32 ``(E, 2)``).  ``flags`` is ``None`` when
    the request passed untouched, else a dict recording every repair
    (``dropped_vertices``, ``dropped_edges``, ``self_loops``,
    ``sanitized``) — the session copies it onto the returned scores so a
    repaired request is never mistaken for a pristine one."""

    pos: Any
    edges: Any
    flags: Optional[dict]


def _coerce(pos, edges, index):
    """Shared dtype/shape coercion: returns float32 (V, 2) positions and
    int32 (E, 2) edges or raises :class:`InvalidInputError`."""
    try:
        pos = np.asarray(pos, dtype=np.float32)
    except (TypeError, ValueError) as e:
        raise InvalidInputError(f"positions not coercible to float32: {e}",
                                request_index=index, reason="bad_dtype")
    if pos.ndim != 2 or pos.shape[1] != 2:
        raise InvalidInputError(
            f"positions must have shape (V, 2), got {pos.shape}",
            request_index=index, reason="bad_shape")
    edges_arr = np.asarray(edges)
    if edges_arr.size == 0:
        edges_arr = np.zeros((0, 2), np.int32)
    if edges_arr.ndim != 2 or edges_arr.shape[1] != 2:
        raise InvalidInputError(
            f"edges must have shape (E, 2), got {edges_arr.shape}",
            request_index=index, reason="bad_shape")
    if not np.issubdtype(edges_arr.dtype, np.integer):
        as_int = edges_arr.astype(np.int64, copy=False)
        # float-typed but integral-valued edge lists are coerced; a
        # fractional vertex id is uninterpretable in any mode
        with np.errstate(invalid="ignore"):
            integral = np.all(np.isfinite(edges_arr)) and \
                np.array_equal(as_int, edges_arr)
        if not integral:
            raise InvalidInputError(
                "edge indices must be integers "
                f"(got dtype {edges_arr.dtype} with non-integral values)",
                request_index=index, reason="bad_dtype")
        edges_arr = as_int
    edges_arr = np.ascontiguousarray(edges_arr, np.int32)
    return np.ascontiguousarray(pos), edges_arr


def validate_request(pos, edges, *, mode: str = "strict",
                     index: Optional[int] = None) -> ValidatedRequest:
    """Validate (and in ``sanitize`` mode repair) one request.

    Runs entirely on host numpy *before* any padding, hashing, or
    coalescing — a poisoned request can therefore only ever fail itself.
    Returns a :class:`ValidatedRequest`; raises
    :class:`InvalidInputError` in ``strict`` mode (and for
    uninterpretable inputs in every mode but ``off``).
    """
    if mode not in VALIDATION_MODES:
        raise ValueError(f"validation mode must be one of "
                         f"{VALIDATION_MODES}, got {mode!r}")
    if mode == "off":
        return ValidatedRequest(np.asarray(pos, np.float32),
                                np.asarray(edges, np.int32), None)

    pos, edges = _coerce(pos, edges, index)
    n_v = pos.shape[0]
    flags: dict = {}

    finite = np.isfinite(pos).all(axis=1)
    n_bad_v = int(n_v - int(finite.sum()))
    if n_bad_v:
        if mode == "strict":
            raise InvalidInputError(
                f"{n_bad_v} of {n_v} vertex positions are non-finite "
                "(NaN/Inf would poison the bucketing sort for the whole "
                "coalesced batch)",
                request_index=index, reason="non_finite_positions")
        # sanitize: drop the poisoned vertices, remap the survivors
        remap = np.cumsum(finite) - 1          # old id -> new id
        pos = np.ascontiguousarray(pos[finite])
        flags["dropped_vertices"] = n_bad_v
        if edges.shape[0]:
            ok = (edges >= 0) & (edges < n_v)
            endpoint_alive = np.zeros(edges.shape, bool)
            endpoint_alive[ok] = finite[edges[ok]]
            keep = endpoint_alive.all(axis=1)
            # edges referencing a dropped vertex go with it; out-of-range
            # endpoints survive to the range check below so the
            # accounting stays per-cause
            keep |= ~ok.all(axis=1)
            dropped = int(edges.shape[0] - int(keep.sum()))
            if dropped:
                flags["dropped_edges"] = dropped
            edges = edges[keep]
            inb = (edges >= 0) & (edges < n_v)
            remapped = edges.copy()
            remapped[inb] = remap[edges[inb]]
            edges = np.ascontiguousarray(remapped)
        n_v = pos.shape[0]

    if edges.shape[0]:
        in_range = ((edges >= 0) & (edges < n_v)).all(axis=1)
        n_oor = int(edges.shape[0] - int(in_range.sum()))
        if n_oor:
            if mode == "strict":
                bad = int(np.flatnonzero(~in_range)[0])
                raise InvalidInputError(
                    f"{n_oor} edges reference vertices outside [0, {n_v}) "
                    f"(first offender: edge {bad} = "
                    f"{tuple(int(x) for x in edges[bad])}); JAX gathers "
                    "would clamp these into wrong-but-finite counts",
                    request_index=index, reason="edge_index_range")
            flags["dropped_edges"] = flags.get("dropped_edges", 0) + n_oor
            edges = np.ascontiguousarray(edges[in_range])

    if edges.shape[0]:
        loops = edges[:, 0] == edges[:, 1]
        n_loops = int(loops.sum())
        if n_loops:
            # normalization, not an error: self-loops belong to no pair
            # budget of any metric, but used to skew strip planning
            flags["self_loops"] = n_loops
            edges = np.ascontiguousarray(edges[~loops])

    if flags:
        flags["sanitized"] = True
    return ValidatedRequest(pos, edges, flags or None)


def validate_batch(batch_pos, edges, *, mode: str = "strict"):
    """Validate a ``(B, V, 2)`` candidate batch sharing one edge list.

    The batch members share one topology, so edge repairs (range check,
    self-loop normalization) apply once; position finiteness is checked
    per layout.  Batch shapes cannot drop individual layouts, so a
    non-finite member raises :class:`InvalidInputError` (carrying the
    offending layout's index) in *both* ``strict`` and ``sanitize`` —
    per-request quarantine is the serving session's job
    (:meth:`repro_torch.launch.session.EvalSession.evaluate_batch`).
    Returns ``(batch_pos, edges, flags)``.
    """
    if mode not in VALIDATION_MODES:
        raise ValueError(f"validation mode must be one of "
                         f"{VALIDATION_MODES}, got {mode!r}")
    batch_pos = np.asarray(batch_pos, np.float32)
    edges = np.asarray(edges, np.int32)
    if mode == "off":
        return batch_pos, edges, None
    if batch_pos.ndim != 3 or batch_pos.shape[-1] != 2:
        raise InvalidInputError(
            f"batch positions must have shape (B, V, 2), got "
            f"{batch_pos.shape}", reason="bad_shape")
    finite = np.isfinite(batch_pos).all(axis=(1, 2))
    if not finite.all():
        bad = int(np.flatnonzero(~finite)[0])
        raise InvalidInputError(
            f"layout {bad} of the batch has non-finite positions",
            request_index=bad, reason="non_finite_positions")
    validated = validate_request(batch_pos[0], edges, mode=mode)
    if validated.flags and validated.flags.get("dropped_vertices"):
        # vertex drops would desynchronize the shared (B, V, 2) shape;
        # finiteness was already checked, so this only triggers in
        # sanitize mode on inputs strict would have rejected anyway
        raise InvalidInputError(
            "cannot sanitize vertex drops across a shared-shape batch",
            reason="non_finite_positions")
    return batch_pos, validated.edges, validated.flags
