"""The one typed result: :class:`ReadabilityScores` (counterpart of
:mod:`repro.core.scores`, same fields and views).

The type serves three altitudes: *device* (fields are tensors fresh out
of the engine, scalars or ``(B,)``), *host* (after
:func:`scores_from_result`: Python ints/floats with ``n_vertices`` /
``n_edges`` filled in) and *batched* (leading ``B`` dim,
:meth:`ReadabilityScores.unbatch` splits).  A host conversion fetches
every tensor field in one device-to-host copy.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.validate import (CancelledError, DeadlineExceededError,
                                       OverloadedError)
from repro_torch.spans import span

METRIC_FIELDS = ("node_occlusion", "minimum_angle", "edge_length_variation",
                 "edge_crossing", "edge_crossing_angle",
                 "crossing_count_for_angle")
_INT_FIELDS = ("node_occlusion", "edge_crossing", "crossing_count_for_angle")
_FETCHED = METRIC_FIELDS + ("overflow",)


def _fetch(res) -> dict:
    """Host numpy values of the metric and overflow fields of ``res``.

    Tensor fields travel together: stacked as float64 (exact for counts
    below 2**53 and for every float32) into one copy, then cast back to
    each field's dtype."""
    out, tensors = {}, []
    for name in _FETCHED:
        v = getattr(res, name)
        if isinstance(v, torch.Tensor):
            tensors.append((name, v))
        else:
            out[name] = None if v is None else np.asarray(v)
    if tensors:
        shape = torch.broadcast_shapes(*(t.shape for _, t in tensors))
        host = torch.stack([t.to(torch.float64).expand(shape)
                            for _, t in tensors]).cpu().numpy()
        for (name, t), row in zip(tensors, host):
            dtype = np.int64 if name in _INT_FIELDS or name == "overflow" \
                else np.float32
            out[name] = row.astype(dtype)
    return out


class ReadabilityScores(NamedTuple):
    """Scores of one layout (scalars) or a batch of layouts ((B,) fields).

    ``overflow`` counts capacity drops (0 means the plan's capacities
    covered the layout).  ``n_vertices`` / ``n_edges`` are host-side
    sizes that let :meth:`normalized` relate counts to pair budgets.
    ``error`` is a :class:`repro_torch.core.validate.ReadabilityError`
    when this slot of a quarantining batch call failed; ``flags``
    records sanitization (``{"sanitized": True, ...}``) or saturation
    (``{"saturated": True}``).
    """

    node_occlusion: Any = None
    minimum_angle: Any = None
    edge_length_variation: Any = None
    edge_crossing: Any = None
    edge_crossing_angle: Any = None
    crossing_count_for_angle: Any = None
    overflow: Any = None
    n_vertices: Any = None
    n_edges: Any = None
    error: Any = None
    flags: Any = None

    def asdict(self) -> dict:
        return dict(self._asdict())

    @property
    def ok(self) -> bool:
        """True when this slot evaluated (no quarantined error)."""
        return self.error is None

    @property
    def saturated(self) -> bool:
        """True when capacities stayed overflowed after the bounded
        replan retries (sanitize mode; counts may be under-reported)."""
        return bool(self.flags) and bool(self.flags.get("saturated"))

    @property
    def shed(self) -> bool:
        """True when admission control shed this request (``error`` is
        :class:`~repro_torch.core.validate.OverloadedError`)."""
        return isinstance(self.error, OverloadedError)

    @property
    def expired(self) -> bool:
        """True when the request's deadline passed before its dispatch
        completed (``error`` is
        :class:`~repro_torch.core.validate.DeadlineExceededError`)."""
        return isinstance(self.error, DeadlineExceededError)

    @property
    def cancelled(self) -> bool:
        """True when the request's cancel token fired before dispatch
        (``error`` is :class:`~repro_torch.core.validate.CancelledError`)."""
        return isinstance(self.error, CancelledError)

    def raise_for_error(self) -> "ReadabilityScores":
        """Raise the quarantined error, if any; else return self."""
        if self.error is not None:
            raise self.error
        return self

    @property
    def batch_size(self):
        """Leading batch dim of the metric fields, or None for scalars."""
        for name in _FETCHED:
            v = getattr(self, name)
            if v is not None and getattr(v, "ndim", 0) >= 1:
                return int(v.shape[0])
        return None

    def unbatch(self):
        """Split a batched result into per-layout host scores."""
        return scores_from_batch(self, self.n_vertices, self.n_edges)

    def normalized(self) -> "ReadabilityScores":
        """[0, 1] readability view: higher is always better.

        ``N_c`` against C(V, 2), ``E_c`` against C(E, 2), ``M_l``
        squashed by ``1 / (1 + M_l)``; ``M_a`` and ``E_ca`` are already in
        [0, 1].  Batch-aware.  Needs ``n_vertices`` / ``n_edges`` when
        the respective counts are present.
        """
        got = _fetch(self)
        out = {}
        if got["node_occlusion"] is not None:
            if self.n_vertices is None:
                raise ValueError("normalized() needs n_vertices to scale "
                                 "node_occlusion; evaluate through "
                                 "repro_torch.api so the sizes are recorded")
            v = int(self.n_vertices)
            pairs = max(v * (v - 1) // 2, 1)
            out["node_occlusion"] = _unit(
                1.0 - got["node_occlusion"].astype(np.float64) / pairs)
        if got["edge_crossing"] is not None:
            if self.n_edges is None:
                raise ValueError("normalized() needs n_edges to scale "
                                 "edge_crossing; evaluate through "
                                 "repro_torch.api so the sizes are recorded")
            e = int(self.n_edges)
            pairs = max(e * (e - 1) // 2, 1)
            out["edge_crossing"] = _unit(
                1.0 - got["edge_crossing"].astype(np.float64) / pairs)
        if got["edge_length_variation"] is not None:
            m_l = got["edge_length_variation"].astype(np.float64)
            out["edge_length_variation"] = _unit(1.0 / (1.0 + m_l))
        for name in ("minimum_angle", "edge_crossing_angle"):
            if got[name] is not None:
                out[name] = _unit(got[name].astype(np.float64))
        ccfa = got["crossing_count_for_angle"]
        return ReadabilityScores(
            crossing_count_for_angle=_plain(ccfa),
            overflow=_plain(got["overflow"]), n_vertices=self.n_vertices,
            n_edges=self.n_edges, error=self.error, flags=self.flags, **out)


def _unit(x):
    x = np.clip(x, 0.0, 1.0)
    return float(x) if np.ndim(x) == 0 else x


def _plain(v):
    if v is None or np.ndim(v):
        return v
    return v.item()


# ---------------------------------------------------------------------------
# host conversions (each fetches every tensor field in ONE copy)
# ---------------------------------------------------------------------------

def _cast(v, to):
    return None if v is None else to(v)


def scores_from_result(res, n_vertices=None, n_edges=None
                       ) -> ReadabilityScores:
    """One (unbatched) engine result -> host scores (Python scalars)."""
    with span("scores.fetch"):
        got = _fetch(res)
    return ReadabilityScores(
        node_occlusion=_cast(got["node_occlusion"], int),
        minimum_angle=_cast(got["minimum_angle"], float),
        edge_length_variation=_cast(got["edge_length_variation"], float),
        edge_crossing=_cast(got["edge_crossing"], int),
        edge_crossing_angle=_cast(got["edge_crossing_angle"], float),
        crossing_count_for_angle=_cast(got["crossing_count_for_angle"], int),
        overflow=0 if got["overflow"] is None else int(got["overflow"]),
        n_vertices=_cast(n_vertices, int), n_edges=_cast(n_edges, int),
        error=getattr(res, "error", None), flags=getattr(res, "flags", None))


def error_scores(error, n_vertices=None, n_edges=None) -> ReadabilityScores:
    """The per-slot result of a quarantined request: every metric
    ``None``, the typed error attached."""
    return ReadabilityScores(error=error, n_vertices=_cast(n_vertices, int),
                             n_edges=_cast(n_edges, int))


def host_batch(res, n_vertices=None, n_edges=None,
               flags=None) -> ReadabilityScores:
    """A batched engine result with numpy ``(B,)`` fields (one copy)."""
    with span("scores.fetch"):
        got = _fetch(res)
    return ReadabilityScores(**got, n_vertices=n_vertices, n_edges=n_edges,
                             flags=flags)


def scores_from_batch(res, n_vertices=None, n_edges=None):
    """Split a batched result (leading B dim on every field) into a list
    of B host :class:`ReadabilityScores`; one copy."""
    got = _fetch(res)
    batch = ReadabilityScores(**got).batch_size
    if batch is None:
        raise ValueError("scores_from_batch needs a batched result; "
                         "use scores_from_result for scalars")

    def pick(name, i, cast):
        field = got[name]
        return None if field is None else cast(field[i])

    return [ReadabilityScores(
        node_occlusion=pick("node_occlusion", i, int),
        minimum_angle=pick("minimum_angle", i, float),
        edge_length_variation=pick("edge_length_variation", i, float),
        edge_crossing=pick("edge_crossing", i, int),
        edge_crossing_angle=pick("edge_crossing_angle", i, float),
        crossing_count_for_angle=pick("crossing_count_for_angle", i, int),
        overflow=0 if got["overflow"] is None else int(got["overflow"][i]),
        n_vertices=_cast(n_vertices, int), n_edges=_cast(n_edges, int))
        for i in range(batch)]
