"""Mesh-sharded *batched* evaluation: the batch axis over the ranks
(counterpart of :mod:`repro.distributed.batched`).

The layout-optimization workload scores B candidate layouts of one graph
per search step.  Every per-layout value of the natively batched engine
program (:func:`repro_torch.core.engine.evaluate_batched_body`) is
computed by per-layout code (each bucketing sort is per row, each sweep
reduction per layout), so the batch splits over the ranks with no
collective until the per-layout results are gathered: each rank runs the
batched body on its ``(B / n, V, 2)`` slice (the strip-reversal kernel on
its tier slabs), then the ranks ``all_gather`` the results.  Integer
metrics equal the single-host :func:`~repro_torch.core.engine.
evaluate_layouts`'s, floats agree to rounding.

``Evaluator(EvalConfig(backend="distributed")).evaluate_batch`` routes
here, and an :class:`~repro_torch.launch.session.EvalSession` with a
``mesh`` dispatches coalesced serving batches through it.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.scores import ReadabilityScores
from repro_torch.core.validate import BackendUnavailableError
from repro_torch.distributed.collectives import all_gather


def pad_batch_to_devices(batch_pos, n_dev: int):
    """Pad the batch axis up to a multiple of ``n_dev`` with copies of
    layout 0: real, in-extent coordinates, which cannot overflow a
    capacity the natural batch does not (PARK padding could overflow the
    occlusion grid's corner cell).  Returns ``(padded, natural_B)``."""
    B = batch_pos.shape[0]
    pad = (-B) % n_dev
    if pad == 0:
        return batch_pos, B
    if isinstance(batch_pos, torch.Tensor):
        filler = batch_pos[:1].expand((pad,) + tuple(batch_pos.shape[1:]))
        return torch.cat([batch_pos, filler]), B
    filler = np.broadcast_to(batch_pos[:1], (pad,) + batch_pos.shape[1:])
    return np.concatenate([batch_pos, filler]), B


def evaluate_layouts_sharded(mesh, plan, batch_pos, edges, *,
                             n_valid_vertices=None, n_valid_edges=None):
    """Mesh-sharded :func:`~repro_torch.core.engine.evaluate_layouts`:
    ``(B, V, 2)`` candidate layouts of one graph, batch axis split over
    every axis of ``mesh``; every rank calls it with the same arguments
    and gets the whole batched
    :class:`~repro_torch.core.scores.ReadabilityScores` (``(B,)`` device
    fields on ``mesh.device``).

    ``B`` need not divide ``mesh.size``: the batch is padded with copies
    of layout 0 and the results cut back.  ``n_valid_vertices`` /
    ``n_valid_edges`` follow the engine's padding contract and
    ``overflow`` feeds :func:`~repro_torch.core.engine.replan_on_overflow`.
    ``plan`` is the ordinary host-side plan, replicated.  A failed
    dispatch raises :class:`BackendUnavailableError` with the original
    error chained."""
    if getattr(batch_pos, "ndim", None) != 3:
        raise ValueError("evaluate_layouts_sharded wants a (B, V, 2) "
                         "batch; got shape "
                         f"{tuple(getattr(batch_pos, 'shape', ()))}")
    if not isinstance(batch_pos, torch.Tensor):
        batch_pos = np.asarray(batch_pos, np.float32)
    padded, B = pad_batch_to_devices(batch_pos, mesh.size)
    per = padded.shape[0] // mesh.size
    mine = padded[mesh.rank * per:(mesh.rank + 1) * per]
    try:
        res = engine.evaluate_batched_body(
            plan, mine, edges, n_valid_vertices, n_valid_edges,
            device=mesh.device)
        res = ReadabilityScores(*(
            None if v is None else all_gather(mesh, v)[:B] for v in res))
    except Exception as err:
        # a failed mesh dispatch is an infrastructure failure: the typed
        # error, original chained, so that the session's ladder (and
        # direct callers) catch one class
        raise BackendUnavailableError(
            f"sharded dispatch over {mesh.size} ranks failed: "
            f"{type(err).__name__}: {err}") from err
    return res
