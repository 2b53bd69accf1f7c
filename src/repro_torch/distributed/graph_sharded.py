"""Graph-axis sharded evaluation: ONE layout spatially partitioned over the
ranks of a mesh (counterpart of :mod:`repro.distributed.graph_sharded`).

The paper's headline numbers (17x node occlusion, 146x edge crossing on
a Spark cluster, fig. 4) are about one graph too large for one worker.
This driver partitions the decompositions of one layout contiguously over
a 1-D mesh (:func:`repro_torch.core.grid.plan_graph_shards`):

* **strips** (E_c / E_ca): rank ``i`` sweeps strips ``[i *
  strips_per_shard, ...)`` with the strip-reversal kernel, and the ranks
  sum their partial (count, deviation) sums;
* **occlusion cells** (N_c): contiguous flat-cell ranges with exactly ONE
  one-sided halo exchange
  (:func:`repro_torch.distributed.collectives.halo_exchange`);
* **M_a / M_l**: replicated.

Inputs are replicated on every rank (coordinates are O(V); what is
sharded is the O(pairs) sweep work), and every rank gets the summed
totals.  Integer metrics equal the single-host fused engine's under the
same flat plan and do not depend on the rank count; the
``halo_exchanges`` counter of :data:`repro_torch.core.grid.CALL_COUNTS`
certifies one exchange per evaluation, zero for strip-only metric
subsets.

``EvalSession(EvalConfig(backend="graph_sharded"))`` routes here, with
the degradation ladder down to the single-host fused engine on a failed
dispatch (:class:`~repro_torch.core.validate.BackendUnavailableError`).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import engine
from repro_torch.core import grid as gridlib
from repro_torch.core.validate import BackendUnavailableError


def plan_with_shard_spec(plan, n_shards: int):
    """``plan`` with its ``graph_shard`` spec matching ``n_shards``.

    The per-rank strip and cell ranges derive from the plan's own grid
    geometry, so a replanned (grown) plan gets fresh ranges.  Returns the
    plan unchanged when the spec already matches."""
    spec = gridlib.plan_graph_shards(plan.n_strips, plan.grid_nx,
                                     plan.grid_ny, n_shards)
    if plan.graph_shard == spec:
        return plan
    return dataclasses.replace(plan, graph_shard=spec)


def evaluate_graph_sharded(mesh, plan, pos, edges, *, n_valid_vertices=None,
                           n_valid_edges=None):
    """Evaluate ONE ``(V, 2)`` layout with its decompositions partitioned
    over ``mesh`` (1-D); every rank of the mesh calls it with the same
    arguments.

    Returns the :class:`~repro_torch.core.scores.ReadabilityScores` of
    device scalars that :func:`~repro_torch.core.engine.evaluate_planned`
    returns, with integer metrics equal to it under the same flat plan
    (``tier_strips=False``: every rank sweeps the flat top capacity).
    ``n_valid_vertices`` / ``n_valid_edges`` follow the engine's padding
    contract, and ``overflow`` feeds
    :func:`~repro_torch.core.engine.replan_on_overflow`.  ``plan``'s
    ``graph_shard`` spec is derived here from ``mesh.size``.  A failed
    dispatch raises :class:`BackendUnavailableError` with the original
    error chained."""
    if getattr(pos, "ndim", None) != 2:
        raise ValueError("evaluate_graph_sharded wants ONE (V, 2) layout "
                         "(the graph axis is what is sharded); got shape "
                         f"{tuple(getattr(pos, 'shape', ()))}")
    if len(mesh.axis_names) != 1:
        raise ValueError("evaluate_graph_sharded wants a 1-D mesh; got "
                         f"axes {tuple(mesh.axis_names)}")
    plan = plan_with_shard_spec(plan, mesh.size)
    try:
        return engine.evaluate_graph_shard_body(
            plan, pos, edges, mesh=mesh, n_valid_vertices=n_valid_vertices,
            n_valid_edges=n_valid_edges)
    except Exception as err:
        # a failed mesh dispatch (a lost rank, a collective or kernel
        # error) is an infrastructure failure: one typed error class,
        # original chained, which the session's ladder catches
        raise BackendUnavailableError(
            f"graph-sharded dispatch over {mesh.size} ranks failed: "
            f"{type(err).__name__}: {err}") from err
