"""The exact all-pairs readability scores (paper S3.1) and the legacy
evaluation shims; counterpart of :mod:`repro.core.metrics`.

* :func:`evaluate_exact` -- the exact-reference front door, re-exported
  by :mod:`repro_torch.api` (not deprecated).
* :func:`evaluate_layout` -- DEPRECATED kwarg mirror: ``method="exact"``
  routes to :func:`evaluate_exact`, the enhanced path to the cached
  config-keyed evaluator (:func:`repro_torch.api.evaluator_for`).
* ``ReadabilityReport``, :func:`report_from_result`,
  :func:`reports_from_batch` and ``EngineResult`` -- the old names of
  :class:`~repro_torch.core.scores.ReadabilityScores` and its
  conversions.

The exact path is the ground truth the enhanced (strip and grid) path is
measured against, as in the paper's accuracy tables: O(V^2) occlusion,
O(E^2) CCW crossing sweep, exact crossing angles.  On the CUDA device
its pairwise sweeps are hand-written kernels (:mod:`repro_torch.kernels`)
whatever ``use_kernels`` says; on the CPU their plain PyTorch versions
run.
"""

from __future__ import annotations

import torch

from repro_torch.core import engine
from repro_torch.core.crossing import count_crossings_exact
from repro_torch.core.crossing_angle import DEFAULT_IDEAL, finish_exact
from repro_torch.core.edge_length import edge_length_variation
from repro_torch.core.engine import ALL_METRICS, resolve_device
from repro_torch.core.keys import EvalConfig, warn_once
from repro_torch.core.min_angle import minimum_angle
from repro_torch.core.occlusion import count_occlusions_exact
from repro_torch.core.scores import (ReadabilityScores, scores_from_batch,
                                     scores_from_result)
from repro_torch.distributed import pairwise
from repro_torch.kernels import ops
from repro_torch.spans import span

# Legacy names: one typed result for every path (see repro_torch.core.scores).
ReadabilityReport = ReadabilityScores
report_from_result = scores_from_result
reports_from_batch = scores_from_batch
EngineResult = engine.EngineResult


def evaluate_exact(pos, edges, *, config: EvalConfig = None,
                   use_kernels: bool = False, device=None,
                   mesh=None) -> ReadabilityScores:
    """Exact (all-pairs, paper S3.1) readability scores of one layout.

    ``config`` supplies ``radius``, ``ideal_angle`` and the metric subset
    (``n_strips``, orientation and backend are meaningless here and
    ignored).  ``use_kernels`` keeps the one thing it changes in the
    reference, how E_ca is finished from the kernel's count and
    deviation sum: ``False`` forms ``e_ca`` in float32
    (:func:`~repro_torch.core.crossing_angle.finish_exact`, as
    ``crossing_angle_exact`` does); ``True`` forms ``1 - dev / count`` in
    Python floats.  With both crossing metrics asked, one crossing-angle
    sweep gives both: it tests each edge pair with the crossing sweep's
    predicate, so its count is E_c.  With E_c alone the crossing sweep,
    the cheaper, runs.

    Runs on CUDA unless ``device`` says otherwise, and raises when no CUDA
    device exists; pass ``device="cpu"`` to run on the CPU.

    With ``mesh`` (a :class:`~repro_torch.distributed.compat.Mesh`) every
    rank calls this with the same arguments and gets the same scores: the
    all-pairs sweeps split their pair rows over the ranks
    (:mod:`repro_torch.distributed.pairwise`, N_c and E_c / E_ca), the
    partials are combined by collectives, and M_a and M_l are computed on
    every rank.  The device is ``mesh.device``; a ``device`` that names
    another raises.
    """
    config = config or EvalConfig()
    if mesh is not None:
        return _exact_over_mesh(pos, edges, config, use_kernels, device,
                                mesh)
    with span("exact"):
        dev = resolve_device(device)
        pos = torch.as_tensor(pos, dtype=torch.float32, device=dev)
        edges = torch.as_tensor(edges, dtype=torch.int32, device=dev)
        metrics = config.metrics
        out = {}
        # each span ends at its int(...) / float(...), which waits for
        # the device: launch and sweep are inside it
        if "node_occlusion" in metrics:
            with span("exact.occlusion"):
                out["node_occlusion"] = int(
                    count_occlusions_exact(pos, config.radius))
        if "minimum_angle" in metrics:
            with span("exact.min_angle"):
                m_a, _ = minimum_angle(pos, edges)
                out["minimum_angle"] = float(m_a)
        if "edge_length_variation" in metrics:
            with span("exact.edge_length"):
                out["edge_length_variation"] = float(
                    edge_length_variation(pos, edges))
        # with both crossing metrics asked, the one sweep runs (and is
        # waited on) in exact.crossing, and exact.crossing_angle only
        # finishes E_ca from its count and deviation sum
        both = "edge_crossing" in metrics and "edge_crossing_angle" in metrics
        if "edge_crossing" in metrics:
            with span("exact.crossing"):
                if both:
                    count, dev_sum = ops.crossing_angle_op(
                        pos, edges, ideal=config.ideal_angle)
                else:
                    count = count_crossings_exact(pos, edges)
                out["edge_crossing"] = int(count)
        if "edge_crossing_angle" in metrics:
            with span("exact.crossing_angle"):
                if not both:
                    count, dev_sum = ops.crossing_angle_op(
                        pos, edges, ideal=config.ideal_angle)
                out.update(_angle_fields(count, dev_sum, use_kernels))
        return ReadabilityScores(overflow=0, n_vertices=int(pos.shape[0]),
                                 n_edges=int(edges.shape[0]), **out)


def _angle_fields(count, dev_sum, use_kernels):
    """E_ca and its crossing count from a sweep's ``(count, deviation
    sum)``, finished as ``use_kernels`` says."""
    if use_kernels:
        count = int(count)
        e_ca = 1.0 - float(dev_sum) / count if count > 0 else 1.0
    else:
        e_ca, _ = finish_exact(count, dev_sum)
    return {"edge_crossing_angle": float(e_ca),
            "crossing_count_for_angle": int(count)}


def _exact_over_mesh(pos, edges, config, use_kernels, device, mesh):
    """:func:`evaluate_exact` over ``mesh``.  Each rank launches its
    share of the crossing sweep first (E_c's, or one sweep for E_c and
    E_ca), which is most of its device time, then its share of N_c's
    sweep, M_a and M_l, which queue behind it, then one gather of every
    partial (``exact.reduce``), and only then reads any result: a rank's
    host waits once a call, for its own device and the other ranks
    together, and its launches after the first overlap its own sweep.
    The metric spans hold their launches; the root ``exact`` holds the
    wait."""
    if device is not None:
        want = torch.device(device)
        if want.type != mesh.device.type or (
                want.index is not None and want != mesh.device):
            raise ValueError(f"device={want} conflicts with the mesh's "
                             f"device {mesh.device}")
    with span("exact"):
        pos = torch.as_tensor(pos, dtype=torch.float32, device=mesh.device)
        edges = torch.as_tensor(edges, dtype=torch.int32,
                                device=mesh.device)
        metrics = config.metrics
        occlusion = "node_occlusion" in metrics
        crossing = "edge_crossing" in metrics
        angle = "edge_crossing_angle" in metrics
        counts, sums = [], []
        if crossing or angle:
            with span("exact.crossing" if crossing
                      else "exact.crossing_angle"):
                if angle:
                    count, dev_sum = pairwise.crossing_angle_rows(
                        mesh, pos, edges, ideal=config.ideal_angle)
                    sums.append(dev_sum)
                else:
                    count = pairwise.crossing_rows(mesh, pos, edges)
                counts.append(count)
        if occlusion:
            with span("exact.occlusion"):
                counts.append(pairwise.occlusion_rows(mesh, pos,
                                                      config.radius))
        if "minimum_angle" in metrics:
            with span("exact.min_angle"):
                m_a, _ = minimum_angle(pos, edges)
        if "edge_length_variation" in metrics:
            with span("exact.edge_length"):
                m_l = edge_length_variation(pos, edges)
        if counts:
            with span("exact.reduce"):
                counts, sums = pairwise.sum_partials(mesh, counts, sums)
        out = {}
        if occlusion:
            out["node_occlusion"] = int(counts[-1])
        if "minimum_angle" in metrics:
            out["minimum_angle"] = float(m_a)
        if "edge_length_variation" in metrics:
            out["edge_length_variation"] = float(m_l)
        if crossing:
            out["edge_crossing"] = int(counts[0])
        if angle:
            with span("exact.crossing_angle"):
                out.update(_angle_fields(counts[0], sums[0], use_kernels))
        return ReadabilityScores(overflow=0, n_vertices=int(pos.shape[0]),
                                 n_edges=int(edges.shape[0]), **out)


def evaluate_layout(pos, edges, *, radius: float = 0.5,
                    ideal_angle=DEFAULT_IDEAL, method: str = "enhanced",
                    metrics=ALL_METRICS, n_strips: int = 64,
                    orientation: str = "both", use_kernels: bool = False,
                    device=None) -> ReadabilityScores:
    """DEPRECATED: use :class:`repro_torch.api.Evaluator` (or
    :func:`evaluate_exact` for ``method="exact"``).

    Kwargs map 1:1 onto :class:`~repro_torch.core.keys.EvalConfig`; the
    enhanced path is served by the cached evaluator of that config and
    ``device``, so repeated calls on one topology reuse its plan."""
    warn_once(
        "evaluate_layout",
        "evaluate_layout is deprecated: build an EvalConfig and use "
        "repro_torch.api.Evaluator (evaluate_exact for method='exact'); "
        "this shim maps onto the cached config-keyed Evaluator")
    config = EvalConfig.from_legacy(
        radius=radius, n_strips=n_strips, orientation=orientation,
        metrics=metrics, ideal_angle=float(ideal_angle),
        use_kernels=use_kernels)
    if method == "exact":
        return evaluate_exact(pos, edges, config=config,
                              use_kernels=use_kernels, device=device)
    from repro_torch import api
    return api.evaluator_for(config, device=device).evaluate(pos, edges)
