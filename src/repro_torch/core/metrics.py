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
its three pairwise sweeps are hand-written kernels
(:mod:`repro_torch.kernels`) whatever ``use_kernels`` says; on the CPU
their plain PyTorch versions run.
"""

from __future__ import annotations

import torch

from repro_torch.core import engine
from repro_torch.core.crossing import count_crossings_exact
from repro_torch.core.crossing_angle import DEFAULT_IDEAL, crossing_angle_exact
from repro_torch.core.edge_length import edge_length_variation
from repro_torch.core.engine import ALL_METRICS, resolve_device
from repro_torch.core.keys import EvalConfig, warn_once
from repro_torch.core.min_angle import minimum_angle
from repro_torch.core.occlusion import count_occlusions_exact
from repro_torch.core.scores import (ReadabilityScores, scores_from_batch,
                                     scores_from_result)
from repro_torch.kernels import ops

# Legacy names: one typed result for every path (see repro_torch.core.scores).
ReadabilityReport = ReadabilityScores
report_from_result = scores_from_result
reports_from_batch = scores_from_batch
EngineResult = engine.EngineResult


def evaluate_exact(pos, edges, *, config: EvalConfig = None,
                   use_kernels: bool = False,
                   device=None) -> ReadabilityScores:
    """Exact (all-pairs, paper S3.1) readability scores of one layout.

    ``config`` supplies ``radius``, ``ideal_angle`` and the metric subset
    (``n_strips``, orientation and backend are meaningless here and
    ignored).  ``use_kernels`` keeps the one thing it changes in the
    reference, how E_ca is finished from the kernel's count and
    deviation sum: ``False`` forms ``e_ca`` in float32, as
    :func:`crossing_angle_exact` does; ``True`` forms ``1 - dev / count``
    in Python floats.

    Runs on CUDA unless ``device`` says otherwise, and raises when no CUDA
    device exists; pass ``device="cpu"`` to run on the CPU.
    """
    config = config or EvalConfig()
    dev = resolve_device(device)
    pos = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    edges = torch.as_tensor(edges, dtype=torch.int32, device=dev)
    metrics = config.metrics
    out = {}
    if "node_occlusion" in metrics:
        out["node_occlusion"] = int(count_occlusions_exact(pos,
                                                           config.radius))
    if "minimum_angle" in metrics:
        m_a, _ = minimum_angle(pos, edges)
        out["minimum_angle"] = float(m_a)
    if "edge_length_variation" in metrics:
        out["edge_length_variation"] = float(edge_length_variation(pos,
                                                                   edges))
    if "edge_crossing" in metrics:
        out["edge_crossing"] = int(count_crossings_exact(pos, edges))
    if "edge_crossing_angle" in metrics:
        if use_kernels:
            count, dev_sum = ops.crossing_angle_op(pos, edges,
                                                   ideal=config.ideal_angle)
            count = int(count)
            out["edge_crossing_angle"] = (
                1.0 - float(dev_sum) / count if count > 0 else 1.0)
        else:
            e_ca, count, _ = crossing_angle_exact(pos, edges,
                                                  ideal=config.ideal_angle)
            out["edge_crossing_angle"] = float(e_ca)
        out["crossing_count_for_angle"] = int(count)
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
