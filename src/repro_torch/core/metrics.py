"""The exact all-pairs readability scores (paper S3.1); counterpart of
:func:`repro.core.metrics.evaluate_exact`, re-exported by
:mod:`repro_torch.api`.

The exact path is the ground truth the enhanced (strip and grid) path is
measured against, as in the paper's accuracy tables: O(V^2) occlusion,
O(E^2) CCW crossing sweep, exact crossing angles.  On the CUDA device
its three pairwise sweeps are hand-written kernels
(:mod:`repro_torch.kernels`) whatever ``use_kernels`` says; on the CPU
their plain PyTorch versions run.
"""

from __future__ import annotations

import torch

from repro_torch.core.crossing import count_crossings_exact
from repro_torch.core.crossing_angle import crossing_angle_exact
from repro_torch.core.edge_length import edge_length_variation
from repro_torch.core.engine import resolve_device
from repro_torch.core.keys import EvalConfig
from repro_torch.core.min_angle import minimum_angle
from repro_torch.core.occlusion import count_occlusions_exact
from repro_torch.core.scores import ReadabilityScores
from repro_torch.kernels import ops


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
