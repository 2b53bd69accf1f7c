"""Edge crossing angle ``E_ca`` (paper S3.1.5); counterpart of
:mod:`repro.core.crossing_angle`.

``E_ca = 1 - mean over crossing pairs of |ideal - a_c| / ideal``, where
``a_c`` is the acute angle between the two crossing edges and ``ideal``
defaults to 70 degrees (Huang et al. 2008).

* :data:`DEFAULT_IDEAL` -- the ideal angle as the float32 rounding the
  reference computes, so plans and digests agree bit for bit.
* :func:`crossing_angle_exact` -- the exact all-pairs E_ca.  The enhanced
  E_ca rides on the engine's strip sweep
  (:mod:`repro_torch.core.engine`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops

DEFAULT_IDEAL = np.float32(np.deg2rad(np.float32(70.0)))


def crossing_angle_exact(pos, edges, *, ideal=DEFAULT_IDEAL, block: int = 512,
                         edge_valid=None):
    """Exact E_ca plus the crossing count it is normalized by.

    Returns ``(e_ca, count, dev_sum)`` scalar tensors (float32, int64,
    float32): ``e_ca = 1 - dev_sum / max(count, 1)`` in float32, 1.0 when
    there are no crossings.  Each deviation multiplies by the float32
    ``1 / ideal`` (the kernel's form; the reference divides, an ulp apart
    per deviation).  On CUDA tensors the crossing-angle kernel sweeps the
    pairs; on CPU tensors its plain version, in row blocks of ``block``.
    The deviation sum is taken in float64 and rounded to float32 once.
    """
    count, dev = ops.crossing_angle_op(pos, edges, ideal=ideal,
                                       valid=edge_valid, row_block=block)
    dev_sum = dev.to(torch.float32)
    mean = dev_sum / torch.clamp_min(count, 1).to(torch.float32)
    e_ca = torch.where(count > 0, 1.0 - mean, 1.0)
    return e_ca, count, dev_sum
