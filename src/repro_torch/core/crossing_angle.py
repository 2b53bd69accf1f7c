"""The calibration constant of edge crossing angle ``E_ca``.

Only :data:`DEFAULT_IDEAL` is ported so far (the exact all-pairs E_ca of
``repro.core.crossing_angle`` is still to port): the ideal crossing angle
of 70 degrees (Huang et al. 2008) as the float32 rounding the reference
computes, so plans and digests agree bit for bit.
"""

from __future__ import annotations

import numpy as np

DEFAULT_IDEAL = np.float32(np.deg2rad(np.float32(70.0)))
