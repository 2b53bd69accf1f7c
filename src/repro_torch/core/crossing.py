"""Edge crossing ``E_c`` by the exact all-pairs sweep (paper S3.1.4);
counterpart of :func:`repro.core.crossing.count_crossings_exact`.

Every pair of edges ``i < j`` is tested with the paper's CCW straddle
test; pairs sharing an endpoint are excluded (a shared endpoint is a
touch, not a crossing), and collinear overlaps count as crossings (the
test is not strict).  The enhanced strip sweep is the engine's
(:mod:`repro_torch.core.engine`).
"""

from __future__ import annotations

from repro_torch.kernels import ops


def count_crossings_exact(pos, edges, *, block: int = 512, edge_valid=None):
    """Exact E_c: edge pairs (i < j), both valid, no shared endpoint, CCW
    straddle.  On CUDA tensors the segment-crossing kernel sweeps the
    pairs; on CPU tensors its plain version, in row blocks of ``block``
    (the count does not depend on it).  Returns an int64 scalar tensor."""
    return ops.crossing_count_op(pos, edges, valid=edge_valid,
                                 row_block=block)
