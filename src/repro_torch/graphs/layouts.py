"""Layouts (numpy copy of ``repro.graphs.layouts.random_layout``; the
force-directed layout is still to port)."""

from __future__ import annotations

import numpy as np


def random_layout(n_vertices: int, seed: int = 0, scale: float = 100.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, scale, size=(n_vertices, 2)).astype(np.float32)
