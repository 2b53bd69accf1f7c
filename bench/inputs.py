"""The one general generator: a cell's inputs from its configuration
file, its traffic file and ``--seed``.

A configuration names a graph generator (``graph.generator``, a file of
``bench/generators/``, given the file's ``graph`` keys with their own
fixed seed) and how layouts are drawn (``layouts.kind``, a file of
``bench/layouts/``).  Everything drawn from ``--seed`` is drawn on the
device by one ``torch.Generator`` in one call, then copied to the host,
where the program's callers keep their layouts.
"""

from __future__ import annotations

import numpy as np
import torch

from bench import find


def make_graph(config: dict):
    """``(edges int32 (E, 2), base layout float32 (V, 2) or None)``."""
    g = config["graph"]
    edges, pos = find.module("generators", g["generator"]).make(g)
    if edges.shape[0] != g["n_edges"]:
        raise ValueError(f"{g['generator']} made {edges.shape[0]} edges; "
                         f"the configuration states {g['n_edges']}")
    return edges, pos


def make_layouts(config: dict, traffic: dict, base, n_layouts: int,
                 seed: int, device) -> np.ndarray:
    """``(n_layouts, V, 2)`` float32 host layouts drawn from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    out = find.module("layouts", config["layouts"]["kind"]).make(
        config, traffic, base, n_layouts, gen)
    return out.cpu().numpy()
