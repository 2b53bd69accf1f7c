"""Graph batch construction: padding, masking, molecule batching,
partitioning with halo tables for node-sharded execution (numpy copy of
:mod:`repro.graphs.format`: the same arrays, byte for byte, from the same
``numpy.random.Generator``).

Batches are plain dicts of arrays; every array has a static padded shape
plus a validity mask -- the contract every model in
:mod:`repro_torch.models` honours.  The models take them as tensors
(``torch.from_numpy``) on their device.
"""

from __future__ import annotations

import numpy as np


def _round_up(n, m):
    return -(-n // m) * m


def pad_graph_batch(node_feat, edges, labels=None, *, node_pad_to=None,
                    edge_pad_to=None, pad_multiple: int = 128):
    """Full-graph batch with padded nodes/edges + masks (numpy, host)."""
    n, e = node_feat.shape[0], edges.shape[0]
    n_pad = node_pad_to or _round_up(n, pad_multiple)
    e_pad = edge_pad_to or _round_up(e, pad_multiple)
    feat = np.zeros((n_pad, node_feat.shape[1]), np.float32)
    feat[:n] = node_feat
    src = np.zeros(e_pad, np.int32)
    dst = np.zeros(e_pad, np.int32)
    src[:e] = edges[:, 0]
    dst[:e] = edges[:, 1]
    batch = {
        "node_feat": feat,
        "edge_src": src,
        "edge_dst": dst,
        "node_mask": (np.arange(n_pad) < n),
        "edge_mask": (np.arange(e_pad) < e),
    }
    if labels is not None:
        lab = np.full(n_pad, -1, np.int32)
        lab[:n] = labels
        batch["labels"] = lab
    return batch


def batch_molecules(rng, *, n_graphs: int, nodes_per: int, edges_per: int,
                    n_species: int = 8, box: float = 4.0):
    """Batched small molecules (the gnn 'molecule' shape): positions,
    species, radius-free random bonds, shared flat node space with
    graph_id routing."""
    N = n_graphs * nodes_per
    E = n_graphs * edges_per
    pos = rng.normal(scale=box / 2, size=(N, 3)).astype(np.float32)
    species = rng.integers(0, n_species, N).astype(np.int32)
    src = np.zeros(E, np.int32)
    dst = np.zeros(E, np.int32)
    for g in range(n_graphs):
        lo = g * nodes_per
        s = rng.integers(lo, lo + nodes_per, edges_per)
        d = rng.integers(lo, lo + nodes_per, edges_per)
        src[g * edges_per:(g + 1) * edges_per] = s
        dst[g * edges_per:(g + 1) * edges_per] = d
    graph_id = np.repeat(np.arange(n_graphs), nodes_per).astype(np.int32)
    return {
        "positions": pos,
        "species": species,
        "edge_src": src,
        "edge_dst": dst,
        "edge_mask": src != dst,
        "node_mask": np.ones(N, bool),
        "graph_id": graph_id,
    }, n_graphs


def partition_with_halo(edges: np.ndarray, n_nodes: int, n_parts: int,
                        halo_cap: int):
    """Random node partition + per-part local edge lists and halo tables.

    Returns per-part dicts with locally-reindexed edges: owned nodes get
    ids [0, n_own), halo (remote-source) nodes [n_own, n_own + halo_cap).
    Partition quality is the pipeline's responsibility (METIS in a real
    deployment; random here) — the model-side contract is only the fixed
    ``halo_cap``. Edges whose halo overflows the cap are dropped and
    counted (a real system re-partitions when this is non-zero).
    """
    part = np.arange(n_nodes) % n_parts  # round-robin 'random' partition
    own = [np.where(part == p)[0] for p in range(n_parts)]
    local_id = np.zeros(n_nodes, np.int64)
    for p in range(n_parts):
        local_id[own[p]] = np.arange(len(own[p]))
    parts = []
    for p in range(n_parts):
        mask = part[edges[:, 1]] == p          # dst-owned edges
        e = edges[mask]
        halo_nodes = np.unique(e[:, 0][part[e[:, 0]] != p])[:halo_cap]
        halo_lookup = {g: i for i, g in enumerate(halo_nodes)}
        src_local = np.zeros(len(e), np.int64)
        keep = np.ones(len(e), bool)
        n_own = len(own[p])
        for i, s in enumerate(e[:, 0]):
            if part[s] == p:
                src_local[i] = local_id[s]
            elif s in halo_lookup:
                src_local[i] = n_own + halo_lookup[s]
            else:
                keep[i] = False                # halo overflow
        parts.append({
            "own": own[p],
            "halo": halo_nodes,
            "edge_src_local": src_local[keep].astype(np.int32),
            "edge_dst_local": local_id[e[keep, 1]].astype(np.int32),
            "dropped": int((~keep).sum()),
        })
    return parts
