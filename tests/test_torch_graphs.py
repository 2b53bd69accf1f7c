"""The port's graph substrate against the reference: ``to_csr`` and
``graphs/format.py`` (numpy copies, byte-equal to
:mod:`repro.graphs.datasets` / :mod:`repro.graphs.format` from the same
inputs and ``numpy.random.Generator``), and the neighbour sampler
(:mod:`repro_torch.graphs.sampler`), held to validity: torch cannot
reproduce ``jax.random``'s draws, so these are the twins of
``tests/test_substrates.py::test_neighbor_sampler_valid`` and
``::test_fanout_batch_shapes`` plus the zero-degree rows, the second
hop's mask and a seeded generator's determinism.
"""

import numpy as np
import pytest
import torch

from repro.graphs import datasets as ref_datasets
from repro.graphs import format as ref_format
from repro_torch.graphs import datasets, format as t_format
from repro_torch.graphs.sampler import sample_fanout_batch, sample_neighbors


def same_bytes(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            same_bytes(got[k], want[k])
        return
    if isinstance(want, (int, float)):
        assert got == want and type(got) is type(want)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert (got.dtype, got.shape) == (want.dtype, want.shape)
    assert got.tobytes() == want.tobytes()


def csr(edges, n):
    indptr, indices = datasets.to_csr(edges, n)
    return indptr, indices, torch.from_numpy(indptr), \
        torch.from_numpy(indices)


def lonely_graph():
    """Edges among nodes 0-19 of 30 (nodes 20-29, the last included, have
    no edge: the last one's CSR start is one past the last entry)."""
    return ref_datasets.random_edges(20, 50, seed=3), 30


@pytest.mark.parametrize("case", ["substrates", "skewed", "lonely"])
def test_to_csr_equals_reference(case):
    if case == "substrates":
        edges, n = ref_datasets.random_edges(200, 600, seed=1), 200
    elif case == "skewed":
        edges, n = ref_datasets.random_edges(300, 900, seed=4, skew=0.8), 300
    else:
        edges, n = lonely_graph()
    got = datasets.to_csr(edges, n)
    want = ref_datasets.to_csr(edges, n)
    for g, w in zip(got, want):
        same_bytes(g, w)


@pytest.mark.parametrize("labels", [False, True])
@pytest.mark.parametrize("pads", [{}, {"pad_multiple": 16},
                                  {"node_pad_to": 50, "edge_pad_to": 70}])
def test_pad_graph_batch_equals_reference(labels, pads):
    rng = np.random.default_rng(7)
    feat = rng.normal(size=(37, 5)).astype(np.float32)
    edges = ref_datasets.random_edges(37, 61, seed=5)
    lab = rng.integers(0, 4, 37).astype(np.int32) if labels else None
    same_bytes(t_format.pad_graph_batch(feat, edges, lab, **pads),
               ref_format.pad_graph_batch(feat, edges, lab, **pads))


def test_batch_molecules_equals_reference():
    kw = dict(n_graphs=5, nodes_per=7, edges_per=9, n_species=4, box=3.0)
    got, n_got = t_format.batch_molecules(np.random.default_rng(11), **kw)
    want, n_want = ref_format.batch_molecules(np.random.default_rng(11), **kw)
    assert n_got == n_want == 5
    same_bytes(got, want)


@pytest.mark.parametrize("halo_cap", [3, 1000])
def test_partition_with_halo_equals_reference(halo_cap):
    """A cap of 3 drops edges (counted); a large one keeps them all."""
    edges = ref_datasets.random_edges(60, 200, seed=6)
    got = t_format.partition_with_halo(edges, 60, 3, halo_cap)
    want = ref_format.partition_with_halo(edges, 60, 3, halo_cap)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        same_bytes(g, w)
    assert (sum(p["dropped"] for p in got) > 0) == (halo_cap == 3)


def test_neighbor_sampler_valid():
    """Twin of the reference's: every sampled neighbour is adjacent to
    its seed."""
    edges = ref_datasets.random_edges(200, 600, seed=1)
    indptr, indices, indptr_t, indices_t = csr(edges, 200)
    gen = torch.Generator().manual_seed(0)
    nbr, mask = sample_neighbors(indptr_t, indices_t,
                                 torch.arange(32, dtype=torch.int32), 8, gen)
    assert nbr.shape == mask.shape == (32, 8)
    assert nbr.dtype == torch.int32 and mask.dtype == torch.bool
    for b in range(32):
        adj = set(indices[indptr[b]:indptr[b + 1]].tolist())
        assert mask[b].all() == bool(adj)
        for j in range(8):
            if mask[b, j]:
                assert int(nbr[b, j]) in adj


def test_fanout_batch_shapes():
    """Twin of the reference's: the dense fanout block's shapes."""
    edges = ref_datasets.random_edges(500, 2000, seed=2)
    _, _, indptr_t, indices_t = csr(edges, 500)
    feats = torch.from_numpy(np.random.default_rng(0).normal(
        size=(500, 16)).astype(np.float32))
    labels = torch.arange(500, dtype=torch.int32) % 7
    batch = sample_fanout_batch(indptr_t, indices_t, feats, labels,
                                torch.arange(64, dtype=torch.int32),
                                torch.Generator().manual_seed(1), (5, 3))
    assert batch["x0"].shape == (64, 16)
    assert batch["x1"].shape == (64, 5, 16)
    assert batch["x2"].shape == (64, 5, 3, 16)
    assert batch["m1"].shape == (64, 5)
    assert batch["m2"].shape == (64, 5, 3)
    assert torch.equal(batch["labels"], labels[:64])


def test_fanout_batch_hops_are_adjacent():
    """Features that carry their node id: every unmasked first-hop row is
    a neighbour of its seed, every unmasked second-hop row a neighbour of
    its first hop; zero-degree seeds are masked on both hops (``m2 &=
    m1``) and read node 0."""
    edges, n = lonely_graph()
    indptr, indices, indptr_t, indices_t = csr(edges, n)
    feats = torch.arange(n, dtype=torch.float32)[:, None].repeat(1, 3)
    seeds = torch.tensor([0, 5, 19, 20, 29, 7], dtype=torch.int32)
    batch = sample_fanout_batch(indptr_t, indices_t, feats,
                                torch.zeros(n, dtype=torch.int32), seeds,
                                torch.Generator().manual_seed(2), (4, 3))

    def adj(v):
        return set(indices[indptr[v]:indptr[v + 1]].tolist())

    x1 = batch["x1"][..., 0].long()
    x2 = batch["x2"][..., 0].long()
    for b, s in enumerate(seeds.tolist()):
        assert bool(batch["m1"][b].all()) == bool(adj(s))
        for j in range(4):
            if not batch["m1"][b, j]:
                assert int(x1[b, j]) == 0 and not batch["m2"][b, j].any()
                continue
            assert int(x1[b, j]) in adj(s)
            for k in range(3):
                if batch["m2"][b, j, k]:
                    assert int(x2[b, j, k]) in adj(int(x1[b, j]))


def test_zero_degree_rows_are_masked():
    """Seeds without edges (the last node's CSR start is one past the
    last entry) get fully masked rows of id 0."""
    edges, n = lonely_graph()
    _, _, indptr_t, indices_t = csr(edges, n)
    seeds = torch.arange(18, 30, dtype=torch.int32)
    nbr, mask = sample_neighbors(indptr_t, indices_t, seeds, 6,
                                 torch.Generator().manual_seed(3))
    assert mask[:2].all() and not mask[2:].any()
    assert (nbr[2:] == 0).all()


def test_sampler_is_deterministic_per_generator_seed():
    edges = ref_datasets.random_edges(200, 600, seed=1)
    _, _, indptr_t, indices_t = csr(edges, 200)
    seeds = torch.arange(64, dtype=torch.int32)

    def draw(seed):
        return sample_neighbors(indptr_t, indices_t, seeds, 8,
                                torch.Generator().manual_seed(seed))[0]

    assert torch.equal(draw(5), draw(5))
    assert not torch.equal(draw(5), draw(6))
