"""The port's equivariant family (:mod:`repro_torch.models.equivariant`)
against the reference: NequIP and EquiformerV2 (full and compact eSCN)
energies, NequIP's forces, the energy loss, every gradient leaf and
three AdamW steps, rotation invariance, the SO(2) truncation, chunking,
``segment_softmax``, ``radial_basis`` and ``_pick_chunks``.

One numpy parameter draw (``numpy_params``) is loaded into both packages
(``params_from_reference``); the reference runs jitted, once per
configuration and batch (module-scoped fixtures).  Configurations: the
smoke configs (twins of ``tests/test_configs_smoke.py::
test_gnn_smoke_train_step`` on its batch, and on :func:`padded_batch`:
masked self-loops and padding, a node with no incoming edge, two
graphs, several edge chunks), ``tests/test_equivariant.py``'s and
``tests/test_perf_variants.py``'s own configs on their batches.

Tolerances, each relative to the largest magnitude of the reference's
value: NequIP energies ``NEQUIP_RTOL`` (1e-5), EquiformerV2 energies
``EQV_RTOL`` (1e-4: the Wigner blocks differ by up to 1.6e-6 at l = 6,
``tests/test_torch_so3.py``), forces, losses, gradient leaves and step
losses ``GRAD_RTOL`` (1e-3).  Measured on a CPU (float32): NequIP
energies within 2.1e-6 (padded batch; 2.5e-7 smoke, 9.4e-8 at
``NEQUIP_TEST``), EquiformerV2 within 1.4e-7, losses within 6.1e-7,
gradient leaves within 1.2e-6, forces within 6.4e-7.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.graphs.format import batch_molecules
from repro.models import equivariant as ref_eqv
from repro.models import so3 as ref_so3
from repro_torch import configs as t_configs
from repro_torch.models import equivariant as eqv
from repro_torch.models.common import params_from_reference
from repro_torch.optim import adamw
from test_torch_gnn import one_torch_thread, port_run, reference_run  # noqa

NEQUIP_RTOL, EQV_RTOL, GRAD_RTOL = 1e-5, 1e-4, 1e-3
# tests/test_equivariant.py's invariance bars
INV_RTOL, INV_ATOL = 2e-4, 1e-4

# tests/test_equivariant.py's and tests/test_perf_variants.py's configs
NEQUIP_TEST = dict(name="nequip-test", n_layers=3, d_hidden=8, edge_chunk=64)
EQV_TEST = dict(name="eqv2-test", n_layers=2, d_hidden=16, l_max=4, m_max=2,
                n_heads=4, edge_chunk=32)
EQV_VARIANT = dict(name="t", n_layers=2, d_hidden=16, l_max=4, m_max=2,
                   n_heads=4, edge_chunk=16)


def configs(kind, **fields):
    """``(port config, reference config)`` of ``kind`` ("nequip" or
    "equiformer"): the smoke config, or these fields."""
    if not fields:
        arch = "nequip" if kind == "nequip" else "equiformer-v2"
        return (t_configs.get_arch(arch).smoke_config,
                ref_configs.get_arch(arch).smoke_config)
    if kind == "nequip":
        return eqv.NequIPConfig(**fields), ref_eqv.NequIPConfig(**fields)
    return eqv.EquiformerConfig(**fields), ref_eqv.EquiformerConfig(**fields)


def forward_of(pkg, cfg):
    return (pkg.nequip_forward if "nequip" in cfg.name
            else pkg.equiformer_forward)


# ---------------------------------------------------------------------------
# batches (numpy)
# ---------------------------------------------------------------------------

def smoke_batch():
    """``test_gnn_smoke_train_step``'s batch: 24 nodes, 64 random edges
    all valid (self-loops included), random graph ids in {0, 1},
    targets."""
    rng = np.random.default_rng(0)
    n, e = 24, 64
    return {
        "positions": rng.normal(size=(n, 3)).astype(np.float32),
        "species": rng.integers(0, 4, n).astype(np.int32),
        "edge_src": rng.integers(0, n, e).astype(np.int32),
        "edge_dst": rng.integers(0, n, e).astype(np.int32),
        "edge_mask": np.ones(e, bool),
        "node_mask": np.ones(n, bool),
        "graph_id": rng.integers(0, 2, n).astype(np.int32),
        "targets": rng.normal(size=(2,)).astype(np.float32),
    }


def padded_batch():
    """``batch_molecules`` of 2 graphs of 10 nodes and 100 edges (its
    self-loops masked), node 1 without an incoming edge, padded to 24
    nodes and 256 edges (two chunks at the smoke configs' 128): padded
    edges run from the first padded node to itself, masked."""
    rng = np.random.default_rng(3)
    b, n_graphs = batch_molecules(rng, n_graphs=2, nodes_per=10,
                                  edges_per=100, n_species=4)
    b["edge_dst"] = np.where(b["edge_dst"] == 1, 0, b["edge_dst"])
    b["edge_mask"] = b["edge_src"] != b["edge_dst"]
    n, e, pad = 24, 256, 20
    out = {k: np.zeros((n if v.shape[0] == pad else e, *v.shape[1:]),
                       v.dtype) for k, v in b.items()}
    for k, v in b.items():
        out[k][:v.shape[0]] = v
    out["edge_src"][b["edge_src"].size:] = pad
    out["edge_dst"][b["edge_dst"].size:] = pad
    out["targets"] = rng.normal(size=(n_graphs,)).astype(np.float32)
    return out


def molecule_batch(seed, n=20, e=64):
    """``tests/test_equivariant.py``'s batch."""
    rng = np.random.default_rng(seed)
    return {
        "positions": rng.normal(size=(n, 3)).astype(np.float32),
        "species": rng.integers(0, 4, n).astype(np.int32),
        "edge_src": rng.integers(0, n, e).astype(np.int32),
        "edge_dst": rng.integers(0, n, e).astype(np.int32),
        "edge_mask": rng.random(e) > 0.1,
        "node_mask": np.ones(n, bool),
        "graph_id": np.zeros(n, np.int32),
    }


def variant_batch():
    """``tests/test_perf_variants.py::test_compact_escn_equivalent``'s
    batch."""
    rng = np.random.default_rng(3)
    n, e = 20, 48
    return {
        "positions": rng.normal(size=(n, 3)).astype(np.float32),
        "species": rng.integers(0, 4, n).astype(np.int32),
        "edge_src": rng.integers(0, n, e).astype(np.int32),
        "edge_dst": rng.integers(0, n, e).astype(np.int32),
        "edge_mask": rng.random(e) > 0.1,
        "node_mask": np.ones(n, bool),
        "graph_id": np.zeros(n, np.int32),
    }


def tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def random_rotation(seed):
    rng = np.random.default_rng(seed)
    a, b, g = rng.uniform(-np.pi, np.pi, 3)
    return (ref_so3._rot_z(a) @ ref_so3._rot_y(b)
            @ ref_so3._rot_z(g)).astype(np.float32)


def close(got, want, rtol, what=""):
    want = np.asarray(want, np.float64)
    assert np.shape(got) == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max(), err_msg=what)


# ---------------------------------------------------------------------------
# training twins: energies, loss, every gradient leaf, three AdamW steps
# ---------------------------------------------------------------------------

TRAIN_CASES = [("nequip", "smoke", False), ("nequip", "padded", False),
               ("equiformer", "smoke", False),
               ("equiformer", "padded", False),
               ("equiformer", "padded", True)]


@pytest.fixture(scope="module", params=TRAIN_CASES,
                ids=["-".join(map(str, c)) for c in TRAIN_CASES])
def train_case(request):
    kind, which, compact = request.param
    tcfg, rcfg = configs(kind)
    if compact:
        tcfg = dataclasses.replace(tcfg, compact_escn=True)
        rcfg = dataclasses.replace(rcfg, compact_escn=True)
    batch = smoke_batch() if which == "smoke" else padded_batch()
    n_graphs = batch["targets"].size
    tree = eqv.numpy_params(tcfg, 0)

    def twin(pkg, cfg, b):
        fwd = forward_of(pkg, cfg)
        return (lambda p: fwd(p, b, cfg, n_graphs=n_graphs),
                lambda out: pkg.energy_loss(out, b["targets"]))

    want = reference_run(*twin(ref_eqv, rcfg, jax.tree.map(jnp.asarray,
                                                           batch)), tree)
    got = port_run(*twin(eqv, tcfg, tensors(batch)), tree)
    return kind, which, tcfg, batch, tree, got, want


def test_train_matches_reference(train_case):
    """Energies (1e-5 NequIP, 1e-4 EquiformerV2), the loss, every gradient
    leaf and three AdamW steps' losses (1e-3)."""
    kind, _, _, _, _, got, want = train_case
    close(got["out"], want["out"], NEQUIP_RTOL if kind == "nequip"
          else EQV_RTOL, "energies")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=GRAD_RTOL)
    g_leaves = adamw._leaves(got["grads"])
    w_leaves = jax.tree.leaves(want["grads"])
    assert len(g_leaves) == len(w_leaves)
    for i, (g, w) in enumerate(zip(g_leaves, w_leaves)):
        close(g, w, GRAD_RTOL, f"gradient leaf {i}")
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=GRAD_RTOL)


def test_smoke_shapes_and_finite(train_case):
    """What the reference's smoke test asserts: energies of shape
    (n_graphs,), finite, and a finite loss after a step."""
    _, _, _, batch, _, got, _ = train_case
    assert got["out"].shape == batch["targets"].shape
    assert np.isfinite(got["out"]).all()
    assert np.isfinite(got["losses"]).all()


def self_loop_nodes(batch):
    """Nodes with a self-loop edge, masked or not."""
    return np.unique(batch["edge_src"][batch["edge_src"]
                                       == batch["edge_dst"]])


@pytest.mark.parametrize("which", ["smoke", "padded"])
def test_nequip_forces_match_reference(which):
    """Forces ``-dE/dpos`` against ``jax.grad`` (1e-3 of the largest).

    A self-loop has a zero edge vector, and ``jnp.arctan2``'s gradient at
    (0, 0) is NaN where ``torch.atan2``'s is 0: the reference's forces
    are NaN on every node with a self-loop edge, masked or not (the mask
    multiplies the NaN by 0), the port's finite.  The port is held to the
    reference on every other node, and its force on such a node to the
    reference's on a copy of the batch without its self-loops."""
    tcfg, rcfg = configs("nequip")
    batch = smoke_batch() if which == "smoke" else padded_batch()
    n_graphs = batch["targets"].size
    tree = eqv.numpy_params(tcfg, 1)
    rp = jax.tree.map(jnp.asarray, tree)

    @jax.jit
    def ref_forces(b):
        return -jax.grad(lambda x: ref_eqv.nequip_forward(
            rp, dict(b, positions=x), rcfg, n_graphs=n_graphs).sum())(
            b["positions"])

    def port_forces(b):
        pos = torch.from_numpy(b["positions"]).requires_grad_()
        energy = eqv.nequip_forward(
            params_from_reference(tree, device="cpu"),
            dict(tensors(b), positions=pos), tcfg, n_graphs=n_graphs).sum()
        (grad,) = torch.autograd.grad(energy, pos)
        return -grad.numpy()

    want = np.asarray(ref_forces(jax.tree.map(jnp.asarray, batch)))
    forces = port_forces(batch)
    loops = self_loop_nodes(batch)
    assert loops.size
    assert set(np.flatnonzero(np.isnan(want).any(1))) == set(loops)
    assert np.isfinite(forces).all()
    keep = np.ones(len(forces), bool)
    keep[loops] = False
    close(forces[keep], want[keep], GRAD_RTOL, "forces")
    # with each self-loop's destination moved to the next node (its mask
    # kept), both packages' forces are finite and agree everywhere
    moved = dict(batch, edge_dst=np.where(
        batch["edge_src"] == batch["edge_dst"],
        (batch["edge_dst"] + 1) % 20, batch["edge_dst"]).astype(np.int32))
    want = np.asarray(ref_forces(jax.tree.map(jnp.asarray, moved)))
    assert np.isfinite(want).all()
    close(port_forces(moved), want, GRAD_RTOL, "forces, no self-loop")
    if which == "padded":
        assert not forces[20:].any()


# ---------------------------------------------------------------------------
# forwards at the reference tests' own configs; invariance
# ---------------------------------------------------------------------------

FORWARD_CASES = [("nequip", NEQUIP_TEST, 0), ("nequip", NEQUIP_TEST, 1),
                 ("equiformer", EQV_TEST, 3), ("equiformer", EQV_TEST, 4)]


@pytest.fixture(scope="module", params=FORWARD_CASES,
                ids=[f"{k}-{s}" for k, _, s in FORWARD_CASES])
def forward_case(request):
    """One config and ``molecule_batch(seed)``, its rotated and translated
    copy (``tests/test_equivariant.py``'s rotations), and the reference's
    energies of the unrotated batch."""
    kind, fields, seed = request.param
    tcfg, rcfg = configs(kind, **fields)
    batch = molecule_batch(seed)
    base = seed if kind == "nequip" else seed - 3
    R = random_rotation(base + (7 if kind == "nequip" else 11))
    t = (np.array([1.5, -2.0, 0.25], np.float32) if kind == "nequip"
         else np.array([-0.5, 3.0, 1.0], np.float32))
    moved = dict(batch, positions=batch["positions"] @ R.T + t)
    tree = eqv.numpy_params(tcfg, seed)
    want = np.asarray(jax.jit(lambda p, b: forward_of(ref_eqv, rcfg)(
        p, b, rcfg))(jax.tree.map(jnp.asarray, tree),
                     jax.tree.map(jnp.asarray, batch)))
    params = params_from_reference(tree, device="cpu")
    fwd = forward_of(eqv, tcfg)
    with torch.no_grad():
        got = fwd(params, tensors(batch), tcfg).numpy()
        got_moved = fwd(params, tensors(moved), tcfg).numpy()
    return kind, tcfg, batch, params, want, got, got_moved


def test_forward_matches_reference(forward_case):
    kind, _, _, _, want, got, _ = forward_case
    close(got, want, NEQUIP_RTOL if kind == "nequip" else EQV_RTOL)


def test_energy_rotation_invariant(forward_case):
    """Energies under a global rotation plus translation, at
    ``tests/test_equivariant.py``'s bars."""
    _, _, _, _, _, got, got_moved = forward_case
    np.testing.assert_allclose(got, got_moved, rtol=INV_RTOL, atol=INV_ATOL)


def test_chunk_count_invariant(forward_case):
    """``edge_chunk`` 16 (four chunks) against one chunk of all E edges:
    the same energies up to float32 sums in another order."""
    kind, tcfg, batch, params, _, got, _ = forward_case
    E = batch["edge_src"].size
    fwd = forward_of(eqv, tcfg)
    with torch.no_grad():
        for chunk in (16, E):
            cfg = dataclasses.replace(tcfg, edge_chunk=chunk)
            close(fwd(params, tensors(batch), cfg).numpy(), got, 1e-5,
                  f"edge_chunk {chunk}")


@pytest.mark.parametrize("compact", [False, True])
def test_compact_escn_matches_reference(compact):
    """``tests/test_perf_variants.py::test_compact_escn_equivalent``'s
    config and batch: each layout against the reference's (1e-4), and
    compact against full at its rtol 1e-4."""
    tcfg, rcfg = configs("equiformer", **EQV_VARIANT, compact_escn=compact)
    batch = variant_batch()
    tree = eqv.numpy_params(tcfg, 0)
    want = np.asarray(jax.jit(lambda p, b: ref_eqv.equiformer_forward(
        p, b, rcfg))(jax.tree.map(jnp.asarray, tree),
                     jax.tree.map(jnp.asarray, batch)))
    params = params_from_reference(tree, device="cpu")
    with torch.no_grad():
        got = eqv.equiformer_forward(params, tensors(batch), tcfg).numpy()
        other = eqv.equiformer_forward(
            params, tensors(batch),
            dataclasses.replace(tcfg, compact_escn=not compact)).numpy()
    close(got, want, EQV_RTOL)
    np.testing.assert_allclose(got, other, rtol=1e-4)


def test_shard_channels_changes_no_value():
    """``shard_channels`` is a layout hint: on one device the same
    energies, bit for bit."""
    tcfg, _ = configs("equiformer", **EQV_VARIANT)
    params = params_from_reference(eqv.numpy_params(tcfg, 0), device="cpu")
    batch = tensors(variant_batch())
    with torch.no_grad():
        a = eqv.equiformer_forward(params, batch, tcfg)
        b = eqv.equiformer_forward(params, batch, dataclasses.replace(
            tcfg, shard_channels=True))
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

def test_so2_truncation_zeroes_high_m():
    """eSCN: after the SO(2) conv in the aligned frame, |m| > m_max
    vanishes; the kept rows equal the reference's conv."""
    fields = dict(name="t", n_layers=1, d_hidden=4, l_max=3, m_max=1)
    tcfg, rcfg = configs("equiformer", **fields)
    tree = eqv.numpy_params(tcfg, 0)
    x = np.random.default_rng(0).normal(
        size=(5, tcfg.irrep_dim, 4)).astype(np.float32)
    so2 = params_from_reference(tree, device="cpu")["layers"][0]["so2"]
    y = eqv._so2_conv(torch.from_numpy(x), so2, tcfg).numpy()
    for m in range(tcfg.m_max + 1, tcfg.l_max + 1):
        idp, idn = eqv._m_component_ids(tcfg.l_max, m)
        assert not y[:, idp, :].any() and not y[:, idn, :].any()
    want = ref_eqv._so2_conv(jnp.asarray(x), jax.tree.map(
        jnp.asarray, tree["layers"][0]["so2"]), rcfg)
    close(y, want, 1e-6)
    for m in range(tcfg.m_max + 1):
        for got_ids, ref_ids in zip(eqv._m_component_ids(tcfg.l_max, m),
                                    ref_eqv._m_component_ids(tcfg.l_max, m)):
            assert got_ids == np.asarray(ref_ids).tolist()
            got_c = eqv._compact_m_ids(tcfg.l_max, tcfg.m_max, m)
            ref_c = ref_eqv._compact_m_ids(tcfg.l_max, tcfg.m_max, m)
            assert [list(g) for g in got_c] == [
                np.asarray(r).tolist() for r in ref_c]
    assert eqv._compact_layout(6, 2) == ref_eqv._compact_layout(6, 2)


def test_segment_softmax_matches_reference():
    """Per head, against the reference's 1-D ``segment_softmax``: an empty
    segment (3), a segment of masked ``-1e30`` logits only (4: equal
    weights), mixed masked and finite logits, and large logits."""
    rng = np.random.default_rng(5)
    seg = np.array([0, 0, 1, 2, 2, 2, 4, 4, 5, 5, 1, 0], np.int32)
    logits = rng.normal(size=(seg.size, 3)).astype(np.float32) * 30
    logits[6:8] = -1e30
    logits[8, 0] = -1e30
    want = np.stack([np.asarray(ref_eqv.segment_softmax(
        jnp.asarray(logits[:, h]), jnp.asarray(seg), 6))
        for h in range(3)], axis=1)
    got = eqv.segment_softmax(torch.from_numpy(logits),
                              torch.from_numpy(seg).long(), 6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[6:8], 0.5)
    got1 = eqv.segment_softmax(torch.from_numpy(logits[:, 0]),
                               torch.from_numpy(seg).long(), 6).numpy()
    np.testing.assert_array_equal(got1, got[:, 0])


@pytest.mark.parametrize("n_rbf,cutoff", [(8, 5.0), (16, 8.0), (3, 1.5)])
def test_radial_basis_matches_reference(n_rbf, cutoff):
    """Over r in [0, 1.5 cutoff] (the envelope clips past the cutoff)."""
    r = np.linspace(0.0, 1.5 * cutoff, 301).astype(np.float32)
    want = np.asarray(ref_eqv.radial_basis(jnp.asarray(r), n_rbf, cutoff))
    got = eqv.radial_basis(torch.from_numpy(r), n_rbf, cutoff).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    assert not got[r >= cutoff].any()


def test_pick_chunks_matches_reference():
    for n_edges in range(1, 200):
        for target in (0, 1, 7, 16, 64, 128, 1000):
            assert eqv._pick_chunks(n_edges, target) == \
                ref_eqv._pick_chunks(n_edges, target)
    assert eqv._pick_chunks(16384, 4096) == 4
    assert eqv._pick_chunks(16384, 16384) == 1


@pytest.mark.parametrize("arch", ["nequip", "equiformer-v2"])
def test_params_round_trip_and_init(arch):
    """``numpy_params`` -> ``params_from_reference`` keeps every number;
    the generator init has the reference init's layout, shapes and
    dtypes (published config), is deterministic per seed and draws at the
    reference's scales."""
    tcfg = t_configs.get_arch(arch).config
    rcfg = ref_configs.get_arch(arch).config
    tree = eqv.numpy_params(tcfg, 0)
    back = adamw._map(lambda t: t.numpy(),
                      params_from_reference(tree, device="cpu"))
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    r_init = (ref_eqv.init_nequip_params if arch == "nequip"
              else ref_eqv.init_equiformer_params)
    t_init = (eqv.init_nequip_params if arch == "nequip"
              else eqv.init_equiformer_params)
    shapes = jax.eval_shape(lambda k: r_init(rcfg, k), jax.random.PRNGKey(0))
    assert jax.tree.structure(shapes) == jax.tree.structure(tree)
    params = t_init(tcfg, torch.Generator().manual_seed(0))
    got = [(tuple(t.shape), str(t.dtype)) for t in adamw._leaves(params)]
    assert got == [(s.shape, "torch." + str(s.dtype))
                   for s in jax.tree.leaves(shapes)]
    again = t_init(tcfg, torch.Generator().manual_seed(0))
    for a, b in zip(adamw._leaves(params), adamw._leaves(again)):
        assert torch.equal(a, b)
    C = tcfg.d_hidden
    w = params["layers"][0]["w_self" if arch == "nequip" else "w_out"]
    assert float(w.abs().max()) <= 2.0 * C ** -0.5 * (1 + 1e-6)
    np.testing.assert_allclose(float(w.std()), 0.8796 * C ** -0.5,
                               rtol=0.02)
    assert not params["readout"]["b1"].any()
