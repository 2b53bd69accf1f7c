"""The port's GNN family (:mod:`repro_torch.models.gnn`) against the
reference: GCN and GraphSAGE full-graph, GraphSAGE sampled, the masked
node-classification loss, and three AdamW steps of each.

One numpy parameter draw (``numpy_params``) is loaded into both packages
(``params_from_reference``); the reference runs jitted, one compile per
configuration and batch (module-scoped fixtures).  Twins of
``tests/test_configs_smoke.py::test_gnn_smoke_train_step`` (gcn-cora,
graphsage-reddit) and ``::test_graphsage_sampled_smoke``, on their
batches, and on a padded batch with masked edges and nodes and
zero-degree nodes.  Tolerances: logits within ``RTOL`` of the output's
largest magnitude, the loss at ``RTOL``, each gradient leaf within
``GRAD_RTOL`` of its largest magnitude, three steps' losses at
``GRAD_RTOL`` (float32 sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import gnn as ref_gnn
from repro.optim import adamw as ref_adamw
from repro_torch import configs as t_configs
from repro_torch.graphs.format import pad_graph_batch
from repro_torch.models import gnn
from repro_torch.models.common import params_from_reference
from repro_torch.optim import adamw

RTOL, GRAD_RTOL = 1e-5, 1e-4
STEPS = 3
# tests/test_configs_smoke.py's optimizer
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side runs on one intra-op thread here (restored
    afterwards): the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# shared by the recsys twins: a forward, its loss, gradients and steps in
# both packages
# ---------------------------------------------------------------------------

def reference_run(forward, loss_of, tree, steps=STEPS):
    """The reference, jitted (one compile): ``forward(params)``,
    ``loss_of(out)``, the loss's gradient and ``steps`` AdamW steps'
    losses from ``tree``."""
    def loss_fn(p):
        out = forward(p)
        return loss_of(out), out

    opt = ref_adamw.AdamWConfig(**OPT)

    @jax.jit
    def step(p, s):
        (loss, out), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        p, s, _ = ref_adamw.apply_updates(p, g, s, opt)
        return p, s, loss, out, g

    params = jax.tree.map(jnp.asarray, tree)
    state, losses = ref_adamw.init_state(params), []
    for i in range(steps):
        params, state, loss, out, grads = step(params, state)
        losses.append(float(loss))
        if i == 0:
            first = {"out": np.asarray(out), "loss": float(loss),
                     "grads": jax.tree.map(np.asarray, grads)}
    return dict(first, losses=losses)


def port_run(forward, loss_of, tree, steps=STEPS):
    """:func:`reference_run` on the port, on the CPU: autograd gradients
    and the port's functional AdamW."""
    def with_grad(params):
        return adamw._map(lambda p: p.detach().requires_grad_(), params)

    def grad(p):
        # a leaf the loss does not reach (the retrieval head under the
        # CTR loss) has a zero gradient, as jax.grad gives it
        return torch.zeros_like(p) if p.grad is None else p.grad

    params = with_grad(params_from_reference(tree, device="cpu"))
    out = forward(params)
    loss = loss_of(out)
    loss.backward()
    run = {"out": out.detach().numpy(), "loss": float(loss.detach()),
           "grads": adamw._map(lambda p: grad(p).numpy(), params)}
    opt = adamw.AdamWConfig(**OPT)
    state, losses = adamw.init_state(params), []
    for _ in range(steps):
        params = with_grad(params)
        step_loss = loss_of(forward(params))
        step_loss.backward()
        grads = adamw._map(grad, params)
        params, state, _ = adamw.apply_updates(
            adamw._map(torch.Tensor.detach, params), grads, state, opt)
        losses.append(float(step_loss.detach()))
    run["losses"] = losses
    return run


def check_runs(got, want):
    out = np.asarray(want["out"], np.float64)
    assert got["out"].shape == out.shape
    np.testing.assert_allclose(got["out"], out, rtol=0,
                               atol=RTOL * np.abs(out).max())
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
    g_leaves = adamw._leaves(got["grads"])
    w_leaves = jax.tree.leaves(want["grads"])
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_RTOL * np.abs(w).max())
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=GRAD_RTOL)
    assert all(np.isfinite(got["losses"]))


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

def smoke_batch(cfg):
    """``test_gnn_smoke_train_step``'s batch: 40 nodes, 120 random edges
    (self-loops and repeats included), every edge and node valid."""
    rng = np.random.default_rng(0)
    n, e = 40, 120
    return {
        "node_feat": rng.normal(size=(n, cfg.d_in)).astype(np.float32),
        "edge_src": rng.integers(0, n, e).astype(np.int32),
        "edge_dst": rng.integers(0, n, e).astype(np.int32),
        "edge_mask": np.ones(e, bool),
        "node_mask": np.ones(n, bool),
        "labels": rng.integers(0, cfg.n_classes, n).astype(np.int32),
    }


def masked_batch(cfg):
    """``pad_graph_batch`` of 30 nodes whose 45 edges touch nodes 0-19
    only (20-29 have degree zero), padded to 48 nodes and 64 edges:
    masked edges (index 0 to 0) and masked nodes (label -1)."""
    rng = np.random.default_rng(1)
    edges = rng.integers(0, 20, (45, 2)).astype(np.int32)
    feat = rng.normal(size=(30, cfg.d_in)).astype(np.float32)
    labels = rng.integers(0, cfg.n_classes, 30).astype(np.int32)
    return pad_graph_batch(feat, edges, labels, node_pad_to=48,
                           edge_pad_to=64)


def sampled_batch(cfg, masked):
    """``test_graphsage_sampled_smoke``'s batch (all masks on), or with
    random masks: a zero-degree seed (row 0 of ``m1`` off) and ``m2 &=
    m1``."""
    rng = np.random.default_rng(0)
    f1, f2 = cfg.sample_sizes
    B = 8
    batch = {
        "x0": rng.normal(size=(B, cfg.d_in)).astype(np.float32),
        "x1": rng.normal(size=(B, f1, cfg.d_in)).astype(np.float32),
        "x2": rng.normal(size=(B, f1, f2, cfg.d_in)).astype(np.float32),
        "m1": np.ones((B, f1), bool),
        "m2": np.ones((B, f1, f2), bool),
        "labels": rng.integers(0, cfg.n_classes, B).astype(np.int32),
    }
    if masked:
        m1 = rng.random((B, f1)) < 0.7
        m1[0] = False
        batch["m1"] = m1
        batch["m2"] = (rng.random((B, f1, f2)) < 0.6) & m1[:, :, None]
    return batch


# ---------------------------------------------------------------------------
# the twins
# ---------------------------------------------------------------------------

CASES = [("gcn-cora", "smoke"), ("gcn-cora", "masked"),
         ("graphsage-reddit", "smoke"), ("graphsage-reddit", "masked"),
         ("graphsage-reddit", "sampled"), ("graphsage-reddit",
                                           "sampled_masked")]


def forwards(pkg, cfg, batch, mode):
    """``(forward(params), loss_of(logits))`` of ``pkg`` (the reference's
    or the port's gnn module) on ``batch``, as the smoke tests train."""
    if mode.startswith("sampled"):
        def forward(p):
            return pkg.sage_forward_sampled(p, batch, cfg)
        mask = batch["labels"] >= 0
    else:
        fwd = pkg.gcn_forward if cfg.kind == "gcn" else pkg.sage_forward_full

        def forward(p):
            return fwd(p, batch, cfg)
        mask = batch["node_mask"]

    def loss_of(logits):
        return pkg.node_classification_loss(logits, batch["labels"],
                                            mask)[0]
    return forward, loss_of


@pytest.fixture(scope="module", params=CASES, ids=["-".join(c) for c in CASES])
def case(request):
    arch, mode = request.param
    tcfg = t_configs.get_arch(arch).smoke_config
    rcfg = ref_configs.get_arch(arch).smoke_config
    batch = (smoke_batch(tcfg) if mode == "smoke"
             else masked_batch(tcfg) if mode == "masked"
             else sampled_batch(tcfg, masked=mode == "sampled_masked"))
    tree = gnn.numpy_params(tcfg, 0)
    want = reference_run(*forwards(ref_gnn, rcfg, jax.tree.map(
        jnp.asarray, batch), mode), tree)
    got = port_run(*forwards(gnn, tcfg, {k: torch.from_numpy(v)
                                         for k, v in batch.items()}, mode),
                   tree)
    return arch, mode, got, want


def test_matches_reference(case):
    """Logits, loss, every gradient leaf and three AdamW steps' losses."""
    _, _, got, want = case
    check_runs(got, want)


def test_smoke_shapes_and_finite(case):
    """What the reference's smoke tests assert: the logits' shape, finite
    values and a finite loss after a training step."""
    arch, mode, got, _ = case
    cfg = t_configs.get_arch(arch).smoke_config
    rows = 8 if mode.startswith("sampled") else (40 if mode == "smoke"
                                                 else 48)
    assert got["out"].shape == (rows, cfg.n_classes)
    assert np.isfinite(got["out"]).all() and np.isfinite(got["loss"])


@pytest.mark.parametrize("norm", ["sym", "none"])
def test_gcn_norm_variants(norm):
    """``norm="sym"`` halves the undirected degree, any other keeps it."""
    tcfg = dataclasses.replace(t_configs.get_arch("gcn-cora").smoke_config,
                               norm=norm)
    rcfg = dataclasses.replace(ref_configs.get_arch("gcn-cora").smoke_config,
                               norm=norm)
    batch = masked_batch(tcfg)
    tree = gnn.numpy_params(tcfg, 2)
    want = np.asarray(ref_gnn.gcn_forward(jax.tree.map(jnp.asarray, tree),
                                          batch, rcfg))
    got = gnn.gcn_forward(params_from_reference(tree, device="cpu"),
                          {k: torch.from_numpy(v) for k, v in batch.items()},
                          tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())


def test_zero_degree_nodes_keep_their_own_term():
    """A node with no valid edge aggregates only itself: GCN's self loop
    (``h / (deg + 1)`` with deg 0) and GraphSAGE's zero neighbour mean."""
    for arch in ("gcn-cora", "graphsage-reddit"):
        cfg = t_configs.get_arch(arch).smoke_config
        batch = {k: torch.from_numpy(v) for k, v in masked_batch(cfg).items()}
        params = params_from_reference(gnn.numpy_params(cfg, 0),
                                       device="cpu")
        fwd = gnn.gcn_forward if cfg.kind == "gcn" else gnn.sage_forward_full
        lone = dict(batch, node_feat=batch["node_feat"][20:30],
                    edge_mask=torch.zeros_like(batch["edge_mask"]),
                    edge_src=torch.zeros_like(batch["edge_src"]),
                    edge_dst=torch.zeros_like(batch["edge_dst"]))
        torch.testing.assert_close(fwd(params, batch, cfg)[20:30],
                                   fwd(params, lone, cfg), rtol=1e-6,
                                   atol=1e-6)


def test_accuracy_takes_the_first_maximum():
    """Tied logits predict the first class, as ``jnp.argmax``; masked
    rows and negative labels count as the reference counts them."""
    logits = np.array([[1.0, 1.0, 0.0], [0.0, 2.0, 2.0], [3.0, 3.0, 3.0],
                       [0.5, 0.2, 0.1]], np.float32)
    labels = np.array([0, 1, 2, -1], np.int32)
    mask = np.array([True, True, True, False])
    want = ref_gnn.node_classification_loss(jnp.asarray(logits),
                                            jnp.asarray(labels),
                                            jnp.asarray(mask))
    got = gnn.node_classification_loss(torch.from_numpy(logits),
                                       torch.from_numpy(labels),
                                       torch.from_numpy(mask))
    assert float(got[1]) == float(want[1]) == float(np.float32(2.0 / 3.0))
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=RTOL)


@pytest.mark.parametrize("arch", ["gcn-cora", "graphsage-reddit"])
def test_params_round_trip_and_init(arch):
    """``numpy_params`` -> ``params_from_reference`` keeps every number;
    the generator init has the reference init's layout, shapes and
    dtypes, is deterministic per seed and draws at the reference's
    scale."""
    tcfg = t_configs.get_arch(arch).config
    rcfg = ref_configs.get_arch(arch).config
    tree = gnn.numpy_params(tcfg, 0)
    back = adamw._map(lambda t: t.numpy(),
                      params_from_reference(tree, device="cpu"))
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    t_init = gnn.init_gcn_params if tcfg.kind == "gcn" \
        else gnn.init_sage_params
    r_init = ref_gnn.init_gcn_params if tcfg.kind == "gcn" \
        else ref_gnn.init_sage_params
    shapes = jax.eval_shape(lambda k: r_init(rcfg, k), jax.random.PRNGKey(0))
    params = t_init(tcfg, torch.Generator().manual_seed(0))
    jax.tree.map(lambda t, s: (tuple(t.shape), "float32") == (
        s.shape, str(s.dtype)) or pytest.fail(f"{t.shape} {s}"),
        adamw._map(lambda t: t, params), shapes,
        is_leaf=lambda x: isinstance(x, torch.Tensor))
    again = t_init(tcfg, torch.Generator().manual_seed(0))
    for a, b in zip(adamw._leaves(params), adamw._leaves(again)):
        assert torch.equal(a, b)
    w = params["layers"][0][next(iter(gnn._WEIGHTS[tcfg.kind]))]
    assert float(w.abs().max()) <= 2.0 * tcfg.d_in ** -0.5 * (1 + 1e-6)
    np.testing.assert_allclose(float(w.std()), 0.8796 * tcfg.d_in ** -0.5,
                               rtol=0.02)
