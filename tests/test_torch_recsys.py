"""The port's recsys family (:mod:`repro_torch.models.recsys`) against the
reference: ``embedding_bag`` (sum, mean, max; weighted; an empty bag),
xDeepFM's logits, BCE loss, gradients and three AdamW steps, the
retrieval head, and the CIN's row chunks.

One numpy parameter draw (``numpy_params``) of the smoke config is
loaded into both packages; the reference runs jitted once for the
module.  Twin of ``tests/test_configs_smoke.py::
test_recsys_smoke_train_step`` on its batch.  Tolerances as in
``tests/test_torch_gnn.py``; the CIN chunked and unchunked agree at
``CHUNK_RTOL`` (the same contraction per row; only the matrix product's
width changes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import recsys as ref_recsys
from repro_torch import configs as t_configs
from repro_torch.models import recsys
from repro_torch.models.common import params_from_reference
from repro_torch.optim import adamw
from test_torch_gnn import (RTOL, check_runs, one_torch_thread,  # noqa: F401
                            port_run, reference_run)

CHUNK_RTOL = 1e-6
B = 32


def smoke_ids(cfg):
    """``test_recsys_smoke_train_step``'s ids and labels."""
    rng = np.random.default_rng(0)
    ids = (rng.integers(0, 64, (B, cfg.n_fields))
           + cfg.field_offsets[None, :]).astype(np.int32)
    labels = rng.integers(0, 2, B).astype(np.float32)
    return ids, labels


@pytest.fixture(scope="module")
def runs():
    tcfg = t_configs.get_arch("xdeepfm").smoke_config
    rcfg = ref_configs.get_arch("xdeepfm").smoke_config
    tree = recsys.numpy_params(tcfg, 0)
    ids, labels = smoke_ids(tcfg)
    want = reference_run(
        lambda p: ref_recsys.xdeepfm_logits(p, jnp.asarray(ids), rcfg),
        lambda out: ref_recsys.bce_loss(out, jnp.asarray(labels)), tree)
    want["scores"] = np.asarray(jax.jit(
        lambda p: ref_recsys.retrieval_scores(p, ids[:2], rcfg))(
        jax.tree.map(jnp.asarray, tree)))
    ids_t, labels_t = torch.from_numpy(ids), torch.from_numpy(labels)
    got = port_run(lambda p: recsys.xdeepfm_logits(p, ids_t, tcfg),
                   lambda out: recsys.bce_loss(out, labels_t), tree)
    got["scores"] = recsys.retrieval_scores(
        params_from_reference(tree, device="cpu"), ids_t[:2], tcfg).numpy()
    return tcfg, tree, got, want


def test_xdeepfm_matches_reference(runs):
    """Logits, BCE, every gradient leaf (the tables' rows that the batch
    touches and zeros elsewhere) and three AdamW steps' losses."""
    _, _, got, want = runs
    check_runs(got, want)


def test_recsys_smoke_train_step(runs):
    """What the reference's smoke test asserts, on the port: logits
    ``(B,)``, finite, a finite loss through the steps, retrieval scores
    ``(1, n_items)`` finite."""
    cfg, _, got, _ = runs
    assert got["out"].shape == (B,) and np.isfinite(got["out"]).all()
    assert np.isfinite(got["losses"]).all()
    assert got["scores"].shape == (2, cfg.n_items)
    assert np.isfinite(got["scores"]).all()


def test_retrieval_scores_match_reference(runs):
    _, _, got, want = runs
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=RTOL * np.abs(want["scores"]).max())


@pytest.mark.parametrize("chunk_rows", [1, 5, 7])
def test_cin_chunks_agree(runs, chunk_rows, monkeypatch):
    """With :data:`CIN_CHUNK_BYTES` cut to ``chunk_rows`` rows of the
    widest outer product (``H_{k-1} m D`` float32 elements), the CIN in
    chunks equals it in one chunk, forward and gradients (each chunk
    recomputed in the backward), and so do the logits."""
    cfg, tree, got, _ = runs
    params = params_from_reference(tree, device="cpu")
    for w in params["cin"] + [params["cin_out"]]:
        w.requires_grad_()
    ids = torch.from_numpy(smoke_ids(cfg)[0])
    x0 = recsys._lookup(params, ids, cfg)
    x0.requires_grad_()
    widest = max(cfg.n_fields, *cfg.cin_layers[:-1]) * cfg.n_fields \
        * cfg.embed_dim * 4
    outs = {}
    for rows in (chunk_rows, B):
        monkeypatch.setattr(recsys, "CIN_CHUNK_BYTES", rows * widest)
        assert recsys.cin_chunk_rows(cfg) == rows
        out = recsys._cin(x0, params, cfg)
        grads = torch.autograd.grad((out * torch.linspace(-1, 1, B)).sum(),
                                    [x0, *params["cin"]])
        outs[rows] = [out.detach(), *grads]
        if rows == chunk_rows:
            logits = recsys.xdeepfm_logits(params, ids, cfg).detach()
    for a, b in zip(outs[chunk_rows], outs[B]):
        torch.testing.assert_close(a, b, rtol=CHUNK_RTOL,
                                   atol=CHUNK_RTOL * float(b.abs().max()))
    np.testing.assert_allclose(logits.numpy(), got["out"], rtol=CHUNK_RTOL,
                               atol=CHUNK_RTOL * np.abs(got["out"]).max())


def test_cin_chunk_rows_at_the_published_width():
    """At xdeepfm's published width one row's widest outer product is
    200 x 39 x 10 float32 elements (312,000 bytes): 3,441 rows to a
    1 GiB chunk."""
    assert recsys.cin_chunk_rows(t_configs.get_arch("xdeepfm").config) \
        == (1 << 30) // 312_000 == 3441


def bag_inputs(weighted):
    """A 40 x 6 table, 23 ids in 7 bags, bag 4 empty."""
    rng = np.random.default_rng(3)
    table = rng.normal(size=(40, 6)).astype(np.float32)
    ids = rng.integers(0, 40, 23).astype(np.int32)
    bags = rng.choice([0, 1, 2, 3, 5, 6], 23).astype(np.int32)
    weights = (rng.random(23).astype(np.float32) + 0.5) if weighted else None
    return table, ids, bags, weights


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combine", ["sum", "mean", "max"])
def test_embedding_bag_matches_reference(combine, weighted):
    """Every combiner with and without weights; the empty bag is 0 for
    sum and mean and ``-inf`` for max, as ``jax.ops.segment_max`` leaves
    it.  Sum and mean also hold the table's and the weights' gradients."""
    table, ids, bags, weights = bag_inputs(weighted)
    cot = np.random.default_rng(4).normal(size=(7, 6)).astype(np.float32)

    def ref_f(t, w):
        return ref_recsys.embedding_bag(t, jnp.asarray(ids),
                                        jnp.asarray(bags), 7, weights=w,
                                        combine=combine)

    want = np.asarray(ref_f(jnp.asarray(table), None if weights is None
                            else jnp.asarray(weights)))
    t = torch.from_numpy(table).requires_grad_()
    w = None if weights is None else \
        torch.from_numpy(weights).requires_grad_()
    got = recsys.embedding_bag(t, torch.from_numpy(ids),
                               torch.from_numpy(bags), 7, weights=w,
                               combine=combine)
    assert got.shape == want.shape == (7, 6)
    assert (np.isneginf(got.detach().numpy()[4]).all() if combine == "max"
            else (got.detach().numpy()[4] == 0).all())
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=1e-6)
    if combine == "max":
        return
    args = (jnp.asarray(table),) + (() if weights is None
                                    else (jnp.asarray(weights),))
    ref_grads = jax.grad(
        lambda *a: jnp.sum(ref_f(a[0], a[1] if len(a) > 1 else None)
                           * cot), argnums=tuple(range(len(args))))(*args)
    got_grads = torch.autograd.grad((got * torch.from_numpy(cot)).sum(),
                                    [t] + ([] if w is None else [w]))
    for g, r in zip(got_grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=1e-6)


def test_bce_loss_matches_reference():
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=64) * 4).astype(np.float32)
    logits[:3] = (0.0, 30.0, -30.0)
    labels = rng.integers(0, 2, 64).astype(np.float32)
    want = float(ref_recsys.bce_loss(jnp.asarray(logits),
                                     jnp.asarray(labels)))
    got = float(recsys.bce_loss(torch.from_numpy(logits),
                                torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_params_round_trip_and_init(runs):
    """``numpy_params`` -> ``params_from_reference`` keeps every number;
    the generator init has the reference init's layout, shapes and
    dtypes and is deterministic per seed; the config's offsets and
    vocabulary are the reference's."""
    cfg, tree, _, _ = runs
    rcfg = ref_configs.get_arch("xdeepfm").smoke_config
    back = adamw._map(lambda t: t.numpy(),
                      params_from_reference(tree, device="cpu"))
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    shapes = jax.eval_shape(lambda k: ref_recsys.init_xdeepfm_params(rcfg, k),
                            jax.random.PRNGKey(0))
    params = recsys.init_xdeepfm_params(cfg, torch.Generator().manual_seed(0))
    t_leaves, r_leaves = adamw._leaves(params), jax.tree.leaves(shapes)
    assert [(tuple(t.shape), str(t.dtype)) for t in t_leaves] == \
        [(s.shape, f"torch.{s.dtype}") for s in r_leaves]
    again = recsys.init_xdeepfm_params(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(t_leaves,
                                                 adamw._leaves(again)))
    assert float(params["embed"].abs().max()) <= 0.02
    np.testing.assert_array_equal(cfg.field_offsets, rcfg.field_offsets)
    assert cfg.total_vocab == rcfg.total_vocab == 384
