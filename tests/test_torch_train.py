"""The LM training path of the port against the reference: the data
pipeline (``repro_torch.data.pipeline``), ``chunked_softmax_xent``
(``models/common.py``), ``loss_fn`` and its gradients
(``models/transformer.py``), ``build_lm_trainer`` and ``main``
(``launch/train.py``; its in-place optimizer step, int8 round trip and
remat are held to the port's own routes in
``tests/test_torch_train_inplace.py``).

Every LM smoke config runs at ``dtype=float32`` with the reference's
parameter pytree from one numpy draw (``numpy_params``) loaded into both
packages; the reference runs jitted, one compile per architecture and
variant, shared through module-scoped fixtures.  Tolerances: pipeline
batches bit-equal; ``loss_fn`` values at rtol 1e-5 and gradients per
leaf within 1e-4 of the leaf's max |g| (float32 sums in another order);
one bfloat16 case at rtol 2^-7; five trainer steps beside the
reference's at rtol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data import pipeline as ref_pipeline
from repro.launch.train import build_lm_trainer as ref_build_lm_trainer
from repro.models import common as ref_common
from repro.models import transformer as ref_tf
from repro.optim import adamw as ref_adamw
from repro_torch import configs as t_configs
from repro_torch.data import pipeline
from repro_torch.launch import train
from repro_torch.models import common
from repro_torch.models import transformer as t_tf
from repro_torch.optim import adamw

LM_ARCHS = t_configs.ARCH_IDS[:5]
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
TRAJ_RTOL = 1e-4
BF16_RTOL = 2.0 ** -7
B, S = 4, 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side runs on one intra-op thread here (restored
    afterwards): the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch, dtype="float32", **kw):
    """The smoke config of ``arch`` in both packages at ``dtype``."""
    tdt, rdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    tcfg = dataclasses.replace(t_configs.get_arch(arch).smoke_config,
                               dtype=tdt, **kw).with_mesh(1)
    rcfg = dataclasses.replace(ref_configs.get_arch(arch).smoke_config,
                               dtype=rdt, **kw).with_mesh(1)
    return tcfg, rcfg


def port_model(tcfg, tree, device="cpu"):
    model = t_tf.Transformer(tcfg, device=device)
    model.load_state_dict(t_tf.params_from_reference(tree))
    return model


def as_torch(batch, device="cpu"):
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def leaf_errors(model, ref_grads):
    """Per leaf, max |port - reference| over the reference's max |g|."""
    out = {}
    tree = model.param_tree()
    pairs = [(f"layers.{k}", p, ref_grads["layers"][k])
             for k, p in tree["layers"].items()]
    pairs += [(k, tree[k], ref_grads[k]) for k in ("embed", "ln_f",
                                                   "unembed")]
    for name, p, r in pairs:
        r = np.asarray(r, np.float64)
        g = p.grad.double().cpu().numpy()
        out[name] = float(np.abs(g - r).max() / max(np.abs(r).max(), 1e-30))
    return out


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shard", [None, (2, 0), (2, 1), (4, 3)])
def test_token_stream_matches_reference(shard):
    """Batches and cursors bit-equal to the reference's, whole or one host's
    shard (``host_slice``)."""
    kw = dict(vocab_size=1000, seq_len=24, global_batch=8, seed=5)
    port, ref = pipeline.TokenStream(**kw), ref_pipeline.TokenStream(**kw)
    sl = None if shard is None else pipeline.host_slice(8, *shard)
    if shard is not None:
        assert sl == ref_pipeline.host_slice(8, *shard)
    for _ in range(3):
        got, want = port.next_batch(sl), ref.next_batch(sl)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        assert port.state.cursor() == ref.state.cursor()


def test_token_stream_resume_from_cursor():
    """A stream restored from a cursor continues with the reference's
    batch (twin of ``test_token_stream_deterministic_resume``)."""
    s1 = pipeline.TokenStream(1000, 32, 8, seed=3)
    batches = [s1.next_batch() for _ in range(3)]
    s2 = pipeline.TokenStream(1000, 32, 8, seed=3)
    s2.state = pipeline.StreamState.from_cursor({"seed": 3, "step": 2})
    resumed = s2.next_batch()
    np.testing.assert_array_equal(batches[2]["tokens"], resumed["tokens"])
    ref = ref_pipeline.TokenStream(1000, 32, 8, seed=3)
    ref.state = ref_pipeline.StreamState.from_cursor(s1.state.cursor())
    s1.state = pipeline.StreamState.from_cursor(s1.state.cursor())
    np.testing.assert_array_equal(s1.next_batch()["labels"],
                                  ref.next_batch()["labels"])


def test_click_stream_matches_reference():
    """Click-log batches bit-equal to the reference's, with its field
    offsets (twin of ``test_click_stream_shapes_and_offsets``)."""
    vocabs = [100, 10, 1000]
    port = pipeline.ClickLogStream(vocabs, 16, seed=0)
    ref = ref_pipeline.ClickLogStream(vocabs, 16, seed=0)
    for sl in (None, pipeline.host_slice(16, 4, 1)):
        got, want = port.next_batch(sl), ref.next_batch(sl)
        for k in ("ids", "labels"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    b = pipeline.ClickLogStream(vocabs, 16, seed=0).next_batch()
    assert b["ids"].shape == (16, 3)
    assert (b["ids"][:, 0] < 100).all()
    assert (b["ids"][:, 1] >= 100).all() and (b["ids"][:, 1] < 110).all()
    assert set(np.unique(b["labels"])) <= {0.0, 1.0}


# ---------------------------------------------------------------------------
# the chunked loss
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def xent_case():
    rng = np.random.default_rng(0)
    T, d, V = 32, 16, 50
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = (rng.standard_normal((d, V)) / 4).astype(np.float32)
    labels = rng.integers(0, V, T).astype(np.int32)
    mask = (rng.random(T) < 0.8).astype(np.float32)
    return x, w, labels, mask


@pytest.mark.parametrize("n_chunks", [1, 2, 4, 8])
def test_chunked_xent_matches_reference(xent_case, n_chunks):
    """Value, token count and gradient with respect to ``x``."""
    x, w, labels, mask = xent_case

    def ref_loss(xv):
        return ref_common.chunked_softmax_xent(
            lambda xc: xc @ jnp.asarray(w), xv, jnp.asarray(labels),
            jnp.asarray(mask), n_chunks=n_chunks, z_loss=1e-3)

    (want, want_count), want_g = jax.jit(jax.value_and_grad(
        ref_loss, has_aux=True))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w)
    got, count = common.chunked_softmax_xent(
        lambda xc: xc @ wt, xt, torch.from_numpy(labels),
        torch.from_numpy(mask), n_chunks=n_chunks, z_loss=1e-3)
    got.backward()
    assert float(count) == float(want_count) == float(mask.sum())
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g),
                               rtol=LOSS_RTOL, atol=1e-7)


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=LM_ARCHS)
def loss_case(request):
    """One smoke architecture at float32: the port's loss and gradients
    and the reference's (jitted value_and_grad) on one TokenStream
    batch."""
    arch = request.param
    tcfg, rcfg = configs(arch)
    tree = t_tf.numpy_params(tcfg, 0)
    batch = pipeline.TokenStream(tcfg.vocab_size, S, B, seed=1).next_batch()
    (rl, rm), rg = jax.jit(jax.value_and_grad(
        lambda p, b: ref_tf.loss_fn(p, b, rcfg), has_aux=True))(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))
    model = port_model(tcfg, tree)
    total, mets = t_tf.loss_fn(model, as_torch(batch))
    total.backward()
    return dict(arch=arch, tcfg=tcfg, tree=tree, batch=batch, model=model,
                total=total.detach(), mets=mets,
                ref=(float(rl), {k: float(v) for k, v in rm.items()}, rg))


def test_loss_fn_matches_reference(loss_case):
    """``total``, ``xent``, ``aux`` and ``tokens`` at rtol 1e-5 (the
    MoE architectures' router aux included)."""
    want_total, want, _ = loss_case["ref"]
    mets = loss_case["mets"]
    np.testing.assert_allclose(float(loss_case["total"]), want_total,
                               rtol=LOSS_RTOL)
    for k in ("xent", "aux", "tokens"):
        np.testing.assert_allclose(float(mets[k]), want[k], rtol=LOSS_RTOL,
                                   atol=0 if k != "aux" else 1e-7)
    assert float(mets["tokens"]) == (loss_case["batch"]["labels"] >= 0).sum()
    if loss_case["tcfg"].moe:
        assert float(mets["aux"]) > 0


def test_loss_fn_gradients_match_reference(loss_case):
    """Every leaf's gradient within 1e-4 of the leaf's max |g|."""
    errs = leaf_errors(loss_case["model"], loss_case["ref"][2])
    bad = {k: v for k, v in errs.items() if not v <= GRAD_TOL}
    assert not bad, bad


def test_loss_fn_masks_negative_labels():
    """A label of -1 drops its token from the mean: the loss equals the
    loss over the kept tokens, and a fully masked batch counts 0 tokens
    and has loss 0."""
    tcfg, _ = configs("qwen3-4b")
    model = port_model(tcfg, t_tf.numpy_params(tcfg, 0))
    batch = as_torch(pipeline.TokenStream(tcfg.vocab_size, S, B,
                                          seed=2).next_batch())
    with torch.no_grad():
        _, full = t_tf.loss_fn(model, batch)
        masked = dict(batch, labels=torch.full_like(batch["labels"], -1))
        total, none = t_tf.loss_fn(model, masked)
    assert float(full["tokens"]) == B * (S - 1)
    assert float(none["tokens"]) == 0 and float(total) == 0.0


def test_bf16_loss_matches_reference():
    """qwen3-4b's smoke config at its default bfloat16: ``total`` and
    ``xent`` within 2^-7 of the reference's bfloat16 run."""
    tcfg, rcfg = configs("qwen3-4b", "bfloat16")
    tree = t_tf.numpy_params(tcfg, 0)
    batch = pipeline.TokenStream(tcfg.vocab_size, S, B, seed=1).next_batch()
    rl, rm = jax.jit(lambda p, b: ref_tf.loss_fn(p, b, rcfg))(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))
    total, mets = t_tf.loss_fn(port_model(tcfg, tree), as_torch(batch))
    total.backward()
    np.testing.assert_allclose(float(total), float(rl), rtol=BF16_RTOL)
    np.testing.assert_allclose(float(mets["xent"]), float(rm["xent"]),
                               rtol=BF16_RTOL)


# ---------------------------------------------------------------------------
# the trainer beside the reference's
# ---------------------------------------------------------------------------

TRAINERS = {"accum1": dict(grad_accum=1), "accum4": dict(grad_accum=4),
            "compress": dict(grad_accum=1, compress=True)}


@pytest.mark.parametrize("variant", sorted(TRAINERS))
def test_trainer_matches_reference(variant):
    """Five steps of ``build_lm_trainer`` from the same parameters and
    batches as the reference's jitted trainer: loss and grad norm per
    step at rtol 1e-4, lr equal."""
    kw = TRAINERS[variant]
    tcfg, rcfg = configs("qwen3-4b")
    tree = t_tf.numpy_params(tcfg, 0)
    opt_cfg = adamw.AdamWConfig(peak_lr=3e-3, warmup_steps=2, total_steps=5)
    ref_opt = ref_adamw.AdamWConfig(peak_lr=3e-3, warmup_steps=2,
                                    total_steps=5)
    stream = pipeline.TokenStream(tcfg.vocab_size, S, 8, seed=4)
    batches = [stream.next_batch() for _ in range(5)]
    ref_step = ref_build_lm_trainer(rcfg, ref_opt, **kw)
    params = jax.tree.map(jnp.asarray, tree)
    state = ref_adamw.init_state(params)
    model = port_model(tcfg, tree)
    opt_state = adamw.init_state(model.param_tree())
    step = train.build_lm_trainer(model, opt_cfg, **kw)
    for b in batches:
        params, state, want = ref_step(params, state,
                                       jax.tree.map(jnp.asarray, b))
        got = step(opt_state, b)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=TRAJ_RTOL)
        np.testing.assert_allclose(float(got["lr"]), float(want["lr"]),
                                   rtol=1e-7)
    assert int(opt_state["step"]) == 5


def test_grad_accum_matches_full_batch():
    """Four micro-batches step like the full batch (twin of the
    reference's ``test_grad_accum_matches_full_batch``)."""
    tcfg, _ = configs("qwen3-4b")
    tree = t_tf.numpy_params(tcfg, 0)
    opt_cfg = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=1,
                                total_steps=10)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, tcfg.vocab_size, (8, 32)),
             "labels": rng.integers(0, tcfg.vocab_size, (8, 32))}
    out = []
    for accum in (1, 4):
        model = port_model(tcfg, tree)
        state = adamw.init_state(model.param_tree())
        m = train.build_lm_trainer(model, opt_cfg, grad_accum=accum)(
            state, batch)
        out.append((float(m["loss"]), model))
    (l1, m1), (l4, m4) = out
    np.testing.assert_allclose(l1, l4, rtol=1e-3)
    for a, b in zip(m1.parameters(), m4.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=5e-3)


# ---------------------------------------------------------------------------
# main: twins of tests/test_train_integration.py's LM cases
# ---------------------------------------------------------------------------

def test_lm_training_decreases_loss(tmp_path):
    losses = train.main([
        "--arch", "qwen3-4b", "--smoke", "--steps", "30", "--batch", "8",
        "--seq", "64", "--lr", "3e-3", "--device", "cpu",
        "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "10",
    ])
    assert losses[-1] < losses[0]


def test_lm_training_resume_matches(tmp_path, capsys):
    common_args = ["--arch", "qwen3-4b", "--smoke", "--batch", "4",
                   "--seq", "32", "--lr", "1e-3", "--device", "cpu"]
    full = train.main(common_args + ["--steps", "20"])
    d = str(tmp_path / "ck")
    train.main(common_args + ["--steps", "10", "--checkpoint-dir", d,
                              "--checkpoint-every", "10"])
    resumed = train.main(common_args + ["--steps", "20", "--checkpoint-dir",
                                        d, "--checkpoint-every", "10"])
    assert "resumed from checkpoint step 10" in capsys.readouterr().out
    assert len(resumed) == 10
    np.testing.assert_allclose(resumed[-1], full[-1], rtol=2e-3)


def test_compressed_grads_still_train():
    losses = train.main(["--arch", "qwen3-4b", "--smoke", "--steps", "20",
                         "--batch", "4", "--seq", "32", "--lr", "3e-3",
                         "--compress-grads", "--device", "cpu"])
    assert losses[-1] < losses[0]


def test_main_defaults_to_cuda():
    """Without ``--device`` ``main`` runs on CUDA, and without a card it
    raises rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--steps", "1"])
