"""The in-place parts of the port's LM training path, held against the
port's own functional or unrecomputed routes: ``apply_updates_``
against ``apply_updates`` and ``int8_roundtrip_`` against
``decompress_int8(compress_int8(.))`` (bit for bit), and ``cfg.remat``
on against off (equal loss and gradients).  No JAX here: the ``gpu``
cases run on the card with ``-m gpu``
(``tests/test_torch_train.py`` holds these routes to the reference).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as t_configs
from repro_torch.data import pipeline
from repro_torch.models import transformer as t_tf
from repro_torch.optim import adamw

CUDA = pytest.param("cuda", marks=pytest.mark.gpu)
B, S = 4, 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread here (restored afterwards): the suite's workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_model(arch, device, **kw):
    cfg = dataclasses.replace(t_configs.get_arch(arch).smoke_config,
                              dtype=torch.float32, **kw)
    model = t_tf.Transformer(cfg, device=device)
    model.load_state_dict(t_tf.params_from_reference(
        t_tf.numpy_params(cfg, 0)))
    return model


def as_torch(batch, device):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def random_tree(rng, scale=1.0):
    shapes = {"a": (300,), "b": (7, 9), "layers": {"w": (3, 5, 70),
                                                   "z": (3, 1)}}

    def make(s):
        return (rng.standard_normal(s) * scale).astype(np.float32) \
            if isinstance(s, tuple) else {k: make(v) for k, v in s.items()}
    return make(shapes)


def to_torch(tree, device):
    return adamw._map(lambda a: torch.tensor(a, device=device), tree)


@pytest.mark.parametrize("device", ["cpu", CUDA])
@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_apply_updates_inplace_is_bit_equal(device, clip, monkeypatch):
    """Three steps of ``apply_updates_`` (blocks smaller than the leaves)
    equal three of ``apply_updates`` bit for bit: parameters, moments,
    step, grad norm and lr; clipped and unclipped."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(adamw, "BLOCK", 64)
    rng = np.random.default_rng(0)
    cfg = adamw.AdamWConfig(peak_lr=1e-2, warmup_steps=2, total_steps=10,
                            clip_norm=clip)
    p0 = random_tree(rng)
    params_f, params_i = to_torch(p0, device), to_torch(p0, device)
    state_f = adamw.init_state(params_f)
    state_i = adamw.init_state(params_i)
    for _ in range(3):
        g = random_tree(rng, 3.0)
        params_f, state_f, mf = adamw.apply_updates(
            params_f, to_torch(g, device), state_f, cfg)
        mi = adamw.apply_updates_(params_i, to_torch(g, device), state_i,
                                  cfg)
        for k in ("grad_norm", "lr"):
            assert torch.equal(mf[k], mi[k])
    assert torch.equal(state_f["step"], state_i["step"])
    for t in ("params", "m", "v"):
        want = params_f if t == "params" else state_f[t]
        got = params_i if t == "params" else state_i[t]
        for a, b in zip(adamw._leaves(want), adamw._leaves(got)):
            assert torch.equal(a, b), t


def test_int8_roundtrip_inplace_equals_tree(monkeypatch):
    """``int8_roundtrip_`` (row blocks smaller than the leaves, leaves not
    a multiple of the chunk) leaves exactly the values of
    ``decompress_int8(compress_int8(.))`` (held to the reference's by
    ``tests/test_torch_adamw.py``)."""
    rng = np.random.default_rng(1)
    tree = random_tree(rng)
    want = adamw.decompress_int8(adamw.compress_int8(to_torch(tree, "cpu")))
    got = to_torch(tree, "cpu")
    monkeypatch.setattr(adamw, "ROWS", 3)
    monkeypatch.setattr(adamw, "CHUNK", 16)
    adamw.int8_roundtrip_(got)
    want16 = adamw.decompress_int8(adamw.compress_int8(to_torch(tree, "cpu"),
                                                       chunk=16))
    for a, b in zip(adamw._leaves(got), adamw._leaves(want16)):
        assert torch.equal(a, b)
    monkeypatch.undo()
    got = to_torch(tree, "cpu")
    adamw.int8_roundtrip_(got)
    for a, b in zip(adamw._leaves(got), adamw._leaves(want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("device", ["cpu", CUDA])
def test_remat_on_and_off_give_equal_gradients(device):
    """``cfg.remat`` recomputes each block in the backward: the loss and
    every gradient equal those without it (float32, TF32 off)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    grads = []
    for remat in (True, False):
        model = port_model("qwen2-moe-a2.7b", device, remat=remat)
        batch = as_torch(pipeline.TokenStream(model.cfg.vocab_size, S, B,
                                              seed=3).next_batch(), device)
        total, _ = t_tf.loss_fn(model, batch)
        total.backward()
        grads.append((float(total), {k: p.grad.cpu() for k, p
                                     in model.named_parameters()}))
    (l_on, g_on), (l_off, g_off) = grads
    assert l_on == l_off
    for k in g_on:
        torch.testing.assert_close(g_on[k], g_off[k], rtol=0, atol=0)


@pytest.mark.parametrize("device", ["cpu", CUDA])
@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2-moe-a2.7b"])
def test_stacked_grads_equal_autograd(device, arch):
    """With ``stacked_grads`` (the trainer's route) the stacks' ``.grad``
    holds exactly the gradients that ``torch.autograd.grad`` gives
    without it, where autograd reaches the stacked parameters; with it
    and no ``.grad`` allocated the forward refuses."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = port_model(arch, device)
    batch = as_torch(pipeline.TokenStream(model.cfg.vocab_size, S, B,
                                          seed=4).next_batch(), device)
    names, params = zip(*model.named_parameters())
    total, _ = t_tf.loss_fn(model, batch)
    want = torch.autograd.grad(total, params)
    model.stacked_grads = True
    with pytest.raises(RuntimeError, match="stacked_grads needs"):
        t_tf.loss_fn(model, batch)
    for p in params:
        p.grad = torch.zeros_like(p)
    t_tf.loss_fn(model, batch)[0].backward()
    for name, p, w in zip(names, params, want):
        assert torch.equal(p.grad, w), name
