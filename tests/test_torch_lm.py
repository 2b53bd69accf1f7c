"""The LM serving substrate of the port against the reference: the
configs (``repro_torch.configs``), the sharding helpers, the model
building blocks, the transformer's ``forward`` / ``prefill`` /
``decode_step`` and its KV cache, ``lm_generate`` and
``merge_decode_attention``.

Every LM smoke config runs at ``dtype=float32`` (the reference's bf16
default rounds differently in the two frameworks, and at float32 the
MoE router's logits do not tie), with the reference's parameter pytree
from one numpy draw (``numpy_params``) loaded into both packages
(``params_from_reference``).  The reference runs jitted, one compile of
each entry per architecture, shared by the architecture's tests.
Tolerance: ``RTOL`` / ``ATOL`` on hidden states, logits and caches
(float32 products summed in another order); greedy tokens equal.

``merge_decode_attention`` runs on 1 and 2 gloo ranks
(``tests/_torch_dist.py``, ``merge_decode``), started once for the
module, against the reference's on a one-device mesh and a float32
unsharded attention.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as dist_
from repro import configs as ref_configs
from repro.distributed import sharding as ref_sharding
from repro.distributed.collectives import \
    merge_decode_attention as ref_merge
from repro.launch.serve import lm_generate as ref_lm_generate
from repro.models import common as ref_common
from repro.models import transformer as ref_tf
from repro_torch import configs as t_configs
from repro_torch.distributed import sharding as t_sharding
from repro_torch.launch.serve import lm_generate
from repro_torch.models import common as t_common
from repro_torch.models import transformer as t_tf

RTOL, ATOL = 1e-4, 1e-5
LM_ARCHS = t_configs.ARCH_IDS[:5]
PORTED_ARCHS = LM_ARCHS + ("gcn-cora", "nequip", "equiformer-v2",
                            "graphsage-reddit", "xdeepfm")
B, S, N_NEW = 2, 16, 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side runs on one intra-op thread here (restored
    afterwards): the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def merge_worlds():
    """The gloo ranks of the merge test, started with the module so that
    they run while the reference compiles."""
    return dist_.start_worlds((1, 2), "merge_decode")


@pytest.fixture(scope="module", params=LM_ARCHS)
def arch(request):
    """One smoke architecture at float32: the port's model and the
    reference's results (forward, prefill, one decode step, generate)."""
    name = request.param
    tcfg = dataclasses.replace(t_configs.get_arch(name).smoke_config,
                               dtype=torch.float32)
    rcfg = dataclasses.replace(ref_configs.get_arch(name).smoke_config,
                               dtype=jnp.float32)
    tree = t_tf.numpy_params(tcfg, 0)
    model = t_tf.Transformer(tcfg, device="cpu")
    model.load_state_dict(t_tf.params_from_reference(tree))
    params = jax.tree.map(jnp.asarray, tree)
    prompt = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (B, S)).astype(np.int32)
    ref = {}
    ref["hidden"], ref["aux"] = jax.jit(
        lambda p, t: ref_tf.forward(p, t, rcfg))(params, prompt)
    cache = ref_tf.init_cache(rcfg, B, S + N_NEW)
    cache, ref["prefill_logits"] = jax.jit(
        lambda p, t, c: ref_tf.prefill(p, t, c, rcfg))(params, prompt, cache)
    ref["prefill_cache"] = cache
    first = jnp.argmax(ref["prefill_logits"], axis=-1).astype(jnp.int32)
    ref["decode"] = jax.jit(lambda p, t, c: ref_tf.decode_step(p, t, c, rcfg))(
        params, first, cache)
    ref["first"] = first
    ref["tokens"] = ref_lm_generate(params, rcfg, prompt, N_NEW)
    return name, tcfg, model, prompt, ref


def close(got, want, what):
    np.testing.assert_allclose(
        np.asarray(got.detach().float().numpy() if isinstance(
            got, torch.Tensor) else got, np.float64),
        np.asarray(want, np.float64), rtol=RTOL, atol=ATOL, err_msg=what)


def test_configs_match_reference():
    """Every arch's published and smoke configs field for field (the
    dtype as its torch counterpart), the LM configs' parameter counts,
    the shape sets and skips, ``all_cells`` over all ten archs."""
    assert t_configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert (t_configs.LM_SHAPES, t_configs.GNN_SHAPES,
            t_configs.RECSYS_SHAPES) == (ref_configs.LM_SHAPES,
                                          ref_configs.GNN_SHAPES,
                                          ref_configs.RECSYS_SHAPES)
    assert t_configs.list_archs() == ref_configs.list_archs()
    dtypes = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
    for name in PORTED_ARCHS:
        t, r = t_configs.get_arch(name), ref_configs.get_arch(name)
        assert (t.arch_id, t.family, tuple(t.shapes), dict(t.skips)) == \
            (r.arch_id, r.family, tuple(r.shapes), dict(r.skips))
        for tc, rc in ((t.config, r.config), (t.smoke_config,
                                              r.smoke_config)):
            assert type(tc).__name__ == type(rc).__name__
            td, rd = dataclasses.asdict(tc), dataclasses.asdict(rc)
            assert dtypes[td.pop("dtype")] == rd.pop("dtype")
            assert td == rd, name
            if t.family != "lm":
                continue
            for model_axis in (1, 16):
                assert dataclasses.asdict(tc.with_mesh(model_axis)) | {
                    "dtype": None} == dataclasses.asdict(
                    rc.with_mesh(model_axis)) | {"dtype": None}
            assert tc.param_count() == rc.param_count()
            assert tc.active_param_count() == rc.active_param_count()
    xt = t_configs.get_arch("xdeepfm").config
    xr = ref_configs.get_arch("xdeepfm").config
    assert (xt.n_fields, xt.total_vocab) == (xr.n_fields, xr.total_vocab) \
        == (39, 91_020_160)
    np.testing.assert_array_equal(xt.field_offsets, xr.field_offsets)
    assert set(PORTED_ARCHS) == set(ref_configs.ARCH_IDS)
    assert t_configs.all_cells(include_skipped=True) == \
        ref_configs.all_cells(include_skipped=True)
    assert t_configs.all_cells() == ref_configs.all_cells()
    for name in ("nequip", "equiformer-v2"):
        tc = t_configs.get_arch(name).config
        assert (tc.irrep_dim, tc.edge_chunk) == (
            ref_configs.get_arch(name).config.irrep_dim,
            ref_configs.get_arch(name).config.edge_chunk)


def test_sharding_helpers_match_reference():
    for n in range(1, 70):
        for m in (1, 2, 3, 4, 8, 16):
            assert t_sharding.round_up(n, m) == ref_sharding.round_up(n, m)
            assert t_sharding.pad_heads(n, m) == ref_sharding.pad_heads(n, m)
            assert t_sharding.repeat_kv_heads(n, m) == \
                ref_sharding.repeat_kv_heads(n, m)


def test_common_blocks_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    close(t_common.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
          ref_common.rms_norm(jnp.asarray(x), jnp.asarray(scale)),
          "rms_norm")
    pos = np.arange(5, dtype=np.int32)[None]
    close(t_common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              1e6),
          ref_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6),
          "apply_rope")
    close(t_common.rope_freqs(16, 5e5), ref_common.rope_freqs(16, 5e5),
          "rope_freqs")
    h = rng.standard_normal((4, 16)).astype(np.float32)
    w = [rng.standard_normal(s).astype(np.float32) * 0.2
         for s in ((16, 24), (16, 24), (24, 16))]
    close(t_common.swiglu(torch.from_numpy(h),
                          *(torch.from_numpy(a) for a in w)),
          ref_common.swiglu(jnp.asarray(h), *(jnp.asarray(a) for a in w)),
          "swiglu")
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.7).astype(np.float32)
    for m in (None, mask):
        close(t_common.softmax_xent(torch.from_numpy(logits),
                                    torch.from_numpy(labels),
                                    None if m is None
                                    else torch.from_numpy(m)),
              ref_common.softmax_xent(jnp.asarray(logits),
                                      jnp.asarray(labels),
                                      None if m is None else jnp.asarray(m)),
              "softmax_xent")


def test_forward_matches_reference(arch):
    name, _, model, prompt, ref = arch
    with torch.no_grad():
        hidden, aux = model(torch.from_numpy(prompt))
    close(hidden, ref["hidden"], f"{name} forward")
    close(aux, ref["aux"], f"{name} aux")


def test_prefill_matches_reference(arch):
    name, _, model, prompt, ref = arch
    cache, logits = model.prefill(torch.from_numpy(prompt),
                                  model.init_cache(B, S + N_NEW))
    close(logits, ref["prefill_logits"], f"{name} prefill logits")
    for k in ("k", "v"):
        close(cache[k], ref["prefill_cache"][k], f"{name} cache {k}")
    assert cache["pos"] == int(ref["prefill_cache"]["pos"]) == S


def test_decode_step_matches_reference(arch):
    name, _, model, prompt, ref = arch
    cache, _ = model.prefill(torch.from_numpy(prompt),
                             model.init_cache(B, S + N_NEW))
    ids, logits, cache = model.decode_step(
        torch.from_numpy(np.asarray(ref["first"])), cache)
    r_ids, r_logits, r_cache = ref["decode"]
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(r_ids))
    close(logits, r_logits, f"{name} decode logits")
    for k in ("k", "v"):
        close(cache[k], r_cache[k], f"{name} decode cache {k}")
    assert cache["pos"] == int(r_cache["pos"]) == S + 1


def test_lm_generate_tokens_equal(arch):
    name, _, model, prompt, ref = arch
    got = lm_generate(model, torch.from_numpy(prompt), N_NEW)
    assert got.dtype == torch.int32 and got.shape == (B, N_NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref["tokens"]),
                                  err_msg=name)


def test_decode_after_prefill_equals_fresh_prefill(arch):
    """A decode step after a prefill gives the logits a fresh prefill of
    the extended sequence gives at its last position (the cache holds
    what the full pass computes; iRoPE's local chunks and NoPE global
    layers included).  MoE archs run it with ``moe_group=1``: the
    capacity dispatch groups tokens, so a prefill and a decode step route
    under other capacities (and the group must divide the token count);
    one token per group drops none, so routing no longer depends on the
    grouping."""
    name, cfg, model, prompt, _ = arch
    if cfg.moe:
        state = model.state_dict()
        model = t_tf.Transformer(dataclasses.replace(cfg, moe_group=1),
                                 device="cpu")
        model.load_state_dict(state)
    t = torch.from_numpy(prompt)
    cache, logits = model.prefill(t, model.init_cache(B, S + 1))
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    _, step_logits, _ = model.decode_step(nxt, cache)
    ext = torch.cat([t, nxt[:, None].long()], dim=1)
    _, fresh = model.prefill(ext, model.init_cache(B, S + 1))
    close(step_logits, fresh, f"{name} decode vs fresh prefill")


def test_params_round_trip_and_init():
    """``params_from_reference`` gives every parameter of the module (no
    key missing or left over); ``init_params`` draws the reference's
    shapes and scales from the generator, repeatably, with a zero padded
    vocabulary and zero norms."""
    cfg = dataclasses.replace(
        t_configs.get_arch("qwen2-moe-a2.7b").smoke_config,
        dtype=torch.float32).with_mesh(3)
    ref_shapes = jax.tree.map(
        np.shape, ref_tf.init_params(dataclasses.replace(
            ref_configs.get_arch("qwen2-moe-a2.7b").smoke_config,
            dtype=jnp.float32).with_mesh(3), jax.random.PRNGKey(0)))
    tree = t_tf.numpy_params(cfg, 5)
    assert jax.tree.map(np.shape, tree) == ref_shapes
    model = t_tf.Transformer(cfg, device="cpu")
    missing, unexpected = model.load_state_dict(
        t_tf.params_from_reference(tree), strict=False)
    assert not missing and not unexpected
    draws = [t_tf.Transformer(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(7)) for _ in range(2)]
    for (k, a), (_, b) in zip(draws[0].state_dict().items(),
                              draws[1].state_dict().items()):
        assert torch.equal(a, b), k
    m = draws[0]
    assert float(m.embed[cfg.vocab_size:].abs().max()) == 0.0
    assert float(m.unembed[:, cfg.vocab_size:].abs().max()) == 0.0
    assert float(m.layers["ln1"].abs().max()) == 0.0
    d = cfg.d_model
    assert float(m.layers["wq"].abs().max()) <= 2.0 * d ** -0.5 + 1e-6
    assert 0.5 < float(m.layers["wq"].std()) * d ** 0.5 < 1.0


def test_kv_cache_bytes():
    cfg = t_configs.get_arch("qwen3-4b").config
    cache_bytes = t_tf.kv_cache_bytes(cfg, 4, 1056)
    assert cache_bytes == 2 * 36 * 4 * 1056 * 8 * 128 * 2
    assert 0.5e9 < cache_bytes < 0.7e9


@pytest.mark.parametrize("world", [1, 2])
def test_merge_decode_attention_over_ranks(merge_worlds, world):
    """``merge_decode_attention`` on ``world`` gloo ranks equals the
    reference's on a one-device mesh and a float32 unsharded softmax
    attention over the positions up to ``MERGE_POS``."""
    from jax.sharding import Mesh

    q, k, v = dist_.merge_inputs()
    mesh = Mesh(np.array(jax.devices()[:1]), ("model",))
    want = ref_merge(mesh, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     dist_.MERGE_POS)
    s = np.einsum("bhd,bthd->bht", q, k) * q.shape[-1] ** -0.5
    s[..., dist_.MERGE_POS + 1:] = -np.inf
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    p /= p.sum(axis=-1, keepdims=True)
    plain = np.einsum("bht,bthd->bhd", p, v)
    got = np.asarray(dist_.finish_worlds({world: merge_worlds.pop(world)})[
        world], np.float32)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, plain, rtol=RTOL, atol=ATOL)
