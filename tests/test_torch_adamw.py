"""The port's AdamW (:mod:`repro_torch.optim.adamw`) against
:mod:`repro.optim.adamw`: twins of every case of ``tests/test_adamw.py``
(schedule endpoints, clipping, descent, weight decay, state structure,
the int8 round trip), plus the same params, gradients and state -- the
reference's state carried across with ``state_from_reference`` -- through
both ``apply_updates``, outputs equal at rtol 1e-6.

The reference runs op by op here (each call is a handful of elementwise
primitives, and unjitted it rounds each op as the port does; under
``jit`` XLA would contract ``b1 * m + (1 - b1) * g`` into FMAs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.optim import adamw as ref_adamw
from repro_torch.optim import adamw

RTOL = 1e-6
CPU = torch.device("cpu")


def _lr(cfg, step):
    return float(adamw.cosine_schedule(cfg)(torch.tensor(step,
                                                         dtype=torch.int32)))


class TestCosineSchedule:
    CFG = adamw.AdamWConfig(peak_lr=1e-2, warmup_steps=10, total_steps=100,
                            min_lr_frac=0.1)

    def test_starts_at_zero(self):
        assert _lr(self.CFG, 0) == 0.0

    def test_linear_warmup(self):
        np.testing.assert_allclose(_lr(self.CFG, 5),
                                   self.CFG.peak_lr * 0.5, rtol=1e-6)

    def test_peak_at_warmup_end(self):
        np.testing.assert_allclose(_lr(self.CFG, 10), self.CFG.peak_lr,
                                   rtol=1e-6)

    def test_floor_at_total_steps(self):
        np.testing.assert_allclose(
            _lr(self.CFG, 100), self.CFG.peak_lr * self.CFG.min_lr_frac,
            rtol=1e-6)

    def test_monotone_decay_after_warmup(self):
        lrs = [_lr(self.CFG, s) for s in range(10, 101, 10)]
        assert all(a >= b for a, b in zip(lrs, lrs[1:]))

    def test_stays_at_floor_past_total(self):
        np.testing.assert_allclose(_lr(self.CFG, 500),
                                   self.CFG.peak_lr * self.CFG.min_lr_frac,
                                   rtol=1e-6)

    def test_equals_reference(self):
        ref = ref_adamw.cosine_schedule(ref_adamw.AdamWConfig(
            peak_lr=1e-2, warmup_steps=10, total_steps=100, min_lr_frac=0.1))
        for step in (0, 1, 5, 10, 11, 37, 99, 100, 500):
            np.testing.assert_allclose(
                _lr(self.CFG, step),
                float(ref(jnp.asarray(step, jnp.int32))), rtol=RTOL)


class TestClipByGlobalNorm:
    def test_clips_large_gradients(self):
        grads = {"a": torch.full((4,), 10.0), "b": torch.full((3,), -10.0)}
        clipped, norm = adamw.clip_by_global_norm(grads, 1.0)
        expected_norm = np.sqrt(7 * 100.0)
        np.testing.assert_allclose(float(norm), expected_norm, rtol=1e-6)
        np.testing.assert_allclose(float(adamw.global_norm(clipped)), 1.0,
                                   rtol=1e-5)
        np.testing.assert_allclose(clipped["a"].numpy(),
                                   10.0 / expected_norm, rtol=1e-5)

    def test_leaves_small_gradients_alone(self):
        grads = {"a": torch.tensor([0.3, -0.4])}
        clipped, norm = adamw.clip_by_global_norm(grads, 1.0)
        np.testing.assert_allclose(float(norm), 0.5, rtol=1e-6)
        np.testing.assert_allclose(clipped["a"].numpy(), [0.3, -0.4],
                                   rtol=1e-6)

    def test_apply_updates_reports_preclip_norm(self):
        cfg = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=0, total_steps=10,
                                weight_decay=0.0, clip_norm=1.0)
        params = {"p": torch.zeros(4)}
        grads = {"p": torch.full((4,), 100.0)}
        _, _, metrics = adamw.apply_updates(params, grads,
                                            adamw.init_state(params), cfg)
        np.testing.assert_allclose(float(metrics["grad_norm"]), 200.0,
                                   rtol=1e-5)


class TestApplyUpdates:
    def test_quadratic_converges(self):
        target = torch.tensor([3.0, -2.0, 0.5])
        cfg = adamw.AdamWConfig(peak_lr=0.2, warmup_steps=5,
                                total_steps=200, min_lr_frac=0.01,
                                weight_decay=0.0, clip_norm=10.0)
        lr_fn = adamw.cosine_schedule(cfg)

        def loss(p):
            return torch.sum((p["x"] - target) ** 2)

        params = {"x": torch.zeros(3)}
        state = adamw.init_state(params)
        first = float(loss(params))
        for _ in range(200):
            x = params["x"].detach().requires_grad_(True)
            g, = torch.autograd.grad(loss({"x": x}), x)
            params, state, _ = adamw.apply_updates(params, {"x": g}, state,
                                                   cfg, lr_fn)
        assert float(loss(params)) < 1e-3 < first
        assert int(state["step"]) == 200

    def test_weight_decay_shrinks_params(self):
        cfg = adamw.AdamWConfig(peak_lr=0.1, warmup_steps=0, total_steps=10,
                                min_lr_frac=1.0, weight_decay=0.5,
                                clip_norm=1e9)
        params = {"x": torch.tensor([4.0])}
        new, _, _ = adamw.apply_updates(params, {"x": torch.zeros(1)},
                                        adamw.init_state(params), cfg)
        assert 0.0 < float(new["x"][0]) < 4.0

    def test_state_is_param_congruent_pytree(self):
        params = {"a": torch.zeros((2, 3)), "b": {"c": torch.zeros(5)}}
        state = adamw.init_state(params)
        assert state["m"].keys() == params.keys()
        assert state["m"]["b"].keys() == params["b"].keys()
        assert state["m"]["a"].shape == (2, 3)
        assert state["v"]["b"]["c"].shape == (5,)
        assert state["step"].dtype == torch.int32


class TestInt8Compression:
    def test_round_trip_accuracy(self):
        rng = np.random.default_rng(0)
        tree = {"w": torch.tensor(rng.normal(0, 2.0, (37, 19)),
                                  dtype=torch.float32),
                "b": torch.tensor(rng.normal(0, 0.1, (53,)),
                                  dtype=torch.float32)}
        dec = adamw.decompress_int8(adamw.compress_int8(tree))
        for k in tree:
            a, b = tree[k].numpy(), dec[k].numpy()
            assert b.shape == a.shape
            tol = np.max(np.abs(a)) / 127.0
            assert np.max(np.abs(a - b)) <= tol + 1e-7

    def test_compressed_payload_is_int8(self):
        enc = adamw.compress_int8({"w": torch.ones(300)})
        assert enc["w"]["q"].dtype == torch.int8

    def test_equals_reference(self):
        rng = np.random.default_rng(4)
        w = rng.normal(0, 2.0, (37, 19)).astype(np.float32)
        got = adamw.compress_int8({"w": torch.tensor(w)})["w"]
        ref = ref_adamw.compress_int8({"w": jnp.asarray(w)})["w"]
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(ref["q"]))
        np.testing.assert_allclose(got["scale"].numpy(),
                                   np.asarray(ref["scale"]), rtol=RTOL)


# ---------------------------------------------------------------------------
# the same step on both sides, the state carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip_norm", [1e9, 1.0])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("step", [0, 3, 40])
def test_apply_updates_matches_reference(step, weight_decay, clip_norm):
    """Params, gradients and a mid-run state (moments drawn from a seed,
    ``v`` positive) through both packages' ``apply_updates``: new params,
    moments, step, learning rate and pre-clip norm equal at rtol 1e-6.

    With ``clip_norm=1.0`` the gradients are clipped by a factor made from
    the global norm, whose float32 sum of squares the two packages add in
    different orders (measured: 78.28819 against 78.28817, float64
    78.28817; one or two ulps).  Where the moment update ``b1 * m + (1 -
    b1) * g`` then cancels, that ulp of the factor is a larger share of
    the result, so the clipped case adds ``atol = 1e-6 * max|leaf|``,
    the rtol taken at the leaf's scale.  Unclipped (``clip_norm=1e9``:
    the factor is exactly 1 on both sides) every output is held at rtol
    1e-6 alone."""
    rng = np.random.default_rng(10 + step)
    shapes = {"pos": (3, 50, 2), "b": (7,)}
    params = {k: rng.normal(0, 20.0, s).astype(np.float32)
              for k, s in shapes.items()}
    grads = {k: rng.normal(0, 0.5, s).astype(np.float32)
             for k, s in shapes.items()}
    m = {k: rng.normal(0, 0.05, s).astype(np.float32)
         for k, s in shapes.items()}
    v = {k: rng.uniform(1e-4, 1e-2, s).astype(np.float32)
         for k, s in shapes.items()}
    cfg = dict(peak_lr=0.3, warmup_steps=10, total_steps=60,
               min_lr_frac=0.1, weight_decay=weight_decay,
               clip_norm=clip_norm)
    ref_state = {"m": {k: jnp.asarray(a) for k, a in m.items()},
                 "v": {k: jnp.asarray(a) for k, a in v.items()},
                 "step": jnp.asarray(step, jnp.int32)}
    with jax.disable_jit():
        r_p, r_s, r_m = ref_adamw.apply_updates(
            {k: jnp.asarray(a) for k, a in params.items()},
            {k: jnp.asarray(a) for k, a in grads.items()}, ref_state,
            ref_adamw.AdamWConfig(**cfg))
    state = adamw.state_from_reference(
        {k: np.asarray(a) for k, a in ref_state["m"].items()},
        {k: np.asarray(a) for k, a in ref_state["v"].items()},
        np.asarray(ref_state["step"]), device="cpu")
    t_p, t_s, t_m = adamw.apply_updates(
        {k: torch.from_numpy(a) for k, a in params.items()},
        {k: torch.from_numpy(a) for k, a in grads.items()}, state,
        adamw.AdamWConfig(**cfg))
    def close(got, want, what):
        want = np.asarray(want)
        atol = RTOL * float(np.max(np.abs(want))) if clip_norm < 1e9 else 0
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=atol,
                                   err_msg=what)

    for k in shapes:
        close(t_p[k], r_p[k], f"params {k}")
        close(t_s["m"][k], r_s["m"][k], f"m {k}")
        close(t_s["v"][k], r_s["v"][k], f"v {k}")
    assert int(t_s["step"]) == int(r_s["step"]) == step + 1
    for key in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(t_m[key]), float(r_m[key]),
                                   rtol=RTOL, err_msg=key)


def test_state_from_reference_defaults_to_cuda():
    """Like every entry point, ``state_from_reference`` runs on CUDA
    unless told otherwise, and never falls back to the CPU quietly."""
    m = {"pos": np.zeros((2, 3), np.float32)}
    if torch.cuda.is_available():
        assert adamw.state_from_reference(m, m, 1)["step"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            adamw.state_from_reference(m, m, 1)
    state = adamw.state_from_reference(m, m, 7, device="cpu")
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 7
