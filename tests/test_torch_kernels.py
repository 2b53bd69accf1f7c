"""The two ported kernels: their plain PyTorch versions against the
reference on the CPU, and the CUDA kernels against the plain versions on
the card (``gpu`` marker; skipped without a CUDA device).

* strip reversal: per-row ``(count, dev)`` of the plain version equal to
  ``repro.core.engine.fused_reversal_block(..., reduce="rows")``, and its
  sum equal to ``repro.kernels.ops.strip_reversal_op`` (the Pallas kernel
  in interpret mode), with and without the angle.
* occlusion pairs: the plain count equal to
  ``repro.kernels.ops.occlusion_count_op`` (interpret), including pairs
  placed exactly at ``d2 == (2r)^2``.

Tolerance: integer counts are equal; deviation sums agree at rtol 1e-5
(float32 sums in a different order).  The reference is imported inside a
fixture, so the card tests also run where JAX is not installed:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels.py``.
"""

import ctypes
import re
import types

import numpy as np
import pytest
import torch

from repro_torch.core.engine import DEFAULT_IDEAL
from repro_torch.kernels import _build as t_build
from repro_torch.kernels import occlusion_pairs as t_occ
from repro_torch.kernels import strip_reversal as t_rev

RTOL = 1e-5


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import engine, grid
    from repro.kernels import ops
    return types.SimpleNamespace(jnp=jnp, engine=engine, grid=grid, ops=ops)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def slab(rows, cap, seed, *, ties=False, shared=False, invalid_rows=(),
         p_valid=0.85):
    """A ``(rows, cap)`` slab of strip buckets as numpy arrays."""
    rng = np.random.default_rng(seed)
    yl = rng.uniform(0, 10, (rows, cap)).astype(np.float32)
    yr = rng.uniform(0, 10, (rows, cap)).astype(np.float32)
    if ties:                        # quantized ordinates: many exact ties
        yl = np.round(yl).astype(np.float32)
        yr = np.round(yr).astype(np.float32)
    th = rng.uniform(0, np.pi, (rows, cap)).astype(np.float32)
    hi = 6 if shared else 10 * cap
    v = rng.integers(0, hi, (rows, cap)).astype(np.int32)
    u = rng.integers(0, hi, (rows, cap)).astype(np.int32)
    ok = rng.random((rows, cap)) < p_valid
    for r in invalid_rows:
        ok[r] = False
    return yl, yr, th, v, u, ok


SLABS = {
    "cap45": dict(rows=7, cap=45, seed=0),
    "cap200_ties": dict(rows=5, cap=200, seed=1, ties=True),
    "cap128_shared": dict(rows=6, cap=128, seed=2, shared=True),
    "invalid_rows": dict(rows=4, cap=33, seed=3, invalid_rows=(0, 2)),
    "one_row": dict(rows=1, cap=97, seed=4),
    "cap300_ties_shared": dict(rows=3, cap=300, seed=5, ties=True,
                               shared=True),
}


def _torch(arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize("name", sorted(SLABS))
@pytest.mark.parametrize("with_angle", [True, False])
def test_plain_reversal_matches_reference(ref, name, with_angle):
    arrays = slab(**SLABS[name])
    cnt, dev = t_rev.strip_reversal_rows_plain(
        *_torch(arrays), ideal=DEFAULT_IDEAL, with_angle=with_angle)
    jarr = [ref.jnp.asarray(a) for a in arrays]
    rc, rd = ref.engine.fused_reversal_block(
        *jarr, ideal=DEFAULT_IDEAL, with_angle=with_angle, reduce="rows")
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(rc))
    np.testing.assert_allclose(dev.numpy(), np.asarray(rd), rtol=RTOL)
    buckets = ref.grid.SegmentBuckets(*jarr, overflow=0)
    kc, kd = ref.ops.strip_reversal_op(buckets, ideal=DEFAULT_IDEAL,
                                       with_angle=with_angle)
    assert int(cnt.sum()) == int(kc)
    np.testing.assert_allclose(float(dev.sum()), float(kd), rtol=RTOL)
    if name == "invalid_rows":
        assert int(cnt[0]) == 0 and int(cnt[2]) == 0


def test_reversal_wrapper_takes_plain_route_on_cpu_only():
    arrays = _torch(slab(**SLABS["cap45"]))
    before = t_rev.strip_reversal_rows.LAUNCHES
    got = t_rev.strip_reversal_rows(*arrays, ideal=1.0)
    want = t_rev.strip_reversal_rows_plain(*arrays, ideal=1.0)
    assert t_rev.strip_reversal_rows.LAUNCHES == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    meta = [a.to("meta") for a in arrays]
    with pytest.raises(ValueError, match="cuda or cpu"):
        t_rev.strip_reversal_rows(*meta, ideal=1.0)


def boundary_points(radius):
    """Points whose pairs sit exactly at, just inside and just outside
    ``d2 == (2r)^2``: axis-aligned at distance 2r and 3-4-5 triangles
    (every coordinate and product exact in float32)."""
    d = 2.0 * radius
    pts = [(0.0, 0.0), (d, 0.0), (0.0, d), (-d, 0.0),            # exactly 2r
           (10.0, 10.0), (10.0 + 0.6 * d, 10.0 + 0.8 * d),          # 3-4-5
           (0.0, 20.0), (np.nextafter(np.float32(d), 0), 20.0),     # inside
           (0.0, 30.0), (np.nextafter(np.float32(d), 99), 30.0),    # outside
           (40.0, 40.0), (40.0, 40.0)]                               # d = 0
    return np.array(pts, np.float32)


@pytest.mark.parametrize("radius", [2.5, 0.5])
def test_plain_occlusion_boundary_fixture(ref, radius):
    pos = boundary_points(radius)
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    assert (d2 == np.float32((2 * radius) ** 2)).sum() >= 4   # ties exist
    valid = np.ones(pos.shape[0], bool)
    got = t_occ.occlusion_pairs_plain(
        *_torch([pos[:, 0].copy(), pos[:, 1].copy(), valid]), radius)
    want = ref.ops.occlusion_count_op(ref.jnp.asarray(pos), radius,
                                      valid=ref.jnp.asarray(valid))
    assert int(got) == int(want)
    # strict '<': the exact-2r pairs are not occluded, the nudged-in one
    # and the coincident one are
    assert int(got) == 2


@pytest.mark.parametrize("seed", range(3))
def test_plain_occlusion_matches_reference(ref, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(100, 700))
    pos = rng.uniform(0, 30, (n, 2)).astype(np.float32)
    pos[: n // 4] = np.round(pos[: n // 4])       # integer lattice ties
    valid = rng.random(n) < 0.9
    got = t_occ.occlusion_pairs_plain(
        *_torch([pos[:, 0].copy(), pos[:, 1].copy(), valid]), 1.0)
    want = ref.ops.occlusion_count_op(ref.jnp.asarray(pos), 1.0,
                                      valid=ref.jnp.asarray(valid))
    assert int(got) == int(want)


def test_occlusion_wrapper_takes_plain_route_on_cpu_only():
    pos = boundary_points(0.5)
    args = _torch([pos[:, 0].copy(), pos[:, 1].copy(),
                   np.ones(pos.shape[0], bool)])
    before = t_occ.occlusion_pairs.LAUNCHES
    assert int(t_occ.occlusion_pairs(*args, 0.5)) == 2
    assert t_occ.occlusion_pairs.LAUNCHES == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        t_occ.occlusion_pairs(*[a.to("meta") for a in args], 0.5)


@pytest.mark.parametrize("name", sorted(t_build.ENTRY_POINTS))
def test_entry_point_types_match_the_c_source(name):
    """The ctypes argument types set at load time follow the ``extern "C"``
    declaration in ``csrc/<name>.cu`` (pointers and the stream as
    ``c_void_p``)."""
    symbol, argtypes = t_build.ENTRY_POINTS[name]
    src = (t_build.CSRC / f"{name}.cu").read_text()
    decl = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", src)
    assert decl is not None, f"{symbol} not declared in {name}.cu"
    kinds = {"ptr": ctypes.c_void_p, "int": ctypes.c_int,
             "float": ctypes.c_float}
    params = [" ".join(p.split()) for p in decl.group(1).split(",")]
    want = [kinds["ptr" if "*" in p else p.split()[0]] for p in params]
    assert argtypes == want
    assert name in t_build.SOURCES


# ---------------------------------------------------------------------------
# on the card: kernel against plain version
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SLABS) + ["cap1100_wide"])
@pytest.mark.parametrize("with_angle", [True, False])
def test_reversal_kernel_matches_plain_on_card(cuda, name, with_angle):
    spec = SLABS.get(name, dict(rows=3, cap=1100, seed=9, ties=True))
    arrays = _torch(slab(**spec), cuda)
    before = t_rev.strip_reversal_rows.LAUNCHES
    cnt, dev = t_rev.strip_reversal_rows(*arrays, ideal=DEFAULT_IDEAL,
                                         with_angle=with_angle)
    torch.cuda.synchronize()
    assert t_rev.strip_reversal_rows.LAUNCHES == before + 1
    pc, pd = t_rev.strip_reversal_rows_plain(*arrays, ideal=DEFAULT_IDEAL,
                                             with_angle=with_angle)
    assert torch.equal(cnt.cpu(), pc.cpu())
    np.testing.assert_allclose(dev.cpu().numpy(), pd.cpu().numpy(),
                               rtol=RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("radius", [2.5, 0.5])
def test_occlusion_kernel_matches_plain_on_card(cuda, radius):
    rng = np.random.default_rng(0)
    pos = np.concatenate([boundary_points(radius),
                          rng.uniform(0, 40, (1500, 2)).astype(np.float32)])
    n = pos.shape[0]
    n_pad = -(-n // t_occ.TILE) * t_occ.TILE
    x = np.zeros(n_pad, np.float32)
    y = np.zeros(n_pad, np.float32)
    ok = np.zeros(n_pad, bool)
    x[:n], y[:n], ok[:n] = pos[:, 0], pos[:, 1], rng.random(n) < 0.95
    ok[:12] = True
    args = _torch([x, y, ok], cuda)
    got = t_occ.occlusion_pairs(*args, radius)
    torch.cuda.synchronize()
    assert int(got) == int(t_occ.occlusion_pairs_plain(*args, radius))
