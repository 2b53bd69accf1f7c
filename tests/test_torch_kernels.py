"""The ported kernels: their plain PyTorch versions against the
reference on the CPU, and the CUDA kernels against the plain versions on
the card (``gpu`` marker; skipped without a CUDA device).

* strip reversal: per-row ``(count, dev)`` of the plain version equal to
  ``repro.core.engine.fused_reversal_block(..., reduce="rows")``, and its
  sum equal to ``repro.kernels.ops.strip_reversal_op`` (the Pallas kernel
  in interpret mode), with and without the angle.
* occlusion pairs: the plain count equal to
  ``repro.kernels.ops.occlusion_count_op`` (interpret), including pairs
  placed exactly at ``d2 == (2r)^2``.
* segment crossing and crossing-angle sum: the plain count and deviation
  sum equal to ``repro.kernels.ops.crossing_count_op`` /
  ``crossing_angle_op`` (the Pallas kernels in interpret mode) on random
  edges, and to the naive oracles of ``repro.kernels.ref`` on the
  adversarial fixtures of :mod:`repro_torch.kernels.fixtures`.  The
  interpret-mode kernels run under ``jit``, where XLA's CPU backend
  contracts the cross products into FMAs; the fixtures, whose
  near-collinear layout is decided by that rounding, are therefore held
  to the oracles, which run op by op.

The inputs come from :mod:`repro_torch.kernels.fixtures`, which
``chip_smoke.py`` shares.  The slabs include validity masks whose valid
slots are no prefix (``mask_pattern``), the occlusion cases lay valid
vertices out against the kernel's tiles (``occlusion_case``), and the
crossing layouts of ``TILE_LAYOUTS`` put valid edges in chosen tiles,
confine crossings to the rows of one warp, or give segments angles near
0 and pi: the kernels find each row's extent, skip empty tiles and test
the order on the diagonal tiles only, on the device.

Tolerance: integer counts are equal; deviation sums agree at rtol 1e-5
(float32 sums in a different order).  The reference is imported inside a
fixture, so the card tests also run where JAX is not installed:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels.py``.
"""

import ctypes
import math
import re
import types

import numpy as np
import pytest
import torch

from repro_torch.core.engine import DEFAULT_IDEAL
from repro_torch.kernels import _build as t_build
from repro_torch.kernels import crossing_angle_sum as t_ang
from repro_torch.kernels import occlusion_pairs as t_occ
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import segment_crossing as t_cross
from repro_torch.kernels import strip_reversal as t_rev
from repro_torch.kernels.fixtures import (FIXTURES, OCCLUSION_CASES,
                                          STRIP_SLABS, TILE_LAYOUTS,
                                          WIDE_STRIP_SLABS, boundary_points,
                                          occlusion_case, random_segments,
                                          strip_slab)

RTOL = 1e-5
ALL_SLABS = {**STRIP_SLABS, **WIDE_STRIP_SLABS}
SLAB_NAMES = sorted(STRIP_SLABS) + sorted(WIDE_STRIP_SLABS)


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import engine, grid
    from repro.kernels import ops
    from repro.kernels import ref as oracles
    return types.SimpleNamespace(jnp=jnp, engine=engine, grid=grid, ops=ops,
                                 oracles=oracles)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _torch(arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize("name", SLAB_NAMES)
@pytest.mark.parametrize("with_angle", [True, False])
def test_plain_reversal_matches_reference(ref, name, with_angle):
    arrays = strip_slab(**ALL_SLABS[name])
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
    arrays = _torch(strip_slab(**STRIP_SLABS["cap45"]))
    before = t_rev.strip_reversal_rows.LAUNCHES
    got = t_rev.strip_reversal_rows(*arrays, ideal=1.0)
    want = t_rev.strip_reversal_rows_plain(*arrays, ideal=1.0)
    assert t_rev.strip_reversal_rows.LAUNCHES == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    meta = [a.to("meta") for a in arrays]
    with pytest.raises(ValueError, match="cuda or cpu"):
        t_rev.strip_reversal_rows(*meta, ideal=1.0)


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


@pytest.mark.parametrize("name", OCCLUSION_CASES)
def test_plain_occlusion_matches_reference_on_tile_cases(ref, name):
    pos, ok = occlusion_case(name, 0.5)
    got = t_occ.occlusion_pairs_plain(
        *_torch([pos[:, 0].copy(), pos[:, 1].copy(), ok]), 0.5)
    want = ref.ops.occlusion_count_op(ref.jnp.asarray(pos), 0.5,
                                      valid=ref.jnp.asarray(ok))
    assert int(got) == int(want) > 0


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


def edge_arrays(layout, device="cpu"):
    """The crossing kernels' padded ``(x1, y1, x2, y2, theta, v, u, ok)``
    of a fixture layout, on ``device``."""
    pos, edges, valid = _torch(layout, device)
    return t_ops._edge_arrays(pos, edges, valid)


def reference_edge_arrays(ref, layout):
    """The same layout as the reference's unpadded edge arrays."""
    pos, edges, valid = layout
    p, q = pos[edges[:, 0]], pos[edges[:, 1]]
    return [ref.jnp.asarray(a) for a in (p[:, 0], p[:, 1], q[:, 0], q[:, 1],
                                         edges[:, 0], edges[:, 1], valid)]


@pytest.mark.parametrize("n_e,seed", [(200, 0), (256, 1), (512, 2)])
def test_plain_crossing_kernels_match_pallas(ref, n_e, seed):
    layout = random_segments(n_e, seed=seed)
    x1, y1, x2, y2, th, v, u, ok = edge_arrays(layout)
    count = t_cross.crossing_count_plain(x1, y1, x2, y2, v, u, ok)
    a_cnt, a_dev = t_ang.crossing_angle_plain(
        x1, y1, x2, y2, th, v, u, ok, ideal=DEFAULT_IDEAL)
    pos, edges, valid = (ref.jnp.asarray(a) for a in layout)
    want = ref.ops.crossing_count_op(pos, edges, valid=valid)
    w_cnt, w_dev = ref.ops.crossing_angle_op(pos, edges, valid=valid,
                                             ideal=float(DEFAULT_IDEAL))
    assert int(count) == int(want) == int(a_cnt) == int(w_cnt) > 0
    np.testing.assert_allclose(float(a_dev), float(w_dev), rtol=RTOL)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_plain_crossing_kernels_match_oracles_on_fixtures(ref, name):
    layout = FIXTURES[name]()
    x1, y1, x2, y2, th, v, u, ok = edge_arrays(layout)
    count = t_cross.crossing_count_plain(x1, y1, x2, y2, v, u, ok,
                                         row_block=37)
    a_cnt, a_dev = t_ang.crossing_angle_plain(
        x1, y1, x2, y2, th, v, u, ok, ideal=DEFAULT_IDEAL, row_block=64)
    rx1, ry1, rx2, ry2, rv, ru, rok = reference_edge_arrays(ref, layout)
    want = int(ref.oracles.crossing_count_ref(rx1, ry1, rx2, ry2, rv, ru,
                                              rok))
    w_cnt, w_dev = ref.oracles.crossing_angle_ref(
        rx1, ry1, rx2, ry2, rv, ru, DEFAULT_IDEAL, rok)
    assert int(count) == int(a_cnt) == want == int(w_cnt) > 0
    np.testing.assert_allclose(float(a_dev), float(w_dev), rtol=RTOL)


@pytest.mark.parametrize("name", sorted(TILE_LAYOUTS))
def test_plain_crossing_angle_matches_oracles_on_tile_layouts(ref, name):
    layout = TILE_LAYOUTS[name]()
    args = edge_arrays(layout)
    cnt, dev = t_ang.crossing_angle_plain(*args, ideal=DEFAULT_IDEAL)
    rx1, ry1, rx2, ry2, rv, ru, rok = reference_edge_arrays(ref, layout)
    w_cnt, w_dev = ref.oracles.crossing_angle_ref(
        rx1, ry1, rx2, ry2, rv, ru, DEFAULT_IDEAL, rok)
    assert int(cnt) == int(w_cnt) > 0
    np.testing.assert_allclose(float(dev), float(w_dev), rtol=RTOL)


def test_tile_layouts_hit_their_tiles_warps_and_angles():
    """The layouts do what their names say: valid edges only in the named
    tiles, crossings only between rows 32-63 of a tile, and crossing
    pairs whose acute angle is ``pi - d``."""
    tile = t_cross.TILE
    for name in ("tiles2_last", "tiles3_alternate"):
        _, edges, valid = TILE_LAYOUTS[name]()
        tiles = set(np.flatnonzero(valid) // tile)
        assert tiles == ({1} if name == "tiles2_last" else {0, 2})
    x1, y1, x2, y2, th, v, u, ok = edge_arrays(TILE_LAYOUTS["warp_rows"]())
    n = x1.shape[0]
    rows = [i for i in range(n)
            if t_cross.crossing_mask(x1, y1, x2, y2, v, u, ok, i, i + 1).any()]
    assert rows and all(32 <= i % tile < 64 for i in rows)
    x1, y1, x2, y2, th, v, u, ok = edge_arrays(
        TILE_LAYOUTS["theta_near_0_and_pi"]())
    mask = t_cross.crossing_mask(x1, y1, x2, y2, v, u, ok, 0, x1.shape[0])
    d = (th[:, None] - th[None, :]).abs()
    assert bool((mask & (math.pi - d < d)).any())
    assert bool((th[ok] < 0.01).any() and (th[ok] > math.pi - 0.01).any())


def contracted_crossing_count(layout):
    """The crossing count with each cross product contracted as an FMA
    (``a*b - c*d`` with ``a*b`` unrounded), emulated in float64."""
    pos, edges, valid = layout
    p, q = pos[edges[:, 0]], pos[edges[:, 1]]

    def cross(px, py, qx, qy, rx, ry):
        cd = ((qy - py) * (rx - px)).astype(np.float64)
        ab = (qx - px).astype(np.float64) * (ry - py).astype(np.float64)
        return (ab - cd).astype(np.float32)

    a = lambda t: t[:, None]
    b = lambda t: t[None, :]
    x1, y1, x2, y2 = p[:, 0], p[:, 1], q[:, 0], q[:, 1]
    d1 = cross(a(x1), a(y1), a(x2), a(y2), b(x1), b(y1))
    d2 = cross(a(x1), a(y1), a(x2), a(y2), b(x2), b(y2))
    d3 = cross(b(x1), b(y1), b(x2), b(y2), a(x1), a(y1))
    d4 = cross(b(x1), b(y1), b(x2), b(y2), a(x2), a(y2))
    straddle = lambda s, t: ((s <= 0) & (t >= 0)) | ((s >= 0) & (t <= 0))
    v, u = edges[:, 0], edges[:, 1]
    shared = ((a(v) == b(v)) | (a(v) == b(u)) | (a(u) == b(v))
              | (a(u) == b(u)))
    n = len(v)
    upper = np.arange(n)[:, None] < np.arange(n)[None, :]
    return int((straddle(d1, d2) & straddle(d3, d4) & ~shared & upper
                & a(valid) & b(valid)).sum())


def test_near_collinear_fixture_is_decided_by_rounding():
    """On the near-collinear fixture an FMA-contracted cross product
    changes the count: a kernel that let nvcc contract would fail it."""
    layout = FIXTURES["near_collinear"]()
    x1, y1, x2, y2, _, v, u, ok = edge_arrays(layout)
    exact = int(t_cross.crossing_count_plain(x1, y1, x2, y2, v, u, ok))
    assert contracted_crossing_count(layout) != exact
    # integer fixtures have exact products: contraction cannot matter
    assert contracted_crossing_count(FIXTURES["t_junctions"]()) == int(
        t_ops.crossing_count_op(*_torch(FIXTURES["t_junctions"]()[:2]),
                                valid=None))


@pytest.mark.parametrize("kernel", ["segment_crossing", "crossing_angle_sum"])
def test_crossing_wrappers_take_plain_route_on_cpu_only(kernel):
    args = edge_arrays(FIXTURES["invalid_slots"]())
    x1, y1, x2, y2, th, v, u, ok = args
    if kernel == "segment_crossing":
        wrapper = t_cross.crossing_count
        call = lambda a: wrapper(*a[:4], *a[5:])
        want = (t_cross.crossing_count_plain(x1, y1, x2, y2, v, u, ok),)
    else:
        wrapper = t_ang.crossing_angle_stats
        call = lambda a: wrapper(*a, ideal=DEFAULT_IDEAL)
        want = t_ang.crossing_angle_plain(*args, ideal=DEFAULT_IDEAL)
    before = wrapper.LAUNCHES
    got = call(args)
    got = got if isinstance(got, tuple) else (got,)
    assert wrapper.LAUNCHES == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="cuda or cpu"):
        call([a.to("meta") for a in args])


def test_edge_arrays_pad_to_the_tile():
    layout = FIXTURES["invalid_slots"]()
    x1, y1, x2, y2, th, v, u, ok = edge_arrays(layout)
    e = layout[1].shape[0]
    assert x1.shape == (t_cross.TILE,) and e < t_cross.TILE
    assert torch.equal(ok[:e], torch.from_numpy(layout[2]))
    assert not ok[e:].any()
    assert (v[e:] == -1).all() and (u[e:] == -2).all()
    assert (x1[e:] == 0).all() and (th[e:] == 0).all()
    assert v.dtype == u.dtype == torch.int32 and ok.dtype == torch.bool


# ---------------------------------------------------------------------------
# on the card: kernel against plain version
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("name", SLAB_NAMES)
@pytest.mark.parametrize("with_angle", [True, False])
def test_reversal_kernel_matches_plain_on_card(cuda, name, with_angle):
    spec = ALL_SLABS[name]
    arrays = _torch(strip_slab(**spec), cuda)
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


@pytest.mark.gpu
@pytest.mark.parametrize("name", OCCLUSION_CASES)
def test_occlusion_kernel_matches_plain_on_tile_cases(cuda, name):
    pos, ok = occlusion_case(name, 0.5)
    args = _torch([pos[:, 0].copy(), pos[:, 1].copy(), ok], cuda)
    before = t_occ.occlusion_pairs.LAUNCHES
    got = t_occ.occlusion_pairs(*args, 0.5)
    torch.cuda.synchronize()
    assert t_occ.occlusion_pairs.LAUNCHES == before + 1
    assert int(got) == int(t_occ.occlusion_pairs_plain(*args, 0.5)) > 0


CROSSING_CASES = sorted(FIXTURES) + ["random4096"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CROSSING_CASES)
def test_crossing_kernels_match_plain_on_card(cuda, name):
    layout = (random_segments(4096, seed=11) if name == "random4096"
              else FIXTURES[name]())
    args = edge_arrays(layout, cuda)
    x1, y1, x2, y2, th, v, u, ok = args
    before = (t_cross.crossing_count.LAUNCHES,
              t_ang.crossing_angle_stats.LAUNCHES)
    count = t_cross.crossing_count(x1, y1, x2, y2, v, u, ok)
    cnt, dev = t_ang.crossing_angle_stats(*args, ideal=DEFAULT_IDEAL)
    torch.cuda.synchronize()
    assert (t_cross.crossing_count.LAUNCHES,
            t_ang.crossing_angle_stats.LAUNCHES) == (before[0] + 1,
                                                     before[1] + 1)
    want = t_cross.crossing_count_plain(x1, y1, x2, y2, v, u, ok)
    assert int(count) == int(want)
    p_cnt, p_dev = t_ang.crossing_angle_plain(*args, ideal=DEFAULT_IDEAL)
    assert int(cnt) == int(p_cnt) == int(want)
    np.testing.assert_allclose(float(dev), float(p_dev), rtol=RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(TILE_LAYOUTS) + ["random16384"])
def test_crossing_angle_kernel_matches_plain_on_tile_layouts(cuda, name):
    layout = (random_segments(16384, seed=13) if name == "random16384"
              else TILE_LAYOUTS[name]())
    args = edge_arrays(layout, cuda)
    cnt, dev = t_ang.crossing_angle_stats(*args, ideal=DEFAULT_IDEAL)
    torch.cuda.synchronize()
    p_cnt, p_dev = t_ang.crossing_angle_plain(*args, ideal=DEFAULT_IDEAL)
    assert int(cnt) == int(p_cnt) > 0
    np.testing.assert_allclose(float(dev), float(p_dev), rtol=RTOL)
    x1, y1, x2, y2, th, v, u, ok = args
    assert int(t_cross.crossing_count(x1, y1, x2, y2, v, u, ok)) == int(p_cnt)


@pytest.mark.gpu
def test_crossing_angle_kernel_is_bit_identical_across_launches(cuda):
    """Fixed-order reductions and no float atomics: the deviation sum (and
    every tile partial) is the same bit for bit from launch to launch."""
    args = edge_arrays(random_segments(16384, seed=14), cuda)
    first = t_ang.crossing_angle_stats(*args, ideal=DEFAULT_IDEAL)
    second = t_ang.crossing_angle_stats(*args, ideal=DEFAULT_IDEAL)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert first[1].item().hex() == second[1].item().hex()


@pytest.mark.gpu
def test_crossing_angle_launches_counted_once_per_call(cuda):
    args = edge_arrays(TILE_LAYOUTS["tiles3_alternate"](), cuda)
    before = t_ang.crossing_angle_stats.LAUNCHES
    for k in range(1, 4):
        t_ang.crossing_angle_stats(*args, ideal=DEFAULT_IDEAL)
        assert t_ang.crossing_angle_stats.LAUNCHES == before + k
    t_ops.crossing_angle_op(*_torch(TILE_LAYOUTS["tiles1"]()[:2], cuda),
                            ideal=DEFAULT_IDEAL)
    torch.cuda.synchronize()
    assert t_ang.crossing_angle_stats.LAUNCHES == before + 4
