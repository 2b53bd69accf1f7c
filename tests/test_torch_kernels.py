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

The slabs include validity masks whose valid slots are no prefix
(:func:`mask_pattern`) and the occlusion cases lay valid vertices out
against the kernel's tiles (:func:`occlusion_case`): the redesigned
kernels find each row's extent and skip empty tiles on the device.

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
from repro_torch.kernels import crossing_angle_sum as t_ang
from repro_torch.kernels import occlusion_pairs as t_occ
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import segment_crossing as t_cross
from repro_torch.kernels import strip_reversal as t_rev
from repro_torch.kernels.fixtures import FIXTURES, random_segments

RTOL = 1e-5


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


def mask_pattern(name, rows, cap, rng):
    """Validity masks whose valid slots do not form a prefix, or whose
    extents differ from row to row (the strip-reversal kernel finds each
    row's extent on the device)."""
    ok = np.zeros((rows, cap), bool)
    if name == "last_only":         # only the last slot, or first + last
        ok[0::3, -1] = True
        ok[1::3, [0, -1]] = True
        ok[2::3] = True
    elif name == "interior_gaps":   # a prefix of random length, holed
        for r in range(rows):
            n = int(rng.integers(2, cap + 1))
            ok[r, :n] = rng.random(n) < 0.5
    elif name == "one_slot_rows":   # full, empty, one slot, empty, ...
        for r in range(rows):
            kind = r % 4
            if kind == 0:
                ok[r] = True
            elif kind == 2:
                ok[r, int(rng.integers(0, cap))] = True
    elif name == "mixed_lengths":   # short and full rows in one slab
        lengths = [0, 1, 2, 31, 32, 33, 127, 128, 129, 200, 255, 256]
        for r in range(rows):
            ok[r, :min(cap, lengths[r % len(lengths)])] = True
    else:
        raise ValueError(name)
    return ok


def slab(rows, cap, seed, *, ties=False, shared=False, invalid_rows=(),
         p_valid=0.85, mask=None):
    """A ``(rows, cap)`` slab of strip buckets as numpy arrays (``mask``
    names a :func:`mask_pattern`; the default scatters invalid slots)."""
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
    ok = (rng.random((rows, cap)) < p_valid if mask is None
          else mask_pattern(mask, rows, cap, rng))
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
    "last_only": dict(rows=6, cap=300, seed=6, ties=True, mask="last_only"),
    "interior_gaps": dict(rows=5, cap=200, seed=7, mask="interior_gaps"),
    "one_slot_rows": dict(rows=8, cap=150, seed=8, ties=True,
                          mask="one_slot_rows"),
    "mixed_cap256": dict(rows=24, cap=256, seed=9, shared=True,
                         mask="mixed_lengths"),
}
# rows longer than one 1024-slot staging window of the kernel
WIDE_SLABS = {
    "cap1100_wide": dict(rows=3, cap=1100, seed=9, ties=True),
    "cap2500_windows": dict(rows=2, cap=2500, seed=10, ties=True,
                            mask="interior_gaps"),
}


def _torch(arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize("name", sorted(SLABS) + sorted(WIDE_SLABS))
@pytest.mark.parametrize("with_angle", [True, False])
def test_plain_reversal_matches_reference(ref, name, with_angle):
    arrays = slab(**{**SLABS, **WIDE_SLABS}[name])
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


def occlusion_case(name, radius):
    """``(x, y, ok)`` padded to the kernel's tile: dense points (many
    occluding pairs) with the validity laid out to hit the kernel's tile
    skipping and diagonal handling."""
    t = t_occ.TILE
    rng = np.random.default_rng(len(name))
    n = t if name == "one_tile" else 3 * t
    pos = rng.uniform(0, 12, (n, 2)).astype(np.float32)
    ok = np.ones(n, bool)
    if name == "one_tile":          # n of exactly one tile, with ties
        pts = boundary_points(radius)
        pos[:len(pts)] = pts
    elif name == "middle_tile_invalid":
        ok[t:2 * t] = False
    elif name == "last_tile_single":
        ok[2 * t:] = False
        ok[-1] = True               # one valid vertex, on top of vertex 0
        pos[-1] = pos[0]
    else:
        raise ValueError(name)
    return pos, ok


OCCLUSION_CASES = ["last_tile_single", "middle_tile_invalid", "one_tile"]


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
@pytest.mark.parametrize("name", sorted(SLABS) + sorted(WIDE_SLABS))
@pytest.mark.parametrize("with_angle", [True, False])
def test_reversal_kernel_matches_plain_on_card(cuda, name, with_angle):
    spec = {**SLABS, **WIDE_SLABS}[name]
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
