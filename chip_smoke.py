#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs a
CUDA device and the ``src/repro_torch`` sources beside it, and fails
(non-zero exit, no result line) without either.  It imports nothing of
JAX or of the JAX package.

Phases (any failed check raises):

1. **Build** both hand-written kernels from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` for ``sm_90a`` (one compiler per source, started
   together) and print the card's name and power limit.
2. **Kernel vs plain on the card**: the strip-reversal kernel at every
   ``(rows, cap)`` slab the main path below hands it and on an
   adversarial slab (ties, shared endpoints, a cap above one
   shared-memory tile, invalid rows); the occlusion-pair kernel at the
   main path's padded size and on exact ``d2 == (2r)^2`` pairs.
   Integers equal, deviation sums at rtol 1e-5.
3. **Main path at full size**: the layout-local graph at |V| = 100,000
   (about 2e5 edges), ``radius=0.5``, ``n_strips=512``, both
   orientations, all five metrics, through the user's entry points:
   (a) ``Evaluator(cfg).evaluate`` (fused, via the session), (b)
   ``.evaluate_batch`` of B=8 layouts (member 0 the layout, 1-7 seeded
   jitter), (c) ``Evaluator(backend="kernels").evaluate``.  Results must
   equal the JAX reference constants below (integers exactly, floats at
   rtol 1e-5) with ``overflow == 0``, both kernels' launch counts
   must have grown, and the shapes each kernel was launched on must be
   the ones checked and timed in phases 2 and 4.
4. **Timings**: median of 5 CUDA-event-timed runs after a warm-up, for
   (a)-(c) and for each kernel at its main-path shapes beside its plain
   version and its bound.

The last lines are a ``{"kernels": [...]}`` JSON line, the card line
from ``nvidia-smi``, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

N_V, SEED, FRAC_LONG = 100_000, 0, 0.002
RADIUS, N_STRIPS, BATCH, JITTER = 0.5, 512, 8, 0.02
RTOL = 1e-5
REPEATS = 5
# one H100 SXM (NVIDIA data sheet): HBM3 rate, and the FP32 pipe's issue
# rate (67 TFLOP/s counts an FMA as two operations: 132 SMs x 128 lanes
# x 1.98 GHz = 33.5e12 simple operations per second)
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 33.5e12
# operations the functions need, on the valid slots only (the valid slots
# of a strip row are a prefix, so no mask work is needed past them).
# Strip reversal, per unordered pair {i, j} of a row: the reversal either
# way is 4 float compares whose ANDs fold into predicate-combining
# compares, shared endpoints are 4 int compares (also folded), one
# predicate op joins them and one add counts: 10.  Per crossing, the
# deviation: sub, sub, min, sub, div, add (abs is a free source modifier).
# Occlusion, per unordered valid pair: 2 sub, 2 mul, 1 add, 1 compare,
# 1 add to the count (the i < j order is the choice of unordered pairs).
REV_OPS_PER_UNORDERED_PAIR = 10
REV_OPS_PER_CROSSING = 6
OCC_OPS_PER_PAIR = 7

# JAX reference constants for exactly these inputs, made on the CPU with
#   PYTHONPATH=src JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py
# (the reference run op by op; see that script's note on jit and FMA).
REFERENCE = {
    "fused": {
        "node_occlusion": 1538901,
        "minimum_angle": 0.7792223691940308,
        "edge_length_variation": 0.013489088974893093,
        "edge_crossing": 34534,
        "edge_crossing_angle": 0.7175037860870361,
        "crossing_count_for_angle": 34534,
        "overflow": 0,
    },
    "kernels": {
        "node_occlusion": 1538901,
        "minimum_angle": 0.7792223691940308,
        "edge_length_variation": 0.013489088974893093,
        "edge_crossing": 34534,
        "edge_crossing_angle": 0.7175037860870361,
        "crossing_count_for_angle": 34534,
        "overflow": 0,
    },
    "batch": [
        {
            "node_occlusion": 1538901,
            "minimum_angle": 0.7792223691940308,
            "edge_length_variation": 0.013489087112247944,
            "edge_crossing": 34534,
            "edge_crossing_angle": 0.7175037860870361,
            "crossing_count_for_angle": 34534,
            "overflow": 0,
        },
        {
            "node_occlusion": 1534049,
            "minimum_angle": 0.7613797187805176,
            "edge_length_variation": 0.013448505662381649,
            "edge_crossing": 34857,
            "edge_crossing_angle": 0.7166274189949036,
            "crossing_count_for_angle": 34857,
            "overflow": 0,
        },
        {
            "node_occlusion": 1533864,
            "minimum_angle": 0.7615199685096741,
            "edge_length_variation": 0.013448857702314854,
            "edge_crossing": 34533,
            "edge_crossing_angle": 0.7159731388092041,
            "crossing_count_for_angle": 34533,
            "overflow": 0,
        },
        {
            "node_occlusion": 1533890,
            "minimum_angle": 0.7615078687667847,
            "edge_length_variation": 0.013448761776089668,
            "edge_crossing": 34699,
            "edge_crossing_angle": 0.7175784111022949,
            "crossing_count_for_angle": 34699,
            "overflow": 0,
        },
        {
            "node_occlusion": 1534278,
            "minimum_angle": 0.7615787982940674,
            "edge_length_variation": 0.013448711484670639,
            "edge_crossing": 34570,
            "edge_crossing_angle": 0.718038022518158,
            "crossing_count_for_angle": 34570,
            "overflow": 0,
        },
        {
            "node_occlusion": 1534058,
            "minimum_angle": 0.7615923881530762,
            "edge_length_variation": 0.013449139893054962,
            "edge_crossing": 34598,
            "edge_crossing_angle": 0.7178776264190674,
            "crossing_count_for_angle": 34598,
            "overflow": 0,
        },
        {
            "node_occlusion": 1534240,
            "minimum_angle": 0.7617049217224121,
            "edge_length_variation": 0.013448338955640793,
            "edge_crossing": 34674,
            "edge_crossing_angle": 0.7166961431503296,
            "crossing_count_for_angle": 34674,
            "overflow": 0,
        },
        {
            "node_occlusion": 1534117,
            "minimum_angle": 0.7615830898284912,
            "edge_length_variation": 0.013448375277221203,
            "edge_crossing": 34660,
            "edge_crossing_angle": 0.7163858413696289,
            "crossing_count_for_angle": 34660,
            "overflow": 0,
        },
    ],
}
INT_FIELDS = ("node_occlusion", "edge_crossing", "crossing_count_for_angle",
              "overflow")
FLOAT_FIELDS = ("minimum_angle", "edge_length_variation",
                "edge_crossing_angle")


class CheckFailed(RuntimeError):
    pass


def check(ok, message):
    if not ok:
        raise CheckFailed(message)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, repeats=REPEATS, inner=1):
    """Median over ``repeats`` of the CUDA-event time of ``inner`` calls of
    ``fn``, per call, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def inputs():
    import numpy as np
    from repro_torch.graphs.datasets import layout_local_graph
    pos, edges = layout_local_graph(N_V, seed=SEED, frac_long=FRAC_LONG)
    rng = np.random.default_rng(1)
    batch = np.stack([pos] + [
        pos + rng.normal(0, JITTER, pos.shape).astype(np.float32)
        for _ in range(BATCH - 1)]).astype(np.float32)
    return pos, edges, batch


def session_padding(pos, edges):
    """The session's padded request: pow2 buckets, PARK rows."""
    import numpy as np
    from repro_torch.core.keys import pow2_bucket
    from repro_torch.launch.session import PARK
    vb, eb = pow2_bucket(pos.shape[0]), pow2_bucket(edges.shape[0])
    pos_p = np.full((vb, 2), PARK, np.float32)
    pos_p[:pos.shape[0]] = pos
    edges_p = np.zeros((eb, 2), np.int32)
    edges_p[:edges.shape[0]] = edges
    return pos_p, edges_p


def reversal_slabs(plan, pos, edges, n_e, dev, *, flat_buckets=False):
    """The ``(rows, cap)`` slabs the engine hands the strip-reversal kernel
    for ``pos`` ``(B, V, 2)`` under ``plan``, built with the engine's own
    functions: per tier and orientation, or the flat buckets of the
    kernels route."""
    import torch
    from repro_torch.core import engine
    from repro_torch.core import grid as gridlib
    pos_t = torch.as_tensor(pos, device=dev)
    edges_t = torch.as_tensor(edges, device=dev)
    ev = torch.arange(edges_t.shape[0], device=dev) < n_e
    B = pos_t.shape[0]
    slabs = []
    for axis_i, (axis, (ms, cap)) in enumerate(zip(plan.axes,
                                                   plan.strip_plans)):
        if B == 1:
            segs = gridlib.build_strip_segments(
                pos_t[0], edges_t, plan.n_strips, ms, axis=axis,
                edge_valid=ev)
            if flat_buckets:
                b = gridlib.bucketize_segments(segs, plan.n_strips, cap)
                slabs.append((f"axis{axis} flat", [
                    b.yl, b.yr, b.theta, b.v.to(torch.int32),
                    b.u.to(torch.int32), b.valid]))
                continue
            segs = segs._replace(**{f: getattr(segs, f)[None] for f in (
                "strip", "yl", "yr", "theta", "v", "u", "valid")})
        else:
            segs = gridlib.build_strip_segments_batched(
                pos_t, edges_t, plan.n_strips, ms, axis=axis, edge_valid=ev)
        for _, args in engine.tier_slabs(plan, axis_i, segs, B)[0]:
            slabs.append((f"axis{axis} tier{args[0].shape[1]}", list(args)))
    return slabs


def adversarial_slab(dev):
    """Ties, shared endpoints, a cap above one shared-memory tile (256)
    and all-invalid rows."""
    import numpy as np
    import torch
    rng = np.random.default_rng(5)
    rows, cap = 6, 1100
    yl = np.round(rng.uniform(0, 20, (rows, cap))).astype(np.float32)
    yr = np.round(rng.uniform(0, 20, (rows, cap))).astype(np.float32)
    th = rng.uniform(0, np.pi, (rows, cap)).astype(np.float32)
    v = rng.integers(0, 40, (rows, cap)).astype(np.int32)
    u = rng.integers(0, 40, (rows, cap)).astype(np.int32)
    ok = rng.random((rows, cap)) < 0.9
    ok[1] = False
    ok[4] = False
    return [torch.from_numpy(a).to(dev) for a in (yl, yr, th, v, u, ok)]


def boundary_fixture(dev):
    """Pairs at exactly d2 == (2r)^2 (not occluded under the strict '<'),
    one nudged inside and one coincident pair, padded to one tile."""
    import numpy as np
    import torch
    from repro_torch.kernels.occlusion_pairs import TILE
    d = np.float32(2 * RADIUS)
    pts = np.array([(0, 0), (d, 0), (0, d), (-d, 0),
                    (10, 10), (10 + 0.6 * d, 10 + 0.8 * d),
                    (0, 20), (np.nextafter(d, 0), 20),
                    (0, 30), (np.nextafter(d, 99), 30),
                    (40, 40), (40, 40)], np.float32)
    x = np.zeros(TILE, np.float32)
    y = np.zeros(TILE, np.float32)
    ok = np.zeros(TILE, bool)
    x[:len(pts)], y[:len(pts)], ok[:len(pts)] = pts[:, 0], pts[:, 1], True
    return [torch.from_numpy(a).to(dev) for a in (x, y, ok)]


def compare_reversal(label, args, ideal):
    import torch
    from repro_torch.kernels.strip_reversal import (
        strip_reversal_rows, strip_reversal_rows_plain)
    cnt, dev = strip_reversal_rows(*args, ideal=ideal)
    torch.cuda.synchronize()
    pc, pd = strip_reversal_rows_plain(*args, ideal=ideal)
    torch.cuda.synchronize()
    check(torch.equal(cnt, pc), f"strip_reversal counts differ on {label}")
    err = float((dev.double() - pd.double()).abs().max()) if dev.numel() \
        else 0.0
    ok = torch.allclose(dev.double(), pd.double(), rtol=RTOL, atol=0.0)
    check(ok, f"strip_reversal deviation sums differ on {label} "
              f"(max abs err {err})")
    return err


def reversal_bound_ms(args):
    """The least time for one slab: input bytes read once and outputs
    written once over HBM, or the unordered pairs between each row's
    valid slots (and the deviation work on crossing pairs) over the FP32
    issue rate."""
    from repro_torch.kernels.strip_reversal import strip_reversal_rows_plain
    import torch
    yl, ok = args[0], args[5]
    rows, cap = yl.shape
    n_valid = ok.sum(dim=1, dtype=torch.float64)
    crossings = float(strip_reversal_rows_plain(
        *args, ideal=1.0, with_angle=False)[0].sum())
    pairs = float((n_valid * (n_valid - 1) / 2).sum())
    ops = REV_OPS_PER_UNORDERED_PAIR * pairs + REV_OPS_PER_CROSSING * crossings
    nbytes = rows * cap * (5 * 4 + 1) + rows * (8 + 4)
    return max(nbytes / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S) * 1e3, \
        "bytes" if nbytes / HBM_BYTES_PER_S > ops / ALU_OPS_PER_S \
        else "operations"


def occlusion_bound_ms(x, ok):
    n = x.shape[0]
    nv = float(ok.sum())
    ops = OCC_OPS_PER_PAIR * nv * (nv - 1) / 2
    nbytes = n * 9 + 8
    return max(nbytes / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S) * 1e3, \
        "bytes" if nbytes / HBM_BYTES_PER_S > ops / ALU_OPS_PER_S \
        else "operations"


def check_scores(label, got, want):
    for f in INT_FIELDS:
        check(int(getattr(got, f)) == want[f],
              f"{label}: {f} = {int(getattr(got, f))}, reference {want[f]}")
    for f in FLOAT_FIELDS:
        g = float(getattr(got, f))
        check(abs(g - want[f]) <= RTOL * abs(want[f]),
              f"{label}: {f} = {g!r}, reference {want[f]!r} (rtol {RTOL})")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run it from "
              "the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))

    import numpy as np
    from repro_torch.api import EvalConfig, Evaluator
    from repro_torch.core import engine
    from repro_torch.kernels import _build
    from repro_torch.kernels import occlusion_pairs as occlusion_pairs_mod
    from repro_torch.kernels import strip_reversal as strip_reversal_mod
    from repro_torch.kernels.occlusion_pairs import (
        TILE, occlusion_pairs, occlusion_pairs_plain)
    from repro_torch.kernels.strip_reversal import (
        strip_reversal_rows, strip_reversal_rows_plain)

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    report = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          f"{', '.join(report)}", flush=True)
    for name, (seconds, log) in report.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # -- inputs and the main path's kernel shapes --------------------------
    pos, edges, batch = inputs()
    n_v, n_e = pos.shape[0], edges.shape[0]
    cfg = EvalConfig(radius=RADIUS, n_strips=N_STRIPS)
    kcfg = dataclasses.replace(cfg, backend="kernels")
    print(f"graph: |V| = {n_v}, |E| = {n_e}, batch {BATCH}", flush=True)
    flat = engine.plan_readability(pos, edges,
                                   **cfg.plan_kwargs(tier_default=False))
    tiered = engine.plan_readability(batch, edges, **cfg.plan_kwargs())
    pos_p, edges_p = session_padding(pos, edges)
    ideal = flat.ideal
    slabs = {
        "a": reversal_slabs(flat, pos_p[None], edges_p, n_e, dev),
        "b": reversal_slabs(tiered, batch, edges, n_e, dev),
        "c": reversal_slabs(flat, pos_p[None], edges_p, n_e, dev,
                            flat_buckets=True),
    }
    n_pad = -(-pos_p.shape[0] // TILE) * TILE
    occ_x = torch.zeros(n_pad, device=dev)
    occ_y = torch.zeros(n_pad, device=dev)
    occ_ok = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    occ_x[:pos_p.shape[0]] = torch.from_numpy(pos_p[:, 0]).to(dev)
    occ_y[:pos_p.shape[0]] = torch.from_numpy(pos_p[:, 1]).to(dev)
    occ_ok[:n_v] = True
    for path, items in slabs.items():
        for label, args in items:
            print(f"shape ({path}) strip_reversal {label}: "
                  f"{tuple(args[0].shape)}", flush=True)
    print(f"shape (c) occlusion_pairs: ({n_pad},)", flush=True)

    # -- 2. kernel vs plain ------------------------------------------------
    rev_err = 0.0
    for path, items in slabs.items():
        for label, args in items:
            rev_err = max(rev_err, compare_reversal(f"({path}) {label}",
                                                    args, ideal))
    rev_err = max(rev_err, compare_reversal("adversarial",
                                            adversarial_slab(dev), ideal))
    got = occlusion_pairs(occ_x, occ_y, occ_ok, RADIUS)
    torch.cuda.synchronize()
    want = occlusion_pairs_plain(occ_x, occ_y, occ_ok, RADIUS)
    check(int(got) == int(want),
          f"occlusion_pairs {int(got)} != plain {int(want)} at n={n_pad}")
    fx = boundary_fixture(dev)
    got_b = int(occlusion_pairs(*fx, RADIUS))
    torch.cuda.synchronize()
    want_b = int(occlusion_pairs_plain(*fx, RADIUS))
    check(got_b == want_b == 2,
          f"occlusion_pairs boundary fixture gave {got_b}, plain {want_b}, "
          "want 2")
    occ_err = float(max(abs(int(got) - int(want)), abs(got_b - want_b)))
    print(f"kernel vs plain: ok (strip_reversal max abs dev err {rev_err}, "
          f"occlusion_pairs {int(got)} pairs, max abs err {occ_err})",
          flush=True)

    # -- 3. main path ------------------------------------------------------
    ev = Evaluator(cfg)
    kev = Evaluator(kcfg)
    # record the shapes the main path launches each kernel on, to hold
    # them against the shapes checked and timed here
    seen = []
    launches_of = {mod: mod._launch for mod in (strip_reversal_mod,
                                                occlusion_pairs_mod)}

    def recorder(mod):
        def recording_launch(*args):
            seen[-1].append((mod.__name__.rsplit(".", 1)[1],
                             tuple(args[0].shape)))
            return launches_of[mod](*args)
        return recording_launch

    for mod in launches_of:
        mod._launch = recorder(mod)
    strip_reversal_rows.LAUNCHES = 0
    occlusion_pairs.LAUNCHES = 0
    runs = {}
    launches = {}
    seen_shapes = {}
    try:
        for path, call in (("a", lambda: ev.evaluate(pos, edges)),
                           ("b", lambda: ev.evaluate_batch(batch, edges)),
                           ("c", lambda: kev.evaluate(pos, edges))):
            before = (strip_reversal_rows.LAUNCHES, occlusion_pairs.LAUNCHES)
            seen.append([])
            runs[path] = call()
            launches[path] = (strip_reversal_rows.LAUNCHES - before[0],
                              occlusion_pairs.LAUNCHES - before[1])
            seen_shapes[path] = sorted(seen[-1])
    finally:
        for mod, launch in launches_of.items():
            mod._launch = launch
    rev_launches = strip_reversal_rows.LAUNCHES
    occ_launches = occlusion_pairs.LAUNCHES
    print(f"launches per path (strip_reversal, occlusion_pairs): "
          f"{launches}", flush=True)
    for path, shapes in seen_shapes.items():
        planned = sorted([("strip_reversal", tuple(args[0].shape))
                          for _, args in slabs[path]]
                         + [("occlusion_pairs", (n_pad,))] * (path == "c"))
        check(shapes == planned,
              f"({path}) launched the kernels on {shapes}, the shapes "
              f"checked and timed here are {planned}")
    check(rev_launches > 0 and occ_launches > 0,
          f"main path launched strip_reversal {rev_launches}x, "
          f"occlusion_pairs {occ_launches}x")
    check(launches["a"] == (len(slabs["a"]), 0)
          and launches["b"] == (len(slabs["b"]), 0)
          and launches["c"] == (len(slabs["c"]), 1),
          f"launches {launches} do not match the planned slabs")
    a, b, c = runs["a"], runs["b"].unbatch(), runs["c"]
    for f in INT_FIELDS:
        check(getattr(a, f) == getattr(b[0], f) == getattr(c, f),
              f"{f}: (a) {getattr(a, f)} (b)[0] {getattr(b[0], f)} "
              f"(c) {getattr(c, f)}")
    check(a.overflow == 0 and c.overflow == 0
          and all(r.overflow == 0 for r in b), "overflow")
    check_scores("(a) fused", a, REFERENCE["fused"])
    check_scores("(c) kernels", c, REFERENCE["kernels"])
    for i, r in enumerate(b):
        check_scores(f"(b)[{i}] batch", r, REFERENCE["batch"][i])
    for k in ("a", "c"):
        print(f"({k}) {runs[k]}")
    print(f"(b)[0] {b[0]}")
    print("main path: ok, equal to the JAX reference constants "
          f"(ints exact, floats rtol {RTOL})", flush=True)

    # -- 4. timings --------------------------------------------------------
    path_ms = {
        "a": cuda_ms(lambda: ev.evaluate(pos, edges)),
        "b": cuda_ms(lambda: ev.evaluate_batch(batch, edges)),
        "c": cuda_ms(lambda: kev.evaluate(pos, edges)),
    }
    for k, label in (("a", "evaluate fused"), ("b", f"evaluate_batch B={BATCH}"),
                     ("c", "evaluate kernels")):
        print(f"time ({k}) {label}: {path_ms[k]:.3f} ms "
              f"(median of {REPEATS}, CUDA events) on {card}", flush=True)

    rev = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_by={})
    for path, items in slabs.items():
        for label, args in items:
            k_ms = cuda_ms(lambda: strip_reversal_rows(*args, ideal=ideal),
                           inner=10)
            p_ms = cuda_ms(lambda: strip_reversal_rows_plain(
                *args, ideal=ideal))
            b_ms, by = reversal_bound_ms(args)
            rev["ms"] += k_ms
            rev["plain_ms"] += p_ms
            rev["bound_ms"] += b_ms
            rev["bound_by"][by] = rev["bound_by"].get(by, 0.0) + b_ms
            print(f"time strip_reversal ({path}) {label} "
                  f"{tuple(args[0].shape)}: kernel {k_ms:.4f} ms, plain "
                  f"{p_ms:.4f} ms, bound {b_ms:.5f} ms ({by}) on {card}",
                  flush=True)
    occ_ms = cuda_ms(lambda: occlusion_pairs(occ_x, occ_y, occ_ok, RADIUS),
                     inner=3)
    occ_plain = cuda_ms(lambda: occlusion_pairs_plain(occ_x, occ_y, occ_ok,
                                                      RADIUS))
    occ_bound, occ_by = occlusion_bound_ms(occ_x, occ_ok)
    print(f"time occlusion_pairs (c) ({n_pad},): kernel {occ_ms:.4f} ms, "
          f"plain {occ_plain:.4f} ms, bound {occ_bound:.5f} ms ({occ_by}) "
          f"on {card}", flush=True)

    kernels = [
        dict(name="strip_reversal", route="cuda",
             source="src/repro_torch/kernels/csrc/strip_reversal.cu",
             replaces="src/repro/kernels/strip_reversal.py:25",
             launches=rev_launches, max_abs_err=rev_err, ms=rev["ms"],
             plain_ms=rev["plain_ms"], bound_ms=rev["bound_ms"],
             bound_by=max(rev["bound_by"], key=rev["bound_by"].get),
             library_ms=None),
        dict(name="occlusion_pairs", route="cuda",
             source="src/repro_torch/kernels/csrc/occlusion_pairs.cu",
             replaces="src/repro/kernels/occlusion_pairs.py:30",
             launches=occ_launches, max_abs_err=occ_err, ms=occ_ms,
             plain_ms=occ_plain, bound_ms=occ_bound, bound_by=occ_by,
             library_ms=None),
    ]
    print("kernel times are summed over every launch of one pass of "
          "(a)-(c); launches are counted in that pass", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
