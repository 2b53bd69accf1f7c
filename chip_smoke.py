#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs a
CUDA device and the ``src/repro_torch`` sources beside it, and fails
(non-zero exit, no result line) without either.  It imports nothing of
JAX or of the JAX package.

Phases (any failed check raises):

1. **Build** the four hand-written kernels from
   ``src/repro_torch/kernels/csrc`` with ``nvcc`` for ``sm_90a`` (one
   compiler per source, started together) and print the card's name and
   power limit.
2. **Kernel vs plain on the card**: the strip-reversal kernel at every
   ``(rows, cap)`` slab the main path below hands it and on an
   adversarial slab (ties, shared endpoints, a cap above one staging
   window, invalid rows) and on slabs whose valid slots are no prefix
   (:func:`masked_slabs`); the occlusion-pair kernel at the main path's
   padded size, at the exact path's, on exact ``d2 == (2r)^2`` pairs and
   on the tile layouts of :func:`occlusion_tile_cases`; the
   segment-crossing and crossing-angle
   kernels on the adversarial layouts and the tile layouts of
   ``repro_torch.kernels.fixtures`` and at the exact path's size.
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
   (d) the exact all-pairs path, ``repro_torch.api.evaluate_exact`` with
   ``use_kernels=False`` and ``True``, on ego-Facebook at its published
   size (4,039 vertices, 88,234 edges, random layout), against the JAX
   reference's op-by-op constants; each call must launch the
   segment-crossing, crossing-angle and occlusion-pair kernels once
   each, on the shapes checked and timed here.
   (e) the serving front and the standalone enhanced algorithms:
   (e1) ``ReadabilityServer(EvalConfig(radius=0.5, n_strips=512))``
   serves (b)'s 8 layouts as 8 requests in one session dispatch of B=8 on
   a flat plan (integers equal to (b)'s constants: padded == natural and
   flat == tiered; a second round is a plan hit with no replan); (e2) the
   same on ``backend="kernels"``; (e3) ``ReadabilityServer(method=
   "exact")`` on (d)'s inputs (``EXACT_REFERENCE``); (e4) fault drills
   with the port's ``FaultPlan`` on the |V| = 10,000 layout-local graph
   of ``benchmarks/serve_bench.py`` (a failed B=8 dispatch split and
   retried, a NaN request quarantined alone, a cancelled and two shed
   requests, a hung chunk expired by the watchdog), each counter equal to
   ``FaultPlan.injected`` and every other slot's integers equal to an
   unfaulted run; (e5) ``count_crossings_enhanced``,
   ``crossing_angle_enhanced`` and ``count_occlusions_enhanced`` at |V| =
   100,000 against ``ENHANCED_REFERENCE``.  Outside the drills any error
   slot or failure counter fails the run: split-and-retry would otherwise
   hide a kernel that fails to launch.
4. **Timings**: median of 5 CUDA-event-timed runs after a warm-up, for
   (a)-(e3) and (e5); for each kernel at each shape launched in one pass
   of (a)-(e), its time alone on the device (median, min and max of 21
   readings of back-to-back launches of its C entry, whose outputs are
   then held against the wrapper's result), its wrapper's time, its plain
   version's and its bound, counted from the operations these inputs
   need, on the data phase 2 checked at that shape; a kernel's numbers
   are summed over its launches in the pass.

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
# operations the functions need on these inputs, on the valid slots only:
# a test that only some pairs reach is charged to those pairs, counted by
# the plain versions (the shared-endpoint mask left out where it says so).
# Strip reversal, per unordered pair {i, j} of valid slots of a row: the
# reversal in either order is 4 float compares (the ANDs folded into
# predicate-combining compares) and one predicate op joining the two
# orders: 5.  Per reversing pair (shared endpoints included): the 4 int
# compares for shared endpoints, folded: 4.  Per crossing (a reversal
# without a shared endpoint): one add to the count, and the deviation
# sub, sub, min, sub, div, add (abs is a free source modifier): 7.
# Occlusion, per unordered valid pair: 2 sub, 2 mul, 1 add, 1 compare: 6
# (the i < j order is the choice of unordered pairs); per occluded pair,
# one add to the count.
# Crossing test, per unordered pair of valid edges: the differences
# p2 - p1, q2 - p1, q1 - p2 (6 sub; q - p of each segment is per edge),
# four cross products (8 mul, 4 sub), the two straddle tests (3 each: a
# min, a max and one compare pair folded into a predicate op), one
# predicate op to join them: 25.  Per straddling pair (shared endpoints
# included): 4 int compares for shared endpoints, folded: 4.  Per
# crossing: one add to the count; and with the angle the deviation sub,
# sub, min, sub, mul, add: 6.
REV_OPS_PER_UNORDERED_PAIR = 5
REV_OPS_PER_REVERSAL = 4
REV_OPS_PER_CROSSING = 7
OCC_OPS_PER_PAIR = 6
OCC_OPS_PER_OCCLUSION = 1
CROSS_OPS_PER_UNORDERED_PAIR = 25
CROSS_OPS_PER_STRADDLE = 4
CROSS_OPS_PER_CROSSING = 1
ANGLE_OPS_PER_CROSSING = 6
# device time of a kernel alone: readings of back-to-back launches of its
# C entry, queued behind a sleep of about 2 ms (at the H100's 1.98 GHz)
# so that the host's enqueue does not pace them
DEVICE_READINGS = 21
SLEEP_CYCLES = 4_000_000
# repeats of the plain all-pairs versions at the exact path's size (each
# call takes about a second)
EXACT_PLAIN_REPEATS = 3

# the exact path's inputs: ego-Facebook at its published size (paper
# Table 1), the inputs of benchmarks/table3_accuracy.py at scale 1.0
EXACT_DATASET, EXACT_GRAPH_SEED, EXACT_LAYOUT_SEED = "ego-Facebook", 0, 1
EXACT_RADIUS = 0.5

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
# phase (e4): the drills' graph, benchmarks/serve_bench.py's largest size
# and strip count (make_graph(10000): seed 0, frac_long 0.02), B = 8 (member
# 0 the layout, 1-7 jittered from numpy.random.default_rng(2)); a hung
# chunk's members carry DRILL_DEADLINE and the server DRILL_TIMEOUT
DRILL_N_V, DRILL_FRAC_LONG, DRILL_N_STRIPS = 10_000, 0.02, 128
DRILL_DEADLINE, DRILL_TIMEOUT, DRILL_HANG_SECONDS = 1.0, 2.0, 10.0

# JAX reference constants of repro.api.evaluate_exact(pos, edges,
# config=EvalConfig(radius=0.5), use_kernels=False) on the exact path's
# inputs, made on the CPU with
#   PYTHONPATH=src JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py --exact
# (op by op; both routes of the port are held to them)
EXACT_REFERENCE = {
    "node_occlusion": 2533,
    "minimum_angle": 0.01865684986114502,
    "edge_length_variation": 0.0015983630437403917,
    "edge_crossing": 900016170,
    "edge_crossing_angle": 0.7149947881698608,
    "crossing_count_for_angle": 900016170,
    "overflow": 0,
}

# JAX reference constants of phase (e5): repro.core's
# count_crossings_enhanced / crossing_angle_enhanced (n_strips=512, "both")
# and count_occlusions_enhanced (radius 0.5) on the |V| = 100,000 layout,
# made on the CPU with
#   PYTHONPATH=src JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py --serve
# (op by op).  The same run served (b)'s batch through the reference's
# ReadabilityServer as (e1) does and found its integers equal to
# REFERENCE["batch"], which (e1) and (e2) are held to; (e3) is (d0)'s call
# and is held to EXACT_REFERENCE.
ENHANCED_REFERENCE = {
    "count_crossings_enhanced": {"count": 34534, "overflow": 0},
    "crossing_angle_enhanced": {
        "edge_crossing_angle": 0.7175037860870361,
        "count": 34534,
        "dev_sum": 9755.7255859375,
        "overflow": 0,
    },
    "count_occlusions_enhanced": {"count": 1538901, "overflow": 0},
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


def resource_usage(name, log):
    """Registers, shared memory and spills of ``csrc/<name>.cu``'s
    kernels: from ptxas's lines in ``log`` (its build in this process),
    else as ``cuobjdump -res-usage`` reads them from the built library
    (LOCAL is the spill space)."""
    import re
    lines = [line.split(":", 1)[-1].strip() for line in log.splitlines()
             if "registers" in line or "spill" in line]
    if lines:
        return "; ".join(lines)
    from repro_torch.kernels._build import library_path, nvcc_path
    out = subprocess.run(
        [str(Path(nvcc_path()).parent / "cuobjdump"), "-res-usage",
         str(library_path(name))], capture_output=True, text=True,
        timeout=60).stdout
    found = re.findall(r"REG:\d+ STACK:\d+ SHARED:\d+ LOCAL:\d+", out)
    return "; ".join(found) + " (cuobjdump)" if found else "not reported"


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
    from repro_torch.kernels.fixtures import boundary_points
    from repro_torch.kernels.occlusion_pairs import TILE
    pts = boundary_points(RADIUS)
    x = np.zeros(TILE, np.float32)
    y = np.zeros(TILE, np.float32)
    ok = np.zeros(TILE, bool)
    x[:len(pts)], y[:len(pts)], ok[:len(pts)] = pts[:, 0], pts[:, 1], True
    return [torch.from_numpy(a).to(dev) for a in (x, y, ok)]


def masked_slabs(dev):
    """The strip slabs of ``repro_torch.kernels.fixtures`` whose valid
    slots are no prefix, or whose extents differ from row to row (the
    kernel finds each row's extent on the device): the last slot alone or
    with the first, interior gaps, one-slot rows between all-invalid
    ones, short and full rows mixed at cap 256, and rows of 2,500 slots
    (three staging windows of the kernel)."""
    import torch
    from repro_torch.kernels.fixtures import (STRIP_SLABS, WIDE_STRIP_SLABS,
                                              strip_slab)
    return {name: [torch.from_numpy(a).to(dev) for a in strip_slab(**spec)]
            for name, spec in {**STRIP_SLABS, **WIDE_STRIP_SLABS}.items()
            if "mask" in spec}


def occlusion_tile_cases(dev):
    """The occlusion layouts of ``repro_torch.kernels.fixtures``: dense
    points (many occluding pairs) laid out against the kernel's tiles: an
    all-invalid tile between valid ones, one valid vertex in the last
    tile (on top of vertex 0), and n of exactly one tile."""
    import torch
    from repro_torch.kernels.fixtures import OCCLUSION_CASES, occlusion_case
    cases = {}
    for name in OCCLUSION_CASES:
        pos, ok = occlusion_case(name, RADIUS)
        cases[name] = [torch.from_numpy(a).to(dev)
                       for a in (pos[:, 0].copy(), pos[:, 1].copy(), ok)]
    return cases


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


def distinct_ids(shape, dev):
    """Vertex ids under which no two slots share an endpoint: v = slot,
    u = -1 - slot.  The plain versions count geometric reversals and
    straddling pairs with them."""
    import torch
    idx = torch.arange(shape[-1], dtype=torch.int32, device=dev)
    idx = idx.expand(shape).contiguous()
    return idx, -1 - idx


def bound(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes > t_ops else "operations"


def reversal_bound_ms(args):
    """The least time for one slab: input bytes read once and outputs
    written once over HBM, or the operations these inputs need over the
    FP32 issue rate: the unordered pairs between each row's valid slots,
    the endpoint test on reversing pairs and the count and deviation on
    crossings."""
    from repro_torch.kernels.strip_reversal import strip_reversal_rows_plain
    import torch
    yl, yr, th, v, u, ok = args
    rows, cap = yl.shape
    n_valid = ok.sum(dim=1, dtype=torch.float64)
    pairs = float((n_valid * (n_valid - 1) / 2).sum())
    reversals = float(strip_reversal_rows_plain(
        yl, yr, th, *distinct_ids(yl.shape, yl.device), ok, ideal=1.0,
        with_angle=False)[0].sum())
    crossings = float(strip_reversal_rows_plain(
        *args, ideal=1.0, with_angle=False)[0].sum())
    ops = (REV_OPS_PER_UNORDERED_PAIR * pairs
           + REV_OPS_PER_REVERSAL * reversals
           + REV_OPS_PER_CROSSING * crossings)
    return bound(rows * cap * (5 * 4 + 1) + rows * (8 + 4), ops)


def occlusion_bound_ms(x, ok, occluded):
    n = x.shape[0]
    nv = float(ok.sum())
    ops = (OCC_OPS_PER_PAIR * nv * (nv - 1) / 2
           + OCC_OPS_PER_OCCLUSION * occluded)
    return bound(n * 9 + 8, ops)


def exact_inputs():
    from repro_torch.graphs.datasets import paper_graph
    from repro_torch.graphs.layouts import random_layout
    edges, n_v = paper_graph(EXACT_DATASET, seed=EXACT_GRAPH_SEED)
    return random_layout(n_v, seed=EXACT_LAYOUT_SEED), edges


def edge_arrays(pos, edges, valid, dev):
    """The crossing kernels' padded edge arrays of a layout on ``dev``,
    as the exact path builds them."""
    import torch
    from repro_torch.kernels.ops import _edge_arrays
    return _edge_arrays(torch.as_tensor(pos, device=dev),
                        torch.as_tensor(edges, device=dev),
                        None if valid is None
                        else torch.as_tensor(valid, device=dev))


def compare_crossing(label, args, ideal):
    """Both crossing kernels against their plain versions.  Returns
    (count error, abs deviation error, crossings)."""
    import torch
    from repro_torch.kernels.crossing_angle_sum import (
        crossing_angle_plain, crossing_angle_stats)
    from repro_torch.kernels.segment_crossing import (crossing_count,
                                                      crossing_count_plain)
    x1, y1, x2, y2, th, v, u, ok = args
    got = int(crossing_count(x1, y1, x2, y2, v, u, ok))
    torch.cuda.synchronize()
    want = int(crossing_count_plain(x1, y1, x2, y2, v, u, ok))
    check(got == want,
          f"segment_crossing {got} != plain {want} on {label}")
    cnt, dsum = crossing_angle_stats(*args, ideal=ideal)
    torch.cuda.synchronize()
    p_cnt, p_dsum = crossing_angle_plain(*args, ideal=ideal)
    check(int(cnt) == int(p_cnt) == want,
          f"crossing_angle_sum count {int(cnt)}, plain {int(p_cnt)}, "
          f"crossings {want} on {label}")
    dev_err = abs(float(dsum) - float(p_dsum))
    check(dev_err <= RTOL * abs(float(p_dsum)),
          f"crossing_angle_sum deviation {float(dsum)!r} != plain "
          f"{float(p_dsum)!r} on {label}")
    return abs(got - want), dev_err, want


def crossing_bound_ms(n, n_valid, straddles, crossings, angle):
    """The least time for one crossing sweep: the edge arrays read once
    and the scalar outputs written once over HBM, or the operations these
    inputs need over the FP32 issue rate: the straddle tests on the
    unordered pairs of valid edges, the endpoint test on straddling pairs
    and the count (and deviation) on crossings."""
    pairs = n_valid * (n_valid - 1) / 2
    ops = (CROSS_OPS_PER_UNORDERED_PAIR * pairs
           + CROSS_OPS_PER_STRADDLE * straddles
           + CROSS_OPS_PER_CROSSING * crossings)
    nbytes = n * (4 * 4 + 2 * 4 + 1) + 8
    if angle:
        ops += ANGLE_OPS_PER_CROSSING * crossings
        nbytes += n * 4 + 8
    return bound(nbytes, ops)


def raw_launcher(name, args, *, ideal=1.0, radius=None, fn=None):
    """A call of kernel ``name``'s C entry (or of ``fn``, a variant's entry
    of the same signature) on ``args`` (the wrapper's arguments) into
    outputs allocated once: the kernel alone, without the wrapper's
    checks, allocations and sums, and not counted in the wrapper's
    launches.  ``launch.result()`` reduces the outputs as the wrapper
    does, so that :func:`time_kernel` can hold what was timed against the
    wrapper's result.  The crossing kernels' outputs are zeroed and hold
    a partial for every tile of the square grid, so that a variant that
    writes the tiles below the diagonal fits too."""
    import torch
    from repro_torch.kernels._build import entry
    fn = fn or entry(name)
    dev = args[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    n = args[0].shape[0]
    if name == "strip_reversal":
        rows, cap = args[0].shape
        outs = (torch.empty(rows, dtype=torch.int64, device=dev),
                torch.empty(rows, dtype=torch.float32, device=dev))
        tail = (rows, cap, float(ideal), 1)
    elif name == "occlusion_pairs":
        from repro_torch.kernels.occlusion_pairs import TILE, _threshold
        n_t = n // TILE
        outs = (torch.empty(n_t * (n_t + 1) // 2, dtype=torch.int32,
                            device=dev),)
        tail = (n, float(_threshold(radius, torch.empty(0))))
    else:
        from repro_torch.kernels.crossing_angle_sum import _ideal_and_recip
        from repro_torch.kernels.segment_crossing import TILE
        outs = tuple(torch.zeros((n // TILE) ** 2, dtype=dt, device=dev)
                     for dt in (torch.int32, torch.float32))
        if name == "segment_crossing":
            args = args[:4] + args[5:]            # no theta
            outs = outs[:1]
            tail = (n,)
        else:
            tail = (n, *(float(t) for t in _ideal_and_recip(ideal)))
    ptrs = [a.data_ptr() for a in args] + list(tail) + [
        o.data_ptr() for o in outs] + [stream]

    def launch():
        err = fn(*ptrs)
        if err != 0:
            raise CheckFailed(f"{name} launch failed: cudaError {err}")

    def result():
        if name == "strip_reversal":
            return outs
        if name == "crossing_angle_sum":
            return (outs[0].sum(dtype=torch.int64),
                    outs[1].sum(dtype=torch.float64))
        return outs[0].sum(dtype=torch.int64)
    launch.result = result
    return launch


def check_same_result(label, got, want):
    """The outputs of a :func:`raw_launcher` against the wrapper's result
    on the same arguments: integers equal, floats at rtol :data:`RTOL`."""
    import torch
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    check(len(got) == len(want), f"{label}: {len(got)} outputs timed, the "
                                 f"wrapper returns {len(want)}")
    for g, w in zip(got, want):
        if w.dtype.is_floating_point:
            same = (g.shape == w.shape and torch.allclose(
                g.double(), w.double(), rtol=RTOL, atol=0.0))
        else:
            same = g.dtype == w.dtype and torch.equal(g, w)
        check(same, f"{label}: the timed launches of the C entry differ "
                    f"from the wrapper's result (sums "
                    f"{float(g.double().sum())!r} and "
                    f"{float(w.double().sum())!r})")


def device_ms(launch, launches):
    """Device time of one launch of ``launch`` (a :func:`raw_launcher`):
    CUDA events around ``launches`` back-to-back launches queued behind a
    sleep, over :data:`DEVICE_READINGS` readings.  Returns (median, min,
    max) per launch."""
    import torch
    launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(DEVICE_READINGS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(launches):
            launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times), min(times), max(times)


class recording_launches:
    """Within the block, every kernel launch through the listed kernel
    modules appends ``(kernel, shape of its first argument)``
    to ``self.seen[-1]``; ``step()`` opens a new list."""

    def __init__(self, *mods):
        self.mods = mods
        self.seen = []

    def step(self):
        self.seen.append([])

    def __enter__(self):
        self.launches = {mod: mod._launch for mod in self.mods}
        for mod in self.mods:
            mod._launch = self._recorder(mod)
        return self

    def _recorder(self, mod):
        name = mod.__name__.rsplit(".", 1)[1]
        launch = self.launches[mod]

        def recording_launch(*args):
            self.seen[-1].append((name, tuple(args[0].shape)))
            return launch(*args)
        return recording_launch

    def __exit__(self, *exc):
        for mod, launch in self.launches.items():
            mod._launch = launch


def check_scores(label, got, want):
    for f in INT_FIELDS:
        check(int(getattr(got, f)) == want[f],
              f"{label}: {f} = {int(getattr(got, f))}, reference {want[f]}")
    for f in FLOAT_FIELDS:
        g = float(getattr(got, f))
        check(abs(g - want[f]) <= RTOL * abs(want[f]),
              f"{label}: {f} = {g!r}, reference {want[f]!r} (rtol {RTOL})")


def padded_batch(batch, edges):
    """The session's padded requests of a ``(B, V, 2)`` batch of one graph:
    ``((B, V_pad, 2) positions, (E_pad, 2) edges)``."""
    import numpy as np
    return (np.stack([session_padding(p, edges)[0] for p in batch]),
            session_padding(batch[0], edges)[1])


FAILURE_COUNTERS = ("dispatch_failures", "quarantined", "chunk_splits",
                    "degraded_dispatches", "watchdog_abandoned", "expired",
                    "shed", "cancelled", "saturated")


def check_clean(label, reports, stats):
    """Outside the drills every slot evaluated and no failure counter
    moved: the session's split-and-retry would otherwise turn a kernel
    that fails to launch into quarantined slots of a run that passes."""
    bad = [(i, r.error) for i, r in enumerate(reports) if not r.ok]
    check(not bad, f"{label}: error slots {bad}")
    moved = {k: stats[k] for k in FAILURE_COUNTERS if stats[k]}
    check(not moved, f"{label}: failure counters moved: {moved}")


def same_ints(label, got, want):
    for f in INT_FIELDS:
        check(getattr(got, f) == getattr(want, f),
              f"{label}: {f} = {getattr(got, f)}, unfaulted run "
              f"{getattr(want, f)}")


def drill_inputs():
    import numpy as np
    from repro_torch.graphs.datasets import layout_local_graph
    pos, edges = layout_local_graph(DRILL_N_V, seed=SEED,
                                    frac_long=DRILL_FRAC_LONG)
    rng = np.random.default_rng(2)
    batch = np.stack([pos] + [
        pos + rng.normal(0, JITTER, pos.shape).astype(np.float32)
        for _ in range(BATCH - 1)]).astype(np.float32)
    return pos, edges, batch


def drill_clean(cfg, reqs):
    """(e4)'s unfaulted run: one dispatch of B = 8, no failure counter."""
    from repro_torch.launch.serve import ReadabilityServer
    server = ReadabilityServer(cfg)
    out = server.evaluate_batch(reqs)
    check_clean("(e4) unfaulted", out, server.stats)
    return out


def run_drills(cfg, reqs, clean):
    """(e4): each drill on a fresh server under the port's ``FaultPlan``;
    the counter that certifies each fault equals what the plan injected,
    every other failure counter stays 0, and every slot the fault does not
    own equals the unfaulted run ``clean`` on integers.  Returns
    ``{drill: (injected, counters)}``."""
    from repro_torch.core.validate import (DeadlineExceededError,
                                           InvalidInputError,
                                           OverloadedError)
    from repro_torch.launch.admission import CancelToken
    from repro_torch.launch.faults import FaultPlan
    from repro_torch.launch.serve import ReadabilityServer

    def drill(name, owned, plan_kw, server_kw=None, **call):
        server = ReadabilityServer(cfg, **(server_kw or {}))
        t0 = time.perf_counter()
        with FaultPlan(**plan_kw) as fp:
            out = server.evaluate_batch(reqs, **call)
        seconds = time.perf_counter() - t0
        stats = server.stats
        for i, r in enumerate(out):
            if i not in owned:
                check(r.ok, f"(e4) {name}: slot {i} failed: {r.error}")
                same_ints(f"(e4) {name} slot {i}", r, clean[i])
        counters = {k: stats[k] for k in FAILURE_COUNTERS}
        print(f"(e4) {name}: {seconds:.3f} s, injected "
              f"{ {k: v for k, v in fp.injected.items() if v} }, counters "
              f"{ {k: v for k, v in counters.items() if v} }", flush=True)
        return out, dict(fp.injected), counters

    def only(counters, **want):
        check(counters == {**{k: 0 for k in FAILURE_COUNTERS}, **want},
              f"(e4) counters {counters}, want {want} and no others")

    done = {}
    # a failed coalesced dispatch: split, every member retried alone
    out, inj, cnt = drill("fail_dispatches=[0]", (),
                          dict(fail_dispatches=[0]))
    check(inj["fail_dispatches"] == 1, f"(e4) injected {inj}")
    only(cnt, dispatch_failures=inj["fail_dispatches"], chunk_splits=1)
    done["fail"] = (inj, cnt)
    # a poisoned request: quarantined to its own slot
    out, inj, cnt = drill("nan_requests=[3]", (3,), dict(nan_requests=[3]))
    check(isinstance(out[3].error, InvalidInputError)
          and out[3].error.request_index == 3, f"(e4) slot 3: {out[3]}")
    only(cnt, quarantined=inj["nan_requests"])
    check(inj["nan_requests"] == 1, f"(e4) injected {inj}")
    done["nan"] = (inj, cnt)
    # a cancelled request and a queue bound of 6: three own slots fail
    tokens = [CancelToken() for _ in reqs]
    tokens[2].cancel()
    out, inj, cnt = drill("cancel + max_queue=6", (2, 6, 7), {},
                          dict(max_queue=BATCH - 2), cancel=tokens)
    check(out[2].cancelled and out[6].shed and out[7].shed
          and isinstance(out[6].error, OverloadedError),
          f"(e4) cancel/shed slots: {out[2].error}, {out[6].error}, "
          f"{out[7].error}")
    check(not any(inj.values()), f"(e4) injected {inj}")
    only(cnt, cancelled=1, shed=2)
    done["cancel_shed"] = (inj, cnt)
    # a hung chunk of 4 with a deadline: the watchdog abandons it, its
    # members expire, the next chunk of 4 is served
    t0 = time.perf_counter()
    out, inj, cnt = drill(
        "hang_dispatches=[0]", (0, 1, 2, 3),
        dict(hang_dispatches=[0], hang_seconds=DRILL_HANG_SECONDS),
        dict(max_coalesce=4, dispatch_timeout=DRILL_TIMEOUT),
        deadline=[DRILL_DEADLINE] * 4 + [None] * 4)
    check(time.perf_counter() - t0 < DRILL_HANG_SECONDS,
          "(e4) the hang was not cut by the watchdog")
    check(all(isinstance(out[i].error, DeadlineExceededError)
              for i in range(4)), f"(e4) hung slots: {out[:4]}")
    check(inj["hang_dispatches"] == 1, f"(e4) injected {inj}")
    only(cnt, watchdog_abandoned=inj["hang_dispatches"], expired=4,
         dispatch_failures=1, chunk_splits=1)
    done["hang"] = (inj, cnt)
    return done


def occlusion_args(pos_p, n_valid, dev):
    """The occlusion-pair kernel's padded x, y and valid arrays of a padded
    layout, as ``ops.occlusion_count_op`` builds them."""
    import torch
    from repro_torch.kernels.occlusion_pairs import TILE
    n_pad = -(-pos_p.shape[0] // TILE) * TILE
    x = torch.zeros(n_pad, device=dev)
    y = torch.zeros(n_pad, device=dev)
    ok = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    x[:pos_p.shape[0]] = torch.from_numpy(pos_p[:, 0].copy()).to(dev)
    y[:pos_p.shape[0]] = torch.from_numpy(pos_p[:, 1].copy()).to(dev)
    ok[:n_valid] = True
    return x, y, ok


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

    import warnings
    from collections import Counter

    from repro_torch.api import EvalConfig, Evaluator, evaluate_exact
    from repro_torch.core import (count_crossings_enhanced,
                                  count_occlusions_enhanced,
                                  crossing_angle_enhanced, engine)
    from repro_torch.kernels import _build
    from repro_torch.kernels import crossing_angle_sum as crossing_angle_mod
    from repro_torch.kernels import occlusion_pairs as occlusion_pairs_mod
    from repro_torch.kernels import segment_crossing as segment_crossing_mod
    from repro_torch.kernels import strip_reversal as strip_reversal_mod
    from repro_torch.kernels.crossing_angle_sum import (
        crossing_angle_plain, crossing_angle_stats)
    from repro_torch.kernels.fixtures import FIXTURES, TILE_LAYOUTS
    from repro_torch.kernels.occlusion_pairs import (
        occlusion_pairs, occlusion_pairs_plain)
    from repro_torch.kernels.segment_crossing import (crossing_count,
                                                      crossing_count_plain)
    from repro_torch.kernels.strip_reversal import (
        strip_reversal_rows, strip_reversal_rows_plain)
    from repro_torch.launch.serve import ReadabilityServer

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
    ptxas = {name: resource_usage(name, log)
             for name, (seconds, log) in report.items()}
    for name, usage in ptxas.items():
        print(f"  ptxas {name}: {usage}")

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
    batch_p, _ = padded_batch(batch, edges)
    ideal = flat.ideal
    # phase (e4)'s graph, served on a flat plan from member 0 as the
    # session plans it, in chunks of B = 8, 4, 2 and 1
    dpos, dedges, dbatch = drill_inputs()
    dcfg = EvalConfig(radius=RADIUS, n_strips=DRILL_N_STRIPS)
    dplan = engine.plan_readability(dpos, dedges,
                                    **dcfg.plan_kwargs(tier_default=False))
    dbatch_p, dedges_p = padded_batch(dbatch, dedges)
    print(f"drill graph: |V| = {dpos.shape[0]}, |E| = {dedges.shape[0]}, "
          f"n_strips {DRILL_N_STRIPS}", flush=True)
    slabs = {
        "a": reversal_slabs(flat, pos_p[None], edges_p, n_e, dev),
        "b": reversal_slabs(tiered, batch, edges, n_e, dev),
        "c": reversal_slabs(flat, pos_p[None], edges_p, n_e, dev,
                            flat_buckets=True),
        "e1": reversal_slabs(flat, batch_p, edges_p, n_e, dev),
        "e2": [item for i in range(BATCH) for item in reversal_slabs(
            flat, batch_p[i:i + 1], edges_p, n_e, dev, flat_buckets=True)],
        "e4": [item for width in (8, 4, 2, 1) for item in reversal_slabs(
            dplan, dbatch_p[:width], dedges_p, dedges.shape[0], dev)],
    }
    occ_x, occ_y, occ_ok = occlusion_args(pos_p, n_v, dev)
    n_pad = occ_x.shape[0]
    for path, items in slabs.items():
        for label, args in items:
            per_row = args[5].sum(dim=1, dtype=torch.float64)
            print(f"shape ({path}) strip_reversal {label}: "
                  f"{tuple(args[0].shape)}, valid slots per row: mean "
                  f"{float(per_row.mean()):.1f}, max {int(per_row.max())}",
                  flush=True)
    print(f"shape (c), (e2) occlusion_pairs: ({n_pad},)", flush=True)

    # the exact path's inputs and kernel shapes
    epos, eedges = exact_inputs()
    xcfg = EvalConfig(radius=EXACT_RADIUS)
    print(f"exact graph: {EXACT_DATASET}, |V| = {epos.shape[0]}, "
          f"|E| = {eedges.shape[0]}", flush=True)
    xargs = edge_arrays(epos, eedges, None, dev)
    e_pad = xargs[0].shape[0]
    xocc_x, xocc_y, xocc_ok = occlusion_args(epos, epos.shape[0], dev)
    x_pad = xocc_x.shape[0]
    print(f"shape (d), (e3) segment_crossing: ({e_pad},); crossing_angle_sum: "
          f"({e_pad},); occlusion_pairs: ({x_pad},)", flush=True)

    # -- 2. kernel vs plain ------------------------------------------------
    # each kernel's checked shapes, with the arguments first checked there
    # (phase 4 times each launched shape on them)
    rev_checked, occ_checked = {}, {}
    rev_err = 0.0
    for path, items in slabs.items():
        for label, args in items:
            rev_err = max(rev_err, compare_reversal(f"({path}) {label}",
                                                    args, ideal))
            rev_checked.setdefault(tuple(args[0].shape),
                                   (f"({path}) {label}", args))
    rev_err = max(rev_err, compare_reversal("adversarial",
                                            adversarial_slab(dev), ideal))
    for label, args in masked_slabs(dev).items():
        rev_err = max(rev_err, compare_reversal(label, args, ideal))
    got = occlusion_pairs(occ_x, occ_y, occ_ok, RADIUS)
    torch.cuda.synchronize()
    want = occlusion_pairs_plain(occ_x, occ_y, occ_ok, RADIUS)
    check(int(got) == int(want),
          f"occlusion_pairs {int(got)} != plain {int(want)} at n={n_pad}")
    occ_checked[(n_pad,)] = ("(c)", (occ_x, occ_y, occ_ok), RADIUS,
                             int(want))
    # (e2) launches the same shape on the jittered members
    e2_occ = occlusion_args(batch_p[BATCH - 1], n_v, dev)
    got_e2 = int(occlusion_pairs(*e2_occ, RADIUS))
    torch.cuda.synchronize()
    want_e2 = int(occlusion_pairs_plain(*e2_occ, RADIUS))
    check(got_e2 == want_e2, f"occlusion_pairs {got_e2} != plain {want_e2} "
                             f"on (e2) member {BATCH - 1}")
    fx = boundary_fixture(dev)
    got_b = int(occlusion_pairs(*fx, RADIUS))
    torch.cuda.synchronize()
    want_b = int(occlusion_pairs_plain(*fx, RADIUS))
    check(got_b == want_b == 2,
          f"occlusion_pairs boundary fixture gave {got_b}, plain {want_b}, "
          "want 2")
    got_x = int(occlusion_pairs(xocc_x, xocc_y, xocc_ok, EXACT_RADIUS))
    torch.cuda.synchronize()
    want_x = int(occlusion_pairs_plain(xocc_x, xocc_y, xocc_ok,
                                       EXACT_RADIUS))
    check(got_x == want_x,
          f"occlusion_pairs {got_x} != plain {want_x} at n={x_pad}")
    occ_checked[(x_pad,)] = ("(d)", (xocc_x, xocc_y, xocc_ok), EXACT_RADIUS,
                             want_x)
    occ_err = float(max(abs(int(got) - int(want)), abs(got_e2 - want_e2),
                        abs(got_b - want_b), abs(got_x - want_x)))
    for label, case in occlusion_tile_cases(dev).items():
        got_t = int(occlusion_pairs(*case, RADIUS))
        torch.cuda.synchronize()
        want_t = int(occlusion_pairs_plain(*case, RADIUS))
        check(got_t == want_t and want_t > 0,
              f"occlusion_pairs {got_t} != plain {want_t} on {label}")
    cross_err, angle_err = 0.0, 0.0
    for name, make in {**FIXTURES, **TILE_LAYOUTS}.items():
        c_err, d_err, _ = compare_crossing(name, edge_arrays(*make(), dev),
                                           xcfg.ideal_angle)
        cross_err, angle_err = max(cross_err, c_err), max(angle_err, d_err)
    c_err, d_err, crossings = compare_crossing(f"(d) ({e_pad},)", xargs,
                                               xcfg.ideal_angle)
    cross_err, angle_err = max(cross_err, c_err), max(angle_err, d_err)
    cross_checked = {(e_pad,): ("(d)", xargs)}
    print(f"kernel vs plain: ok (strip_reversal max abs dev err {rev_err}, "
          f"occlusion_pairs {int(got)}, {got_e2} and {got_x} pairs, max abs "
          f"err {occ_err}; segment_crossing {crossings} crossings, max abs "
          f"err {cross_err}; crossing_angle_sum max abs dev err "
          f"{angle_err})", flush=True)

    # -- 3. main path ------------------------------------------------------
    ev = Evaluator(cfg)
    kev = Evaluator(kcfg)
    # record the shapes the main path launches each kernel on, to hold
    # them against the shapes checked and timed here
    kernel_mods = (strip_reversal_mod, occlusion_pairs_mod,
                   segment_crossing_mod, crossing_angle_mod)
    counters = (strip_reversal_rows, occlusion_pairs, crossing_count,
                crossing_angle_stats)
    names = ("strip_reversal", "occlusion_pairs", "segment_crossing",
             "crossing_angle_sum")
    for fn in counters:
        fn.LAUNCHES = 0
    runs = {}
    launches = {}
    seen_shapes = {}
    with recording_launches(*kernel_mods) as rec:
        for path, call in (("a", lambda: ev.evaluate(pos, edges)),
                           ("b", lambda: ev.evaluate_batch(batch, edges)),
                           ("c", lambda: kev.evaluate(pos, edges))):
            before = (strip_reversal_rows.LAUNCHES, occlusion_pairs.LAUNCHES)
            rec.step()
            runs[path] = call()
            launches[path] = (strip_reversal_rows.LAUNCHES - before[0],
                              occlusion_pairs.LAUNCHES - before[1])
            seen_shapes[path] = sorted(rec.seen[-1])
    total_launches = Counter({"strip_reversal": strip_reversal_rows.LAUNCHES,
                              "occlusion_pairs": occlusion_pairs.LAUNCHES})
    print(f"launches per path (strip_reversal, occlusion_pairs): "
          f"{launches}", flush=True)
    for path in ("a", "b", "c"):
        planned = sorted([("strip_reversal", tuple(args[0].shape))
                          for _, args in slabs[path]]
                         + [("occlusion_pairs", (n_pad,))] * (path == "c"))
        check(seen_shapes[path] == planned,
              f"({path}) launched the kernels on {seen_shapes[path]}, the "
              f"shapes checked and timed here are {planned}")
    check(total_launches["strip_reversal"] > 0
          and total_launches["occlusion_pairs"] > 0,
          f"main path launched {dict(total_launches)}")
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

    # (d) and (e): each run with the counts set to 0 just before it and
    # read just after
    sub_launches = {}

    def run_counted(key, rec, call):
        for fn in counters:
            fn.LAUNCHES = 0
        rec.step()
        out = call()
        sub_launches[key] = tuple(fn.LAUNCHES for fn in counters)
        seen_shapes[key] = sorted(rec.seen[-1])
        total_launches.update(dict(zip(names, sub_launches[key])))
        return out

    exact_planned = sorted([("crossing_angle_sum", (e_pad,)),
                            ("occlusion_pairs", (x_pad,)),
                            ("segment_crossing", (e_pad,))])
    xruns = {}
    with recording_launches(*kernel_mods) as rec:
        for uk in (False, True):
            xruns[uk] = run_counted(f"d{int(uk)}", rec, lambda: evaluate_exact(
                epos, eedges, config=xcfg, use_kernels=uk))
            check(seen_shapes[f"d{int(uk)}"] == exact_planned,
                  f"(d) use_kernels={uk} launched the kernels on "
                  f"{seen_shapes[f'd{int(uk)}']}, the shapes checked and "
                  f"timed here are {exact_planned}")
    print("launches in (d) (strip_reversal, occlusion_pairs, "
          f"segment_crossing, crossing_angle_sum): "
          f"{[sub_launches['d0'], sub_launches['d1']]}", flush=True)
    for uk in (False, True):
        got_launches = sub_launches[f"d{int(uk)}"]
        check(got_launches == (0, 1, 1, 1),
              f"(d) use_kernels={uk} launched {got_launches}, want one "
              "launch of each exact-path kernel")
        check(xruns[uk].overflow == 0, "(d) overflow")
        check_scores(f"(d) exact use_kernels={uk}", xruns[uk],
                     EXACT_REFERENCE)
        print(f"(d) use_kernels={uk} {xruns[uk]}")
    print("exact path: ok, equal to the JAX reference constants "
          f"(ints exact, floats rtol {RTOL})", flush=True)

    # (e) the serving front and the standalone enhanced algorithms
    reqs = [(p, edges) for p in batch]
    dreqs = [(p, dedges) for p in dbatch]
    server = ReadabilityServer(cfg)
    kserver = ReadabilityServer(kcfg)
    with warnings.catch_warnings(record=True) as shim_warnings:
        warnings.simplefilter("always")
        xserver = ReadabilityServer(method="exact")
    check(any(issubclass(w.category, DeprecationWarning)
              for w in shim_warnings),
          "(e3) ReadabilityServer(method='exact') did not warn")

    def enhanced():
        return (count_crossings_enhanced(pos, edges, n_strips=N_STRIPS),
                crossing_angle_enhanced(pos, edges, n_strips=N_STRIPS),
                count_occlusions_enhanced(pos, RADIUS))

    with recording_launches(*kernel_mods) as rec:
        e1 = run_counted("e1", rec, lambda: [
            server.evaluate_batch(reqs) for _ in range(2)])
        e2 = run_counted("e2", rec, lambda: kserver.evaluate_batch(reqs))
        e3 = run_counted("e3", rec, lambda: xserver.evaluate(epos, eedges))
        drills = run_counted("e4", rec, lambda: run_drills(
            dcfg, dreqs, drill_clean(dcfg, dreqs)))
        e5 = run_counted("e5", rec, enhanced)
    print("launches in (e) (strip_reversal, occlusion_pairs, "
          f"segment_crossing, crossing_angle_sum): "
          f"{ {k: v for k, v in sub_launches.items() if k[0] == 'e'} }",
          flush=True)

    # (e1) one dispatch of B = 8 per round, the second round a plan hit
    s1 = server.stats
    check_clean("(e1)", e1[0] + e1[1], s1)
    check((s1["dispatches"], s1["coalesced"], s1["plan_misses"],
           s1["plan_hits"], s1["replans"]) == (2, 2 * BATCH, 1, 1, 0),
          f"(e1) stats {s1}")
    for rnd in (0, 1):
        for i, r in enumerate(e1[rnd]):
            check(r.overflow == 0, f"(e1) overflow on {i}")
            check_scores(f"(e1) round {rnd} [{i}]", r, REFERENCE["batch"][i])
    e1_slab = [("strip_reversal", tuple(args[0].shape))
               for _, args in slabs["e1"]]
    check(seen_shapes["e1"] == sorted(e1_slab * 2),
          f"(e1) launched {seen_shapes['e1']}, planned {e1_slab} per round")
    # (e2) the kernels backend: one dispatch, each member on flat buckets
    # and the all-pairs occlusion count
    s2 = kserver.stats
    check_clean("(e2)", e2, s2)
    check((s2["dispatches"], s2["coalesced"]) == (1, BATCH),
          f"(e2) stats {s2}")
    for i, r in enumerate(e2):
        check(r.overflow == 0, f"(e2) overflow on {i}")
        check_scores(f"(e2) [{i}]", r, REFERENCE["batch"][i])
    e2_planned = sorted([("strip_reversal", tuple(args[0].shape))
                         for _, args in slabs["e2"]]
                        + [("occlusion_pairs", (n_pad,))] * BATCH)
    check(seen_shapes["e2"] == e2_planned,
          f"(e2) launched {seen_shapes['e2']}, planned {e2_planned}")
    # (e3) the exact method of the legacy mirror is (d0)'s call
    check(e3.ok and e3.overflow == 0, f"(e3) {e3}")
    check_scores("(e3) server method='exact'", e3, EXACT_REFERENCE)
    check(sub_launches["e3"] == (0, 1, 1, 1)
          and seen_shapes["e3"] == exact_planned,
          f"(e3) launched {sub_launches['e3']} on {seen_shapes['e3']}")
    # (e4) the drills launched only shapes checked in phase 2
    check(sub_launches["e4"][0] > 0, f"(e4) launched {sub_launches['e4']}")
    # (e5) the enhanced wrappers
    (ec, ec_ov), (e_ca, ca_count, ca_dev, ca_ov), (nc, nc_ov) = e5
    want5 = ENHANCED_REFERENCE
    for label, got5, want in (
            ("count_crossings_enhanced", (ec, ec_ov),
             want5["count_crossings_enhanced"]),
            ("crossing_angle_enhanced", (ca_count, ca_ov),
             want5["crossing_angle_enhanced"]),
            ("count_occlusions_enhanced", (nc, nc_ov),
             want5["count_occlusions_enhanced"])):
        check((int(got5[0]), int(got5[1])) == (want["count"],
                                               want["overflow"]),
              f"(e5) {label}: ({int(got5[0])}, {int(got5[1])}), reference "
              f"({want['count']}, {want['overflow']})")
    for f, g in (("edge_crossing_angle", e_ca), ("dev_sum", ca_dev)):
        w = want5["crossing_angle_enhanced"][f]
        check(abs(float(g) - w) <= RTOL * abs(w),
              f"(e5) crossing_angle_enhanced {f} = {float(g)!r}, reference "
              f"{w!r} (rtol {RTOL})")
    e5_planned = sorted([("strip_reversal", tuple(args[0].shape))
                         for _, args in slabs["c"]] * 2)
    check(seen_shapes["e5"] == e5_planned,
          f"(e5) launched {seen_shapes['e5']}, planned {e5_planned}")
    print(f"(e1)[0] {e1[0][0]}")
    print(f"(e3) {e3}")
    print(f"(e5) E_c {int(ec)}, E_ca {float(e_ca)!r} over {int(ca_count)} "
          f"crossings, N_c {int(nc)}; drills passed: {sorted(drills)}")
    print("serving front and enhanced algorithms: ok, equal to the JAX "
          f"reference constants (ints exact, floats rtol {RTOL})",
          flush=True)

    # every launched shape was checked in phase 2
    launched = Counter(item for shapes in seen_shapes.values()
                       for item in shapes)
    checked = {"strip_reversal": rev_checked, "occlusion_pairs": occ_checked,
               "segment_crossing": cross_checked,
               "crossing_angle_sum": cross_checked}
    unchecked = sorted(k for k in launched if k[1] not in checked[k[0]])
    check(not unchecked, f"launched on shapes not checked in phase 2: "
                         f"{unchecked}")
    check(sum(launched.values()) == sum(total_launches.values()),
          f"recorded launches {dict(launched)}, counted "
          f"{dict(total_launches)}")

    # -- 4. timings --------------------------------------------------------
    path_ms = {
        "a": cuda_ms(lambda: ev.evaluate(pos, edges)),
        "b": cuda_ms(lambda: ev.evaluate_batch(batch, edges)),
        "c": cuda_ms(lambda: kev.evaluate(pos, edges)),
    }
    for uk in (False, True):
        path_ms[f"d{int(uk)}"] = cuda_ms(lambda: evaluate_exact(
            epos, eedges, config=xcfg, use_kernels=uk))
    path_ms["e1"] = cuda_ms(lambda: server.evaluate_batch(reqs))
    path_ms["e2"] = cuda_ms(lambda: kserver.evaluate_batch(reqs))
    path_ms["e3"] = cuda_ms(lambda: xserver.evaluate(epos, eedges))
    path_ms["e5"] = cuda_ms(enhanced)
    for k, label in (("a", "evaluate fused"), ("b", f"evaluate_batch B={BATCH}"),
                     ("c", "evaluate kernels"),
                     ("d0", "evaluate_exact use_kernels=False"),
                     ("d1", "evaluate_exact use_kernels=True"),
                     ("e1", f"server fused, {BATCH} requests"),
                     ("e2", f"server kernels, {BATCH} requests"),
                     ("e3", "server method='exact'"),
                     ("e5", "enhanced E_c + E_ca + N_c")):
        print(f"time ({k}) {label}: {path_ms[k]:.3f} ms "
              f"(median of {REPEATS}, CUDA events) on {card}", flush=True)

    def time_kernel(name, label, shape, launch, launches, wrapper, plain,
                    bound_and_by, plain_repeats=REPEATS, note=""):
        """Time one kernel at one shape: the kernel alone on the device
        (its outputs then held against the wrapper's result), its wrapper
        (inner launches), its plain version; print them with the bound.
        Returns a dict of those numbers."""
        med, lo, hi = device_ms(launch, launches)
        check_same_result(f"{name} {label} {shape}", launch.result(),
                          wrapper())
        w_ms = cuda_ms(wrapper, inner=launches)
        p_ms = cuda_ms(plain, repeats=plain_repeats)
        b_ms, by = bound_and_by
        print(f"time {name} {label} {shape}: device {med:.5f} ms (min "
              f"{lo:.5f}, max {hi:.5f}; {DEVICE_READINGS} readings of "
              f"{launches} launches), wrapper {w_ms:.5f} ms, plain "
              f"{p_ms:.4f} ms, bound {b_ms:.5f} ms ({by}) on {card}{note}",
              flush=True)
        return dict(ms=med, wrapper_ms=w_ms, plain_ms=p_ms, bound_ms=b_ms,
                    bound_by=by)

    def total(name, time_shape):
        """One kernel's numbers summed over its launches in the pass: each
        launched shape timed once (``time_shape``) and counted as often
        as it was launched."""
        rows_ = []
        for (k, shape), n in sorted(launched.items()):
            if k == name:
                row = time_shape(shape)
                print(f"  {name} {shape}: {n} launches in the pass")
                rows_ += [row] * n
        by = {}
        for r in rows_:
            by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + r["bound_ms"]
        out = {k: sum(r[k] for r in rows_)
               for k in ("ms", "wrapper_ms", "plain_ms", "bound_ms")}
        out["bound_by"] = max(by, key=by.get)
        return out

    def time_reversal(shape):
        label, args = rev_checked[shape]
        return time_kernel(
            "strip_reversal", label, shape,
            raw_launcher("strip_reversal", args, ideal=ideal), 20,
            lambda: strip_reversal_rows(*args, ideal=ideal),
            lambda: strip_reversal_rows_plain(*args, ideal=ideal),
            reversal_bound_ms(args))

    def time_occlusion(shape):
        label, args, radius, occluded = occ_checked[shape]
        return time_kernel(
            "occlusion_pairs", label, shape,
            raw_launcher("occlusion_pairs", list(args), radius=radius),
            3 if shape[0] > 65536 else 20,
            lambda: occlusion_pairs(*args, radius),
            lambda: occlusion_pairs_plain(*args, radius),
            occlusion_bound_ms(args[0], args[2], occluded))

    x1, y1, x2, y2, th, v, u, ok = xargs
    n_valid = float(ok.sum())
    straddles = int(crossing_count_plain(x1, y1, x2, y2,
                                         *distinct_ids(v.shape, dev), ok))
    torch.cuda.synchronize()
    print(f"(d) straddling pairs (shared endpoints included): {straddles}, "
          f"crossings {crossings}", flush=True)

    def time_crossing(shape):
        return time_kernel(
            "segment_crossing", cross_checked[shape][0], shape,
            raw_launcher("segment_crossing", list(xargs)), 2,
            lambda: crossing_count(x1, y1, x2, y2, v, u, ok),
            lambda: crossing_count_plain(x1, y1, x2, y2, v, u, ok),
            crossing_bound_ms(e_pad, n_valid, straddles, crossings,
                              angle=False),
            plain_repeats=EXACT_PLAIN_REPEATS)

    def time_angle(shape):
        return time_kernel(
            "crossing_angle_sum", cross_checked[shape][0], shape,
            raw_launcher("crossing_angle_sum", list(xargs),
                         ideal=xcfg.ideal_angle), 2,
            lambda: crossing_angle_stats(*xargs, ideal=xcfg.ideal_angle),
            lambda: crossing_angle_plain(*xargs, ideal=xcfg.ideal_angle),
            crossing_bound_ms(e_pad, n_valid, straddles, crossings,
                              angle=True),
            plain_repeats=EXACT_PLAIN_REPEATS,
            note=f"; ptxas {ptxas['crossing_angle_sum']}")

    rev = total("strip_reversal", time_reversal)
    occ = total("occlusion_pairs", time_occlusion)
    cross = total("segment_crossing", time_crossing)
    angle = total("crossing_angle_sum", time_angle)

    kernels = [
        dict(name="strip_reversal", route="cuda",
             source="src/repro_torch/kernels/csrc/strip_reversal.cu",
             replaces="src/repro/kernels/strip_reversal.py:25",
             launches=total_launches["strip_reversal"], max_abs_err=rev_err,
             **rev, library_ms=None),
        dict(name="occlusion_pairs", route="cuda",
             source="src/repro_torch/kernels/csrc/occlusion_pairs.cu",
             replaces="src/repro/kernels/occlusion_pairs.py:30",
             launches=total_launches["occlusion_pairs"], max_abs_err=occ_err,
             **occ, library_ms=None),
        dict(name="segment_crossing", route="cuda",
             source="src/repro_torch/kernels/csrc/segment_crossing.cu",
             replaces="src/repro/kernels/segment_crossing.py:39",
             launches=total_launches["segment_crossing"],
             max_abs_err=cross_err, **cross, library_ms=None),
        dict(name="crossing_angle_sum", route="cuda",
             source="src/repro_torch/kernels/csrc/crossing_angle_sum.cu",
             replaces="src/repro/kernels/crossing_angle_sum.py:27",
             launches=total_launches["crossing_angle_sum"],
             max_abs_err=angle_err, **angle, library_ms=None),
    ]
    print("kernel times are summed over every launch of one pass of "
          "(a)-(e); launches are counted in that pass; ms is the kernel "
          "alone on the device (median), wrapper_ms the wrapper's call",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
