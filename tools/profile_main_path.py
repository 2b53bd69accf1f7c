"""Where the main path's time goes on the card.

Builds ``chip_smoke.py``'s inputs (the layout-local graph at |V| =
100,000, ``radius=0.5``, ``n_strips=512``, B=8 batch; ego-Facebook for
the exact path) and, for each path -- (a) fused ``evaluate``, (b)
``evaluate_batch`` with the plan made per call (as ``chip_smoke.py``
calls it), (b') the same with the plan made once and passed in, (c)
kernels ``evaluate``, (d) ``evaluate_exact`` with ``use_kernels`` False
and True, (e1)-(e3) ``ReadabilityServer`` fused and kernels on the batch
as 8 requests and ``method="exact"``, (e5) the enhanced wrappers -- prints
the wall time,
the device time ``torch.profiler`` records, the device's idle share of
the wall time, and the kernels that take the most device time.  For (e1)
it also splits one call's host clock into the session's request
preparation (validation, topology hash, pow2 padding), the batch stack
and the engine call with its host scores.

Usage (from the repository root, on a CUDA machine)::

    python tools/profile_main_path.py
"""

from __future__ import annotations

import dataclasses
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

RUNS = 3


def profile(label, fn, card):
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(RUNS):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / RUNS
    # device-side events only (kernels and copies): CPU ops carry the
    # device time of what they launch too, which would count it twice
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in events) / RUNS
    print(f"{label}: wall {statistics.median(walls):.3f} ms unprofiled "
          f"(median of {RUNS}), {wall:.3f} ms profiled; device "
          f"{device_us / 1e3:.3f} ms; idle share "
          f"{1 - device_us / 1e3 / wall:.3f} on {card}")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        print(f"    {e.self_device_time_total / RUNS / 1e3:9.4f} ms "
              f"x{e.count // RUNS:<5d} {e.key[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_main_path: needs a CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (BATCH, EXACT_RADIUS, N_STRIPS, RADIUS,
                            card_line, exact_inputs, inputs)
    from repro_torch.api import EvalConfig, Evaluator, evaluate_exact

    card = card_line()
    pos, edges, batch = inputs()
    cfg = EvalConfig(radius=RADIUS, n_strips=N_STRIPS)
    ev = Evaluator(cfg)
    kev = Evaluator(dataclasses.replace(cfg, backend="kernels"))
    plan = ev.plan(batch, edges)
    t0 = time.perf_counter()
    ev.plan(batch, edges)
    print(f"host planning of the B={BATCH} batch: "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
    profile("(a) evaluate fused", lambda: ev.evaluate(pos, edges), card)
    profile(f"(b) evaluate_batch B={BATCH}, plan per call",
            lambda: ev.evaluate_batch(batch, edges), card)
    profile(f"(b') evaluate_batch B={BATCH}, plan passed in",
            lambda: ev.evaluate_batch(batch, edges, plan=plan), card)
    profile("(c) evaluate kernels", lambda: kev.evaluate(pos, edges), card)
    epos, eedges = exact_inputs()
    xcfg = EvalConfig(radius=EXACT_RADIUS)
    for uk in (False, True):
        profile(f"(d) evaluate_exact use_kernels={uk}",
                lambda: evaluate_exact(epos, eedges, config=xcfg,
                                       use_kernels=uk), card)

    import warnings
    from repro_torch.core import (count_crossings_enhanced,
                                  count_occlusions_enhanced,
                                  crossing_angle_enhanced)
    from repro_torch.launch.serve import ReadabilityServer
    reqs = [(p, edges) for p in batch]
    server = ReadabilityServer(cfg)
    kserver = ReadabilityServer(dataclasses.replace(cfg, backend="kernels"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        xserver = ReadabilityServer(method="exact")
    profile(f"(e1) server fused, {BATCH} requests",
            lambda: server.evaluate_batch(reqs), card)
    host_split(server.session, reqs)
    profile(f"(e2) server kernels, {BATCH} requests",
            lambda: kserver.evaluate_batch(reqs), card)
    profile("(e3) server method='exact'",
            lambda: xserver.evaluate(epos, eedges), card)
    profile("(e5) enhanced E_c + E_ca + N_c", lambda: (
        count_crossings_enhanced(pos, edges, n_strips=N_STRIPS),
        crossing_angle_enhanced(pos, edges, n_strips=N_STRIPS),
        count_occlusions_enhanced(pos, RADIUS)), card)
    return 0


def host_split(session, reqs):
    """One warm ``evaluate_batch`` of ``reqs`` split on the host clock
    into the session's steps (the device synchronised after each)."""
    import numpy as np
    import torch
    from repro_torch.core import engine
    from repro_torch.core.scores import scores_from_batch

    t0 = time.perf_counter()
    members = [session._prepare(i, p, e)[1] for i, (p, e) in
               enumerate(reqs)]
    t1 = time.perf_counter()
    stacked = np.stack([m["pos_p"] for m in members])
    t2 = time.perf_counter()
    plan = session.plans.get(session._prepare(0, *reqs[0])[0])
    t3 = time.perf_counter()
    res = engine.evaluate_layouts(plan, stacked, members[0]["edges_p"],
                                  members[0]["n_v"], members[0]["n_e"],
                                  device=session.device)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    scores_from_batch(res, members[0]["n_v"], members[0]["n_e"])
    t5 = time.perf_counter()
    print(f"    (e1) host split: prepare {len(reqs)} requests "
          f"{(t1 - t0) * 1e3:.3f} ms, stack {(t2 - t1) * 1e3:.3f} ms, "
          f"engine {(t4 - t3) * 1e3:.3f} ms, host scores "
          f"{(t5 - t4) * 1e3:.3f} ms")


if __name__ == "__main__":
    sys.exit(main())
