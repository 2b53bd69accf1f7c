#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from, on the card:

    python3 bench/control.py --workload <cell> --seeds 11 12 13 \
        [--mode control|program|fault] [--fault <name>]

For each seed it makes the cell's inputs as a run does and prints each
number a run compares, beside its limit, as one JSON line:

* ``control`` (the default): the plain reference computed one precision
  below the configuration's (bfloat16 for float32) in the program's
  place for the call a run would check (the call's ``control``).  Every
  seed has to fail at least one limit;
* ``program``: the program's own first call, as a sound run makes it;
  the lower readings;
* ``fault``: the program's first call with a fault of :data:`FAULTS`
  planted in it; the faults' readings.

The exit code is 0 where every control or fault reading fails a limit
(or, for ``program``, where every reading passes).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _search_step_fault(mode):
    """A search step that, after the first, returns its state unchanged
    (``later``) or keeps the second moment it was given (``stale_v``);
    every step returns its state unchanged (``state``) or the step count
    it was given (``stale_step``)."""
    from repro_torch.search.gradient import GradientSearch
    real = GradientSearch.step

    def faulty(self, plan, opt_cfg, pos, state, *args, **kwargs):
        new, st, losses, grad_norm = real(self, plan, opt_cfg, pos, state,
                                          *args, **kwargs)
        later = int(state["step"]) > 0
        if mode == "state" or (mode == "later" and later):
            return pos, state, losses, grad_norm
        if mode == "stale_v" and later:
            st = dict(st, v=state["v"])
        if mode == "stale_step":
            st = dict(st, step=state["step"])
        return new, st, losses, grad_norm
    GradientSearch.step = faulty
    return lambda: setattr(GradientSearch, "step", real)


FAULTS = {
    "search": {m: (lambda m=m: _search_step_fault(m))
               for m in ("state", "later", "stale_v", "stale_step")},
}
"""Faults a cell's call can have, by call: ``plant()`` returns the undo."""


def _gaps(call, outputs, cell):
    pick = call.pick([0], None) if hasattr(call, "pick") else [0]
    gaps, _ = call.check(outputs, pick)
    return {k: (gaps[k], cell.limits[k]) for k in cell.limits}


def control_gaps(root, cell, seed, device, dtype=None):
    """``{name: (gap, limit)}`` of the control on ``seed``'s inputs."""
    import torch
    from bench import harness

    call = harness.make_call(cell, seed, torch.device(device))
    call.release([])
    return _gaps(call, call.control(dtype or torch.bfloat16), cell)


def program_gaps(root, cell, seed, device, fault=None):
    """``{name: (gap, limit)}`` of the program's first call on ``seed``'s
    inputs, with ``fault`` (a name of :data:`FAULTS`) planted."""
    import torch
    from bench import harness

    undo = FAULTS[cell.traffic["call"]][fault]() if fault else None
    try:
        call = harness.make_call(cell, seed, torch.device(device))
        outputs = {0: call(0)}
    finally:
        if undo:
            undo()
    call.release(outputs)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return _gaps(call, outputs, cell)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--mode", choices=("control", "program", "fault"),
                    default="control")
    ap.add_argument("--fault")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench import harness
    cell = harness.find_cell(ROOT, args.workload)
    as_wanted = True
    for seed in args.seeds:
        t = time.perf_counter()
        if args.mode == "control":
            got = control_gaps(ROOT, cell, seed, "cuda")
        else:
            got = program_gaps(ROOT, cell, seed, "cuda",
                               args.fault if args.mode == "fault" else None)
        fails = any(v > lim for v, lim in got.values())
        as_wanted &= fails != (args.mode == "program")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "mode": args.mode, "fault": args.fault,
                          "fails": fails,
                          "seconds": time.perf_counter() - t,
                          "gaps": {k: v for k, (v, _) in got.items()}}),
              flush=True)
    return 0 if as_wanted else 1


if __name__ == "__main__":
    sys.exit(main())
