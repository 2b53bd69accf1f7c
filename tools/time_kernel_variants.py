"""Time variants of an exact-path crossing kernel alone on the card.

Usage (from the repository root, on a CUDA machine)::

    python tools/time_kernel_variants.py KERNEL VARIANT [VARIANT ...]
        [--rounds 4] [--sass DIR]

``KERNEL`` is ``crossing_angle_sum`` or ``segment_crossing``.  A
``VARIANT`` is ``path/to/source.cu`` or ``path/to/source.cu:NAME=VALUE,...``:
a CUDA source that exports the kernel's C entry under the in-repo
signature (``repro_torch.kernels._build.ENTRY_POINTS``), compiled with
``-DNAME=VALUE`` for each define.  The in-repo source under other values
of its tuning knobs is a variant as well, e.g.::

    python tools/time_kernel_variants.py crossing_angle_sum \\
        src/repro_torch/kernels/csrc/crossing_angle_sum.cu \\
        src/repro_torch/kernels/csrc/crossing_angle_sum.cu:SEGMENT_PAIRS_UNROLL=2

Each variant is built with ``_build``'s ``nvcc`` flags into
``build/variants/`` (one ``nvcc`` per variant, all started together) and
launched on the exact path's edge arrays (ego-Facebook, (88320,), as
``chip_smoke.py`` builds them) by ``chip_smoke.raw_launcher``, whose
outputs fit a partial for every tile of the square grid (so the grid of
an earlier design fits too).  Its time alone on the
device is ``chip_smoke.device_ms``'s (CUDA events around back-to-back
launches queued behind a sleep, 21 readings), taken in ``--rounds``
rounds, the variants in order in one round and in reverse in the next,
so that drift of the card's clock falls on all alike.  Its outputs,
summed as the wrapper sums them, are then held against the in-repo
wrapper's result: integers equal, floats at rtol 1e-5.

Prints, per variant, the median of its round medians, the least and the
greatest reading, and ptxas's registers and spills; then the card's name
and power limit and one JSON line.  ``--sass DIR`` also writes each
variant's SASS (``cuobjdump -sass``) to ``DIR`` and prints how often the
opcodes that matter to the sweep occur in it.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

BUILD = ROOT / "build" / "variants"
LAUNCHES = 2
KERNELS = ("crossing_angle_sum", "segment_crossing")
SASS_OPS = ("FADD", "FMUL", "FMNMX", "FSETP", "ISETP", "FSEL", "SEL",
            "LDS", "IADD3", "PLOP3", "BRA", "BSSY", "BSYNC")


def parse_variant(spec):
    """``(label, source path, [-D flags])`` of a VARIANT argument."""
    src, _, defs = spec.partition(":")
    flags = [f"-D{d}" for d in defs.split(",") if d]
    return spec, Path(src).resolve(), flags


def start_build(src, flags):
    from repro_torch.kernels import _build
    digest = hashlib.blake2b(
        src.read_bytes() + b"".join(p.read_bytes() for p in
                                    sorted(src.parent.glob("*.cuh")))
        + " ".join(flags).encode(), digest_size=8).hexdigest()
    out = BUILD / f"lib{src.stem}-{digest}.so"
    BUILD.mkdir(parents=True, exist_ok=True)
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-Xptxas", "-v",
           "-o", str(out), str(src)]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def ptxas_summary(log):
    return "; ".join(line.split(":", 1)[-1].strip()
                     for line in log.splitlines()
                     if "registers" in line or "spill" in line)


def sass_counts(lib, dest):
    """Write ``lib``'s SASS to ``dest`` and count the sweep's opcodes."""
    from repro_torch.kernels._build import nvcc_path
    cuobjdump = Path(nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    dest.write_text(sass)
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                     sass)
    return {op: ops.count(op) for op in SASS_OPS} | {"total": len(ops)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=KERNELS)
    ap.add_argument("variants", nargs="+")
    ap.add_argument("--rounds", type=int, default=4,
                    help="timing rounds; 0 builds and checks only")
    ap.add_argument("--sass", type=Path, default=None,
                    help="write each variant's SASS into this directory")
    opts = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("time_kernel_variants: needs a CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (EXACT_RADIUS, card_line, check_same_result,
                            device_ms, edge_arrays, exact_inputs,
                            raw_launcher)
    from repro_torch.api import EvalConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels.crossing_angle_sum import crossing_angle_stats
    from repro_torch.kernels.segment_crossing import crossing_count

    card = card_line()
    variants = [parse_variant(v) for v in opts.variants]
    started = [start_build(src, flags) for _, src, flags in variants]
    libs, ptxas = [], []
    for (label, _, _), (out, proc) in zip(variants, started):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"nvcc failed on {label}:\n{log}", file=sys.stderr)
            return 1
        libs.append(out)
        ptxas.append(ptxas_summary(log))

    dev = torch.device("cuda")
    ideal = EvalConfig(radius=EXACT_RADIUS).ideal_angle
    args = list(edge_arrays(*exact_inputs(), None, dev))
    if opts.kernel == "segment_crossing":
        x1, y1, x2, y2, _, v, u, ok = args
        want = crossing_count(x1, y1, x2, y2, v, u, ok)
    else:
        want = crossing_angle_stats(*args, ideal=ideal)
    symbol, argtypes = _build.ENTRY_POINTS[opts.kernel]
    launches = []
    for lib in libs:
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.restype, fn.argtypes = ctypes.c_int, argtypes
        launches.append(raw_launcher(opts.kernel, args, ideal=ideal, fn=fn))

    readings = [[] for _ in variants]
    if opts.rounds == 0:                 # build and check only
        for k, launch in enumerate(launches):
            launch()
            check_same_result(variants[k][0], launch.result(), want)
    for rnd in range(opts.rounds):
        order = range(len(variants))
        for k in (order if rnd % 2 == 0 else reversed(order)):
            readings[k].append(device_ms(launches[k], LAUNCHES))
            check_same_result(variants[k][0], launches[k].result(), want)

    rows = []
    for k, (label, _, _) in enumerate(variants):
        times = readings[k] or [(float("nan"),) * 3]
        med = statistics.median(r[0] for r in times)
        lo = min(r[1] for r in times)
        hi = max(r[2] for r in times)
        row = dict(variant=label, ms=med, min_ms=lo, max_ms=hi,
                   ptxas=ptxas[k])
        if opts.sass is not None:
            opts.sass.mkdir(parents=True, exist_ok=True)
            name = re.sub(r"[^A-Za-z0-9_.=-]+", "_", label)[-120:]
            row["sass"] = sass_counts(libs[k], opts.sass / f"{name}.sass")
        rows.append(row)
        print(f"{opts.kernel} {label}: device {med:.5f} ms per launch (min "
              f"{lo:.5f}, max {hi:.5f}; {opts.rounds} rounds of 21 "
              f"readings of {LAUNCHES} launches) at ({args[0].shape[0]},), "
              f"outputs equal to the in-repo wrapper's; ptxas {ptxas[k]}"
              + (f"; sass {row['sass']}" if "sass" in row else ""),
              flush=True)
    print(card)
    print(json.dumps({"kernel": opts.kernel, "card": card,
                      "variants": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
