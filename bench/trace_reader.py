"""What the benchmark reads from a ``torch.profiler`` trace of a window.

The trace is exported as Chrome-trace JSON and read back:

* the window: the span from the first to the end of the last device
  synchronisation (``cudaDeviceSynchronize``), which the harness makes
  on each side of the measured calls;
* device work: every ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` event,
  clipped to the window.  ``busy_s`` is the length of the union of their
  intervals, so work that overlaps on two streams counts once and the
  profiler's own host overhead, which stretches the window, leaves it
  alone;
* idle gaps: the stretches of the window where the device ran nothing,
  each named by the innermost CUDA runtime or driver call running at its
  start, or ``python`` where none was;
* kernel names of the program's own hand-written kernels: the
  ``__global__`` functions of its CUDA sources.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
SYNC = "cudaDeviceSynchronize"


def merge(intervals):
    """Union of ``(start, end)`` intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def kernel_names(csrc: Path):
    """Names of the ``__global__`` functions in ``csrc/*.cu`` and
    ``*.cuh``."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)"
                     r"\s*)?(\w+)\s*\(")
    names = set()
    for p in sorted(csrc.glob("*.cu*")):
        names.update(pat.findall(p.read_text()))
    return sorted(names)


@dataclass
class DeviceTrace:
    window: tuple                      # (start, end) in microseconds
    device: list                       # (name, start, end), clipped
    host: list = field(default_factory=list)   # (name, start, end)

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_s(self, keep=lambda name: True):
        """Seconds of the window in which a kept device event ran."""
        u = merge((s, e) for n, s, e in self.device if keep(n))
        return sum(e - s for s, e in u) * 1e-6

    def top_ops(self, k=10):
        """``[[name, seconds], ...]``: device time summed by name."""
        tot = {}
        for n, s, e in self.device:
            tot[n] = tot.get(n, 0.0) + (e - s) * 1e-6
        return [[n[:160], t] for n, t in
                sorted(tot.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k=10):
        """``[[host activity, seconds], ...]``: the ``k`` longest idle
        stretches of the window."""
        w0, w1 = self.window
        u = merge((s, e) for _, s, e in self.device)
        gaps, t = [], w0
        for s, e in u:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if w1 > t:
            gaps.append((t, w1))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:k]
        out = []
        for g0, g1 in gaps:
            inner = [(e - s, n) for n, s, e in self.host if s <= g0 < e]
            name = min(inner)[1] if inner else "python"
            out.append([name[:160], (g1 - g0) * 1e-6])
        return out


def read_chrome_trace(path) -> DeviceTrace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    syncs = [(float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0)))
             for ev in events
             if ev.get("name") == SYNC and ev.get("cat") == "cuda_runtime"]
    if len(syncs) < 2:
        raise ValueError(f"fewer than two {SYNC} calls in the trace")
    window = (min(syncs)[0], max(e for _, e in syncs))
    w0, w1 = window
    device, host = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"])
        e = s + float(ev["dur"])
        cat = ev.get("cat")
        if cat in DEVICE_CATS:
            s, e = max(s, w0), min(e, w1)
            if e > s:
                device.append((ev.get("name", "?"), s, e))
        elif cat in HOST_CATS and e > w0 and s < w1:
            host.append((ev.get("name", "?"), s, e))
    return DeviceTrace(window=window, device=device, host=host)
