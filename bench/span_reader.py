"""The program's spans (:mod:`repro_torch.spans`) laid on a
``torch.profiler`` trace of the window.

A span is stamped with ``time.time_ns()``; a trace event with ``ts`` in
microseconds from the file's ``baseTimeNanoseconds``, on the same clock.
So a span lies at ``(start_ns - base_ns) / 1000`` on the trace's
timeline, with no anchor to fit.  From the two this module reads:

* a span's length, and counts of spans by name;
* the device-idle time inside a set of spans, and outside another;
* the device-busy time of the ops launched inside a span: each device
  event leads, through its ``correlation``, to the CUDA runtime call
  that launched it, and that call to the innermost span open on its
  thread at the time.  A launch from a thread with no span open there
  (autograd's worker thread runs the backward's launches) goes to the
  innermost span open on any thread, the one that called it;
* the idle gaps named ``<innermost span>/<runtime call or python>``.

The window, the device events and the runtime calls are those of
:mod:`bench.trace_reader`.
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field

from bench.trace_reader import DEVICE_CATS, HOST_CATS, SYNC, merge


@dataclass
class SpanTrace:
    base_ns: int
    window: tuple                      # (start, end) in microseconds
    device: list                       # (name, start, end, launch), clipped
    host: list = field(default_factory=list)   # (name, start, end)


def read_span_trace(path) -> SpanTrace:
    """The trace of ``path`` with its base time and, for each device
    event, its launch ``(ts, tid)`` (``None`` where no runtime call has
    its correlation)."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    syncs = [(float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0)))
             for ev in events
             if ev.get("name") == SYNC and ev.get("cat") == "cuda_runtime"]
    if len(syncs) < 2:
        raise ValueError(f"fewer than two {SYNC} calls in the trace")
    w0, w1 = min(syncs)[0], max(e for _, e in syncs)
    launches, device, host = {}, [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat")
        s = float(ev["ts"])
        e = s + float(ev["dur"])
        corr = (ev.get("args") or {}).get("correlation")
        if cat in HOST_CATS:
            if corr is not None:
                launches[corr] = (s, ev.get("tid"))
            if e > w0 and s < w1:
                host.append((ev.get("name", "?"), s, e))
        elif cat in DEVICE_CATS:
            s, e = max(s, w0), min(e, w1)
            if e > s:
                device.append((ev.get("name", "?"), s, e, corr))
    device = [(n, s, e, launches.get(c)) for n, s, e, c in device]
    return SpanTrace(base_ns=int(doc.get("baseTimeNanoseconds", 0)),
                     window=(w0, w1), device=device, host=host)


class Placed:
    """Drained spans on a trace's clock (microseconds from ``base_ns``)."""

    def __init__(self, spans, base_ns=0):
        self.by_id = {s.id: s for s in spans}
        self.at = {s.id: ((s.start_ns - base_ns) / 1e3,
                          (s.end_ns - base_ns) / 1e3) for s in spans}
        self.threads = {}
        for s in sorted(spans, key=lambda s: s.start_ns):
            self.threads.setdefault(s.thread, []).append(s.id)
        self.starts = {t: [self.at[i][0] for i in ids]
                       for t, ids in self.threads.items()}

    def count(self, name):
        return sum(s.name == name for s in self.by_id.values())

    def length_us(self, names):
        """Summed lengths of the spans named in ``names``."""
        return sum(e - s for i, (s, e) in self.at.items()
                   if self.by_id[i].name in names)

    def intervals(self, names):
        return merge(self.at[i] for i, s in self.by_id.items()
                     if s.name in names)

    def _innermost_on(self, thread, t):
        ids = self.threads.get(thread)
        if not ids:
            return None
        k = bisect.bisect_right(self.starts[thread], t) - 1
        if k < 0:
            return None
        # spans of one thread nest: the last to start before ``t`` is
        # inside the innermost span holding ``t``, if any holds it
        sid = ids[k]
        while sid is not None and sid in self.by_id:
            if self.at[sid][1] > t:
                return sid
            sid = self.by_id[sid].parent
        return None

    def innermost(self, t, thread=None):
        """The id of the innermost span holding ``t``: on ``thread``
        where one there holds it, else the shortest on any thread."""
        sid = self._innermost_on(thread, t)
        if sid is not None:
            return sid
        found = [self._innermost_on(th, t) for th in self.threads]
        found = [i for i in found if i is not None]
        return min(found, key=lambda i: self.at[i][1] - self.at[i][0],
                   default=None)

    def lineage(self, sid):
        """The names of span ``sid`` and its ancestors."""
        names = set()
        while sid is not None and sid in self.by_id:
            names.add(self.by_id[sid].name)
            sid = self.by_id[sid].parent
        return names


def _length(intervals):
    return sum(e - s for s, e in intervals)


def _subtract(a, b):
    """``a`` minus ``b``, both sorted disjoint ``[start, end]`` lists."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append([s, b[k][0]])
            s = max(s, b[k][1])
            k += 1
        if e > s:
            out.append([s, e])
    return out


def idle_us(trace: SpanTrace, placed: Placed, names, outside=()):
    """Microseconds of the window inside the spans named in ``names``,
    outside those named in ``outside``, in which the device ran
    nothing."""
    w0, w1 = trace.window
    inside = _subtract(placed.intervals(names), placed.intervals(outside))
    inside = _subtract(inside, [[-float("inf"), w0], [w1, float("inf")]])
    busy = merge((s, e) for _, s, e, _ in trace.device)
    return _length(_subtract(inside, busy))


def _launching(trace: SpanTrace, placed: Placed):
    """``[(span id or None, start, end)]``: each device event with the
    span its launch was made in."""
    return [(None if launch is None else placed.innermost(*launch), s, e)
            for _, s, e, launch in trace.device]


def busy_us(trace: SpanTrace, placed: Placed, names):
    """Microseconds in which the device ran ops launched inside a span
    named in ``names`` (or inside its descendants)."""
    names = set(names)
    ops = _launching(trace, placed)
    inside = {sid: bool(placed.lineage(sid) & names)
              for sid, _, _ in ops if sid is not None}
    return _length(merge((s, e) for sid, s, e in ops if inside.get(sid)))


def busy_by_span(trace: SpanTrace, placed: Placed):
    """``{span name: seconds}``: device-busy time by the innermost span
    its ops were launched in (``-`` for ops launched outside every
    span)."""
    by = {}
    for sid, s, e in _launching(trace, placed):
        by.setdefault("-" if sid is None else placed.by_id[sid].name,
                      []).append((s, e))
    return {n: _length(merge(v)) * 1e-6 for n, v in by.items()}


def launched_share(trace: SpanTrace, placed: Placed):
    """The share of the device-busy time whose ops were launched inside
    some span; ``None`` for a trace with no device time."""
    ops = _launching(trace, placed)
    total = _length(merge((s, e) for _, s, e in ops))
    if total <= 0:
        return None
    return _length(merge((s, e) for sid, s, e in ops
                         if sid is not None)) / total


def _gaps(trace: SpanTrace):
    """The idle stretches of the window, sorted."""
    return _subtract([list(trace.window)],
                     merge((s, e) for _, s, e, _ in trace.device))


def named_gaps(trace: SpanTrace, placed: Placed, k=10):
    """``[[name, seconds], ...]``: the ``k`` longest idle stretches of
    the window, named ``<innermost span>/<runtime call>`` by what the
    host was in at its start (``-`` outside every span, ``python``
    outside every runtime call)."""
    out = []
    for g0, g1 in sorted(_gaps(trace), key=lambda g: g[0] - g[1])[:k]:
        inner = [(e - s, n) for n, s, e in trace.host if s <= g0 < e]
        call = min(inner)[1] if inner else "python"
        sid = placed.innermost(g0)
        where = placed.by_id[sid].name if sid is not None else "-"
        out.append([f"{where}/{call}"[:160], (g1 - g0) * 1e-6])
    return out


def idle_by_span(trace: SpanTrace, placed: Placed):
    """``{span name: seconds}``: the window's idle time, each stretch put
    down to the innermost span open then (``-`` outside every span)."""
    gaps = _gaps(trace)
    starts = [g[0] for g in gaps]

    def idle(a, b):
        total, i = 0.0, max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(gaps) and gaps[i][0] < b:
            total += max(0.0, min(gaps[i][1], b) - max(gaps[i][0], a))
            i += 1
        return total

    children = {}
    for sid, sp in placed.by_id.items():
        children.setdefault(sp.parent, []).append(placed.at[sid])
    out = {}
    for sid, sp in placed.by_id.items():
        own = _subtract([list(placed.at[sid])], merge(children.get(sid, ())))
        out[sp.name] = out.get(sp.name, 0.0) + sum(idle(a, b) for a, b in own)
    outside = _subtract(gaps, placed.intervals(
        {sp.name for sp in placed.by_id.values()}))
    out["-"] = _length(outside)
    return {n: v * 1e-6 for n, v in out.items()}


def spans_of(run):
    """The run's recorded spans (:class:`Placed`, on its trace's clock
    where it was traced), or ``None`` where none were recorded: the
    harness stores the drained spans as ``run.spans`` and the trace as
    ``run.span_trace``."""
    drained = getattr(run, "spans", None)
    if drained is None:
        return None
    trace = getattr(run, "span_trace", None)
    return Placed(drained.spans, 0 if trace is None else trace.base_ns)


def of(run):
    """``(trace, placed)`` of a traced run whose spans were recorded, or
    ``None``."""
    placed = spans_of(run)
    trace = getattr(run, "span_trace", None)
    if placed is None or trace is None:
        return None
    return trace, placed
