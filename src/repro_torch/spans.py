"""Spans: named, nested intervals of the host's work inside the port.

``with span("batch.validate"): ...`` marks one step of a call.  Spans
are stamped with :func:`time.time_ns` (``CLOCK_REALTIME``), the clock of
``torch.profiler``'s Chrome trace (an event's ``ts`` in microseconds plus
the file's ``baseTimeNanoseconds``), so a recorded span lands on the
trace's timeline as it is, and each idle gap or device op of the trace
can be put down to the span the host was in.

The recorder is off by default.  Off, :func:`span` reads one module
global and returns one shared no-op context manager: nothing is
allocated, timed or appended.  :func:`enable` starts a fresh in-memory
recorder, :func:`drain` hands over what it recorded and clears it, and
:func:`disable` turns it off.  The buffer is bounded (``CAPACITY``
spans); what does not fit is dropped and counted.

Names are fixed strings.  A span's ``parent`` is the span enclosing it
on the same thread (``None`` for a root), and ``call`` is the ``id`` of
its root: every span under one root shares it.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple, Optional

CAPACITY = 1 << 16


class Span(NamedTuple):
    """One recorded span; times in ``time.time_ns()`` nanoseconds and
    ``thread`` the native thread id, as the profiler's trace names it."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    call: int
    thread: int


class Drained(NamedTuple):
    """What :func:`drain` hands over: the spans, in the order they ended,
    and how many did not fit the buffer since the last drain."""

    spans: tuple
    dropped: int


class _Recorder:

    def __init__(self):
        self.lock = threading.Lock()
        self.ids = itertools.count()
        self.local = threading.local()
        self.spans = []
        self.dropped = 0

    def stack(self):
        """This thread's open spans, ``[(id, call), ...]``."""
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
            self.local.thread = threading.get_native_id()
        return stack

    def add(self, record):
        with self.lock:
            if len(self.spans) < CAPACITY:
                self.spans.append(record)
            else:
                self.dropped += 1


class _Open:
    """A span being recorded (the recorder is on)."""

    __slots__ = ("rec", "name", "id", "parent", "call", "start")

    def __init__(self, rec, name):
        self.rec = rec
        self.name = name

    def __enter__(self):
        stack = self.rec.stack()
        self.id = next(self.rec.ids)
        if stack:
            self.parent, self.call = stack[-1]
        else:
            self.parent, self.call = None, self.id
        stack.append((self.id, self.call))
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        rec = self.rec
        rec.stack().pop()
        rec.add(Span(self.id, self.name, self.start, end, self.parent,
                     self.call, rec.local.thread))
        return False


_OFF = contextlib.nullcontext()
_RECORDER = None


def span(name: str):
    """A context manager that records ``name`` over its block while the
    recorder is on; the shared no-op otherwise."""
    rec = _RECORDER
    if rec is None:
        return _OFF
    return _Open(rec, name)


def enable() -> None:
    """Start recording into a fresh, empty buffer."""
    global _RECORDER
    _RECORDER = _Recorder()


def disable() -> None:
    """Stop recording; what was not drained is dropped."""
    global _RECORDER
    _RECORDER = None


def drain() -> Drained:
    """The spans recorded since :func:`enable` or the last drain, and the
    count dropped; clears both.  Recording goes on."""
    rec = _RECORDER
    if rec is None:
        return Drained((), 0)
    with rec.lock:
        out = Drained(tuple(rec.spans), rec.dropped)
        rec.spans = []
        rec.dropped = 0
    return out
