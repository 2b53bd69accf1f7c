"""The calls a traffic file's ``"call"`` names, one file each
(``bench/calls/<call>.py``, found by :func:`bench.find.module`), each
with one class, ``Call``, made as ``Call(config, traffic, seed, device)``.

A ``Call`` builds its cell's inputs in set-up and records the set-up's
phases in ``phases``; ``warm()`` makes the call once on every shape the
window uses; ``call(i)`` makes the ``i``-th call of the window;
``units(out)`` counts what a call completed (layouts, steps);
``release(outputs)`` frees the program's state once the window has
closed; ``check(outputs, pick)`` compares the picked calls with the
plain reference (:mod:`bench.reference`), on inputs the benchmark made
and handed to both sides, and returns ``(gaps, work)``; ``control(dtype)``
puts the reference computed in ``dtype`` in the program's place for the
call a run would check as ``outputs[0]``.  A ``Call`` may also have
``pick(done, rng)``, the calls to check; by default one completed call
is drawn from the seed.  The program is imported by these files and
nowhere else in the harness.

This module holds what the calls share.
"""

from __future__ import annotations

import time

import numpy as np
import torch

SCORES = ("node_occlusion", "minimum_angle", "edge_length_variation",
          "edge_crossing", "edge_crossing_angle", "crossing_count_for_angle")
COUNTS = ("node_occlusion", "edge_crossing", "crossing_count_for_angle")


def finite(value):
    """``value``, or infinity where it is not a number: a NaN compares
    false with every limit and would pass."""
    return value if np.isfinite(value) else np.inf


def gap(field, got, want):
    """A count's absolute difference; a score's difference relative to
    the reference's value (infinite where either is not finite)."""
    if field in COUNTS:
        return abs(int(got) - int(want))
    return finite(abs(float(got) - float(want))
                  / max(abs(float(want)), 1e-30))


def score_gaps(gaps, got, want, index=None):
    """Widens ``gaps`` by the gaps of one layout's scores ``got`` (an
    object with the score fields, or arrays of them at ``index``)."""
    for f in SCORES:
        value = getattr(got, f)
        if index is not None:
            value = value[index]
        gaps[f] = max(gaps[f], gap(f, value, want[f]))


def program_device(device):
    """What the program is given: nothing on CUDA, where it runs by
    default, as users call it; the device elsewhere (CPU tests)."""
    return None if torch.device(device).type == "cuda" else device


def eval_config(config):
    from repro_torch.api import EvalConfig
    return EvalConfig(**config["eval"])


def ideal(config):
    """The configuration's ideal crossing angle in radians, as float32
    rounds it."""
    return float(np.float32(np.deg2rad(np.float32(
        config["ideal_angle_degrees"]))))


class Phases(dict):
    """Seconds of each set-up phase, printed by the harness."""

    def __init__(self):
        super().__init__()
        self._last = time.perf_counter()

    def mark(self, name):
        now = time.perf_counter()
        self[name] = now - self._last
        self._last = now
