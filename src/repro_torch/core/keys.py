"""Configuration and cache-key machinery (counterpart of
:mod:`repro.core.keys`).

:class:`EvalConfig` is the frozen, hashable description of *how* to
evaluate; :meth:`EvalConfig.digest` is a process-stable content hash,
equal to the reference's for equal configs.  The shape-bucket helpers
(:func:`pow2_bucket`, :func:`pow2_chunks`) and :func:`topology_hash` live
here so the plan-cache key and the request padding can never disagree.
:meth:`EvalConfig.from_legacy` maps the old kwarg mirrors onto a config,
and :func:`warn_once` is the deprecation plumbing the shims warn through
(the port's own registry: the reference's shims warn through theirs).
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import warnings
from typing import Optional

import numpy as np

from repro_torch.core.engine import ALL_METRICS, DEFAULT_IDEAL

BACKENDS = ("fused", "eager", "kernels", "distributed", "graph_sharded")
ORIENTATIONS = ("vertical", "horizontal", "both")
PRECISIONS = ("float32", "bfloat16")
VALIDATIONS = ("strict", "sanitize", "off")


# ---------------------------------------------------------------------------
# shape buckets + topology identity (shared by cache keys and padding)
# ---------------------------------------------------------------------------

def pow2_bucket(n: int, floor: int = 128) -> int:
    """Smallest power-of-two >= max(n, floor).

    THE shape-bucket function: the plan-cache key and the request
    padding both go through it, so they can never disagree.
    """
    b = int(floor)
    n = int(n)
    while b < n:
        b *= 2
    return b


def pow2_chunks(items, max_chunk: int):
    """Split ``items`` into descending power-of-two-sized chunks so a
    batched evaluator only ever sees O(log B) distinct batch dims (each
    a one-time trace) instead of one trace per group size."""
    out = []
    i = 0
    while i < len(items):
        size = 1
        while size * 2 <= min(len(items) - i, max_chunk):
            size *= 2
        out.append(items[i:i + size])
        i += size
    return out


def topology_hash(edges, n_vertices: int) -> str:
    """Stable digest of an edge topology (vertex count + edge list)."""
    h = hashlib.blake2b(digest_size=12)
    h.update(np.int64(n_vertices).tobytes())
    h.update(np.ascontiguousarray(edges, np.int32).tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Frozen, hashable description of a readability evaluation: the
    reference's :class:`repro.core.keys.EvalConfig`, field for field.

    Fields are canonicalized in ``__post_init__`` (metrics reordered to
    :data:`~repro_torch.core.engine.ALL_METRICS` order, numbers coerced
    to plain Python types) exactly as the reference does, so ``repr``
    and :meth:`digest` agree with it for equal configs.  Every backend
    and precision the reference accepts is accepted here (the digest
    needs them); :class:`repro_torch.api.Evaluator` serves ``"fused"``,
    ``"eager"`` and ``"kernels"`` in float32 and raises
    ``NotImplementedError`` for the rest.  The device is not a config
    field: it is an argument of the evaluator, so configs and digests
    are device-independent.
    """

    radius: float = 0.5
    n_strips: int = 64
    orientation: str = "both"
    metrics: tuple = ALL_METRICS
    ideal_angle: float = DEFAULT_IDEAL
    tier_strips: Optional[bool] = None
    cell_block: int = 512
    strip_block: int = 256
    backend: str = "fused"
    precision: str = "float32"
    shards: Optional[int] = None
    validation: str = "strict"
    temperature: float = 0.05

    def __post_init__(self):
        if self.orientation not in ORIENTATIONS:
            raise ValueError(f"orientation must be one of {ORIENTATIONS}, "
                             f"got {self.orientation!r}")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {self.backend!r}")
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, "
                             f"got {self.precision!r}")
        if self.validation not in VALIDATIONS:
            raise ValueError(f"validation must be one of {VALIDATIONS}, "
                             f"got {self.validation!r}")
        metrics = (self.metrics,) if isinstance(self.metrics, str) \
            else tuple(self.metrics)
        unknown = [m for m in metrics if m not in ALL_METRICS]
        if unknown:
            raise ValueError(f"unknown metrics {unknown}; "
                             f"choose from {ALL_METRICS}")
        if not metrics:
            raise ValueError("metrics must not be empty")
        # canonical order: membership is what matters downstream, so two
        # configs selecting the same subset must be == and hash alike
        object.__setattr__(self, "metrics",
                           tuple(m for m in ALL_METRICS if m in metrics))
        ideal = DEFAULT_IDEAL if self.ideal_angle is None else self.ideal_angle
        object.__setattr__(self, "ideal_angle", float(ideal))
        object.__setattr__(self, "radius", float(self.radius))
        object.__setattr__(self, "n_strips", int(self.n_strips))
        object.__setattr__(self, "cell_block", int(self.cell_block))
        object.__setattr__(self, "strip_block", int(self.strip_block))
        if self.tier_strips is not None:
            object.__setattr__(self, "tier_strips", bool(self.tier_strips))
        if self.shards is not None:
            shards = int(self.shards)
            if shards < 1:
                raise ValueError(f"shards must be >= 1, got {shards}")
            object.__setattr__(self, "shards", shards)
        temperature = float(self.temperature)
        if not temperature > 0:
            raise ValueError(f"temperature must be > 0, got {temperature}")
        object.__setattr__(self, "temperature", temperature)

    # -- derived views -----------------------------------------------------

    @property
    def use_kernels(self) -> bool:
        return self.backend == "kernels"

    def plan_kwargs(self, *, tier_default: bool = True) -> dict:
        """Keyword arguments for
        :func:`repro_torch.core.engine.plan_readability` — the ONE mapping
        from config to plan, used by every front end."""
        tier = self.tier_strips if self.tier_strips is not None \
            else tier_default
        return dict(radius=self.radius, ideal_angle=self.ideal_angle,
                    n_strips=self.n_strips, orientation=self.orientation,
                    metrics=self.metrics, cell_block=self.cell_block,
                    strip_block=self.strip_block, tier_strips=tier,
                    precision=self.precision)

    def digest(self) -> str:
        """Process-stable content hash of the (canonicalized) config."""
        payload = repr(dataclasses.astuple(self)).encode()
        return hashlib.blake2b(payload, digest_size=12).hexdigest()

    @classmethod
    def from_legacy(cls, *, radius: float = 0.5, n_strips: int = 64,
                    orientation: str = "both", metrics=ALL_METRICS,
                    ideal_angle=None, use_kernels: bool = False,
                    backend: Optional[str] = None,
                    tier_strips: Optional[bool] = None) -> "EvalConfig":
        """Map one of the old kwarg mirrors onto a config (shim glue)."""
        if backend is None:
            backend = "kernels" if use_kernels else "fused"
        return cls(radius=radius, n_strips=n_strips, orientation=orientation,
                   metrics=tuple(metrics), ideal_angle=ideal_angle,
                   tier_strips=tier_strips, backend=backend)


# ---------------------------------------------------------------------------
# deprecation plumbing (each shim warns exactly once per process)
# ---------------------------------------------------------------------------

_WARNED: set = set()
# watchdog worker threads reach the shims too: the check-and-add is atomic
# under this lock, so two threads can never both warn for one key
_WARNED_LOCK = threading.Lock()


def warn_once(key: str, message: str, *, stacklevel: int = 3) -> None:
    """Issue ``DeprecationWarning`` once per ``key`` per process.

    The shims (``evaluate_layout``, ``EvalSession(**kwargs)``,
    ``ReadabilityServer(method=...)``) all warn through here, so steady
    traffic through old call sites logs one line, not millions."""
    with _WARNED_LOCK:
        if key in _WARNED:
            return
        _WARNED.add(key)
    warnings.warn(message, DeprecationWarning, stacklevel=stacklevel)


def reset_deprecation_warnings() -> None:
    """Forget which shims already warned (test hook)."""
    with _WARNED_LOCK:
        _WARNED.clear()
