"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` entry and is compiled
on first use by ``nvcc`` into its own shared library, loaded with
``ctypes``.  Libraries live under ``build/repro_torch/`` at the root of
the checkout, named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds
and an unchanged one is reused.  :func:`build_all`
starts one ``nvcc`` per source at once.

No ``--use_fast_math``: the strip-reversal deviation must stay an IEEE
division, as in the reference, and the crossing kernels' comparisons
must see NaN (an invalid slot is NaN there).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# each source's C entry and its argument types (every pointer and the
# stream as c_void_p); all entries return a cudaError_t as int
_P = ctypes.c_void_p
ENTRY_POINTS = {
    "strip_reversal": ("strip_reversal_launch", [_P] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int] +
        [_P] * 3),
    "occlusion_pairs": ("occlusion_pairs_launch", [_P] * 3 + [
        ctypes.c_int, ctypes.c_float] + [_P] * 2),
    "segment_crossing": ("segment_crossing_launch", [_P] * 7 + [
        ctypes.c_int] + [_P] * 2),
    "crossing_angle_sum": ("crossing_angle_sum_launch", [_P] * 8 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_float] + [_P] * 3),
}
SOURCES = tuple(ENTRY_POINTS)

_LIBS: dict = {}
_ENTRIES: dict = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels are built "
                       "from source on first use")


def library_path(name: str) -> Path:
    """Where the shared library of ``csrc/<name>.cu`` is (or will be)."""
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.blake2b(src + headers + " ".join(NVCC_FLAGS).encode(),
                             digest_size=8).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    out = library_path(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name, out, tmp, proc) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names=SOURCES) -> dict:
    """Compile every listed source that is not built yet, one ``nvcc``
    each, all started together.  Returns ``{name: (seconds, nvcc log)}``
    (0 seconds and an empty log for a library already built)."""
    t0 = time.perf_counter()
    started = {name: _start(name) for name in names}
    report = {}
    for name, (out, tmp, proc) in started.items():
        log = _finish(name, out, tmp, proc)
        report[name] = (time.perf_counter() - t0 if proc else 0.0, log)
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if
    needed (once per process), with its C entry's types set."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            symbol, argtypes = ENTRY_POINTS[name]
            fn = getattr(lib, symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
            _ENTRIES[name] = fn
            _LIBS[name] = lib
        return lib


def entry(name: str):
    """The typed C entry of ``csrc/<name>.cu`` (see :data:`ENTRY_POINTS`),
    loading the library on first use."""
    fn = _ENTRIES.get(name)
    if fn is None:
        load(name)
        fn = _ENTRIES[name]
    return fn
