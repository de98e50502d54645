"""ctypes bindings for the native data-ops library (C++, GIL-free).

The port's copy of mlcomp_tpu/native (its ``dataops.cpp`` and
``schedcore.cpp`` are copied beside this file).  ``g++`` builds
``libmlcdata.so`` at first use into ``mlcomp_tpu_torch/_build/native-<hash>/``,
keyed on a hash of the sources and the flags, never next to the sources:
a fresh checkout builds once, an edited source rebuilds.  Every entry point
degrades as the reference's does: where the toolchain or the build is
missing, :func:`lib` returns None and callers (``data/loader.py``,
``dag/graph.DagAnalyzer``) take the numpy or Python path, with the same
results.  ``MLCOMP_TPU_NO_NATIVE`` turns the library off.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRCS = [_DIR / "dataops.cpp", _DIR / "schedcore.cpp"]
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-pthread"]
BUILD_ROOT = _DIR.parent / "_build"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def so_path() -> Path:
    """Where the library for these sources and flags is built."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SRCS:
        h.update(src.read_bytes())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / "libmlcdata.so"


def _build(so: Path) -> bool:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".libmlcdata.{os.getpid()}.so")
    cmd = ["g++", *_FLAGS, *[str(s) for s in _SRCS], "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, so)   # whole or absent: a concurrent loader never sees half a file
    return True


def lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it on first use; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("MLCOMP_TPU_NO_NATIVE"):
            return None
        so = so_path()
        if not so.exists() and not _build(so):
            return None
        try:
            l = ctypes.CDLL(str(so))
        except OSError:
            return None
        l.mlc_gather.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
        ]
        l.mlc_gather.restype = None
        l.mlc_shuffle.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64]
        l.mlc_shuffle.restype = None
        l.mlc_iota.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        l.mlc_iota.restype = None
        l.mlc_dag_analyze.argtypes = [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        l.mlc_dag_analyze.restype = ctypes.c_int64
        _lib = l
        return _lib


def gather_rows(
    src: np.ndarray, idx: np.ndarray, n_threads: Optional[int] = None
) -> Optional[np.ndarray]:
    """dst[i] = src[idx[i]] via the native thread pool; None -> caller
    falls back to numpy.  src must be C-contiguous."""
    l = lib()
    if l is None or not src.flags.c_contiguous or src.ndim < 1:
        return None
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if len(idx) and (idx.min() < -len(src) or idx.max() >= len(src)):
        raise IndexError(f"gather index out of range for {len(src)} rows")
    idx = np.where(idx < 0, idx + len(src), idx)
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:], dtype=np.int64))
    dst = np.empty((len(idx),) + src.shape[1:], dtype=src.dtype)
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    l.mlc_gather(
        src.ctypes.data, row_bytes, idx.ctypes.data, len(idx),
        dst.ctypes.data, n_threads,
    )
    return dst


def shuffled_indices(n: int, seed: int) -> Optional[np.ndarray]:
    """Deterministic native Fisher-Yates permutation of arange(n)."""
    l = lib()
    if l is None:
        return None
    idx = np.empty(n, dtype=np.int64)
    l.mlc_iota(idx.ctypes.data, n)
    l.mlc_shuffle(idx.ctypes.data, n, np.uint64(seed & (2**64 - 1)))
    return idx


def dag_analyze(dep_offsets, deps, status, priority):
    """One-pass ready set + doom propagation over a dependency CSR.

    Returns ``(ready_indices, doomed_indices)`` (numpy int64 arrays) or
    None when the native library is unavailable or the graph is cyclic:
    callers fall back to the Python graph walk (dag/graph.py).
    """
    l = lib()
    if l is None:
        return None
    dep_offsets = np.ascontiguousarray(dep_offsets, dtype=np.int64)
    deps = np.ascontiguousarray(deps, dtype=np.int64)
    status = np.ascontiguousarray(status, dtype=np.int8)
    priority = np.ascontiguousarray(priority, dtype=np.int64)
    n = len(status)
    ready = np.empty(n, dtype=np.int64)
    doomed = np.empty(n, dtype=np.int64)
    n_doomed = np.zeros(1, dtype=np.int64)
    n_ready = l.mlc_dag_analyze(
        n, dep_offsets.ctypes.data, deps.ctypes.data, status.ctypes.data,
        priority.ctypes.data, ready.ctypes.data, doomed.ctypes.data,
        n_doomed.ctypes.data,
    )
    if n_ready < 0:
        return None
    return ready[:n_ready].copy(), doomed[: n_doomed[0]].copy()
