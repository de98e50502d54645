"""Build the hand-written CUDA kernels and load them through ctypes.

Every ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds).  Libraries land in ``mlcomp_tpu_torch/_build/<hash>/``, keyed
on a hash of all sources and the compiler flags: a fresh checkout builds
at first use, an edited source rebuilds, an unchanged one loads from the
directory.  All sources compile in parallel, one ``nvcc`` each.

Nothing here runs at import time: the CPU tests import every module and
this machine may have no ``nvcc`` at all.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME or /usr/local/cuda/bin): the "
        "CUDA kernels are built from mlcomp_tpu_torch/csrc at first use"
    )


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile (if needed) and load every kernel library; returns them
    by source stem."""
    with _lock:
        if _libs:
            return _libs
        out = build_dir()
        out.mkdir(parents=True, exist_ok=True)
        procs = []
        for src in _sources():
            so = out / f"lib{src.stem}.so"
            if so.exists():
                continue
            tmp = out / f".lib{src.stem}.{os.getpid()}.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o",
                   str(tmp), str(src)]
            procs.append((src, so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )))
        errors = []
        for src, so, tmp, p in procs:
            log = p.communicate()[0].decode(errors="replace")
            if p.returncode != 0:
                errors.append(f"{src.name}:\n{log}")
                continue
            os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        for src in _sources():
            _libs[src.stem] = ctypes.CDLL(str(out / f"lib{src.stem}.so"))
        return _libs


def function(stem: str, name: str, argtypes):
    """The C launcher ``name`` of ``lib<stem>.so`` with its argument types
    declared (``ctypes.c_void_p`` for every pointer and the stream, so
    none is cut to 32 bits) and an int result, the ``cudaError_t``."""
    fn = getattr(build_all()[stem], name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


RESOURCE_FIELDS = ("regs", "static_smem", "dynamic_smem", "local_bytes", "threads",
                   "ctas_per_sm")


def resources(stem: str, name: str, kernels) -> dict:
    """The resources of ``kernels`` (names, in the order the C function
    ``name`` of ``lib<stem>.so`` fills them, six ints each from
    ``cudaFuncGetAttributes`` and the occupancy calculator): {kernel:
    {field: int for RESOURCE_FIELDS}}.  ``local_bytes`` is the per-thread
    local memory (register spills)."""
    n = len(RESOURCE_FIELDS)
    buf = (ctypes.c_int * (n * len(kernels)))()
    query = function(stem, name, [ctypes.c_void_p])
    check(query(ctypes.addressof(buf)), f"{stem} resources")
    return {k: dict(zip(RESOURCE_FIELDS, buf[n * i:n * (i + 1)])) for i, k in enumerate(kernels)}


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
