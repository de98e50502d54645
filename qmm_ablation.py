#!/usr/bin/env python3
"""Where the int8 matmul's tiled path spends its time, on one NVIDIA GPU.

    python3 qmm_ablation.py

Builds csrc/quant_matmul.cu as it stands and in variants with one part of
the wgmma kernel's step loop taken out (the results of those are wrong;
only their times count), then times each at the 1.2B transformer_lm's
projections at 256 rows (an admission chunk) and 4096 rows (an 8 x 512
prefill), each the median of five windows of CUDA events:

- ``kernel``: the kernel as committed;
- ``no_conversion``: the int8 -> bf16 conversion removed;
- ``no_copies``: the copies of steps past the first ring removed;
- ``no_products``: the wgmma products removed;
- ``products_only``, ``conversion_only``, ``copies_only``: one part kept.

It also times the planner's D split at 256 rows against its neighbours.
Prints the card's name and power limit, one JSON line per measurement,
and exits non-zero without a card.  Needs nvcc (the kernels build into a
temporary directory) and nothing else of the repo but mlcomp_tpu_torch.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CONVERT = ("    convert_step(t);\n    fence_proxy_async();", "    fence_proxy_async();")
COPY = ("    if (t + STAGES - 1 < steps) load_step(t + STAGES - 1);", "")
PRODUCT = ("      wgmma_ss_n128(acc, desc_kmajor(xa, 64, kk), desc_kmajor(bb, BN, kk), "
           "t > 0 || kk > 0);", "      acc[kk] += 1.f;")
VARIANTS = {
    "kernel": [], "no_conversion": [CONVERT], "no_copies": [COPY], "no_products": [PRODUCT],
    "products_only": [CONVERT, COPY], "conversion_only": [COPY, PRODUCT],
    "copies_only": [CONVERT, PRODUCT],
}
# (D, N) of the fused qkv, fused gate_up, down and out projections
SHAPES = {"qkv": (2048, 6144), "gate_up": (2048, 16384), "down": (8192, 2048),
          "out": (2048, 2048)}
ROWS = (256, 4096)
PEAK_OPS, PEAK_BYTES = 989e12, 3.35e12   # H100 SXM data sheet: bf16 dense, HBM3


def time_ms(fn, iters=30, windows=5):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(windows + 1)]
    marks[0].record()
    for w in range(windows):
        for _ in range(iters):
            fn()
        marks[w + 1].record()
    torch.cuda.synchronize()
    per = sorted(a.elapsed_time(b) / iters for a, b in zip(marks, marks[1:]))
    return per[len(per) // 2], [per[0], per[-1]]


def main() -> int:
    if not torch.cuda.is_available():
        print("qmm_ablation: no CUDA device; this script runs on the GPU", file=sys.stderr)
        return 1
    from mlcomp_tpu_torch.ops.cuda import build
    from mlcomp_tpu_torch.ops.cuda import quant_matmul as qm

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    src = (build.CSRC_DIR / "quant_matmul.cu").read_text()
    tmp = Path(tempfile.mkdtemp(prefix="qmm_ablation_"))

    def compile_variant(item):
        name, edits = item
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: the kernel no longer has {old!r}")
            text = text.replace(old, new)
        (tmp / f"{name}.cu").write_text(text)
        so = tmp / f"lib{name}.so"
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-o",
                        str(so), str(tmp / f"{name}.cu")], check=True, capture_output=True)
        fn = ctypes.CDLL(str(so)).qmm_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, ctypes.c_float, p, p, i, i, i, i, i, i, p]
        fn.restype = i
        return name, fn

    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        launchers = dict(ex.map(compile_variant, VARIANTS.items()))

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    def caller(fn, x, q8, sc, splits):
        r, d = x.shape
        n = q8.shape[1]
        out = torch.empty(r, n, dtype=torch.bfloat16, device=dev)
        part = torch.empty(splits, r, n, device=dev) if splits > 1 else None
        args = (x.data_ptr(), q8.data_ptr(), sc.data_ptr(), None, 1e-6,
                part.data_ptr() if part is not None else None, out.data_ptr(),
                r, d, n, splits, d // splits, 0, stream)
        return lambda: build.check(fn(*args), "qmm_launch")

    for rows in ROWS:
        for shape, (d, n) in SHAPES.items():
            q8 = torch.randint(-127, 128, (d, n), generator=g, device=dev, dtype=torch.int8)
            sc = torch.rand(n, generator=g, device=dev) / (127 * math.sqrt(d))
            x = torch.randn(rows, d, generator=g, device=dev).bfloat16()
            pl = qm.plan(rows, d, n)
            bound = max(2 * rows * d * n / PEAK_OPS,
                        (rows * d * 2 + d * n + n * 4 + rows * n * 2) / PEAK_BYTES) * 1e3
            for name, fn in launchers.items():
                ms, spread = time_ms(caller(fn, x, q8, sc, pl["splits"]))
                print(json.dumps({"variant": name, "shape": shape, "rows": rows, "d": d, "n": n,
                                  "splits": pl["splits"], "ms": ms, "ms_spread": spread,
                                  "bound_ms": bound}), flush=True)
            if rows == 256:
                steps = d // qm.GEMM_BK
                for s in (pl["splits"] // 2, pl["splits"] * 2):
                    if s >= 1 and steps % s == 0 and steps // s >= qm.MIN_SLICE_STEPS:
                        ms, spread = time_ms(caller(launchers["kernel"], x, q8, sc, s))
                        print(json.dumps({"variant": "kernel", "shape": shape, "rows": rows,
                                          "d": d, "n": n, "splits": s, "planned": pl["splits"],
                                          "ctas": pl["tiles"] * s, "ms": ms, "ms_spread": spread,
                                          "bound_ms": bound}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
