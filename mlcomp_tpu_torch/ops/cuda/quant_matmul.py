"""int8 weight-only matmul: ``bf16((x @ q8) * scale)``, dequantized inside
the kernel (csrc/quant_matmul.cu), optionally with an RMSNorm of x folded
into its prologue.

The counterpart of mlcomp_tpu/ops/pallas/quant_matmul.py.  A CUDA tensor
launches the kernel; a CPU tensor takes :func:`quant_matmul_plain`, the
same arithmetic in plain PyTorch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mlcomp_tpu_torch.ops.cuda import build

GEMV_ROWS = 64        # rows at or below which the decode kernel runs
_GEMV_COLS = 128
_TARGET_CTAS = 264    # two waves of 132 SMs for the decode kernel
_MAX_X_STAGE = 16384  # floats of staged x per CTA (64 KB)

launches = 0        # kernel launches without the norm prologue (B1)
norm_launches = 0   # kernel launches with the norm prologue (B2)


def quant_matmul_plain(x: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor,
                       norm_scale: Optional[torch.Tensor] = None,
                       norm_eps: float = 1e-6) -> torch.Tensor:
    """Plain version: x rounds to bf16 (after the norm when ``norm_scale``
    is given), int8 -> bf16 is exact, the product and sums run in f32, the
    scale multiplies the sum once, the result rounds to bf16."""
    if norm_scale is not None:
        x32 = x.float()
        inv = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + norm_eps)
        xb = (x32 * inv * norm_scale.float()).bfloat16()
    else:
        xb = x.bfloat16()
    acc = xb.float() @ q8.float()
    return (acc * scale.float()).bfloat16()


def _splits(rows: int, d: int, n: int) -> int:
    """D-split count for the decode kernel: enough CTAs to cover the SMs
    twice, a D slice that is a multiple of 32 rows and whose staged x fits
    shared memory."""
    target = -(-_TARGET_CTAS // (n // _GEMV_COLS))
    valid = [s for s in range(1, d // 32 + 1)
             if d % s == 0 and (d // s) % 32 == 0
             and rows * (d // s) <= _MAX_X_STAGE]
    return min((s for s in valid if s >= target), default=valid[-1])


def quant_matmul(x: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor,
                 norm_scale: Optional[torch.Tensor] = None,
                 norm_eps: float = 1e-6) -> torch.Tensor:
    """x (R, D) bf16; q8 (D, N) int8; scale (N,) f32; ``norm_scale`` (D,)
    f32 folds ``rmsnorm(x)`` into the prologue (R <= 64; x then arrives
    un-normed, bf16 or f32).  Returns (R, N) bf16.  D and N must be
    multiples of 128."""
    global launches, norm_launches
    r, d = x.shape
    d2, n = q8.shape
    if d != d2:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)} vs q8 {tuple(q8.shape)}")
    if scale.shape != (n,):
        raise ValueError(f"scale must be ({n},); got {tuple(scale.shape)}")
    if d % 128 or n % 128:
        raise NotImplementedError(f"D={d} and N={n} must be multiples of 128")
    if norm_scale is not None:
        if norm_scale.shape != (d,):
            raise ValueError(f"norm_scale must be ({d},); got {tuple(norm_scale.shape)}")
        if r > GEMV_ROWS:
            raise NotImplementedError(f"the norm prologue takes at most {GEMV_ROWS} rows; got {r}")
    if x.device.type == "cpu":
        return quant_matmul_plain(x, q8, scale, norm_scale, norm_eps)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on cuda or cpu tensors, not {x.device}")
    x_types = (torch.bfloat16, torch.float32) if norm_scale is not None else (torch.bfloat16,)
    if x.dtype not in x_types or q8.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"need {x_types} x, int8 q8, f32 scale; got {x.dtype}, {q8.dtype}, {scale.dtype}")
    if norm_scale is not None and norm_scale.dtype != torch.float32:
        raise TypeError(f"norm_scale must be f32; got {norm_scale.dtype}")
    tensors = [x, q8, scale] + ([norm_scale] if norm_scale is not None else [])
    for t in tensors:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("quant_matmul operands must be contiguous and on one device")
    out = torch.empty((r, n), dtype=torch.bfloat16, device=x.device)
    splits, chunk, partial = 1, d, None
    if r <= GEMV_ROWS:
        splits = _splits(r, d, n)
        chunk = d // splits
        if splits > 1:
            partial = torch.empty((splits, r, n), dtype=torch.float32, device=x.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    launch = build.function("quant_matmul", "qmm_launch",
                            [p, p, p, p, ctypes.c_float, p, p, i, i, i, i, i, i, p])
    err = launch(
        x.data_ptr(), q8.data_ptr(), scale.data_ptr(),
        norm_scale.data_ptr() if norm_scale is not None else None, norm_eps,
        partial.data_ptr() if partial is not None else None, out.data_ptr(),
        r, d, n, splits, chunk, int(x.dtype == torch.float32), build.stream_ptr(x.device),
    )
    build.check(err, "quant_matmul")
    if norm_scale is None:
        launches += 1
    else:
        norm_launches += 1
    return out
