"""int8 weight-only matmul: ``bf16((x @ q8) * scale)``, dequantized inside
the kernel (csrc/quant_matmul.cu), optionally with an RMSNorm of x folded
into its prologue.

The counterpart of mlcomp_tpu/ops/pallas/quant_matmul.py.  A CUDA tensor
launches the kernel; a CPU tensor takes :func:`quant_matmul_plain`, the
same arithmetic in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from mlcomp_tpu_torch.ops.cuda import build

GEMV_ROWS = 64        # rows at or below which the decode kernel runs
# the decode path (csrc/quant_matmul.cu, qmm_gemv_tc_kernel): output
# features a CTA, depth of one step, the row tiles (mma's N) that rows pad
# to, and the cluster sizes it takes (up to the portable 8)
GEMV_BN, GEMV_KS = 128, 128
GEMV_ROW_TILES = (8, 16, 32, 64)
GEMV_CLUSTERS = (1, 2, 4, 8)
# the tiled path (csrc/quant_matmul.cu, qmm_wgmma_kernel): output tile,
# depth of one step, and the fewest steps a D slice may hold
GEMM_BM, GEMM_BN, GEMM_BK = 128, 128, 64
MIN_SLICE_STEPS = 2
# the row count the tiled path's D split is sized for: the engine's
# admission chunk.  The split is a function of (D, N) alone, so a row's
# f32 sum order never depends on how many rows the call holds
SPLIT_ROWS = 256
SMS = 132             # the H100's SMs

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


@functools.lru_cache(maxsize=None)
def gemv_plan(rows: int, d: int, n: int) -> dict:
    """The decode kernel's grid for ``rows`` <= GEMV_ROWS: 128-feature
    output tiles, rows padded to the next of GEMV_ROW_TILES, and, where the
    tiles leave SMs idle, D split over the CTAs of one thread-block cluster
    (one launch: the cluster adds its slices through distributed shared
    memory).  The cluster is the largest of GEMV_CLUSTERS that divides
    D's 128-deep steps and keeps the grid within one wave of
    two CTAs an SM (the kernel's shared memory leaves room for two); no
    split where the tiles alone fill the card.  Returns {"rows_padded",
    "tiles", "cluster", "ctas", "d_chunk", "steps"}: ``steps`` per CTA."""
    tiles = n // GEMV_BN
    steps = d // GEMV_KS
    cluster = 1
    if tiles < SMS:
        cluster = max(c for c in GEMV_CLUSTERS if steps % c == 0 and tiles * c <= 2 * SMS)
    return dict(rows_padded=next(t for t in GEMV_ROW_TILES if t >= rows), tiles=tiles,
                cluster=cluster, ctas=tiles * cluster, d_chunk=d // cluster,
                steps=steps // cluster)


@functools.lru_cache(maxsize=None)
def _gemm_splits(d: int, n: int) -> int:
    tiles = -(-SPLIT_ROWS // GEMM_BM) * (n // GEMM_BN)
    steps = d // GEMM_BK
    fits = [s for s in range(1, steps // MIN_SLICE_STEPS + 1)
            if steps % s == 0 and tiles * s <= SMS]
    return max(fits, default=1)


def plan(rows: int, d: int, n: int) -> dict:
    """The tiled path's grid for ``rows`` > GEMV_ROWS: 128 x 128 output
    tiles, and D split into ``splits`` slices of whole 64-deep steps,
    summed in slice order by a second pass.  The split reads (D, N) alone:
    the most slices (of at least MIN_SLICE_STEPS steps) that still give
    every CTA of a SPLIT_ROWS-row call (the admission chunk) an SM of its
    own.  Past one CTA an SM a split only adds partial sums to write and
    add (measured on the H100: qkv at 256 rows takes longer split in two,
    192 CTAs, than whole, 96), and a split that followed the row count
    would give one row other f32 sums at other batch sizes.  Returns
    {"tiles", "splits", "ctas", "d_chunk", "steps"}: ``steps`` per
    slice."""
    tiles = -(-rows // GEMM_BM) * (n // GEMM_BN)
    splits = _gemm_splits(d, n)
    return dict(tiles=tiles, splits=splits, ctas=tiles * splits, d_chunk=d // splits,
                steps=d // GEMM_BK // splits)


def resources() -> dict:
    """The tiled path's kernel ("gemm"), its split pass ("reduce") and the
    decode kernel at 8 rows ("gemv", "gemv_norm") and at 64 rows ("gemv_64",
    "gemv_norm_f32_64": the norm prologue on f32 x) on the card
    (``build.resources``): {name: {field: int}}."""
    return build.resources("quant_matmul", "qmm_resources",
                           ("gemm", "reduce", "gemv", "gemv_norm", "gemv_64",
                            "gemv_norm_f32_64"))


def quant_matmul(x: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor,
                 norm_scale: Optional[torch.Tensor] = None,
                 norm_eps: float = 1e-6) -> torch.Tensor:
    """x (R, D) bf16; q8 (D, N) int8; scale (N,) f32; ``norm_scale`` (D,)
    f32 folds ``rmsnorm(x)`` into the prologue (R <= 64; x then arrives
    un-normed, bf16 or f32).  Returns (R, N) bf16.  D and N must be
    multiples of 128.  Up to GEMV_ROWS rows the decode kernel runs on
    :func:`gemv_plan`'s grid, one launch; above them the wgmma tiles on
    :func:`plan`'s grid, whose D slices a second pass adds."""
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
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("quant_matmul operands must be contiguous, 16-byte aligned "
                             "and on one device")
    out = torch.empty((r, n), dtype=torch.bfloat16, device=x.device)
    partial = None
    if r <= GEMV_ROWS:
        splits = gemv_plan(r, d, n)["cluster"]
    else:
        splits = _gemm_splits(d, n)
        if splits > 1:
            partial = torch.empty((splits, r, n), dtype=torch.float32, device=x.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    launch = build.function("quant_matmul", "qmm_launch",
                            [p, p, p, p, ctypes.c_float, p, p, i, i, i, i, i, i, p])
    err = launch(
        x.data_ptr(), q8.data_ptr(), scale.data_ptr(),
        norm_scale.data_ptr() if norm_scale is not None else None, norm_eps,
        partial.data_ptr() if partial is not None else None, out.data_ptr(),
        r, d, n, splits, d // splits, int(x.dtype == torch.float32), build.stream_ptr(x.device),
    )
    build.check(err, "quant_matmul")
    if norm_scale is None:
        launches += 1
    else:
        norm_launches += 1
    return out
