"""Weight-only int8 quantization, and the int8 projection module.

The counterpart of mlcomp_tpu/ops/quant.py.  Parameter trees keep the
JAX package's layout (nested dicts keyed by flax paths, so a tree moves
between the two packages unchanged); a quantized leaf is
``{"q8": int8, "q8_scale": f32}`` with a per-output-channel absmax scale.
The codes are bit-equal to the JAX package's: the same f32 division and
round-half-even (``torch.round`` and ``jnp.round`` agree).

Where the JAX package intercepts flax ``Dense`` modules at apply time, the
port swaps modules: a kernel-consumable leaf loads into an
:class:`Int8Linear`, which runs the CUDA int8 matmul
(ops/cuda/quant_matmul.py) and, on decode shapes, takes its preceding
RMSNorm into the kernel's prologue.

Under a mesh (``serve --mesh``) every rank holds only its tensor-parallel
shard of each int8 weight (``parallel/sharding.serving_shards``) and runs
the kernel on it (:func:`rank_quant_matmul`), with the Megatron role that
``parallel/sharding.TP_RULES`` gives the weight: a column-parallel weight
(q/k/v, gate/up, lm_head) on its ``(m, n/tp)`` shard, a row-parallel one
(out, down) on its ``(m/tp, n)`` shard, whose partial sums the tp group
adds in f32 and rounds once.  That is the JAX package's
``sharded_quant_matmul`` island, on the shards a rank holds; a mesh of one
rank is no mesh (:func:`mesh_gate`), and runs the one-card code.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mlcomp_tpu_torch.ops.cuda.quant_matmul import GEMV_ROWS, quant_matmul
from mlcomp_tpu_torch.parallel import collectives as col
from mlcomp_tpu_torch.parallel.mesh import axis_size

_QKEY = "q8"
_SKEY = "q8_scale"
_ATTN_IN_KEYS = ("q", "k", "v", "qkv", "query", "key", "value")
_ATTN_OUT_KEYS = ("out", "o", "out_proj")
# the RMSNorm prologue holds a whole row: at most this contraction width
NORM_FOLD_MAX_D = 2048


def as_tensor(x) -> torch.Tensor:
    """A tree leaf as a tensor (numpy arrays are wrapped, not copied)."""
    return torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x


def is_quantized_leaf(x: Any) -> bool:
    return isinstance(x, dict) and _QKEY in x and _SKEY in x


def tree_map_with_path(fn: Callable, tree, path: Tuple[str, ...] = ()):
    """Map ``fn(path, leaf)`` over a nested dict; quantized leaves are
    leaves."""
    if isinstance(tree, dict) and not is_quantized_leaf(tree):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def quantize_leaf(w, reduce_axes: Optional[Tuple[int, ...]] = None) -> Dict[str, torch.Tensor]:
    """Per-output-channel absmax int8: the scale is constant along
    ``reduce_axes`` (the contraction axes; default ``(ndim-2,)``)."""
    w32 = as_tensor(w).float()
    if reduce_axes is None:
        reduce_axes = (w32.dim() - 2,)
    absmax = w32.abs().amax(dim=tuple(reduce_axes), keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {_QKEY: q, _SKEY: scale.float()}


def dequantize_leaf(leaf: Dict[str, torch.Tensor], dtype=torch.bfloat16) -> torch.Tensor:
    return (as_tensor(leaf[_QKEY]).float() * as_tensor(leaf[_SKEY])).to(dtype)


def _attn_reduce_axes(path: Tuple[str, ...]) -> Optional[Tuple[int, ...]]:
    """Contraction axes of a 3-D attention projection, recognized by its
    flax path (``.../q/kernel`` -> (0,), ``.../out/kernel`` -> (0, 1))."""
    if len(path) < 2 or path[-1] != "kernel":
        return None
    if path[-2] in _ATTN_IN_KEYS:
        return (0,)
    if path[-2] in _ATTN_OUT_KEYS:
        return (0, 1)
    return None


def _is_float(x) -> bool:
    if isinstance(x, np.ndarray):
        return np.issubdtype(x.dtype, np.floating)
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def quantize_params(params, min_size: int = 4096):
    """Quantize every float leaf with ndim >= 2 and >= ``min_size``
    elements; 3-D attention projections along their true contraction
    axes."""
    def visit(path, leaf):
        if (_is_float(leaf) and leaf.ndim >= 2
                and math.prod(leaf.shape) >= min_size):
            axes = _attn_reduce_axes(path) if leaf.ndim == 3 else None
            return quantize_leaf(leaf, axes)
        return leaf

    return tree_map_with_path(visit, params)


def dequantize_params(params, dtype=torch.bfloat16):
    return tree_map_with_path(
        lambda p, l: dequantize_leaf(l, dtype) if is_quantized_leaf(l) else l, params
    )


def has_quantized(params) -> bool:
    found = []
    tree_map_with_path(lambda p, l: found.append(is_quantized_leaf(l)), params)
    return any(found)


def folded_2d(leaf) -> Optional[Tuple[int, int, int]]:
    """``(n_contract, m, n)`` when the scale is size 1 on a leading prefix
    of axes (the contraction) and full size on the rest, so the leaf folds
    to a 2-D ``(m, n)`` matmul operand; None otherwise."""
    q, s = leaf[_QKEY], leaf[_SKEY]
    if s.ndim != q.ndim:
        return None
    j = 0
    while j < q.ndim and s.shape[j] == 1:
        j += 1
    if j == 0 or j == q.ndim:
        return None
    if tuple(s.shape[j:]) != tuple(q.shape[j:]):
        return None
    return j, math.prod(q.shape[:j]), math.prod(q.shape[j:])


def kernel_consumable(leaf) -> bool:
    """True if the int8 kernel can take this leaf directly: it folds to
    2-D and both folded dims are multiples of 128."""
    if leaf[_QKEY].ndim > 3:
        return False
    folded = folded_2d(leaf)
    if folded is None:
        return False
    _, m, n = folded
    return m % 128 == 0 and n % 128 == 0


def dequantize_nonkernel_params(params, dtype=torch.bfloat16):
    """Dequantize every quantized leaf except those the int8 kernel will
    take: 2-D and attention ``.../kernel`` leaves that are
    kernel-consumable, ``.../embedding`` (a row gather), and stacked MoE
    experts (``experts_w1``/``experts_w2``, (E, in, out) with both slice
    dims multiples of 128), whose 2-D slices :func:`expert_matmul` feeds
    to the kernel one expert at a time; other expert shapes dequantize
    here, as in the JAX package."""
    def visit(path, leaf):
        if not is_quantized_leaf(leaf):
            return leaf
        key = path[-1] if path else None
        if key == "embedding":
            return leaf
        if key == "kernel" and kernel_consumable(leaf):
            if leaf[_QKEY].ndim == 2 or _attn_reduce_axes(path) is not None:
                return leaf
        q = leaf[_QKEY]
        if (key in ("experts_w1", "experts_w2") and q.ndim == 3
                and q.shape[-2] % 128 == 0 and q.shape[-1] % 128 == 0):
            return leaf
        return dequantize_leaf(leaf, dtype)

    return tree_map_with_path(visit, params)


def expert_matmul(x: torch.Tensor, leaf, dtype: torch.dtype) -> torch.Tensor:
    """``x @ dequant(leaf)`` for a 2-D quantized slice (one expert of a
    stacked MoE weight: q8 (in, out), scale (1, out)).  A kernel-consumable
    slice runs the int8 kernel (B1: the decode body at 64 rows or fewer,
    the tiled body above); any other dequantizes inline."""
    if kernel_consumable(leaf):
        q8 = as_tensor(leaf[_QKEY])
        scale = as_tensor(leaf[_SKEY]).float().reshape(-1).contiguous()
        rows = x.reshape(-1, q8.shape[0]).bfloat16().contiguous()
        out = quant_matmul(rows, q8.contiguous(), scale)
        return out.reshape(*x.shape[:-1], q8.shape[1]).to(dtype)
    return x.to(dtype) @ dequantize_leaf(leaf, dtype)


def fold_kernel_leaves(params):
    """Pre-shape the kernel-consumable int8 leaves once, before the token
    loop: q8 folds to its 2-D ``(m, n)`` operand and the scale to ``(n,)``
    (the kernel reads it per output channel; no TPU tile broadcast)."""
    def visit(path, leaf):
        if not is_quantized_leaf(leaf):
            return leaf
        key = path[-1] if path else None
        if key != "kernel" or not kernel_consumable(leaf):
            return leaf
        q = leaf[_QKEY]
        if q.ndim == 3 and _attn_reduce_axes(path) is None:
            return leaf
        _, m, n = folded_2d(leaf)
        return {_QKEY: as_tensor(q).reshape(m, n).contiguous(),
                _SKEY: as_tensor(leaf[_SKEY]).float().reshape(n).contiguous()}

    return tree_map_with_path(visit, params)


def mesh_gate(mesh):
    """``mesh`` when it spans more than one rank, else None (the JAX
    package's ``pallas_mesh`` gate): a mesh of one rank runs the one-card
    code path, bit for bit."""
    if mesh is None or math.prod(
            v for v in (axis_size(mesh, a) for a in ("dp", "fsdp", "pp", "sp", "ep", "tp"))) == 1:
        return None
    return mesh


def check_tp_shard(full: int, tp: int) -> None:
    """A tp-sharded dim of an int8 kernel operand must split into
    lane-tileable shards (the JAX package's check, word for word)."""
    if tp > 1 and full % (tp * 128):
        raise ValueError(f"int8 kernel under tp={tp}: the sharded dim ({full}) must split "
                         f"into lane-tileable {full // tp}-wide shards")


def rank_quant_matmul(x2: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor, tp_group,
                      row_parallel: bool, norm_scale: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """B1 (B2 with ``norm_scale``) on this rank's shard: x2 (rows, m_local)
    bf16, q8 (m_local, n_local), scale (n_local,).  A row-parallel shard's
    bf16 partial products are summed over ``tp_group`` in f32 and rounded
    once (``collectives.reduce_from``), as the JAX island's psum does."""
    out = quant_matmul(x2, q8, scale, norm_scale=norm_scale)
    if row_parallel and tp_group is not None:
        out = col.reduce_from(out, tp_group)
    return out


def folds_norm(x: torch.Tensor, m: int) -> bool:
    """The decode-shape rule under which a projection takes its preceding
    RMSNorm into the int8 kernel: at most 64 rows, the contraction is the
    normed width, at most 2048 wide and a multiple of 128."""
    rows = math.prod(x.shape[:-1])
    d = x.shape[-1]
    return rows <= GEMV_ROWS and d == m and d <= NORM_FOLD_MAX_D and d % 128 == 0


class Int8Linear(nn.Module):
    """``y = x @ dequant(q8)`` over the trailing ``n_contract`` axes of x,
    through the int8 kernel; the module a kernel-consumable leaf loads
    into.  q8 is the folded (m, n) operand, ``scale`` (n,) f32; the output
    rounds to bf16 in the kernel, then casts to ``out_dtype`` (an f32 head
    keeps that bf16 rounding, as on the TPU).

    Holding a tensor-parallel shard (``models/transformer.set_serving_tp``
    sets ``tp_group`` and, from ``TP_RULES``, ``row_parallel``), the
    kernel runs on the shard and a row-parallel one's partial sums add over
    the group in f32 before they round (:func:`rank_quant_matmul`)."""

    def __init__(self, q8: torch.Tensor, scale: torch.Tensor, feats: Tuple[int, ...],
                 n_contract: int, out_dtype: torch.dtype):
        super().__init__()
        self.register_buffer("q8", q8)
        self.register_buffer("scale", scale)
        self.feats = tuple(feats)
        self.n_contract = n_contract
        self.out_dtype = out_dtype
        self.tp_group = None
        self.row_parallel = False

    def forward(self, x: torch.Tensor, norm: Optional[nn.Module] = None) -> torch.Tensor:
        m = self.q8.shape[0]
        lead = x.shape[: x.dim() - self.n_contract]
        if norm is not None and self.n_contract == 1 and folds_norm(x, m):
            out = rank_quant_matmul(x.reshape(-1, m).contiguous(), self.q8, self.scale,
                                    self.tp_group, self.row_parallel, norm_scale=norm.scale)
        else:
            if norm is not None:
                x = norm(x)
            out = rank_quant_matmul(x.reshape(-1, m).bfloat16().contiguous(), self.q8,
                                    self.scale, self.tp_group, self.row_parallel)
        return out.to(self.out_dtype).reshape(*lead, *self.feats)
