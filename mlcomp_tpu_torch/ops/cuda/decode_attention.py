"""Flash decode over an int8 KV cache (csrc/decode_attention.cu): one query
per row (:func:`decode_attention`) or S chunk queries per row
(:func:`decode_attention_chunk`), and the cache helpers that fix its layout.

The counterpart of mlcomp_tpu/ops/pallas/decode_attention.py: the cache is
(B, Hkv, L, dh) int8 values with (B, Hkv, 1, L) bf16 per-(slot, head)
scales, L from :func:`pick_buffer_len` and dh zero-padded to 128, exactly
the JAX package's shapes.  A CUDA tensor launches the kernel; a CPU tensor
takes the plain version beside it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from mlcomp_tpu_torch.ops.cuda import build

NEG_INF = -1e30
LANES = 128
# block budget of the TPU kernel; kept so pick_buffer_len gives the JAX
# package's buffer lengths (the cache shapes are part of the contract)
KV_BLOCK_BUDGET = 2 * 1024 * 1024 + 128 * 1024
# the TPU kernel's query tile: a chunk wider than this runs there as
# ceil(S / 32) sweeps.  The CUDA kernel puts its query tiles on the grid and
# covers any S in one launch, with the same per-query result.
CHUNK_MAX_SQ = 32

launches = 0
chunk_launches = 0


def auto_block_kv(l_buf: int, h_kv: int, dh: int) -> int:
    """Largest lane-multiple divisor of ``l_buf`` whose K+V blocks fit
    :data:`KV_BLOCK_BUDGET` (fallback: one lane)."""
    return max(
        (bl for bl in range(LANES, l_buf + 1, LANES)
         if l_buf % bl == 0 and 2 * h_kv * bl * dh <= KV_BLOCK_BUDGET),
        default=LANES,
    )


def pick_buffer_len(s: int, h_kv: int, dh: int) -> int:
    """Cache-buffer length for ``s`` live slots: the smallest lane multiple
    >= s whose :func:`auto_block_kv` block is fat (>= 384, or the whole
    buffer for short caches)."""
    base = -(-s // LANES) * LANES
    for cand in range(base, base + 4 * LANES + 1, LANES):
        if auto_block_kv(cand, h_kv, dh) >= min(384, cand):
            return cand
    return -(-base // 512) * 512


def quantize_kv(x: torch.Tensor, eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax int8: x (..., dh) -> (int8 values, f32 scales (...)).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(-1), min=eps) / 127.0
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def decode_attention_plain(q, k8, ks, v8, vs, kv_start, kv_stop, scale):
    """Plain version of the single-query kernel: the one-query chunk, as on
    the card (:func:`decode_attention_chunk_plain`)."""
    return decode_attention_chunk_plain(q[:, None], k8, ks, v8, vs, kv_start, kv_stop,
                                        scale)[:, 0]


def decode_attention_chunk_plain(q, k8, ks, v8, vs, kv_start, kv_stop0, scale):
    """Plain version of the kernel, one pass over the whole buffer with its
    arithmetic: logits (q . k) * scale * ks in f32, masked to -1e30, p zero
    for masked slots, the V scale folded into p and rounded to q.dtype,
    l == 0 gives 0.  q (B, S, H, dh); query j's window is
    ``[kv_start, kv_stop0 + j)``."""
    b, s_q, h, dh = q.shape
    h_kv, l_buf = k8.shape[1], k8.shape[2]
    rep = h // h_kv
    qg = q.float().reshape(b, s_q, h_kv, rep, dh)
    s = torch.einsum("bsgrd,bgld->bgsrl", qg, k8.float()) * scale
    s = s * ks.float()[:, :, :, None]                   # (B, Hkv, 1, 1, L)
    slots = torch.arange(l_buf, device=q.device)
    stops = kv_stop0[:, None] + torch.arange(s_q, device=q.device)[None]      # (B, S)
    live = (slots[None, None] >= kv_start[:, None, None]) & (slots[None, None] < stops[..., None])
    live = live[:, None, :, None, :]                    # (B, 1, S, 1, L)
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(live & (m > NEG_INF / 2), torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    pv = (p * vs.float()[:, :, :, None]).to(q.dtype).float()
    acc = torch.einsum("bgsrl,bgld->bsgrd", pv, v8.float())
    l = l[..., 0].permute(0, 2, 1, 3)[..., None]        # (B, S, Hkv, rep, 1)
    out = acc / torch.where(l == 0, torch.ones_like(l), l)
    return out.to(q.dtype).reshape(b, s_q, h, dh)


def _rows(x: Union[None, int, torch.Tensor], b: int, default: int, device) -> torch.Tensor:
    if x is None:
        return torch.full((b,), default, dtype=torch.int32, device=device)
    if isinstance(x, int):
        return torch.full((b,), x, dtype=torch.int32, device=device)
    return x.to(device=device, dtype=torch.int32).expand(b).contiguous()


def _check_cache(q, k8, ks, v8, vs, h: int, dh: int) -> None:
    """The layout checks both wrappers share."""
    b = q.shape[0]
    _, h_kv, l_buf, _ = k8.shape
    if ks.shape != (b, h_kv, 1, l_buf) or vs.shape != (b, h_kv, 1, l_buf):
        raise ValueError(
            f"scales must be (B, Hkv, 1, L) = {(b, h_kv, 1, l_buf)}; got "
            f"ks {tuple(ks.shape)}, vs {tuple(vs.shape)}"
        )
    if h % h_kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    if l_buf % LANES or dh % LANES:
        raise NotImplementedError(
            f"cache length {l_buf} and head dim {dh} must be multiples of {LANES}"
        )


def _check_launch(what: str, q, k8, ks, v8, vs, dh: int) -> None:
    """The CUDA kernel's operand contract (the plain version takes more)."""
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {q.device}")
    if q.dtype != torch.bfloat16 or ks.dtype != torch.bfloat16 or vs.dtype != torch.bfloat16:
        raise TypeError(f"need bf16 q and scales; got {q.dtype}, {ks.dtype}, {vs.dtype}")
    if k8.dtype != torch.int8 or v8.dtype != torch.int8:
        raise TypeError("k8/v8 must be int8")
    if dh > 256:
        raise NotImplementedError(f"kernel takes dh <= 256; got {dh}")
    for t in (q, k8, ks, v8, vs):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{what} operands must be contiguous and on one device")


def _attend(what: str, q, k8, ks, v8, vs, kv_start, kv_stop0, scale):
    """The chunk kernel's checks and launch on a CUDA ``q`` (B, S, H, dh),
    or its plain version on a CPU one; both wrappers go through here."""
    b, s_q, h, dh = q.shape
    _check_cache(q, k8, ks, v8, vs, h, dh)
    l_buf, h_kv = k8.shape[2], k8.shape[1]
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    start = _rows(kv_start, b, 0, q.device)
    stop0 = _rows(kv_stop0, b, l_buf - s_q + 1, q.device)
    if q.device.type == "cpu":
        return decode_attention_chunk_plain(q, k8, ks, v8, vs, start, stop0, scale)
    _check_launch(what, q, k8, ks, v8, vs, dh)
    out = torch.empty_like(q)
    p, i = ctypes.c_void_p, ctypes.c_int
    launch = build.function("decode_attention", "decode_attention_chunk_launch",
                            [p] * 8 + [i] * 6 + [ctypes.c_float, p])
    err = launch(
        *(t.data_ptr() for t in (q, k8, ks, v8, vs, start, stop0, out)),
        b, s_q, h, h_kv, l_buf, dh, scale, build.stream_ptr(q.device),
    )
    build.check(err, what)
    return out


def decode_attention(q: torch.Tensor, k8: torch.Tensor, ks: torch.Tensor,
                     v8: torch.Tensor, vs: torch.Tensor,
                     kv_start=None, kv_stop=None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention against an int8 KV cache: the one-query case
    of :func:`decode_attention_chunk`, counted apart in ``launches``.

    q (B, H, dh); k8/v8 (B, Hkv, L, dh) int8; ks/vs (B, Hkv, 1, L);
    kv_start/kv_stop: (B,) int32 tensors or ints, the valid-slot window
    (default: the whole buffer).  L and dh must be multiples of 128.
    Returns (B, H, dh) in q.dtype."""
    global launches
    out = _attend("decode_attention", q[:, None], k8, ks, v8, vs, kv_start, kv_stop, scale)
    if q.device.type == "cuda":
        launches += 1
    return out[:, 0]


def decode_attention_chunk(q: torch.Tensor, k8: torch.Tensor, ks: torch.Tensor,
                           v8: torch.Tensor, vs: torch.Tensor,
                           kv_start=None, kv_stop0=None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """S queries per row against an int8 KV cache in one launch.

    q (B, S, H, dh) whose K/V are already in the cache: query j sits at
    slot ``kv_stop0 - 1 + j`` and attends ``[kv_start, kv_stop0 + j)``
    (default ``kv_stop0``: ``L - S + 1``, the chunk at the buffer end).  The
    cache as for :func:`decode_attention`, which is the S == 1 case.
    Returns (B, S, H, dh) in q.dtype."""
    global chunk_launches
    out = _attend("decode_attention_chunk", q, k8, ks, v8, vs, kv_start, kv_stop0, scale)
    if q.device.type == "cuda":
        chunk_launches += 1
    return out
