"""Flash-attention forward over (B, S, H, D) tensors (csrc/flash_attention.cu).

The counterpart of the forward half of
mlcomp_tpu/ops/pallas/flash_attention.py: causal and/or per-row key
windows ``[kv_start, kv_stop)``, GQA, and a row with no live key outputs
0.  A CUDA tensor launches the kernel; a CPU tensor takes
:func:`flash_attention_plain`.  No backward: training is a later slice.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from mlcomp_tpu_torch.ops.cuda import build

NEG_INF = -1e30
_KERNEL_DH = 128   # the kernel's head dim; smaller heads zero-pad up to it

launches = 0


def flash_attention_plain(q, k, v, causal, scale, kv_start, kv_stop
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version with the kernel's semantics: f32 logits, masked to
    -1e30, p zero on masked logits (an empty row outputs 0), p rounded to
    v.dtype before the P V product.  Returns (out (B, Sq, H, D), lse
    (B, H, Sq))."""
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    rep = h // h_kv
    qg = q.float().reshape(b, s_q, h_kv, rep, d)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * scale
    cols = torch.arange(s_k, device=q.device)
    live = (cols[None] >= kv_start[:, None]) & (cols[None] < kv_stop[:, None])
    live = live[:, None, None, None, :]
    if causal:
        rows = torch.arange(s_q, device=q.device)
        live = live & (rows[:, None] >= cols[None, :])
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    acc = torch.einsum("bgrqk,bkgd->bqgrd", p.to(v.dtype).float(), v.float())
    out = acc / l_safe.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(l_safe))[..., 0].reshape(b, h, s_q)
    return out.reshape(b, s_q, h, d).to(q.dtype), lse


def _window(x, b: int, default: int, device) -> torch.Tensor:
    if x is None:
        return torch.full((b,), default, dtype=torch.int32, device=device)
    return x.to(device=device, dtype=torch.int32).contiguous()


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, scale: Optional[float] = None,
                        kv_start: Optional[torch.Tensor] = None,
                        kv_stop: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, Sq, H, D); k/v (B, Sk, Hkv, D); kv_start/kv_stop (B,) int32.
    Returns (out (B, Sq, H, D) in q.dtype, lse (B, H, Sq) f32)."""
    global launches
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    if h % h_kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    if causal and s_q != s_k:
        raise NotImplementedError(f"causal flash needs Sq == Sk; got {s_q}/{s_k}")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    lo = _window(kv_start, b, 0, q.device)
    hi = _window(kv_stop, b, s_k, q.device)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale, lo, hi)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"the kernel takes bf16 q/k/v; got {q.dtype}, {k.dtype}, {v.dtype}")
    if d > _KERNEL_DH:
        raise NotImplementedError(f"head dim {d} > {_KERNEL_DH}")
    if d < _KERNEL_DH:
        # zero columns add nothing to q.k and give output columns that
        # are sliced off below
        pad = (0, _KERNEL_DH - d)
        q, k, v = (torch.nn.functional.pad(t, pad) for t in (q, k, v))
    q, k, v = (t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    launch = build.function("flash_attention", "flash_fwd_launch",
                            [p] * 7 + [i] * 6 + [ctypes.c_float, p])
    err = launch(
        *(t.data_ptr() for t in (q, k, v, lo, hi, out, lse)),
        b, h, h_kv, s_q, s_k, int(bool(causal)), scale, build.stream_ptr(q.device),
    )
    build.check(err, "flash_attention")
    launches += 1
    return out[..., :d], lse


def flash_attention(q, k, v, causal: bool = False, scale: Optional[float] = None,
                    kv_start=None, kv_stop=None) -> torch.Tensor:
    """Flash attention over (B, S, H, D) tensors; returns (B, Sq, H, D)."""
    return flash_attention_fwd(q, k, v, causal, scale, kv_start, kv_stop)[0]
