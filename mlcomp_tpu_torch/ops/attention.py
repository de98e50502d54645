"""Attention dispatch: one call site for the models.

The counterpart of mlcomp_tpu/ops/attention.py.  Without a dense mask a
CUDA tensor runs the flash-attention kernel (ops/cuda/flash_attention.py)
and a CPU tensor its plain version; a dense mask always takes
:func:`reference_attention`, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from mlcomp_tpu_torch.ops.cuda.flash_attention import flash_attention

NEG_INF = -1e30


def reference_attention(q, k, v, mask=None, causal: bool = False,
                        scale: Optional[float] = None, kv_start=None,
                        kv_stop=None) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Sk, Hkv, D) with Hkv | H; mask
    broadcastable to (B, {1|Hkv}, Sq, Sk) (or (B, H, Sq, Sk) when Hkv == H);
    kv_start/kv_stop (B,) windows folded into the mask.  Softmax in f32; a
    fully masked row degrades to the uniform average."""
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    if kv_start is not None or kv_stop is not None:
        cols = torch.arange(s_k, device=q.device)[None]
        lo = (torch.zeros((b, 1), dtype=torch.int32, device=q.device) if kv_start is None
              else kv_start.to(torch.int32)[:, None])
        hi = (torch.full((b, 1), s_k, dtype=torch.int32, device=q.device) if kv_stop is None
              else kv_stop.to(torch.int32)[:, None])
        window = ((cols >= lo) & (cols < hi))[:, None, None, :]
        mask = window if mask is None else (mask.bool() & window)
    if h % h_kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    rep = h // h_kv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qg = q.reshape(b, s_q, h_kv, rep, d)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg, k).float() * scale
    if causal:
        cm = torch.ones((s_q, s_k), dtype=torch.bool, device=q.device).tril(s_k - s_q)
        logits = torch.where(cm, logits, torch.full_like(logits, NEG_INF))
    if mask is not None:
        m = mask.bool()
        if m.dim() == 4:
            if m.shape[1] == h and rep > 1:
                m = m.expand(b, h, *m.shape[2:]).reshape(b, h_kv, rep, *m.shape[2:])
            else:
                m = m[:, :, None]
        logits = torch.where(m, logits, torch.full_like(logits, NEG_INF))
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", weights, v)
    return out.reshape(b, s_q, h, d)


def dot_product_attention(q, k, v, mask=None, causal: bool = False,
                          scale: Optional[float] = None, kv_start=None,
                          kv_stop=None) -> torch.Tensor:
    """Multi-head attention over (B, S, H, D) tensors.  ``mask``: True =
    attend; ``kv_start``/``kv_stop``: (B,) per-row key windows, which keep
    the flash path where a dense mask does not."""
    if mask is not None:
        return reference_attention(q, k, v, mask=mask, causal=causal, scale=scale,
                                   kv_start=kv_start, kv_stop=kv_stop)
    return flash_attention(q, k, v, causal=causal, scale=scale,
                           kv_start=kv_start, kv_stop=kv_stop)
