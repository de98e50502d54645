"""Chunked fused linear + softmax cross-entropy for LM heads.

The counterpart of mlcomp_tpu/ops/fused_ce.py.  The decoder LM's largest
activation is the (B, S, V) f32 logits tensor and its gradient; this op
computes

    loss[b, s] = logsumexp(h[b, s] @ W) - (h[b, s] @ W)[labels[b, s]]

over chunks of S, so at most (B, chunk, V) logits exist at once in both
passes:

- forward: per chunk, the product, then logsumexp and the label's logit;
  the chunk's logits are dropped, and only (h, W, labels) are saved;
- backward: per chunk, the logits again, dlogits = (softmax - onehot) g,
  then dh for the chunk and a running f32 dW.

The chunk products are plain matrix products (the JAX package leaves them
to XLA, outside any Pallas kernel), so they stay ``torch.matmul``.
"""

from __future__ import annotations

import torch


def _chunk_logits(h_c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, C, d) x (d, V) -> (B, C, V) f32 logits, the products in f32 as
    the JAX op's ``preferred_element_type`` asks."""
    return torch.matmul(h_c.float(), w.float())


class FusedLinearCrossEntropy(torch.autograd.Function):
    """Per-position CE of ``h @ w`` against ``labels`` (B, S) int, chunked
    over S; returns (B, S) f32.  Differentiable in h and w."""

    @staticmethod
    def forward(ctx, h, w, labels, chunk: int):
        b, s, d = h.shape
        if s % chunk:
            raise ValueError(f"sequence {s} not divisible by chunk {chunk}")
        losses = []
        for c0 in range(0, s, chunk):
            logits = _chunk_logits(h[:, c0:c0 + chunk], w)
            lse = torch.logsumexp(logits, dim=-1)
            picked = logits.gather(-1, labels[:, c0:c0 + chunk, None].long())[..., 0]
            losses.append(lse - picked)
        ctx.save_for_backward(h, w, labels)
        ctx.chunk = chunk
        return torch.cat(losses, dim=1)

    @staticmethod
    def backward(ctx, g):
        h, w, labels = ctx.saved_tensors
        chunk = ctx.chunk
        b, s, d = h.shape
        wf = w.float()
        dw = torch.zeros((d, w.shape[-1]), dtype=torch.float32, device=w.device)
        dh = []
        for c0 in range(0, s, chunk):
            h_c = h[:, c0:c0 + chunk]
            logits = _chunk_logits(h_c, w)
            dlogits = torch.softmax(logits, dim=-1)
            dlogits.scatter_add_(-1, labels[:, c0:c0 + chunk, None].long(),
                                 torch.full_like(dlogits[..., :1], -1.0))
            dlogits.mul_(g[:, c0:c0 + chunk, None].float())
            dh.append(torch.matmul(dlogits, wf.t()))
            dw += torch.einsum("bcd,bcv->dv", h_c.float(), dlogits)
        return torch.cat(dh, dim=1).to(h.dtype), dw.to(w.dtype), None, None


def fused_linear_cross_entropy(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                               chunk: int = 512) -> torch.Tensor:
    """Per-position CE of ``h @ w`` against integer ``labels``.  h (B, S, d)
    (any float dtype; f32 products), w (d, V), labels (B, S); ``chunk`` must
    divide S.  Returns (B, S) f32."""
    return FusedLinearCrossEntropy.apply(h, w, labels, int(chunk))
