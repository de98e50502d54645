"""Ring attention: sequence/context parallelism over the ``sp`` mesh axis.

The counterpart of mlcomp_tpu/parallel/ring.py.  The sequence is sharded
across the ranks of the sp group: each rank keeps its Q shard and the K/V
shards rotate around the ring (:func:`~mlcomp_tpu_torch.parallel.collectives.rotate`,
the ``ppermute`` counterpart), with the softmax accumulated online (a
max/sum renormalization per incoming block), so no rank materializes more
than its (S/n, KV_CHUNK) tile of logits.

``use_flash=True`` (model ``seq_parallel: ring_flash``) runs each
Q-shard x KV-shard block through ``flash_attention_lse`` (B5 forward on
the card; its backward is B10 on the diagonal block and B9 on full
blocks, with the lse cotangent folded into delta) and merges blocks by
logsumexp.  The einsum-tile path is the reference and the default, plain
PyTorch as in the JAX package.

Differentiable by construction: the rotation's backward is the rotation
the other way, so autograd runs the backward ring; no hand-made VJP.
K and V travel as one stacked tensor, so each rank's rotations form one
chain, and the result depends on the chain's last link with a zero
weight: every rank then runs every backward rotation, in the chain's
order, whichever blocks it skipped (a block after the diagonal), so the
ranks' point-to-point exchanges always pair up.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from mlcomp_tpu_torch.parallel import collectives as col

NEG_INF = -1e30

# KV chunk for the within-shard online softmax: logits materialize as
# (Sq, KV_CHUNK) tiles instead of the full (Sq, S_local)
KV_CHUNK = 1024
# the JAX kernel's lane width: the flash ring refuses shards it cannot tile
LANES = 128


def _tile_attn(q, k, v, row0: int, col0: int, causal: bool, scale: float):
    """One Q-shard x KV-chunk tile, GQA-aware, f32 accumulation.

    Returns (unnormalized_out, tile_max, tile_sum) for online merging.
    q: (B, Sq, H, D); k/v: (B, Sk, Hkv, D); row0/col0: global offsets.
    """
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    rep = h // h_kv
    qg = q.reshape(b, s_q, h_kv, rep, d)
    s = torch.einsum("bqhrd,bkhd->bhrqk", qg, k).float() * scale
    if causal:
        rows = row0 + torch.arange(s_q, device=q.device)[:, None]
        cols = col0 + torch.arange(s_k, device=q.device)[None]
        s = torch.where((rows >= cols)[None, None, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)                          # (B,Hkv,rep,Sq,1)
    # clamp fully-masked rows: exp(NEG_INF - NEG_INF) would be exp(0) = 1
    m_safe = torch.clamp(m, min=NEG_INF / 2)
    p = torch.exp(s - m_safe) * (s > NEG_INF / 2).float()
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhrqk,bkhd->bhrqd", p.to(v.dtype), v).float()
    return o, m_safe, l


def _online_merge(acc, m, l, o_b, m_b, l_b):
    """Online-softmax merge of a new (out, max, sum) tile into the running
    accumulators: the one definition both the KV-chunk loop and the ring
    loop use."""
    m_new = torch.maximum(m, m_b)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(m_b - m_new)
    return acc * alpha + o_b * beta, m_new, l * alpha + l_b * beta


def _zero_carry(b, h_kv, rep, s_q, d, like):
    """(acc0, m0, l0) of the online merge."""
    return (
        torch.zeros((b, h_kv, rep, s_q, d), dtype=torch.float32, device=like.device),
        torch.full((b, h_kv, rep, s_q, 1), NEG_INF / 2, dtype=torch.float32, device=like.device),
        torch.zeros((b, h_kv, rep, s_q, 1), dtype=torch.float32, device=like.device),
    )


def _block_attn(q, k, v, row0: int, col0: int, causal: bool, scale: float):
    """Q-shard x KV-shard attention with (Sq, KV_CHUNK)-bounded logits.

    Same (unnormalized_out, max, sum) contract as :func:`_tile_attn`; a KV
    shard longer than ``KV_CHUNK`` streams through the chunks (plus one
    remainder tile for a ragged shard).  Each tile is recomputed in the
    backward (``checkpoint``), so its logits are never saved.
    """
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    rep = h // h_kv
    if s_k <= KV_CHUNK:
        return _tile_attn(q, k, v, row0, col0, causal, scale)

    tile = partial(_tile_attn, causal=causal, scale=scale)
    acc, m, l = _zero_carry(b, h_kv, rep, s_q, d, q)
    for c0 in range(0, s_k, KV_CHUNK):
        c1 = min(c0 + KV_CHUNK, s_k)
        o_b, m_b, l_b = checkpoint(tile, q, k[:, c0:c1], v[:, c0:c1], row0, col0 + c0,
                                   use_reentrant=False)
        acc, m, l = _online_merge(acc, m, l, o_b, m_b, l_b)
    return acc, m, l


def _merge_normalized(out, lse, o_b, l_b):
    """Merge two NORMALIZED partial results via their logsumexps (the
    flash-block form of the online merge; sentinel lse = NEG_INF/2 means
    "no contribution" and stays finite so the exps never produce NaN)."""
    l_new = torch.logaddexp(lse, l_b)
    a = torch.exp(lse - l_new)[..., None]
    b_ = torch.exp(l_b - l_new)[..., None]
    return out * a + o_b * b_, l_new


def _ring_flash(q, k, v, group, causal: bool, scale: float):
    """Ring pass whose per-shard block is ``flash_attention_lse``: each
    Q-shard x KV-shard block runs tiled with O(S) memory, and blocks merge
    by logsumexp.  Causality is decided per ring step (before = full
    block, diagonal = causal kernel, after = skip), so the kernel never
    needs global offsets."""
    from mlcomp_tpu_torch.ops.cuda.flash_attention import flash_attention_lse

    n = col.size(group) if group is not None else 1
    me = col.rank(group) if group is not None else 0
    b, s_q, h, d = q.shape
    out = torch.zeros((b, s_q, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, s_q, h), NEG_INF / 2, dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for i in range(n):
        src = (me - i) % n                      # whose shard we hold now
        # rotate first: the exchange does not depend on this step's block
        kv_nxt = col.rotate(kv, group) if i + 1 < n else None
        if not causal or src <= me:
            o_b, l_b = flash_attention_lse(q, kv[0], kv[1], causal=causal and src == me,
                                           scale=scale)
            out, lse = _merge_normalized(out, lse, o_b.float(), l_b)
        # a block after the diagonal is skipped: its (0, NEG_INF/2) merge
        # would leave the accumulators as they are
        if kv_nxt is not None:
            kv = kv_nxt
    if n > 1:
        # the chain's last link, with weight 0 (see the module docstring)
        out = out + kv.sum(dtype=torch.float32) * 0.0
    return out.to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None,
                   causal: bool = False, scale: Optional[float] = None,
                   use_flash: Optional[bool] = None) -> torch.Tensor:
    """Attention over a sequence sharded on ``group`` (the sp axis's
    process group; None is a group of one).

    q, k, v are this rank's shards (B, S_local, H|Hkv, D),
    sequence-contiguous in ring (rank) order.  Returns the local output
    shard (B, S_local, H, D).  ``use_flash``: run each block through the
    flash kernels (None means False, as in the JAX package).
    """
    n = col.size(group) if group is not None else 1
    me = col.rank(group) if group is not None else 0
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    h_kv = k.shape[2]
    rep = h // h_kv
    tileable = (s_q >= LANES and s_k >= LANES and s_q % LANES == 0
                and s_k % LANES == 0 and s_q == s_k)
    if use_flash:
        if not tileable:
            raise NotImplementedError(
                f"ring flash path needs equal lane-tileable shards; got {s_q}/{s_k}")
        return _ring_flash(q, k, v, group, causal, scale)

    row0 = me * s_q
    acc, m, l = _zero_carry(b, h_kv, rep, s_q, d, q)
    kv = torch.stack([k, v])
    for i in range(n):
        src = (me - i) % n                      # whose shard we hold now
        # rotate first: the exchange does not depend on this step's block
        kv_nxt = col.rotate(kv, group) if i + 1 < n else None
        # a block wholly after this shard's rows is all masked: its merge
        # (alpha 1, beta 0) would leave the accumulators as they are
        if not causal or src <= me:
            if s_k <= KV_CHUNK:
                o_b, m_b, l_b = _block_attn(q, kv[0], kv[1], row0, src * s_k, causal, scale)
            else:
                # the chunk loop's merged accumulators are recomputed in the
                # backward too: each KV shard saves its inputs, not one f32
                # (Sq, D) accumulator a chunk
                o_b, m_b, l_b = checkpoint(_block_attn, q, kv[0], kv[1], row0, src * s_k,
                                           causal, scale, use_reentrant=False)
            acc, m, l = _online_merge(acc, m, l, o_b, m_b, l_b)
        if kv_nxt is not None:
            kv = kv_nxt
    if n > 1:
        # the chain's last link, with weight 0 (see the module docstring)
        l = l + kv.sum(dtype=torch.float32) * 0.0
    out = acc / torch.clamp(l, min=1e-30)
    # (B, Hkv, rep, Sq, D) -> (B, Sq, H, D)
    out = out.movedim(3, 1).reshape(b, s_q, h, d)
    return out.to(q.dtype)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                           causal: bool = False, scale: Optional[float] = None,
                           axis_name: str = "sp", use_flash: Optional[bool] = None
                           ) -> torch.Tensor:
    """Ring attention on this rank's shards of global (B, S, H, D) arrays:
    S over ``axis_name``, batch over the data axes and heads over tp by
    ``seq_shard_spec`` (the rank's local rows and heads), so only the sp
    dimension runs the ring."""
    return ring_attention(q, k, v, col.group_of(mesh, axis_name), causal=causal,
                          scale=scale, use_flash=use_flash)
