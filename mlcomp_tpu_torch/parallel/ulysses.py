"""Ulysses-style sequence parallelism: all-to-all head/sequence exchange.

The counterpart of mlcomp_tpu/parallel/ulysses.py.  The sequence arrives
sharded over the ``sp`` group; two tiled all-to-alls re-shard Q/K/V from
sequence-sharded to head-sharded, so every rank runs ordinary
full-sequence attention on H/n heads through ``dot_product_attention``
(the flash kernels on the card: B5, and B10 in training), and a final
all-to-all restores sequence sharding for the output projection.

Against the ring: Ulysses moves each token's QKV once per direction and
keeps one dense kernel, but caps sp at the head count (heads % sp == 0
and, with GQA, kv_heads % sp == 0) and holds the full sequence of its
head shard.  The ring scales sp past the head count.

Differentiable by construction: the all-to-all's backward is the inverse
exchange (``parallel/collectives.all_to_all``).
"""

from __future__ import annotations

from typing import Optional

import torch

from mlcomp_tpu_torch.ops.attention import dot_product_attention
from mlcomp_tpu_torch.parallel import collectives as col


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None,
                      causal: bool = False, scale: Optional[float] = None) -> torch.Tensor:
    """Attention over a sequence sharded on ``group`` (None: a group of one).

    q (B, S/n, H, D), k/v (B, S/n, Hkv, D) are this rank's shards,
    sequence-contiguous in rank order.  Requires H % n == 0 and
    Hkv % n == 0.  Returns the local output shard (B, S/n, H, D).
    """
    n = col.size(group) if group is not None else 1
    h, h_kv = q.shape[2], k.shape[2]
    if h % n or h_kv % n:
        raise ValueError(
            f"ulysses needs heads divisible by sp: heads={h}, kv_heads={h_kv}, "
            f"sp={n} (use ring attention for sp > head count)"
        )
    if n == 1:
        return dot_product_attention(q, k, v, causal=causal, scale=scale)
    # seq-sharded -> head-sharded: split the head axis n ways, gather the
    # full sequence
    qh, kh, vh = (col.all_to_all(t, group, split_dim=2, concat_dim=1) for t in (q, k, v))
    out = dot_product_attention(qh, kh, vh, causal=causal, scale=scale)
    # head-sharded -> seq-sharded for the output projection
    return col.all_to_all(out, group, split_dim=1, concat_dim=2)


def ulysses_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                              causal: bool = False, scale: Optional[float] = None,
                              axis_name: str = "sp") -> torch.Tensor:
    """Ulysses on this rank's shards of global (B, S, H, D) arrays: S over
    ``axis_name``, batch over the data axes, and heads over tp where
    ``seq_shard_spec(..., heads_split_sp=True)`` puts them there (the
    rank's local rows and heads)."""
    return ulysses_attention(q, k, v, col.group_of(mesh, axis_name), causal=causal,
                             scale=scale)
