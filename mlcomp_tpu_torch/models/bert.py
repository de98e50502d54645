"""BERT-style bidirectional encoder (``bert``, ``bert_base``,
``bert_small``): the port of mlcomp_tpu/models/bert.py.

Pre-norm layers (LayerNorm eps 1e-6, tanh GELU, as flax's defaults), q,
k and v as ``DenseGeneral`` to (H, dh) and the output from (H, dh), bf16
activations over f32 parameters, f32 heads: classification (CLS pooling,
``pooler`` + ``cls_head``) or, with ``num_classes: None``, masked-LM
(``mlm_head`` over the vocabulary).

Key padding comes from token id 0.  ``pad_mode: dense`` (the default)
masks keys with a boolean mask and takes ``reference_attention``, as the
JAX package does; ``pad_mode: window`` turns each row's pads into one
``[kv_start, kv_stop)`` window, which keeps the flash kernels on the card
(forward B5, backward B9).  A row with no live key gets 0 from the
kernels where the XLA reference gives the uniform average.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mlcomp_tpu_torch.models import MODELS
from mlcomp_tpu_torch.models.zoo import (
    Scope,
    ZooModel,
    dense,
    dtype_of,
    embed,
    gelu,
    layer_norm,
    normal,
)
from mlcomp_tpu_torch.ops.attention import dot_product_attention, reference_attention


def transformer_layer(s: Scope, x: torch.Tensor, hidden: int, heads: int, mlp_dim: int,
                      dtype: torch.dtype, dropout: float, train: bool, mask=None,
                      kv_start=None, kv_stop=None) -> torch.Tensor:
    """mlcomp_tpu/models/bert.py's ``TransformerLayer`` (shared with ViT)."""
    h = layer_norm(s.sub("LayerNorm"), x, dtype)
    d_head = hidden // heads
    q = dense(s.sub("DenseGeneral", "q"), h, (heads, d_head), dtype)
    k = dense(s.sub("DenseGeneral", "k"), h, (heads, d_head), dtype)
    v = dense(s.sub("DenseGeneral", "v"), h, (heads, d_head), dtype)
    # shape discovery runs on the meta device, which the kernels do not take
    attend = reference_attention if s.discovering else dot_product_attention
    attn = attend(q, k, v, mask=mask, kv_start=kv_start, kv_stop=kv_stop)
    attn = dense(s.sub("DenseGeneral", "out"), attn, hidden, dtype, n_contract=2)
    if dropout > 0 and train:
        attn = F.dropout(attn, dropout)
    x = x + attn
    h = layer_norm(s.sub("LayerNorm"), x, dtype)
    h = gelu(dense(s.sub("Dense"), h, mlp_dim, dtype))
    h = dense(s.sub("Dense"), h, hidden, dtype)
    if dropout > 0 and train:
        h = F.dropout(h, dropout)
    return x + h


@MODELS.register("bert")
class Bert(ZooModel):
    sample_dtype = torch.int64

    def __init__(self, vocab_size: int = 30522, hidden: int = 768, layers: int = 12,
                 heads: int = 12, mlp_dim: int = 3072, max_len: int = 512,
                 num_classes: Optional[int] = 2, dropout: float = 0.0, dtype: str = "bfloat16",
                 pad_mode: str = "dense", device=None):
        super().__init__(device)
        if pad_mode not in ("dense", "window"):
            raise ValueError(f"pad_mode must be 'dense' or 'window', got {pad_mode!r}")
        self.vocab_size, self.hidden, self.layers, self.heads = vocab_size, hidden, layers, heads
        self.mlp_dim, self.max_len, self.num_classes = mlp_dim, max_len, num_classes
        self.dropout, self.pad_mode = float(dropout), pad_mode
        self.dtype = dtype_of(dtype)
        self.default_sample_shape = (1, 128)

    def apply(self, s: Scope, x: torch.Tensor, train: bool) -> torch.Tensor:
        dt = self.dtype
        ids = x.long()
        mask = kv_start = kv_stop = None
        if self.pad_mode == "window":
            valid = (ids != 0).int()
            kv_start = torch.argmax(valid, dim=-1).int()
            kv_stop = kv_start + valid.sum(-1).int()
        else:
            mask = (ids != 0)[:, None, None, :]
        tok = embed(s.sub("Embed", "tok_emb"), ids, self.vocab_size, self.hidden, dt)
        pos = s.param("pos_emb", (self.max_len, self.hidden), normal(0.02))
        h = tok + pos[None, : ids.shape[1], :].to(dt)
        h = layer_norm(s.sub("LayerNorm"), h, dt)
        for _ in range(self.layers):
            h = transformer_layer(s.sub("TransformerLayer"), h, self.hidden, self.heads,
                                  self.mlp_dim, dt, self.dropout, train, mask=mask,
                                  kv_start=kv_start, kv_stop=kv_stop)
        h = layer_norm(s.sub("LayerNorm"), h, dt)
        if self.num_classes is None:
            return dense(s.sub("Dense", "mlm_head"), h, self.vocab_size, torch.float32)
        cls = torch.tanh(dense(s.sub("Dense", "pooler"), h[:, 0, :], self.hidden, dt))
        return dense(s.sub("Dense", "cls_head"), cls, self.num_classes, torch.float32)


@MODELS.register("bert_base")
def bert_base(**kw) -> Bert:
    return Bert(**kw)


@MODELS.register("bert_small")
def bert_small(**kw) -> Bert:
    kw.setdefault("hidden", 256)
    kw.setdefault("layers", 4)
    kw.setdefault("heads", 4)
    kw.setdefault("mlp_dim", 1024)
    return Bert(**kw)
