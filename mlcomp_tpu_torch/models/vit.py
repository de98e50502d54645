"""Vision Transformer (``vit``, ``vit_b16``, ``vit_s16``, ``vit_tiny``):
the port of mlcomp_tpu/models/vit.py.

A stride-``patch`` conv patchifies NHWC images; an optional CLS token
(zeros) goes first; learned position embeddings (normal 0.02); BERT's
``transformer_layer`` without a mask, so attention takes the flash
kernels on the card (B5 forward, B9 backward; S = 196 at 224 x 224 and
patch 16); a final LayerNorm, mean pooling (``gap``) or the CLS token,
and an f32 head.
"""

from __future__ import annotations

import torch

from mlcomp_tpu_torch.models import MODELS
from mlcomp_tpu_torch.models.bert import transformer_layer
from mlcomp_tpu_torch.models.zoo import (
    ZEROS,
    Scope,
    ZooModel,
    conv,
    dense,
    dtype_of,
    layer_norm,
    normal,
)


@MODELS.register("vit")
class ViT(ZooModel):
    default_sample_shape = (1, 224, 224, 3)

    def __init__(self, num_classes: int = 1000, patch: int = 16, hidden: int = 768,
                 layers: int = 12, heads: int = 12, mlp_dim: int = 3072, dropout: float = 0.0,
                 pool: str = "gap", dtype: str = "bfloat16", device=None):
        super().__init__(device)
        self.num_classes, self.patch, self.hidden, self.layers = num_classes, patch, hidden, layers
        self.heads, self.mlp_dim, self.dropout, self.pool = heads, mlp_dim, float(dropout), pool
        self.dtype = dtype_of(dtype)

    def apply(self, s: Scope, x: torch.Tensor, train: bool) -> torch.Tensor:
        dt = self.dtype
        p = self.patch
        h = conv(s.sub("Conv", "patch_embed"), x.to(dt), self.hidden, (p, p), (p, p),
                 padding="VALID", dtype=dt)
        b, gh, gw, c = h.shape
        h = h.reshape(b, gh * gw, c)
        if self.pool == "cls":
            cls = s.param("cls", (1, 1, self.hidden), ZEROS)
            h = torch.cat([cls.to(dt).expand(b, 1, c), h], dim=1)
        pos = s.param("pos_emb", (h.shape[1], self.hidden), normal(0.02))
        h = h + pos[None].to(dt)
        for _ in range(self.layers):
            h = transformer_layer(s.sub("TransformerLayer"), h, self.hidden, self.heads,
                                  self.mlp_dim, dt, self.dropout, train)
        h = layer_norm(s.sub("LayerNorm"), h, dt)
        pooled = h[:, 0, :] if self.pool == "cls" else h.mean(dim=1)
        return dense(s.sub("Dense", "head"), pooled, self.num_classes, torch.float32)


@MODELS.register("vit_b16")
def vit_b16(**kw) -> ViT:
    return ViT(**kw)


@MODELS.register("vit_s16")
def vit_s16(**kw) -> ViT:
    kw.setdefault("hidden", 384)
    kw.setdefault("layers", 12)
    kw.setdefault("heads", 6)
    kw.setdefault("mlp_dim", 1536)
    return ViT(**kw)


@MODELS.register("vit_tiny")
def vit_tiny(**kw) -> ViT:
    kw.setdefault("hidden", 192)
    kw.setdefault("layers", 4)
    kw.setdefault("heads", 3)
    kw.setdefault("mlp_dim", 768)
    return ViT(**kw)
