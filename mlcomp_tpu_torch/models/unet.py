"""U-Net semantic segmentation (``unet``): the port of
mlcomp_tpu/models/unet.py.

NHWC activations; each level two bias-free 3x3 convs with GroupNorm
(``min(32, features)`` groups, flax's grouping and eps 1e-6) and ReLU;
2x2 max pooling down; nearest 2x upsampling then a 2x2 conv (flax
``SAME``: 0 before, 1 after) up, its output concatenated after the skip;
an f32 1x1 head.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from mlcomp_tpu_torch.models import MODELS
from mlcomp_tpu_torch.models.zoo import Scope, ZooModel, conv, dtype_of, group_norm, max_pool


def conv_block(s: Scope, x: torch.Tensor, features: int, dtype: torch.dtype) -> torch.Tensor:
    for _ in range(2):
        x = conv(s.sub("Conv"), x, features, (3, 3), use_bias=False, dtype=dtype)
        x = F.relu(group_norm(s.sub("GroupNorm"), x, min(32, features), dtype))
    return x


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """``jax.image.resize(..., method="nearest")`` to twice H and W: pixel
    (i, j) of the output is pixel (i // 2, j // 2) of the input."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


@MODELS.register("unet")
class UNet(ZooModel):
    default_sample_shape = (1, 128, 128, 3)

    def __init__(self, num_classes: int = 4, features: Sequence[int] = (32, 64, 128, 256),
                 dtype: str = "bfloat16", device=None):
        super().__init__(device)
        self.num_classes, self.features = num_classes, tuple(features)
        self.dtype = dtype_of(dtype)

    def apply(self, s: Scope, x: torch.Tensor, train: bool) -> torch.Tensor:
        dt = self.dtype
        levels = len(self.features) - 1
        div = 2 ** levels
        if x.shape[1] % div or x.shape[2] % div:
            raise ValueError(
                f"UNet with {levels} down levels needs H,W divisible by {div}; "
                f"got {x.shape[1]}x{x.shape[2]} — pad the input or reduce features")
        x = x.to(dt)
        skips = []
        for f in self.features[:-1]:
            x = conv_block(s.sub("ConvBlock"), x, f, dt)
            skips.append(x)
            x = max_pool(x, 2, 2)
        x = conv_block(s.sub("ConvBlock"), x, self.features[-1], dt)  # bottleneck
        for f, skip in zip(reversed(self.features[:-1]), reversed(skips)):
            x = conv(s.sub("Conv"), upsample2(x), f, (2, 2), dtype=dt)
            x = torch.cat([skip.to(dt), x], dim=-1)
            x = conv_block(s.sub("ConvBlock"), x, f, dt)
        return conv(s.sub("Conv", "head"), x, self.num_classes, (1, 1), dtype=torch.float32)
