"""ResNet family, v1.5 bottleneck (``resnet18``, ``resnet50``,
``resnet101``): the port of mlcomp_tpu/models/resnet.py.

NHWC activations in the model's dtype, BatchNorm with flax's semantics
(models/zoo.py: f32 statistics, biased running variance, momentum 0.9,
eps 1e-5), the stride in the bottleneck's 3x3 conv with flax's asymmetric
``SAME`` padding (0 before, 1 after on even sizes), the last BatchNorm of
each block zero-initialised, and an f32 head.  ``resnet18`` keeps the
bottleneck block, as the JAX package does.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from mlcomp_tpu_torch.models import MODELS
from mlcomp_tpu_torch.models.zoo import (
    ZEROS,
    Scope,
    ZooModel,
    batch_norm,
    conv,
    dense,
    dtype_of,
    max_pool,
)


def bottleneck(s: Scope, x: torch.Tensor, filters: int, stride: int, train: bool,
               dtype: torch.dtype) -> torch.Tensor:
    residual = x
    y = conv(s.sub("Conv"), x, filters, (1, 1), use_bias=False, dtype=dtype)
    y = F.relu(batch_norm(s.sub("BatchNorm"), y, train, dtype))
    y = conv(s.sub("Conv"), y, filters, (3, 3), (stride, stride), use_bias=False, dtype=dtype)
    y = F.relu(batch_norm(s.sub("BatchNorm"), y, train, dtype))
    y = conv(s.sub("Conv"), y, filters * 4, (1, 1), use_bias=False, dtype=dtype)
    # zero-init the last BN scale: the residual branch starts as identity
    y = batch_norm(s.sub("BatchNorm"), y, train, dtype, scale_init=ZEROS)
    if residual.shape != y.shape:
        residual = conv(s.sub("Conv", "conv_proj"), residual, filters * 4, (1, 1),
                        (stride, stride), use_bias=False, dtype=dtype)
        residual = batch_norm(s.sub("BatchNorm", "norm_proj"), residual, train, dtype)
    return F.relu(residual + y)


class ResNet(ZooModel):
    default_sample_shape = (1, 224, 224, 3)

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000, width: int = 64,
                 dtype: str = "bfloat16", device=None):
        super().__init__(device)
        self.stage_sizes, self.num_classes, self.width = tuple(stage_sizes), num_classes, width
        self.dtype = dtype_of(dtype)

    def apply(self, s: Scope, x: torch.Tensor, train: bool) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        x = conv(s.sub("Conv", "conv_init"), x, self.width, (7, 7), (2, 2),
                 padding=[(3, 3), (3, 3)], use_bias=False, dtype=dt)
        x = F.relu(batch_norm(s.sub("BatchNorm", "bn_init"), x, train, dt))
        x = max_pool(x, 3, 2, 1)
        for i, blocks in enumerate(self.stage_sizes):
            for j in range(blocks):
                stride = 2 if i > 0 and j == 0 else 1
                x = bottleneck(s.sub("BottleneckBlock"), x, self.width * 2 ** i, stride, train, dt)
        x = x.mean(dim=(1, 2))  # global average pool
        # f32 head for a numerically stable softmax
        return dense(s.sub("Dense", "head"), x, self.num_classes, torch.float32)


@MODELS.register("resnet50")
def resnet50(**kw) -> ResNet:
    return ResNet(stage_sizes=[3, 4, 6, 3], **kw)


@MODELS.register("resnet18")
def resnet18(**kw) -> ResNet:
    return ResNet(stage_sizes=[2, 2, 2, 2], **kw)


@MODELS.register("resnet101")
def resnet101(**kw) -> ResNet:
    return ResNet(stage_sizes=[3, 4, 23, 3], **kw)
