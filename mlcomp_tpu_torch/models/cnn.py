"""Small convnet for MNIST-class tasks (``mnist_cnn``): the port of
mlcomp_tpu/models/cnn.py.  NHWC input ((B, H, W) gains a channel axis);
the feature map flattens in NHWC order, the order of the JAX module's
Dense rows."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from mlcomp_tpu_torch.models import MODELS
from mlcomp_tpu_torch.models.zoo import Scope, ZooModel, conv, dense, dtype_of, max_pool


@MODELS.register("mnist_cnn")
class MnistCNN(ZooModel):
    default_sample_shape = (1, 28, 28, 1)

    def __init__(self, num_classes: int = 10, features: Sequence[int] = (32, 64),
                 dense: int = 128, dtype: str = "float32", device=None):
        super().__init__(device)
        self.num_classes, self.features, self.dense = num_classes, tuple(features), dense
        self.dtype = dtype_of(dtype)

    def apply(self, s: Scope, x: torch.Tensor, train: bool) -> torch.Tensor:
        if x.dim() == 3:
            x = x[..., None]
        x = x.to(self.dtype)
        for f in self.features:
            x = F.relu(conv(s.sub("Conv"), x, f, (3, 3), dtype=self.dtype))
            x = max_pool(x, 2, 2)
        x = x.reshape(x.shape[0], -1)
        x = F.relu(dense(s.sub("Dense"), x, self.dense, self.dtype))
        # final logits in f32 for a stable softmax and loss
        return dense(s.sub("Dense"), x, self.num_classes, torch.float32)
