"""Plain MLP classifier (``mlp``): the port of mlcomp_tpu/models/mlp.py.
The input flattens in its own (NHWC) order, as the JAX module flattens."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from mlcomp_tpu_torch.models import MODELS
from mlcomp_tpu_torch.models.zoo import Scope, ZooModel, dense, dtype_of


@MODELS.register("mlp")
class MLP(ZooModel):
    default_sample_shape = (1, 64)

    def __init__(self, num_classes: int = 10, hidden: Sequence[int] = (128, 128),
                 dtype: str = "float32", device=None):
        super().__init__(device)
        self.num_classes, self.hidden = num_classes, tuple(hidden)
        self.dtype = dtype_of(dtype)

    def apply(self, s: Scope, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for h in self.hidden:
            x = F.relu(dense(s.sub("Dense"), x, h, self.dtype))
        return dense(s.sub("Dense"), x, self.num_classes, torch.float32)
