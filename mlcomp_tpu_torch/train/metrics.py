"""Metric functions, the port of mlcomp_tpu/train/metrics.py.

Each metric maps ``(outputs, batch) -> scalar`` tensor; the trainer
averages them over an epoch.  Out-of-range labels drop out of every
metric through the losses' ``_ignore_invalid_labels``, the same rule the
losses apply.
"""

from __future__ import annotations

import torch

from mlcomp_tpu_torch.train.losses import _ignore_invalid_labels, masked_mean
from mlcomp_tpu_torch.utils.registry import Registry

METRICS: Registry = Registry("metrics")


@METRICS.register("accuracy")
def accuracy(outputs, batch):
    labels = batch["y"]
    per = (outputs.argmax(-1) == labels).float()
    per, batch = _ignore_invalid_labels(per, labels, outputs.shape[-1], batch)
    return masked_mean(per, batch)


@METRICS.register("top5_accuracy")
def top5_accuracy(outputs, batch):
    labels = batch["y"]
    k = min(5, outputs.shape[-1])
    topk = torch.argsort(outputs, dim=-1, stable=True)[..., -k:]
    hit = (topk == labels[..., None]).any(-1).float()
    hit, batch = _ignore_invalid_labels(hit, labels, outputs.shape[-1], batch)
    return masked_mean(hit, batch)


@METRICS.register("miou")
def miou(outputs, batch, eps: float = 1e-6):
    """Mean IoU over classes; outputs (B,H,W,C), labels (B,H,W); pixels
    with out-of-range labels are excluded from both sides."""
    n = outputs.shape[-1]
    pred = outputs.argmax(-1)
    labels = batch["y"]
    valid = (labels >= 0) & (labels < n)
    ious = []
    for c in range(n):
        p = (pred == c) & valid
        lab = (labels == c) & valid
        inter = (p & lab).float().sum()
        union = (p | lab).float().sum()
        ious.append((inter + eps) / (union + eps))
    return torch.stack(ious).mean()


@METRICS.register("pixel_accuracy")
def pixel_accuracy(outputs, batch):
    labels = batch["y"]
    per = (outputs.argmax(-1) == labels).float()
    per, batch = _ignore_invalid_labels(per, labels, outputs.shape[-1], batch)
    return masked_mean(per, batch)


@METRICS.register("mae")
def mae(outputs, batch):
    return masked_mean((outputs - batch["y"]).abs(), batch)


def create_metrics(names):
    return {n: METRICS.get(n) for n in (names or [])}
