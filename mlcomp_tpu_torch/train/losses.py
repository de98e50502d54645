"""Loss function registry: the port of mlcomp_tpu/train/losses.py.

A loss is a function ``(outputs, batch) -> scalar`` picked by name from
the YAML config.  Every loss of the JAX package is here except
``lm_cross_entropy_fused``, which needs the fused head
(``ops/fused_ce.py``, not ported yet).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from mlcomp_tpu_torch.utils.registry import Registry

LOSSES: Registry = Registry("losses")


def masked_mean(per_example, batch):
    """Mean over the batch honoring the loader's pad mask (``valid``).

    ``per_example`` has shape (B, ...); non-batch dims are averaged first,
    then padded rows (valid==0, emitted by DataLoader pad_to_batch for the
    ragged tail when drop_last=False) are excluded from the mean.
    """
    while per_example.dim() > 1:
        per_example = per_example.mean(dim=-1)
    m = batch.get("valid") if isinstance(batch, dict) else None
    if m is None:
        return per_example.mean()
    m = m.to(per_example.dtype)
    return (per_example * m).sum() / torch.clamp(m.sum(), min=1.0)


def _ignore_invalid_labels(per, labels, n_classes, batch):
    """torch-style ignore_index semantics: integer labels outside
    [0, n_classes) contribute zero loss and drop out of the denominator.

    Spatial losses collapse to a per-example mean over VALID positions
    here; the example-validity mask then folds into the loader's pad mask
    for the batch mean."""
    valid = (labels >= 0) & (labels < n_classes)
    per = torch.where(valid, per, torch.zeros_like(per))
    v = valid.to(per.dtype)
    if per.dim() > 1:
        axes = tuple(range(1, per.dim()))
        per = per.sum(axes) / torch.clamp(v.sum(axes), min=1.0)
        v = (v.sum(axes) > 0).to(per.dtype)
    m = batch.get("valid") if isinstance(batch, dict) else None
    b2 = dict(batch) if isinstance(batch, dict) else {}
    b2["valid"] = v if m is None else v * m
    return per, b2


def softmax_cross_entropy_with_integer_labels(logits, labels):
    """``optax.softmax_cross_entropy_with_integer_labels``: logsumexp of
    the logits minus the label's logit."""
    label_logits = logits.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    return torch.logsumexp(logits, dim=-1) - label_logits


def softmax_cross_entropy(logits, targets):
    """``optax.softmax_cross_entropy`` against a target distribution."""
    return -(targets * F.log_softmax(logits, dim=-1)).sum(-1)


@LOSSES.register("cross_entropy")
def cross_entropy(logits, batch):
    labels = batch["y"]
    if labels.dim() == logits.dim():  # one-hot / soft labels
        return masked_mean(softmax_cross_entropy(logits, labels), batch)
    n = logits.shape[-1]
    per = softmax_cross_entropy_with_integer_labels(logits, labels.clamp(0, n - 1))
    per, batch = _ignore_invalid_labels(per, labels, n, batch)
    return masked_mean(per, batch)


@LOSSES.register("smoothed_cross_entropy")
def smoothed_cross_entropy(logits, batch, smoothing: float = 0.1):
    labels = batch["y"]
    n = logits.shape[-1]
    hit = torch.arange(n, device=logits.device)[None, :] == labels[..., None]
    onehot = torch.where(hit, torch.tensor(1.0 - smoothing, device=logits.device),
                         torch.tensor(smoothing / (n - 1), device=logits.device))
    per = softmax_cross_entropy(logits, onehot.to(logits.dtype))
    per, batch = _ignore_invalid_labels(per, labels, n, batch)
    return masked_mean(per, batch)


@LOSSES.register("bce_with_logits")
def bce_with_logits(logits, batch):
    """``optax.sigmoid_binary_cross_entropy``."""
    y = batch["y"].to(logits.dtype)
    per = -(y * F.logsigmoid(logits) + (1 - y) * F.logsigmoid(-logits))
    return masked_mean(per, batch)


@LOSSES.register("mse")
def mse(preds, batch):
    return masked_mean((preds - batch["y"]) ** 2, batch)


@LOSSES.register("pixel_cross_entropy")
def pixel_cross_entropy(logits, batch):
    """Per-pixel CE for segmentation: logits (B,H,W,C), labels (B,H,W).
    Out-of-range labels (the 255 void convention, or -1) are ignored."""
    labels = batch["y"]
    n = logits.shape[-1]
    per = softmax_cross_entropy_with_integer_labels(logits, labels.clamp(0, n - 1))
    per, batch = _ignore_invalid_labels(per, labels, n, batch)
    return masked_mean(per, batch)


@LOSSES.register("lm_cross_entropy")
def lm_cross_entropy(logits, batch):
    """Next-token CE for decoder LMs: logits (B,S,V), inputs batch['x']."""
    ids = batch["x"].long()
    per = softmax_cross_entropy_with_integer_labels(logits[:, :-1], ids[:, 1:]).mean(dim=-1)
    return masked_mean(per, batch)


@LOSSES.register("dice")
def dice_loss(logits, batch, eps: float = 1e-6):
    """Soft dice over one-hot classes; void pixels (labels outside [0, C))
    are excluded from both the prediction and target masses."""
    labels = batch["y"]
    n = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    onehot = (torch.arange(n, device=logits.device) == labels[..., None]).to(probs.dtype)
    valid = ((labels >= 0) & (labels < n)).to(probs.dtype)[..., None]
    probs = probs * valid
    onehot = onehot * valid
    inter = (probs * onehot).sum((1, 2))
    union = (probs + onehot).sum((1, 2))
    return 1.0 - ((2 * inter + eps) / (union + eps)).mean()


def create_loss(cfg):
    """``"cross_entropy"`` or ``{name: ..., **kwargs}`` → callable."""
    if isinstance(cfg, str):
        name, kwargs = cfg, {}
    else:
        kwargs = dict(cfg)
        name = kwargs.pop("name")
    if name.strip().lower() == "lm_cross_entropy_fused":
        raise NotImplementedError(
            "lm_cross_entropy_fused needs the fused head (ops/fused_ce.py), not ported "
            "yet (ROADMAP A11)")
    fn = LOSSES.get(name)
    return functools.partial(fn, **kwargs) if kwargs else fn
