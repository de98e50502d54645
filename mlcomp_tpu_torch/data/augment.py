"""On-device data augmentation: the port of mlcomp_tpu/data/augment.py.

``build_augment(cfg)`` returns ``augment(gen, x) -> x``, which the
Trainer's step runs on the batch (NHWC floats) on its device before the
forward, drawing from ``gen`` (a ``torch.Generator`` on that device).
Config (``augment:`` in the train executor's args), as in the JAX package:

    augment:
      hflip: true                 # p=0.5 horizontal flip
      crop: 4                     # pad-by-N then random-crop back (CIFAR)
      random_resized_crop:        # ImageNet recipe
        scale: [0.08, 1.0]        # area fraction range
        ratio: [0.75, 1.3333]     # aspect range
      brightness: 0.4             # factor ~ U[1-s, 1+s], per image
      contrast: 0.4               # blend with per-image mean

Composition order: random_resized_crop | crop -> hflip -> color.  Each op
is split into its draws and a deterministic function of them
(:func:`hflip`, :func:`pad_crop`, :func:`random_resized_crop`,
:func:`brightness`, :func:`contrast`), which computes what the JAX op
computes from the same draws; the draws themselves come from another
stream than JAX's.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F


def hflip(x: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Mirror the images whose ``flip`` (B,) is True along W."""
    return torch.where(flip[:, None, None, None], x.flip(2), x)


def pad_crop(x: torch.Tensor, pad: int, off: torch.Tensor) -> torch.Tensor:
    """Zero-pad H and W by ``pad`` and cut each image back to (H, W) at
    ``off`` (B, 2) = (row, col) in [0, 2 pad]."""
    b, h, w, c = x.shape
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    rows = (off[:, 0, None] + torch.arange(h, device=x.device))[:, :, None]
    cols = (off[:, 1, None] + torch.arange(w, device=x.device))[:, None, :]
    return xp[torch.arange(b, device=x.device)[:, None, None], rows, cols]


def _linear_weights(n_in: int, n_out: int, scale: torch.Tensor,
                    translation: torch.Tensor) -> torch.Tensor:
    """``jax.image``'s ``compute_weight_mat`` for the triangle kernel with
    antialiasing, per image: (B, n_in, n_out)."""
    inv = 1.0 / scale
    kernel_scale = torch.clamp_min(inv, 1.0)
    out = torch.arange(n_out, dtype=torch.float32, device=scale.device)
    sample = (out[None] + 0.5) * inv[:, None] - translation[:, None] * inv[:, None] - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=scale.device)
    dist = (sample[:, None, :] - src[None, :, None]).abs() / kernel_scale[:, None, None]
    weights = torch.clamp_min(1.0 - dist, 0.0)
    total = weights.sum(1, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[:, None, :], weights, torch.zeros_like(weights))


def random_resized_crop(x: torch.Tensor, area: torch.Tensor, log_ratio: torch.Tensor,
                        pos: torch.Tensor) -> torch.Tensor:
    """Cut a box of ``area`` pixels (B,) and aspect exp(``log_ratio``) (B,)
    (sides clipped to [8, H] and [8, W]) at fractions ``pos`` (B, 2) of the
    room left, and resample it to (H, W) bilinearly (``jax.image.
    scale_and_translate(..., method="linear")``) in f32."""
    b, h, w, c = x.shape
    ar = torch.exp(log_ratio)
    crop_h = torch.clamp(torch.sqrt(area / ar), 8.0, float(h))
    crop_w = torch.clamp(torch.sqrt(area * ar), 8.0, float(w))
    oy = pos[:, 0] * (h - crop_h)
    ox = pos[:, 1] * (w - crop_w)
    sy, sx = h / crop_h, w / crop_w
    wy = _linear_weights(h, h, sy, -oy * sy)
    wx = _linear_weights(w, w, sx, -ox * sx)
    out = torch.einsum("bhwc,bhy,bwx->byxc", x.float(), wy, wx)
    return out.to(x.dtype)


def brightness(x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Scale each image by its factor ``f`` (B,)."""
    return x * f[:, None, None, None].to(x.dtype)


def contrast(x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Blend each image with its mean: mean + (x - mean) f, in f32."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2, 3), keepdim=True)
    return (mean + (x32 - mean) * f.float()[:, None, None, None]).to(x.dtype)


def _uniform(gen, shape, lo: float, hi: float, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def build_augment(cfg: Optional[Dict[str, Any]]
                  ) -> Optional[Callable[[torch.Generator, torch.Tensor], torch.Tensor]]:
    """Compile an ``augment(gen, x) -> x`` pipeline from config, or None.
    Validates eagerly (a typo'd op fails at Trainer construction, not at the
    first step), with the JAX package's messages."""
    if not cfg:
        return None
    if cfg is True:
        cfg = {"hflip": True}
    known = {"hflip", "crop", "random_resized_crop", "brightness", "contrast"}
    unknown = set(cfg) - known
    if unknown:
        raise ValueError(f"augment: unknown ops {sorted(unknown)}; valid: {sorted(known)}")
    if cfg.get("crop") and cfg.get("random_resized_crop"):
        raise ValueError("augment: pick ONE of crop (pad-and-crop) / random_resized_crop")
    rrc_cfg = cfg.get("random_resized_crop")
    use_rrc = bool(rrc_cfg)
    rrc_scale = rrc_ratio = None
    if use_rrc:
        rrc_cfg = {} if rrc_cfg is True else dict(rrc_cfg)
        rrc_scale = tuple(rrc_cfg.pop("scale", (0.08, 1.0)))
        rrc_ratio = tuple(rrc_cfg.pop("ratio", (3 / 4, 4 / 3)))
        if rrc_cfg:
            raise ValueError(f"random_resized_crop: unknown keys {sorted(rrc_cfg)}")
    pad = int(cfg.get("crop") or 0)
    bright = float(cfg.get("brightness") or 0.0)
    contr = float(cfg.get("contrast") or 0.0)
    flip = bool(cfg.get("hflip"))

    def augment(gen: torch.Generator, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 4:
            raise ValueError(f"augment expects NHWC images, got shape {tuple(x.shape)}")
        if not torch.is_floating_point(x):
            # a U[1-s,1+s] factor truncates to 0 or 1 on integer pixels and
            # the crop/contrast float round-trips would quantize silently
            raise ValueError(f"augment expects float images; x is {x.dtype} — "
                             "scale/normalize to float before augmenting")
        b, h, w, _ = x.shape
        dev = x.device
        if use_rrc:
            area = _uniform(gen, (b,), rrc_scale[0], rrc_scale[1], dev) * (h * w)
            log_ratio = _uniform(gen, (b,), math.log(rrc_ratio[0]), math.log(rrc_ratio[1]), dev)
            pos = torch.rand((b, 2), generator=gen, device=dev)
            x = random_resized_crop(x, area, log_ratio, pos)
        elif pad:
            off = torch.randint(0, 2 * pad + 1, (b, 2), generator=gen, device=dev)
            x = pad_crop(x, pad, off)
        if flip:
            x = hflip(x, torch.rand((b,), generator=gen, device=dev) < 0.5)
        if bright:
            x = brightness(x, _uniform(gen, (b,), 1 - bright, 1 + bright, dev))
        if contr:
            x = contrast(x, _uniform(gen, (b,), 1 - contr, 1 + contr, dev))
        return x

    return augment
