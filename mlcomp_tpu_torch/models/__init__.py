"""Model registry of the port.  This slice registers ``transformer_lm``."""

from __future__ import annotations

from mlcomp_tpu_torch.utils.device import resolve_device
from mlcomp_tpu_torch.utils.registry import Registry

MODELS: Registry = Registry("models")


def load_all() -> None:
    """Import every model module for its registration side effect."""
    from mlcomp_tpu_torch.models import transformer as _transformer  # noqa: F401


def create_model(cfg, device=None):
    """Build a model from a ``{name: ..., **kwargs}`` config on ``device``
    (default ``cuda``).  Weights are loaded afterwards
    (``models.generation.prep_decode_variables``)."""
    load_all()
    cfg = dict(cfg)
    name = cfg.pop("name")
    return MODELS.create(name, device=resolve_device(device), **cfg)
