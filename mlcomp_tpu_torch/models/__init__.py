"""Model registry of the port: ``transformer_lm``, ``moe_lm``,
``transformer_lm_pp`` (models/pipeline_lm.py) and the zoo (``mlp``,
``mnist_cnn``, ``resnet18``/``50``/``101``, ``unet``, ``bert``/``bert_base``/
``bert_small``, ``vit``/``vit_b16``/``vit_s16``/``vit_tiny``)."""

from __future__ import annotations

from mlcomp_tpu_torch.utils.device import resolve_device
from mlcomp_tpu_torch.utils.registry import Registry

MODELS: Registry = Registry("models")


def load_all() -> None:
    """Import every model module for its registration side effect."""
    from mlcomp_tpu_torch.models import bert as _bert  # noqa: F401
    from mlcomp_tpu_torch.models import cnn as _cnn  # noqa: F401
    from mlcomp_tpu_torch.models import mlp as _mlp  # noqa: F401
    from mlcomp_tpu_torch.models import moe as _moe  # noqa: F401
    from mlcomp_tpu_torch.models import pipeline_lm as _pipeline_lm  # noqa: F401
    from mlcomp_tpu_torch.models import resnet as _resnet  # noqa: F401
    from mlcomp_tpu_torch.models import transformer as _transformer  # noqa: F401
    from mlcomp_tpu_torch.models import unet as _unet  # noqa: F401
    from mlcomp_tpu_torch.models import vit as _vit  # noqa: F401


def create_model(cfg, device=None):
    """Build a model from a ``{name: ..., **kwargs}`` config on ``device``
    (default ``cuda``).  Weights are loaded afterwards: the LM's through
    ``load_state`` (``models.generation.prep_decode_variables``), a zoo
    model's through ``load_variables`` (``io.weights.init_variables``)."""
    load_all()
    cfg = dict(cfg)
    name = cfg.pop("name")
    return MODELS.create(name, device=resolve_device(device), **cfg)
