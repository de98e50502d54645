"""Optimizers and learning-rate schedules with optax's semantics.

The port of mlcomp_tpu/train/optim.py.  There a config builds an optax
``GradientTransformation``; here it builds a :class:`Transform` with the
same shape: ``init(params) -> state`` and ``update(grads, state, params)
-> (updates, state)``, plain functions over ``{name: tensor}`` trees and
a state of nested tuples, ints and tensors.  Each optimizer is the chain
optax builds, transform by transform, and each schedule is evaluated at
optax's step count (0 on the first update).  The trainer adds the updates
to the parameters in place.

Ported: the ``constant``, ``cosine``, ``warmup_cosine``, ``step`` and
``linear_warmup`` schedules; ``sgd``, ``adam``, ``adamw`` and
``adafactor`` (optax's chain with its defaults); ``grad_clip`` as
``clip_by_global_norm`` chained first.  ``lamb``, ``lars``, ``rmsprop``
and ``accum_steps`` raise ``NotImplementedError`` (ROADMAP A11).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from mlcomp_tpu_torch.utils.registry import Registry

Tree = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]

SCHEDULES: Registry = Registry("lr schedules")
OPTIMIZERS: Registry = Registry("optimizers")


class Transform(NamedTuple):
    """optax's ``GradientTransformation``: ``init(params) -> state``,
    ``update(updates, state, params) -> (updates, state)``."""
    init: Callable[[Tree], Any]
    update: Callable[[Tree, Any, Tree], Tuple[Tree, Any]]


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params):
        new = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new.append(s)
        return updates, tuple(new)

    return Transform(init, update)


def _stateless(fn: Callable[[Tree, Tree], Tree]) -> Transform:
    return Transform(lambda params: (), lambda u, s, p: (fn(u, p), s))


def _f32(x: float) -> float:
    """``x`` rounded to float32, as optax computes its scalars."""
    return float(np.float32(x))


# ---------------------------------------------------------------- schedules


@SCHEDULES.register("constant")
def constant(lr: float, **_) -> Schedule:
    return lambda count: lr


@SCHEDULES.register("cosine")
def cosine(lr: float, decay_steps: int, alpha: float = 0.0, **_) -> Schedule:
    """``optax.cosine_decay_schedule``."""
    if not decay_steps > 0:
        raise ValueError(f"cosine schedule needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        c = min(float(count), float(decay_steps))
        decay = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
        return lr * ((1 - alpha) * decay + alpha)

    return schedule


def _linear(init: float, end: float, steps: int) -> Schedule:
    """``optax.linear_schedule`` (polynomial, power 1)."""
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        c = min(max(float(count), 0.0), float(steps))
        return (init - end) * (1 - c / steps) + end

    return schedule


@SCHEDULES.register("warmup_cosine")
def warmup_cosine(lr: float, warmup_steps: int, decay_steps: int, end_lr: float = 0.0,
                  **_) -> Schedule:
    """``optax.warmup_cosine_decay_schedule(0, lr, warmup, decay, end)``:
    linear from 0 to ``lr`` over ``warmup_steps``, then cosine down to
    ``end_lr`` over the remaining ``decay_steps - warmup_steps``."""
    warm = _linear(0.0, lr, warmup_steps)
    alpha = 0.0 if lr == 0.0 else end_lr / lr
    cos = cosine(lr, decay_steps - warmup_steps, alpha)
    return lambda count: warm(count) if count < warmup_steps else cos(count - warmup_steps)


@SCHEDULES.register("step")
def step(lr: float, boundaries_and_scales: Dict[int, float], **_) -> Schedule:
    """``optax.piecewise_constant_schedule``: the scale of every boundary
    at or below the count multiplies in."""
    items = sorted((int(k), float(v)) for k, v in boundaries_and_scales.items())
    if any(v < 0 for _, v in items):
        raise ValueError("step schedule expects non-negative scale factors")

    def schedule(count):
        v = lr
        for boundary, scale in items:
            if count >= boundary:
                v = v * scale
        return v

    return schedule


@SCHEDULES.register("linear_warmup")
def linear_warmup(lr: float, warmup_steps: int, **_) -> Schedule:
    return _linear(0.0, lr, warmup_steps)


def _sched(lr: Union[float, Dict[str, Any]]) -> Schedule:
    if isinstance(lr, dict):
        cfg = dict(lr)
        name = cfg.pop("name", "constant")
        return SCHEDULES.get(name)(**cfg)
    return constant(float(lr))


# --------------------------------------------------------------- transforms


def clip_by_global_norm(max_norm: float) -> Transform:
    """Scale every update by ``max_norm / global norm`` when the global
    norm reaches ``max_norm``."""
    def fn(updates, params):
        norm = torch.sqrt(sum((u.float() * u.float()).sum() for u in updates.values()))
        keep = norm < max_norm
        return {k: torch.where(keep, u, (u / norm.to(u.dtype)) * max_norm)
                for k, u in updates.items()}

    return _stateless(fn)


def scale_by_schedule(schedule: Schedule) -> Transform:
    """Multiply by ``schedule(count)``; the count starts at 0."""
    def update(updates, count, params):
        lr = _f32(schedule(count))
        return {k: u * lr for k, u in updates.items()}, count + 1

    return Transform(lambda params: 0, update)


def scale(factor: float) -> Transform:
    return _stateless(lambda u, p: {k: v * factor for k, v in u.items()})


def scale_by_learning_rate(lr: Schedule, flip_sign: bool = True) -> Transform:
    m = -1.0 if flip_sign else 1.0
    return scale_by_schedule(lambda count: m * lr(count))


def trace(decay: float, nesterov: bool = False) -> Transform:
    """Momentum: ``t = g + decay * t``; the update is t (nesterov: g +
    decay * t)."""
    def update(updates, state, params):
        new = {k: g + decay * state[k] for k, g in updates.items()}
        out = {k: g + decay * new[k] for k, g in updates.items()} if nesterov else new
        return out, new

    return Transform(lambda params: {k: torch.zeros_like(p) for k, p in params.items()},
                     update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0) -> Transform:
    def init(params):
        return {"count": 0, "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(updates, state, params):
        count = state["count"] + 1
        mu = {k: (1 - b1) * g + b1 * state["mu"][k] for k, g in updates.items()}
        nu = {k: (1 - b2) * (g * g) + b2 * state["nu"][k] for k, g in updates.items()}
        c1 = _f32(1 - np.float32(b1) ** np.float32(count))
        c2 = _f32(1 - np.float32(b2) ** np.float32(count))
        out = {k: (mu[k] / c1) / (torch.sqrt(nu[k] / c2 + eps_root) + eps) for k in updates}
        return out, {"count": count, "mu": mu, "nu": nu}

    return Transform(init, update)


def add_decayed_weights(weight_decay: float) -> Transform:
    """``u + weight_decay * p`` for every leaf (optax's default mask)."""
    return _stateless(lambda u, p: {k: v + weight_decay * p[k] for k, v in u.items()})


def _factored_dims(shape, factored: bool, min_dim_size_to_factor: int):
    """optax's choice: the two largest axes (numpy's argsort order), when
    the second largest has at least ``min_dim_size_to_factor``."""
    if not factored or len(shape) < 2:
        return None
    dims = np.argsort(shape)
    if shape[dims[-2]] < min_dim_size_to_factor:
        return None
    return int(dims[-2]), int(dims[-1])


def scale_by_factored_rms(factored: bool = True, decay_rate: float = 0.8,
                          step_offset: int = 0, min_dim_size_to_factor: int = 128,
                          epsilon: float = 1e-30) -> Transform:
    """Adafactor's rescaling by a factored estimate of the gradient's rms
    (``optax.scale_by_factored_rms``): a row and a column second moment
    for a leaf with two axes of at least ``min_dim_size_to_factor``, a
    full one otherwise; decay ``1 - (step + 1) ** -decay_rate``."""
    def init(params):
        v_row, v_col, v = {}, {}, {}
        for k, p in params.items():
            dims = _factored_dims(tuple(p.shape), factored, min_dim_size_to_factor)
            if dims is not None:
                d1, d0 = dims
                v_row[k] = torch.zeros(np.delete(p.shape, d0).tolist(), dtype=p.dtype,
                                       device=p.device)
                v_col[k] = torch.zeros(np.delete(p.shape, d1).tolist(), dtype=p.dtype,
                                       device=p.device)
            else:
                v[k] = torch.zeros_like(p)
        return {"count": 0, "v_row": v_row, "v_col": v_col, "v": v}

    def update(updates, state, params):
        t = np.float32(state["count"] - step_offset + 1)
        decay = _f32(1.0 - t ** np.float32(-decay_rate))
        out, v_row, v_col, v = {}, {}, {}, {}
        for k, g in updates.items():
            dims = _factored_dims(tuple(params[k].shape), factored, min_dim_size_to_factor)
            g_sq = g * g + epsilon
            if dims is not None:
                d1, d0 = dims
                vr = decay * state["v_row"][k] + (1.0 - decay) * g_sq.mean(d0)
                vc = decay * state["v_col"][k] + (1.0 - decay) * g_sq.mean(d1)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (vr / vr.mean(reduced_d1, keepdim=True)) ** -0.5
                col_factor = vc ** -0.5
                out[k] = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
                v_row[k], v_col[k] = vr, vc
            else:
                vv = decay * state["v"][k] + (1.0 - decay) * g_sq
                out[k] = g * vv ** -0.5
                v[k] = vv
        return out, {"count": state["count"] + 1, "v_row": v_row, "v_col": v_col, "v": v}

    return Transform(init, update)


def clip_by_block_rms(threshold: float) -> Transform:
    """Divide each leaf by ``max(1, rms(leaf) / threshold)``."""
    def fn(updates, params):
        return {k: u / torch.clamp(torch.sqrt((u * u).mean()) / threshold, min=1.0)
                for k, u in updates.items()}

    return _stateless(fn)


def scale_by_param_block_rms(min_scale: float = 1e-3) -> Transform:
    """Multiply each leaf by its parameter's rms, at least ``min_scale``."""
    def fn(updates, params):
        return {k: u * torch.clamp(torch.sqrt((params[k] * params[k]).mean()), min=min_scale)
                for k, u in updates.items()}

    return _stateless(fn)


# --------------------------------------------------------------- optimizers


@OPTIMIZERS.register("sgd")
def sgd(lr=0.01, momentum: Optional[float] = 0.0, nesterov: bool = False, **_) -> Transform:
    parts = [] if momentum is None else [trace(momentum, nesterov)]
    return chain(*parts, scale_by_learning_rate(_sched(lr)))


@OPTIMIZERS.register("adam")
def adam(lr=1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, **_) -> Transform:
    return chain(scale_by_adam(b1, b2, eps), scale_by_learning_rate(_sched(lr)))


@OPTIMIZERS.register("adamw")
def adamw(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4, **_) -> Transform:
    return chain(scale_by_adam(b1, b2, eps), add_decayed_weights(weight_decay),
                 scale_by_learning_rate(_sched(lr)))


def _not_ported(name: str):
    def factory(**_):
        raise NotImplementedError(
            f"optimizer {name!r} is not ported to mlcomp_tpu_torch yet (ROADMAP A11)")
    return factory


for _name in ("lamb", "lars", "rmsprop"):
    OPTIMIZERS.register(_name, obj=_not_ported(_name))


@OPTIMIZERS.register("adafactor")
def adafactor(lr=None, min_dim_size_to_factor: int = 128, decay_rate: float = 0.8,
              decay_offset: int = 0, multiply_by_parameter_scale: bool = True,
              clipping_threshold: Optional[float] = 1.0, momentum: Optional[float] = None,
              weight_decay_rate: Optional[float] = None, eps: float = 1e-30,
              factored: bool = True, **_) -> Transform:
    """``optax.adafactor``'s chain: factored rms scaling, block-rms
    clipping, the learning rate, the parameter-scale factor, optional
    decayed weights, then a sign flip."""
    if momentum is not None:
        raise NotImplementedError("adafactor momentum is not ported (ROADMAP A11)")
    parts = [scale_by_factored_rms(factored, decay_rate, decay_offset,
                                   min_dim_size_to_factor, eps)]
    if clipping_threshold is not None:
        parts.append(clip_by_block_rms(clipping_threshold))
    if lr is not None:
        parts.append(scale_by_learning_rate(_sched(lr), flip_sign=False))
    if multiply_by_parameter_scale:
        parts.append(scale_by_param_block_rms())
    if weight_decay_rate is not None:
        parts.append(add_decayed_weights(weight_decay_rate))
    parts.append(scale(-1.0))
    return chain(*parts)


def create_optimizer(cfg: Union[str, Dict[str, Any]]) -> Transform:
    """Build from ``{name: adam, lr: ..., grad_clip: ..., ...}``;
    ``grad_clip`` chains ``clip_by_global_norm`` first."""
    if isinstance(cfg, str):
        cfg = {"name": cfg}
    cfg = dict(cfg)
    name = cfg.pop("name")
    grad_clip = cfg.pop("grad_clip", None)
    if int(cfg.pop("accum_steps", 1)) > 1:
        raise NotImplementedError(
            "accum_steps (optax.MultiSteps) is not ported (ROADMAP A11); "
            "use the trainer's grad_accum")
    tx = OPTIMIZERS.get(name)(**cfg)
    if grad_clip:
        tx = chain(clip_by_global_norm(float(grad_clip)), tx)
    return tx


def apply_updates(params: Tree, updates: Tree) -> None:
    """``optax.apply_updates`` in place: ``p += u`` for every leaf."""
    with torch.no_grad():
        for k, p in params.items():
            p.add_(updates[k].to(p.dtype))
