"""TrainState: the step, the model, the optimizer state and the EMA.

The port of mlcomp_tpu/train/state.py.  There the state is an immutable
pytree that the jitted step replaces; here the model's parameters are
updated in place (no second copy of 1.2B parameters per step), and the
state holds what the JAX one holds besides them: the step count, the
optimizer (a :class:`~mlcomp_tpu_torch.train.optim.Transform`) and its
state, and the EMA parameters (``ema`` config; eval and predict prefer
them).  ``params`` maps each parameter's flax path to the live tensor,
so optimizer state, checkpoints and tests use the JAX package's names.
``model_state`` maps ``batch_stats/<flax path>`` to the model's live
BatchNorm statistics (the JAX state's ``{"batch_stats": ...}``; empty for
a model without them): train-mode steps update them in place, eval and
predict read them, and the EMA never touches them, as in the JAX package.

Under a mesh (``parallel/sharding.make_sharded_state``) the parameters,
the optimizer state and the EMA are DTensors placed by ``spec_for``, the
model computes on the views ``binding`` sets into it each step, and
``state_dict`` gathers every leaf to its full value (a collective on
every rank), so a sharded run's checkpoint is the unsharded one.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch
from torch import nn

from mlcomp_tpu_torch.train.optim import Transform, apply_updates


class TrainState:
    def __init__(self, model: nn.Module, params: Dict[str, torch.Tensor], tx: Transform,
                 ema_decay: float = 0.0, model_state: Optional[Dict[str, torch.Tensor]] = None):
        self.step = 0
        self.model = model
        self.params = params
        self.model_state = dict(model_state or {})
        self.tx = tx
        self.opt_state = tx.init(params)
        self.ema_decay = float(ema_decay)
        self.ema_params: Optional[Dict[str, torch.Tensor]] = (
            {k: p.detach().clone() for k, p in params.items()} if ema_decay else None)
        # the per-step views of sharded parameters (parallel/sharding.py);
        # None when the model holds its parameters itself
        self.binding = None

    @classmethod
    def create(cls, model: nn.Module, tx: Transform, ema_decay: float = 0.0) -> "TrainState":
        """A state over ``model.flax_params()`` (the trainable leaves) and,
        where the model has them, ``model.model_state()``."""
        model_state = model.model_state() if hasattr(model, "model_state") else {}
        return cls(model, dict(model.flax_params()), tx, ema_decay, model_state)

    def apply_gradients(self, grads: Dict[str, torch.Tensor]) -> None:
        """One optimizer update from ``grads`` (by flax path), in place."""
        with torch.no_grad():
            updates, self.opt_state = self.tx.update(grads, self.opt_state, self.params)
            apply_updates(self.params, updates)
            if self.ema_params is not None and self.ema_decay:
                d = self.ema_decay
                for k, e in self.ema_params.items():
                    e.copy_(d * e + (1.0 - d) * self.params[k])
        self.step += 1

    @contextlib.contextmanager
    def eval_params(self):
        """Inside, the model computes with the EMA parameters when the state
        tracks them (the JAX package's ``eval_variables``), else with its
        own."""
        if self.ema_params is None:
            yield self.model
            return
        saved = {k: p.detach().clone() for k, p in self.params.items()}
        try:
            with torch.no_grad():
                for k, p in self.params.items():
                    p.copy_(self.ema_params[k])
            yield self.model
        finally:
            with torch.no_grad():
                for k, p in self.params.items():
                    p.copy_(saved[k])

    def state_dict(self) -> Dict[str, Any]:
        """The state with every sharded leaf gathered to its full value (a
        collective: every rank of a mesh calls it)."""
        from mlcomp_tpu_torch.parallel.sharding import full_tree

        return {"step": self.step,
                "params": full_tree({k: p.detach() for k, p in self.params.items()}),
                "opt_state": full_tree(self.opt_state), "ema_params": full_tree(self.ema_params),
                "model_state": dict(self.model_state)}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Restore in place onto the current parameters' devices.  An EMA
        mismatch adapts as the JAX restore does: saved without EMA while
        this state tracks one, the EMA starts from the restored parameters;
        saved with EMA while this state does not, the EMA weights become
        the parameters."""
        from mlcomp_tpu_torch.parallel.sharding import load_into, restore_like

        with torch.no_grad():
            src = sd["params"]
            if self.ema_params is None and sd.get("ema_params") is not None:
                src = sd["ema_params"]
            for k, p in self.params.items():
                load_into(p, src[k].to(p.device if self.binding is None else "cpu"))
            saved_stats = sd.get("model_state") or {}
            for k, t in self.model_state.items():
                if k in saved_stats:
                    t.copy_(saved_stats[k])
        dev = next(iter(self.params.values())).device
        if self.binding is not None:
            self.opt_state = restore_like(self.opt_state, sd["opt_state"])
        else:
            self.opt_state = _to_device(sd["opt_state"], dev)
        if self.ema_params is not None:
            ema = sd.get("ema_params") or sd["params"]
            if self.binding is not None:
                self.ema_params = restore_like(self.ema_params, {k: ema[k] for k in self.params})
            else:
                self.ema_params = {k: ema[k].to(dev).clone() for k in self.params}
        self.step = int(sd["step"])


def _to_device(obj, dev):
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, dict):
        return {k: _to_device(v, dev) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(v, dev) for v in obj)
    return obj


def param_count(params: Dict[str, torch.Tensor]) -> int:
    return sum(p.numel() for p in params.values())
