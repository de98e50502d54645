"""Trainer: the train/eval steps and the epoch loop.

The port of mlcomp_tpu/train/loop.py, with its config keys and behaviour:
``grad_accum`` (the microbatch-mean gradient, summed in f32), ``ema``,
``early_stop``, resume-aware ``fit`` (``epochs_done`` from the step
count), ``eval_epoch``, ``predict``, preemption between steps, and the
``data``/``step`` spans when ``trace`` is set.  The step is eager
PyTorch: forward, loss, ``backward()``, then the optimizer's update in
place; no ``torch.compile`` and no CUDA graph.  Per-step losses and
metrics stay on the device and are summed there; the host reads them once
per epoch, as the JAX loop does.

Not ported yet, and refused with ``NotImplementedError``: a ``mesh`` with
an axis larger than 1 and ``seq_parallel`` (A12), ``profile`` (A13),
``augment`` and ``mixup`` (the image recipes).  ``Trainer(cfg)`` runs on
``cuda``; pass ``device="cpu"`` for the CPU.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from mlcomp_tpu_torch.data.loader import DataLoader
from mlcomp_tpu_torch.train.losses import create_loss
from mlcomp_tpu_torch.train.metrics import create_metrics
from mlcomp_tpu_torch.train.optim import create_optimizer
from mlcomp_tpu_torch.train.state import TrainState, param_count
from mlcomp_tpu_torch.utils.device import resolve_device
from mlcomp_tpu_torch.utils.trace import Tracer, get_tracer, set_tracer


def make_train_step(loss_fn, metric_fns: Dict[str, Callable], grad_accum: int = 1):
    """The train step: ``step(state, batch) -> stats`` (device scalars).

    ``grad_accum > 1`` splits the batch into that many equal microbatches,
    sums their gradients in f32 (the parameters' ``.grad``) and applies the
    optimizer once to the mean: the microbatch-mean semantics of the JAX
    step (masked losses weigh each microbatch's mean equally).  Loss and
    metrics report the microbatch average."""

    def grads_of(model, batch):
        outputs = model(batch["x"])
        loss = loss_fn(outputs, batch)
        loss.backward()
        with torch.no_grad():
            stats = {"loss": loss.detach()}
            for name, fn in metric_fns.items():
                stats[name] = fn(outputs.detach(), batch)
        return stats

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        for p in params.values():
            p.grad = None
        if grad_accum == 1:
            stats = grads_of(state.model, batch)
        else:
            b = batch["x"].shape[0]
            if b % grad_accum:
                raise ValueError(f"batch size {b} not divisible by grad_accum={grad_accum}")
            m = b // grad_accum
            per = [grads_of(state.model, {k: v[i * m:(i + 1) * m] for k, v in batch.items()})
                   for i in range(grad_accum)]
            stats = {k: torch.stack([s[k] for s in per]).mean() for k in per[0]}
            with torch.no_grad():
                for p in params.values():
                    if p.grad is not None:
                        p.grad.div_(grad_accum)
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        state.apply_gradients(grads)
        for p in params.values():
            p.grad = None
        return stats

    return train_step


def metric_improved(value: float, best: Optional[float], mode: str,
                    min_delta: float = 0.0) -> bool:
    """Shared improvement predicate for early stopping and best-checkpoint
    tracking."""
    if best is None:
        return True
    return value < best - min_delta if mode == "min" else value > best + min_delta


def make_eval_step(loss_fn, metric_fns: Dict[str, Callable]):
    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        with state.eval_params() as model:
            outputs = model(batch["x"])
        stats = {"loss": loss_fn(outputs, batch)}
        for name, fn in metric_fns.items():
            stats[name] = fn(outputs, batch)
        return stats

    return eval_step


def _refuse(cfg: Dict[str, Any]) -> None:
    mesh = cfg.get("mesh") or {}
    wide = {k: v for k, v in mesh.items() if isinstance(v, int) and v > 1}
    if wide:
        raise NotImplementedError(
            f"mesh {wide}: sharded training is not ported to mlcomp_tpu_torch yet (ROADMAP A12)")
    if cfg.get("profile"):
        raise NotImplementedError("profile: device profiling is not ported yet (ROADMAP A13)")
    for key in ("augment", "mixup"):
        if cfg.get(key):
            raise NotImplementedError(f"{key}: the image recipes are not ported yet (ROADMAP A11)")


class Trainer:
    """Config-driven trainer used by the train executor.

    cfg keys: model{name,...}, optimizer{name,lr,...}, loss, metrics[list],
    data{train{...}, valid{...}}, epochs, batch_size, seed, grad_accum, ema,
    early_stop, trace.  The weights come from
    ``io.weights.init_params(model cfg, seed, device)``.
    """

    def __init__(self, cfg: Dict[str, Any], device=None):
        from mlcomp_tpu_torch.data.datasets import create_dataset
        from mlcomp_tpu_torch.io.weights import from_flax_params, init_params
        from mlcomp_tpu_torch.models import create_model

        _refuse(cfg)
        self.cfg = dict(cfg)
        self.device = resolve_device(device)
        self.seed = int(cfg.get("seed", 0))
        model_cfg = dict(cfg["model"])
        self.model = create_model(model_cfg, device=self.device)
        m = self.model
        arch = {"vocab_size": m.vocab_size, "hidden": m.hidden, "layers": len(m.layers),
                "heads": m.heads, "kv_heads": m.kv_heads, "mlp_dim": m.mlp_dim}
        params = init_params(arch, self.seed, device=self.device)
        self.model.load_state(from_flax_params(params, fold=False), train=True)
        self.loss_fn = create_loss(cfg.get("loss", "cross_entropy"))
        self.metric_fns = create_metrics(cfg.get("metrics", ["accuracy"]))
        self.tx = create_optimizer(cfg.get("optimizer", {"name": "adam", "lr": 1e-3}))
        self.epochs = int(cfg.get("epochs", 1))

        # host-side span tracing: cfg trace: true | {path: out.json}; the
        # tracer is installed globally only for the duration of fit()
        trace_cfg = cfg.get("trace")
        self.tracer: Optional[Tracer] = None
        self.trace_path: Optional[str] = None
        if trace_cfg:
            tc = trace_cfg if isinstance(trace_cfg, dict) else {}
            self.trace_path = tc.get("path", "trace.json")
            self.tracer = Tracer(self.trace_path)

        self.loaders: Dict[str, DataLoader] = {}
        for split, dcfg in cfg.get("data", {}).items():
            bs = int(dcfg.get("batch_size", cfg.get("batch_size", 64)))
            self.loaders[split] = DataLoader(
                create_dataset(dcfg), batch_size=bs,
                shuffle=bool(dcfg.get("shuffle", split == "train")), seed=self.seed,
                drop_last=bool(dcfg.get("drop_last", split == "train")), device=self.device,
            )
        if not self.loaders:
            raise ValueError("Trainer needs at least one data split configured")

        self.state = TrainState.create(self.model, self.tx,
                                       ema_decay=float(cfg.get("ema", 0.0) or 0.0))
        self._train_step = make_train_step(self.loss_fn, self.metric_fns,
                                           grad_accum=int(cfg.get("grad_accum", 1)))
        self._eval_step = make_eval_step(self.loss_fn, self.metric_fns)

    def _loader(self, split: str) -> DataLoader:
        if split not in self.loaders:
            raise KeyError(f"no {split!r} data configured")
        return self.loaders[split]

    @property
    def n_params(self) -> int:
        return param_count(self.state.params)

    def train_epoch(self) -> Dict[str, float]:
        from mlcomp_tpu_torch.utils.preempt import TaskPreempted, preemption_requested

        agg: Dict[str, Any] = {}
        n = 0
        tracer = self.tracer if self.tracer is not None else get_tracer()
        it = iter(self._loader("train"))
        while True:
            if preemption_requested():
                # between steps, so the state is a consistent post-step
                # state; the executor saves it and the worker requeues
                raise TaskPreempted(f"preemption requested at step {self.state.step}")
            # a fat "data" span means the input pipeline starves the card;
            # a fat "step" span means the host waited on the device
            with tracer.span("data", split="train"):
                batch = next(it, None)
            if batch is None:
                break
            with tracer.span("step", n=n):
                stats = self._train_step(self.state, batch)
            for k, v in stats.items():
                agg[k] = agg.get(k, 0.0) + v  # device-side accumulation
            n += 1
        return {k: float(v) / max(n, 1) for k, v in agg.items()}

    def eval_epoch(self, split: str = "valid") -> Dict[str, float]:
        agg: Dict[str, Any] = {}
        n = 0
        for batch in self._loader(split):
            stats = self._eval_step(self.state, batch)
            for k, v in stats.items():
                agg[k] = agg.get(k, 0.0) + v
            n += 1
        return {k: float(v) / max(n, 1) for k, v in agg.items()}

    def fit(self, on_epoch: Optional[Callable[[int, Dict[str, float]], None]] = None
            ) -> Dict[str, float]:
        """Run up to ``epochs`` total; resume-aware: a restored state that
        already completed k epochs (by step count) runs only the remainder,
        and epoch numbers continue from k.

        ``early_stop`` (``{metric: valid/loss, mode: min, patience: 3,
        min_delta: 0}`` or ``true``) stops when the metric has not improved
        for ``patience`` epochs; the stopping epoch is ``stopped_early``."""
        es = self.cfg.get("early_stop")
        es = {} if es is True else (dict(es) if es else None)
        if es is not None:
            es_metric = es.get("metric", "valid/loss")
            es_mode = es.get("mode", "min")
            if es_mode not in ("min", "max"):
                raise ValueError(f"early_stop.mode must be min|max, got {es_mode!r}")
            es_patience = int(es.get("patience", 3))
            es_delta = float(es.get("min_delta", 0.0))
            es_best: Optional[float] = None
            es_since = 0
            es_warned = False
        self.stopped_early: Optional[int] = None

        last: Dict[str, float] = {}
        tracer = self.tracer if self.tracer is not None else get_tracer()
        if self.tracer is not None:
            set_tracer(self.tracer)
        try:
            for epoch in range(self.epochs_done, self.epochs):
                t0 = time.perf_counter()
                with tracer.span("train_epoch", epoch=epoch):
                    train_stats = self.train_epoch()
                stats = {f"train/{k}": v for k, v in train_stats.items()}
                if "valid" in self.loaders:
                    with tracer.span("eval_epoch", epoch=epoch):
                        stats.update({f"valid/{k}": v
                                      for k, v in self.eval_epoch("valid").items()})
                stats["epoch_time_s"] = time.perf_counter() - t0
                tracer.counter("loss", {"train": stats.get("train/loss", 0.0)})
                if on_epoch is not None:
                    on_epoch(epoch, stats)
                last = stats
                if es is not None:
                    if es_metric not in stats:
                        if not es_warned:
                            es_warned = True
                            logging.getLogger("mlcomp_tpu_torch.trainer").warning(
                                "early_stop metric %r not in epoch stats (have: %s); "
                                "early stopping is inactive", es_metric, sorted(stats))
                    else:
                        v = float(stats[es_metric])
                        if metric_improved(v, es_best, es_mode, es_delta):
                            es_best, es_since = v, 0
                        else:
                            es_since += 1
                            if es_since >= es_patience:
                                self.stopped_early = epoch
                                break
        finally:
            if self.tracer is not None:
                set_tracer(None)
        if self.trace_path and self.tracer is not None:
            self.tracer.save(self.trace_path)
        return last

    @torch.no_grad()
    def predict(self, split: str = "infer", return_labels: bool = False):
        """Forward pass over a split; returns stacked host outputs (padding
        rows of non-drop_last tail batches stripped via ``valid``).
        ``return_labels=True`` also returns the labels of the same batches."""
        outs, labels = [], []
        for batch in self._loader(split):
            with self.state.eval_params() as model:
                out = model(batch["x"]).float().cpu().numpy()
            y = batch["y"].cpu().numpy() if "y" in batch else None
            if "valid" in batch:
                keep = batch["valid"].cpu().numpy() > 0
                out = out[keep]
                y = y[keep] if y is not None else None
            outs.append(out)
            if y is not None:
                labels.append(y)
        preds = np.concatenate(outs, axis=0)
        if return_labels:
            return preds, (np.concatenate(labels, axis=0) if labels else None)
        return preds

    @property
    def steps_per_epoch(self) -> int:
        return len(self._loader("train")) if "train" in self.loaders else 0

    @property
    def epochs_done(self) -> int:
        """Completed epochs inferred from the step counter: the basis of
        resume-aware epoch accounting."""
        spe = self.steps_per_epoch
        return self.state.step // spe if spe else 0
