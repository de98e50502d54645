"""Trainer: the train/eval steps and the epoch loop.

The port of mlcomp_tpu/train/loop.py, with its config keys and behaviour:
``grad_accum`` (the microbatch-mean gradient, summed in f32), ``ema``,
``early_stop``, resume-aware ``fit`` (``epochs_done`` from the step
count), ``eval_epoch``, ``predict``, preemption between steps, and the
``data``/``step`` spans when ``trace`` is set, and a ``torch.profiler``
window over the steps ``profile`` names.  The step is eager
PyTorch: forward, loss, ``backward()``, then the optimizer's update in
place; no ``torch.compile`` and no CUDA graph.  Per-step losses and
metrics stay on the device and are summed there; the host reads them once
per epoch, as the JAX loop does.

The step's randomness (augmentation draws, mixup's permutation) comes from
a ``torch.Generator`` on the batch's device seeded with ``seed + 1``, and
mixup's lambda from a host ``torch.Generator`` with the same seed: other
streams than the JAX package's ``PRNGKey(seed + 1)`` folds, so augmented
or mixed steps do not repeat the JAX package's draws.

Under a mesh (``mesh: {dp, fsdp, pp, sp, ep, tp}``; every rank of a
``torch.distributed`` group, see ``parallel/distributed.py``) the Trainer
does what the JAX one does with its ``Mesh``: it builds the DeviceMesh
(``MeshSpec.from_config``, the unnamed axis taking the rest), installs it
(``set_current_mesh``) for the models' sequence-, tensor- and
pipeline-parallel paths, places the state by ``spec_for`` (each rank
holds its shards; ``parallel/sharding.py``), feeds each rank its rows of
the global batch, averages gradients over dp x fsdp (and sums them over
the axes the model splits its work over), and reports the global means
of the loss and metrics.  Without a process group the mesh is the one
device, and a mesh axis above 1 is refused as the JAX ``resolve`` refuses
it.
``Trainer(cfg)`` runs on ``cuda``; pass ``device="cpu"`` for the CPU.
"""

from __future__ import annotations

import logging
import math
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
from mlcomp_tpu_torch.utils.profile import create_profiler
from mlcomp_tpu_torch.utils.trace import Tracer, get_tracer, set_tracer


def _gamma(gen: torch.Generator, a: float) -> float:
    """A Gamma(a, 1) draw from ``gen`` (Marsaglia and Tsang)."""
    if a < 1.0:
        u = 1.0 - torch.rand((), generator=gen).item()     # in (0, 1]
        return _gamma(gen, a + 1.0) * u ** (1.0 / a)
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    while True:
        x = torch.randn((), generator=gen).item()
        v = (1.0 + c * x) ** 3
        if v <= 0.0:
            continue
        u = 1.0 - torch.rand((), generator=gen).item()
        if math.log(u) < 0.5 * x * x + d - d * v + d * math.log(v):
            return d * v


def beta_draw(gen: torch.Generator, a: float) -> float:
    """A Beta(a, a) draw from ``gen``: mixup's lambda."""
    g1, g2 = _gamma(gen, a), _gamma(gen, a)
    return g1 / (g1 + g2)


def mixup_batch(batch: Dict[str, torch.Tensor], lam: torch.Tensor, perm: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
    """Blend each example with its partner ``perm`` by the shared ``lam``
    (f32, the dominant weight): x becomes lam x + (1 - lam) x[perm], and the
    partners' labels ride in the batch as ``_mix_y`` (so a grad_accum split
    keeps each row's partner in its microbatch).  The JAX step's mixup
    checks and arithmetic."""
    if "y" not in batch:
        raise ValueError(
            "mixup needs labeled batches (y); it is a classification recipe — drop it for "
            "LM/unlabeled training")
    xb = batch["x"]
    if not torch.is_floating_point(xb):
        raise ValueError(
            f"mixup blends float inputs; x is {xb.dtype} (token ids?) — an integer blend "
            "would silently zero the batch")
    x = lam.to(xb.dtype) * xb + (1.0 - lam).to(xb.dtype) * xb[perm]
    return {**batch, "x": x, "_mix_y": batch["y"][perm]}


def sown_losses(model) -> list:
    """The auxiliary objectives the model's last forward left (the JAX
    modules' sown ``losses`` collection, e.g. MoE's load-balance loss): the
    train step adds each one to the loss.  Per step, not state."""
    fn = getattr(model, "sown_losses", None)
    return fn() if fn is not None else []


def make_train_step(loss_fn, metric_fns: Dict[str, Callable], grad_accum: int = 1,
                    augment_fn=None, mixup_alpha: float = 0.0, seed: int = 0, device=None):
    """The train step: ``step(state, batch) -> stats`` (device scalars).

    The model runs in train mode.  ``augment_fn(gen, x)`` (data/augment.py)
    rewrites ``batch["x"]`` first, without gradients; ``mixup_alpha > 0``
    then blends the batch (:func:`mixup_batch`, lambda ~ Beta(alpha,
    alpha), the larger of lambda and 1 - lambda) and the loss becomes
    lam loss(y) + (1 - lam) loss(y[perm]); metrics score against y.  Both
    draw from generators seeded with ``seed + 1``, the batches' ``device``'s
    and the host's.

    The loss adds every auxiliary objective the forward sowed
    (:func:`sown_losses`), as the JAX step adds its ``losses`` collection.

    ``grad_accum > 1`` splits the batch into that many equal microbatches,
    sums their gradients in f32 (the parameters' ``.grad``) and applies the
    optimizer once to the mean: the microbatch-mean semantics of the JAX
    step (masked losses weigh each microbatch's mean equally).  Loss and
    metrics report the microbatch average; BatchNorm statistics update
    once a microbatch, in order, as the JAX step's scan carries them."""
    gen = torch.Generator(device=device or "cpu").manual_seed(seed + 1)
    host_gen = torch.Generator().manual_seed(seed + 1)

    def grads_of(model, batch, lam):
        outputs = model(batch["x"])
        loss = loss_fn(outputs, batch)
        if lam is not None:
            # convex label combination: exact mixup for CE-family losses
            loss = lam * loss + (1.0 - lam) * loss_fn(outputs, {**batch, "y": batch["_mix_y"]})
        for aux in sown_losses(model):
            loss = loss + aux.sum()
        loss.backward()
        with torch.no_grad():
            stats = {"loss": loss.detach()}
            for name, fn in metric_fns.items():
                stats[name] = fn(outputs.detach(), batch)
        return stats

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.model.train()
        binding = state.binding
        # under a mesh the model computes on this step's views of the
        # sharded parameters, and their gradients become the state's
        params = (state.params if binding is None
                  else binding.bind(state.params, requires_grad=True))
        for p in params.values():
            p.grad = None
        if augment_fn is not None:
            with torch.no_grad():
                batch = {**batch, "x": augment_fn(gen, batch["x"])}
        lam = None
        if mixup_alpha > 0.0:
            x = batch["x"]
            w = beta_draw(host_gen, mixup_alpha)
            lam = torch.tensor(max(w, 1.0 - w), dtype=torch.float32).to(x.device)
            perm = torch.randperm(x.shape[0], generator=gen, device=x.device)
            with torch.no_grad():
                batch = mixup_batch(batch, lam, perm)
        if grad_accum == 1:
            stats = grads_of(state.model, batch, lam)
        else:
            b = batch["x"].shape[0]
            if b % grad_accum:
                raise ValueError(f"batch size {b} not divisible by grad_accum={grad_accum}")
            m = b // grad_accum
            per = [grads_of(state.model, {k: v[i * m:(i + 1) * m] for k, v in batch.items()}, lam)
                   for i in range(grad_accum)]
            stats = {k: torch.stack([s[k] for s in per]).mean() for k in per[0]}
            with torch.no_grad():
                for p in params.values():
                    if p.grad is not None:
                        p.grad.div_(grad_accum)
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        if binding is not None:
            grads = binding.reduce_grads(grads, state.params)
            stats = binding.reduce_stats(stats)
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


def make_eval_step(loss_fn, metric_fns: Dict[str, Callable], with_outputs: bool = False):
    """``step(state, batch) -> stats`` in eval mode (EMA weights when the
    state tracks them); ``with_outputs`` also returns the outputs, for the
    valid executor's report, which reads both from one forward."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        state.model.eval()
        with state.eval_params() as model:
            if state.binding is not None:
                state.binding.bind(state.params, requires_grad=False)
            outputs = model(batch["x"])
        stats = {"loss": loss_fn(outputs, batch)}
        for name, fn in metric_fns.items():
            stats[name] = fn(outputs, batch)
        if state.binding is not None:
            stats = state.binding.reduce_stats(stats)
        return (stats, outputs) if with_outputs else stats

    return eval_step


def build_mesh(cfg: Dict[str, Any], device: torch.device):
    """The Trainer's mesh: a DeviceMesh over the process group's ranks
    (``MeshSpec.from_config(cfg["mesh"])``), or None for a process alone,
    where every axis must resolve to 1."""
    from mlcomp_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    spec = MeshSpec.from_config(cfg.get("mesh"))
    if not torch.distributed.is_initialized():
        spec.resolve(1)
        return None
    return make_mesh(spec, device_type=device.type)


class Trainer:
    """Config-driven trainer used by the train executor.

    cfg keys: model{name,...}, optimizer{name,lr,...}, loss, metrics[list],
    data{train{...}, valid{...}}, epochs, batch_size, seed, grad_accum, ema,
    early_stop, trace, profile{dir, start_step, num_steps}, augment, mixup.
    The weights are drawn from ``seed``: ``io.weights.init_params`` for
    ``transformer_lm``, the model's own ``init_variables`` (params and
    BatchNorm statistics, shapes from the first split's first example, as
    the JAX Trainer's ``init_model``) for the zoo.
    """

    def __init__(self, cfg: Dict[str, Any], device=None):
        from mlcomp_tpu_torch.data.augment import build_augment
        from mlcomp_tpu_torch.data.datasets import create_dataset
        from mlcomp_tpu_torch.io.weights import from_flax_params, init_params
        from mlcomp_tpu_torch.models import create_model

        from mlcomp_tpu_torch.parallel.mesh import batch_sharding, set_current_mesh
        from mlcomp_tpu_torch.parallel.sharding import make_sharded_state

        self.cfg = dict(cfg)
        self.device = resolve_device(device)
        self.mesh = build_mesh(cfg, self.device)
        # models reach the mesh for their sequence/tensor/pipeline paths
        set_current_mesh(self.mesh)
        self.seed = int(cfg.get("seed", 0))
        self.loss_fn = create_loss(cfg.get("loss", "cross_entropy"))
        self.metric_fns = create_metrics(cfg.get("metrics", ["accuracy"]))
        self.tx = create_optimizer(cfg.get("optimizer", {"name": "adam", "lr": 1e-3}))
        self.epochs = int(cfg.get("epochs", 1))
        augment_fn = build_augment(cfg.get("augment"))

        # host-side span tracing: cfg trace: true | {path: out.json}; the
        # tracer is installed globally only for the duration of fit()
        trace_cfg = cfg.get("trace")
        self.tracer: Optional[Tracer] = None
        self.trace_path: Optional[str] = None
        if trace_cfg:
            tc = trace_cfg if isinstance(trace_cfg, dict) else {}
            self.trace_path = tc.get("path", "trace.json")
            self.tracer = Tracer(self.trace_path)
        # device profiling: a torch.profiler window over global steps
        # [start_step, start_step + num_steps), written into dir
        self.profiler = create_profiler(cfg.get("profile"), device=self.device)

        self.loaders: Dict[str, DataLoader] = {}
        for split, dcfg in cfg.get("data", {}).items():
            bs = int(dcfg.get("batch_size", cfg.get("batch_size", 64)))
            self.loaders[split] = DataLoader(
                create_dataset(dcfg), batch_size=bs,
                shuffle=bool(dcfg.get("shuffle", split == "train")), seed=self.seed,
                drop_last=bool(dcfg.get("drop_last", split == "train")), device=self.device,
                shard=batch_sharding(self.mesh),
            )
        if not self.loaders:
            raise ValueError("Trainer needs at least one data split configured")

        # under a mesh the weights are drawn on the host, and each rank
        # keeps only its shards on the device (make_sharded_state)
        init_dev = self.device if self.mesh is None else torch.device("cpu")
        self.model = create_model(dict(cfg["model"]), device=init_dev)
        m = self.model
        if hasattr(m, "load_variables"):
            # the zoo: shapes from one example of the first split, as the
            # JAX Trainer's init_model reads them
            split0 = "train" if "train" in self.loaders else next(iter(self.loaders))
            sample_shape = (1,) + tuple(self.loaders[split0].data["x"].shape[1:])
            params, model_state = m.init_variables(self.seed, init_dev, sample_shape)
            m.load_variables(params, model_state, train=True)
        else:
            params = init_params(m.arch(), self.seed, device=init_dev)
            m.load_state(from_flax_params(params, fold=False), train=True)

        ema_decay = float(cfg.get("ema", 0.0) or 0.0)
        if self.mesh is None:
            self.state = TrainState.create(self.model, self.tx, ema_decay=ema_decay)
        else:
            self.state, self.state_specs = make_sharded_state(
                self.model, self.tx, self.mesh, ema_decay=ema_decay)
            if hasattr(m, "device"):
                m.device = self.device
        self._train_step = make_train_step(
            self.loss_fn, self.metric_fns, grad_accum=int(cfg.get("grad_accum", 1)),
            augment_fn=augment_fn, mixup_alpha=float(cfg.get("mixup", 0.0) or 0.0),
            seed=self.seed, device=self.device)
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
        global_step = self.state.step
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
            if self.profiler is not None:
                # opens or closes the window; a close synchronizes the card
                # first, so queued launches stay inside the window
                self.profiler.step(global_step + n)
            with tracer.span("step", n=n):
                stats = self._train_step(self.state, batch)
            for k, v in stats.items():
                agg[k] = agg.get(k, 0.0) + v  # device-side accumulation
            n += 1
        if self.profiler is not None:
            # a window still open closes here: eval work stays out of it
            self.profiler.close()
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
            if self.profiler is not None:
                self.profiler.close()
        if self.trace_path and self.tracer is not None:
            self.tracer.save(self.trace_path)
        return last

    @torch.no_grad()
    def predict(self, split: str = "infer", return_labels: bool = False):
        """Forward pass over a split; returns stacked host outputs (padding
        rows of non-drop_last tail batches stripped via ``valid``).
        ``return_labels=True`` also returns the labels of the same batches."""
        outs, labels = [], []
        self.model.eval()
        binding = self.state.binding
        for batch in self._loader(split):
            with self.state.eval_params() as model:
                if binding is not None:
                    # every rank predicts the whole global batch
                    binding.bind(self.state.params, requires_grad=False)
                    batch = {k: binding.gather_rows(v) for k, v in batch.items()}
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
