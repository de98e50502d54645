"""Inference, validation and generation executors: the port of
mlcomp_tpu/executors/infer.py.

``infer`` restores a train task's checkpoint, forward-passes a dataset and
writes the predictions next to the task; ``valid`` computes the loss and
metrics over the valid split and logs them; ``generate`` decodes
continuations of the ``infer`` (or ``valid``) split's token rows with the
port's ``models.generation.generate``.  Each finds the upstream
checkpoint through an explicit ``ckpt_dir`` arg or through the result of
the task it depends on, and restores weights only
(``io.checkpoint.restore_eval_state``), so the train task's optimizer
config need not be repeated.  ``valid`` stores a ``report:`` section's
dashboard layout; its classification and segmentation reports wait for the
port's classifier models (ROADMAP §A, A11's ``mnist_cnn``): until then such
a section logs a warning and the task validates without it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from mlcomp_tpu_torch.executors.base import ExecutionContext, Executor


def _find_ckpt_dir(ctx: ExecutionContext, args: Dict[str, Any]) -> Optional[str]:
    """Explicit ``ckpt_dir`` arg, else the checkpoint produced by a task
    this one depends on (its own edge: a grid-expanded DAG holds many
    checkpoints)."""
    if args.get("ckpt_dir"):
        return str(args["ckpt_dir"])
    if ctx.store is None:
        return None
    rows = {r["name"]: r for r in ctx.store.task_rows(ctx.dag_id)}
    me = rows.get(ctx.task_name)
    depends = json.loads(me["depends"]) if me else []
    for name in depends:
        row = rows.get(name)
        if row and row["result"]:
            res = json.loads(row["result"])
            if isinstance(res, dict) and "ckpt_dir" in res:
                return res["ckpt_dir"]
    return None


def _restore_trainer(ctx: ExecutionContext, cfg: Dict[str, Any], verb: str):
    """A Trainer from ``cfg`` on the task's device with the upstream
    checkpoint's weights (shared by infer/valid/generate)."""
    from mlcomp_tpu_torch.io.checkpoint import restore_eval_state
    from mlcomp_tpu_torch.train.loop import Trainer

    trainer = Trainer(cfg, device=ctx.device)
    ckpt_dir = _find_ckpt_dir(ctx, cfg)
    if ckpt_dir:
        restore_eval_state(ckpt_dir, trainer.state)
        ctx.log(f"restored checkpoint from {ckpt_dir}")
    else:
        ctx.log(f"no checkpoint found; {verb} with fresh params", level="warning")
    return trainer


class InferExecutor(Executor):
    name = "infer"

    def work(self, ctx: ExecutionContext) -> Optional[Dict[str, Any]]:
        cfg = dict(self.args)
        out_path = Path(cfg.pop("out", Path(ctx.workdir) / f"{ctx.task_name}_preds.npz"))
        trainer = _restore_trainer(ctx, cfg, "inferring")
        split = "infer" if "infer" in trainer.loaders else "valid"
        # labels ride along batch-aligned when the split has them
        preds, labels = trainer.predict(split, return_labels=True)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        if labels is not None:
            np.savez_compressed(out_path, preds=preds, labels=labels)
        else:
            np.savez_compressed(out_path, preds=preds)
        ctx.log(f"wrote {preds.shape} predictions -> {out_path}")
        return {"preds": str(out_path), "n": int(preds.shape[0])}


class ValidExecutor(Executor):
    name = "valid"

    def work(self, ctx: ExecutionContext) -> Optional[Dict[str, Any]]:
        cfg = dict(self.args)
        report_cfg = cfg.pop("report", None)
        trainer = _restore_trainer(ctx, cfg, "validating")
        if report_cfg is not None:
            from mlcomp_tpu_torch.report.artifacts import publish_layout

            publish_layout(ctx, report_cfg)
        # a layout-only section declares dashboard panels and asks for no
        # data report
        layout_only = isinstance(report_cfg, dict) and set(report_cfg) == {"layout"}
        if report_cfg is not None and report_cfg is not False and not layout_only:
            ctx.log("classification and segmentation reports wait for the port's classifier "
                    "models (mnist_cnn); the task validates without one", level="warning")
        stats = trainer.eval_epoch("valid")
        for k, v in stats.items():
            ctx.metric(f"valid/{k}", v)
        ctx.log("valid: " + " ".join(f"{k}={v:.4f}" for k, v in sorted(stats.items())))
        return {k: float(v) for k, v in stats.items()}


class GenerateExecutor(Executor):
    """Autoregressive generation from a trained LM checkpoint: prompts are
    the ``infer`` (or ``valid``) split's token rows (left-padded with
    ``pad_id``, masked unless ``mask_prompt_padding: false``); the knobs
    ``max_new_tokens``, ``temperature``, ``top_k``, ``top_p``, ``eos_id``,
    ``pad_id``, ``gen_seed`` and ``quantize`` ride in the args.  Output: an
    ``.npz`` of the ids, prompt included.  Sampled tokens come from a
    ``torch.Generator`` seeded with ``gen_seed``: other draws than the JAX
    package's; greedy ids are the same."""

    name = "generate"

    def work(self, ctx: ExecutionContext) -> Optional[Dict[str, Any]]:
        from mlcomp_tpu_torch.io.weights import unflatten
        from mlcomp_tpu_torch.models import create_model
        from mlcomp_tpu_torch.models.generation import generate, load_decode_weights

        cfg = dict(self.args)
        out_path = Path(cfg.pop("out", Path(ctx.workdir) / f"{ctx.task_name}_gen.npz"))
        knobs = {
            "temperature": float(cfg.pop("temperature", 0.0)),
            "top_k": cfg.pop("top_k", None),
            "top_p": cfg.pop("top_p", None),
            "eos_id": cfg.pop("eos_id", None),
            "pad_id": int(cfg.pop("pad_id", 0)),
        }
        n_new = int(cfg.pop("max_new_tokens", 32))
        for key, cast in (("top_k", int), ("top_p", float), ("eos_id", int)):
            if knobs[key] is not None:
                knobs[key] = cast(knobs[key])
        seed = int(cfg.pop("gen_seed", 0))
        mask_padding = bool(cfg.pop("mask_prompt_padding", True))
        quantize = cfg.pop("quantize", False)
        if cfg.pop("weights_dtype", None) is not None:
            ctx.log("weights_dtype: the port decodes in the model's dtype; ignored",
                    level="warning")

        trainer = _restore_trainer(ctx, cfg, "generating")
        split = "infer" if "infer" in trainer.loaders else "valid"
        # a serving model with the trainer's weights (flat flax paths)
        model = create_model(dict(cfg["model"]), device=trainer.device)
        tree = unflatten({k: v.detach() for k, v in trainer.state.params.items()})
        mode = load_decode_weights(model, tree, quantize)
        if mode is not None:
            ctx.log("int8 weight-only quantization enabled for decoding"
                    + (" (int8 kernel path)" if mode == "kernel" else ""))
        gen = torch.Generator(device=trainer.device).manual_seed(seed)
        outs = []
        for batch in trainer._loader(split):
            x = batch["x"]
            mask = None
            if mask_padding:
                # a row is real from its first non-pad token on, so a
                # mid-prompt token equal to pad_id stays real
                mask = torch.cumsum((x != knobs["pad_id"]).int(), dim=1) > 0
            ids = generate(model, x, n_new, prompt_mask=mask, generator=gen, **knobs)
            ids = ids.cpu().numpy()
            if "valid" in batch:
                ids = ids[batch["valid"].cpu().numpy() > 0]
            outs.append(ids)
        ids = np.concatenate(outs, axis=0)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(out_path, ids=ids)
        ctx.log(f"generated {ids.shape} token ids -> {out_path}")
        return {"generated": str(out_path), "n": int(ids.shape[0])}
