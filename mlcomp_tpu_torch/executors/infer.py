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
dashboard layout and, unless the section is layout-only, a classification
or segmentation report (``report/artifacts.py``) from the same pass that
computes its metrics.
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


def _widened_sum(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sum two confusion matrices, zero-padding the smaller one: batches
    of pre-argmaxed masks may each observe a different number of classes."""
    n = max(a.shape[0], b.shape[0])
    out = np.zeros((n, n), dtype=a.dtype)
    out[: a.shape[0], : a.shape[1]] += a
    out[: b.shape[0], : b.shape[1]] += b
    return out


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
        stats = None
        if report_cfg is not None and report_cfg is not False and not layout_only:
            # reports are auxiliary: a malformed report option never fails
            # the task; it falls back to the plain eval pass
            try:
                stats = self._valid_with_report(ctx, trainer, report_cfg)
            except Exception as e:
                ctx.log(f"report generation failed: {e!r}", level="error")
        if stats is None:
            stats = trainer.eval_epoch("valid")
        for k, v in stats.items():
            ctx.metric(f"valid/{k}", v)
        ctx.log("valid: " + " ".join(f"{k}={v:.4f}" for k, v in sorted(stats.items())))
        return {k: float(v) for k, v in stats.items()}

    @staticmethod
    def _valid_with_report(ctx: ExecutionContext, trainer, report_cfg: Any) -> Dict[str, float]:
        """One pass over the valid split serves both the report and the
        scalar metrics: each batch's loss and metrics come from the eval
        step ``eval_epoch`` runs (so a report never changes the logged
        values), and the same forward's outputs feed the report.  Segmentation sums a
        pixel confusion matrix per batch; classification keeps at most
        ``max_samples`` score rows.  The payload is stored only after the
        stats succeed."""
        from mlcomp_tpu_torch.report.artifacts import (
            classification_report,
            confusion_matrix,
            segmentation_report_from_confusion,
        )
        from mlcomp_tpu_torch.train.loop import make_eval_step

        # `report: segmentation` == `report: {kind: ...}`; `report: true`
        # == all defaults
        if isinstance(report_cfg, str):
            rc: Dict[str, Any] = {"kind": report_cfg}
        elif isinstance(report_cfg, dict):
            rc = report_cfg
        else:
            rc = {}
        max_samples = int(rc.get("max_samples", 16384))
        ignore_label = rc.get("ignore_label")
        kind = rc.get("kind")
        if kind not in (None, "classification", "segmentation"):
            raise ValueError(f"unknown report kind {kind!r}")
        # explicit classes win; else the dataset's own names (image_folder)
        names = rc.get("classes") or trainer.loaders["valid"].meta.get("_class_names")
        eval_step = make_eval_step(trainer.loss_fn, trainer.metric_fns, with_outputs=True)

        agg: Dict[str, Any] = {}
        n_batches = 0
        cm = None
        kept_p, kept_y, kept_i = [], [], []
        stream_pos = 0  # position in the unfiltered valid stream
        kept_n = 0      # filtered rows kept (fills max_samples)
        truncated = False
        for batch in trainer._loader("valid"):
            per, out_dev = eval_step(trainer.state, batch)
            for k, v in per.items():
                agg[k] = agg.get(k, 0.0) + v  # device-side accumulation
            n_batches += 1

            if "y" not in batch:
                raise ValueError("valid split has no labels")
            out = out_dev.float().cpu().numpy()
            y = batch["y"].cpu().numpy()
            if "valid" in batch:
                keep = batch["valid"].cpu().numpy() > 0
                out, y = out[keep], y[keep]
            if kind is None:
                # spatial labels -> segmentation; per-sample labels with 2-D
                # logits -> classification; anything else has no report
                if out.ndim == y.ndim + 1 and y.ndim >= 2:
                    kind = "segmentation"
                elif out.ndim == 2 and (y.ndim == 1 or y.shape == out.shape):
                    kind = "classification"
                else:
                    raise ValueError(
                        f"cannot infer report kind for outputs {out.shape} vs labels "
                        f"{y.shape}; set report.kind explicitly")
            if kind == "segmentation":
                yp = out.argmax(axis=-1) if out.ndim == y.ndim + 1 else out
                yt, yp = y.astype(np.int64).ravel(), yp.astype(np.int64).ravel()
                m = yt >= 0
                if ignore_label is not None:
                    m &= yt != ignore_label
                yt, yp = yt[m], yp[m]
                # logits fix the class count; pre-argmaxed maps grow it with
                # the classes seen after ignore filtering
                n_cls = out.shape[-1] if out.ndim == y.ndim + 1 else int(
                    max(yt.max(initial=0), yp.max(initial=0))) + 1
                keep2 = (yt < n_cls) & (yp < n_cls)
                delta = confusion_matrix(yt[keep2], yp[keep2], n_cls)
                cm = delta if cm is None else _widened_sum(cm, delta)
            else:
                if y.ndim > 1:  # one-hot / soft labels -> class indices
                    y = y.argmax(axis=-1)
                # stream positions before filtering: gallery indices stay
                # aligned with the (unshuffled) valid stream
                pos = stream_pos + np.arange(len(y))
                stream_pos += len(y)
                m = y >= 0
                if ignore_label is not None:
                    m &= y != ignore_label
                out2, y2, pos2 = out[m], y[m], pos[m]
                room = max_samples - kept_n
                if len(y2) > room:
                    truncated = True
                if room > 0 and len(y2) > 0:
                    kept_p.append(out2[:room].astype(np.float32))
                    kept_y.append(y2[:room])
                    kept_i.append(pos2[:room])
                    kept_n += min(room, len(y2))

        stats = {k: float(v) / max(n_batches, 1) for k, v in agg.items()}
        if (kind == "segmentation" and (cm is None or cm.sum() == 0)) or (
                kind != "segmentation" and kept_n == 0):
            ctx.log("no eligible samples for report", level="warning")
            return stats
        if kind == "segmentation":
            payload = segmentation_report_from_confusion(cm, class_names=names)
        else:
            payload = classification_report(
                np.concatenate(kept_y), np.concatenate(kept_p), class_names=names,
                top_worst=int(rc.get("top_worst", 16)),
                sample_indices=np.concatenate(kept_i))
            if truncated:
                payload["truncated_to"] = kept_n
                ctx.log(f"report kept the first {kept_n} eligible examples (of a "
                        f"{stream_pos}-sample stream)", level="warning")
        ctx.report(rc.get("name", f"{ctx.task_name}_{kind}"), payload)
        ctx.log(f"report: {kind} over {payload.get('n', payload.get('n_pixels'))} samples")
        return stats


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
