"""Train executor: the port of mlcomp_tpu/executors/train.py.

Builds a :class:`~mlcomp_tpu_torch.train.loop.Trainer` on the task's
device (``ExecutionContext.device``; ``None`` means ``cuda``) from the
same YAML args as the JAX executor, logs per-epoch metrics to the task
store, checkpoints into model storage (the port's own format, see
``io/checkpoint.py``), keeps the best-metric checkpoint, resumes from the
newest checkpoint, saves a checkpoint on preemption, and writes epoch
checkpoints asynchronously.  Registered as ``train`` and ``catalyst``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

from mlcomp_tpu_torch.executors.base import ExecutionContext, Executor


def _still_owns_task(ctx: ExecutionContext) -> bool:
    """True unless the store SHOWS this attempt lost the task (stopped,
    or reassigned to another worker).  Store problems err toward True:
    the preemption checkpoint is the feature, the stale-writer race is
    the narrow exception — and a reassignment implies a reachable store."""
    if ctx.store is None:
        return True
    try:
        row = ctx.store.task_row(ctx.task_id)
    except Exception:
        return True
    if row is None or row["status"] != "in_progress":
        return False
    return ctx.worker is None or row["worker"] == ctx.worker


class TrainExecutor(Executor):
    name = "train"

    def work(self, ctx: ExecutionContext) -> Optional[Dict[str, Any]]:
        from mlcomp_tpu_torch.io.checkpoint import latest_step, restore_checkpoint, save_checkpoint
        from mlcomp_tpu_torch.io.storage import ModelStorage
        from mlcomp_tpu_torch.train.loop import Trainer

        cfg = dict(self.args)
        # declarative dashboard layout (report/artifacts.py): a train
        # task's `report: {layout: [...]}` picks its metric panels
        report_cfg = cfg.pop("report", None)
        if report_cfg is not None:
            from mlcomp_tpu_torch.report.artifacts import publish_layout

            publish_layout(ctx, report_cfg)
        storage = ModelStorage(cfg.pop("storage_root", None))
        project = cfg.pop("project", "default")
        # Default storage namespace: dag id + the dag row's creation time.
        # The id alone collides across independent submissions (every fresh
        # local-runner db starts at dag 1, same project/task names), which
        # made a second run "resume" the first run's incompatible
        # checkpoint.  The timestamp is stable across restarts/requeues of
        # the SAME dag row, so intentional resume still works; an explicit
        # dag_name arg opts into cross-run sharing.
        dag_name = cfg.pop("dag_name", None)
        if dag_name is None:
            dag_name = f"dag{ctx.dag_id}"
            if ctx.store is not None:
                created = ctx.store.dag_created(ctx.dag_id)
                if created is not None:
                    dag_name = f"dag{ctx.dag_id}-{int(created * 1000)}"
        ckpt_dir = storage.checkpoint_dir(project, dag_name, ctx.task_name)
        # Catalyst parity (main_metric/minimize_metric): track the best
        # epoch by a named metric and keep its checkpoint separately
        best_metric = cfg.pop("best_metric", None)
        best_mode = cfg.pop("best_mode", "max")
        if best_mode not in ("max", "min"):
            raise ValueError(f"best_mode must be max|min, got {best_mode!r}")
        best: Dict[str, Any] = {"value": None, "epoch": None, "step": None}
        best_dir = str(Path(ckpt_dir) / "best")
        # resume-safe: a restarted task must not let a worse post-restart
        # epoch overwrite the pre-restart best checkpoint
        meta_prior = storage.read_meta(project, dag_name, ctx.task_name)
        prior = meta_prior.get("best")
        if best_metric and prior and prior.get("metric") == best_metric:
            best.update(
                value=prior.get("value"),
                epoch=prior.get("epoch"),
                step=prior.get("step"),
            )
        _warned_missing = [False]

        # trace: true → spans land next to the checkpoints
        if cfg.get("trace") and not (
            isinstance(cfg["trace"], dict) and "path" in cfg["trace"]
        ):
            cfg["trace"] = {"path": str(Path(ckpt_dir) / "trace.json")}

        trainer = Trainer(cfg, device=ctx.device)
        ctx.log(
            f"model={cfg['model'].get('name')} params={trainer.n_params:,} "
            f"device={trainer.device}"
        )

        # resume if a checkpoint exists (restart-safe training tasks)
        verdict_stands: Optional[Dict[str, Any]] = None
        start_step = latest_step(ckpt_dir)
        if start_step is not None and cfg.get("resume", True):
            trainer.state = restore_checkpoint(ckpt_dir, trainer.state)
            ctx.log(f"resumed from checkpoint step {start_step}")
            # a prior run's early-stop decision stands on resume — but only
            # while neither the epoch budget nor the early_stop criteria
            # changed (a user relaxing patience/metric expects training to
            # continue); patience counters themselves are not persisted
            es_prior = meta_prior.get("early_stopped")
            if (
                es_prior is not None
                and cfg.get("early_stop")
                and int(es_prior.get("epochs", -1)) == trainer.epochs
                and es_prior.get("config") == cfg.get("early_stop")
            ):
                verdict_stands = es_prior
                ctx.log(
                    f"early stop from prior run stands (epoch"
                    f" {es_prior.get('epoch')}); skipping training"
                )
                trainer.epochs = trainer.epochs_done  # fit() runs nothing

        # async epoch checkpoints: the device snapshot happens before
        # save() returns (donation-safe), the disk write overlaps the next
        # epoch; closed before any latest_step/restore on these dirs
        from mlcomp_tpu_torch.io.checkpoint import AsyncCheckpointWriter

        from mlcomp_tpu_torch.parallel.distributed import sync_hosts

        # a gang task: every slot saves (the shards' gather is collective),
        # slot 0 alone writes
        writer = AsyncCheckpointWriter(ckpt_dir, primary=ctx.primary)
        best_writer: Optional[AsyncCheckpointWriter] = None

        def on_epoch(epoch: int, stats: Dict[str, float]) -> None:
            nonlocal best_writer
            for k, v in stats.items():
                ctx.metric(k, v, step=epoch)
            ctx.log(
                f"epoch {epoch}: "
                + " ".join(f"{k}={v:.4f}" for k, v in sorted(stats.items()))
            )
            if (epoch + 1) % int(cfg.get("ckpt_every", 1)) == 0:
                writer.save(trainer.state, step=int(trainer.state.step))
            if best_metric and best_metric not in stats:
                if not _warned_missing[0]:
                    _warned_missing[0] = True
                    ctx.log(
                        f"best_metric {best_metric!r} not in epoch stats"
                        f" (have: {sorted(stats)}); no best checkpoint"
                        " will be tracked",
                        level="warning",
                    )
            if best_metric and best_metric in stats:
                from mlcomp_tpu_torch.train.loop import metric_improved

                v = float(stats[best_metric])
                if metric_improved(v, best["value"], best_mode):
                    best.update(
                        value=v, epoch=epoch, step=int(trainer.state.step)
                    )
                    if best_writer is None:
                        best_writer = AsyncCheckpointWriter(best_dir, primary=ctx.primary)
                    best_writer.save(trainer.state, step=int(trainer.state.step))
                    ctx.log(
                        f"new best {best_metric}={v:.4f} @ epoch {epoch}"
                        f" -> {best_dir}"
                    )

        from mlcomp_tpu_torch.utils.preempt import TaskPreempted

        try:
            try:
                final = trainer.fit(on_epoch=on_epoch)
            finally:
                # writers close before any other manager touches these
                # dirs (the preemption save below included)
                writer.close()
                if best_writer is not None:
                    best_writer.close()
                # the slots read the checkpoint directory only once the
                # primary's writes are in it
                sync_hosts("train-ckpt")
        except TaskPreempted:
            # checkpoint the consistent between-steps state so the
            # requeued attempt resumes here instead of the last epoch
            # boundary; then let the marker propagate — the worker
            # requeues preempted tasks without consuming a retry.
            # Ownership re-check first: the same SIGTERM also arrives
            # when a STOPPED or REASSIGNED task's child is killed, and a
            # stale attempt must not write into a checkpoint dir the
            # task's new owner may be using concurrently.
            if not _still_owns_task(ctx):
                ctx.log(
                    "preemption signal for a stopped/reassigned attempt; "
                    "skipping the checkpoint",
                    level="warning",
                )
                raise
            cur = int(trainer.state.step)
            if latest_step(ckpt_dir) != cur:
                save_checkpoint(ckpt_dir, trainer.state, step=cur, primary=ctx.primary)
            ctx.log(
                f"preempted at step {cur}; checkpoint saved, task will "
                f"resume on requeue",
                level="warning",
            )
            raise
        if trainer.stopped_early is not None:
            ctx.log(f"early stop at epoch {trainer.stopped_early}")
        if trainer.trace_path:
            ctx.log(f"trace written to {trainer.trace_path}")
        cur = int(trainer.state.step)
        if latest_step(ckpt_dir) != cur:  # avoid re-saving the epoch save
            save_checkpoint(ckpt_dir, trainer.state, step=cur, primary=ctx.primary)
        sync_hosts("train-final")
        ckpt_path = str(Path(ckpt_dir) / str(cur))
        meta: Dict[str, Any] = {
            "final": final,
            "params": trainer.n_params,
            "ckpt": ckpt_path,
        }
        result: Dict[str, Any] = {
            "ckpt_dir": str(ckpt_dir),
            "final": final,
            "params": trainer.n_params,
        }
        if best_metric and best["value"] is not None:
            meta["best"] = dict(best, metric=best_metric)
            result["best"] = dict(best, metric=best_metric, ckpt_dir=best_dir)
        if trainer.stopped_early is not None:
            meta["early_stopped"] = {
                "epoch": trainer.stopped_early,
                "epochs": trainer.epochs,
                "config": cfg.get("early_stop"),
            }
            result["early_stopped"] = trainer.stopped_early
        elif verdict_stands is not None:
            meta["early_stopped"] = verdict_stands
            result["early_stopped"] = verdict_stands.get("epoch")
        # a skipped run (zero fit epochs) must not clobber the prior final
        if not final and meta_prior.get("final"):
            final = meta_prior["final"]
            meta["final"] = final
            result["final"] = final
        if ctx.primary:
            storage.write_meta(project, dag_name, ctx.task_name, meta)
        return result


class CatalystAlias(TrainExecutor):
    """YAML parity: reference DAGs say ``type: catalyst``."""

    name = "catalyst"
