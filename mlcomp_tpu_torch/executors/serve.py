"""serve_replica executor: a serve daemon as a scheduler task (the port of
mlcomp_tpu/executors/serve.py).

The fleet's :class:`~mlcomp_tpu_torch.fleet.manager.SchedulerLauncher`
submits one single-task DAG per replica with this executor; any Worker
claims it, the daemon binds (an ephemeral port by default, so that many
replicas share a host), publishes its URL into the fleet registry file
before its warmup, and serves until the task is stopped.  Then it shuts the
HTTP server down, removes its registry entry and returns a small stats
result.

The replica runs on the task's device (``ExecutionContext.device``, the
worker's ``--device``; ``None`` means ``cuda``): without a card and
without ``--device cpu`` it fails, as every entry point of the port does.

Stop paths, in both execution modes:

- **isolated child**: the worker's stop-watch kills the child when
  ``store.stop_task`` flips the row; the registry entry stays behind until
  the manager or the next incarnation's ``update_entry`` replaces it.
- **in-process** (``isolate=False``): the executor polls its own task row
  every ``stop_poll_s`` and returns once the row is no longer ours.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from mlcomp_tpu_torch.dag.schema import TaskStatus
from mlcomp_tpu_torch.executors.base import ExecutionContext, Executor


class ServeReplicaExecutor(Executor):
    name = "serve_replica"

    def work(self, ctx: ExecutionContext) -> Optional[Dict[str, Any]]:
        from mlcomp_tpu_torch.fleet.registry import remove_entry, update_entry
        from mlcomp_tpu_torch.serve import load_service, make_http_server

        args = dict(ctx.args)
        args.pop("code_src", None)
        args.pop("code_import", None)
        model_cfg = args.pop("model", None)
        if not isinstance(model_cfg, dict):
            raise ValueError("serve_replica needs a 'model' config mapping")
        replica = str(args.pop("replica", ctx.task_name))
        registry_path = args.pop("registry", None)
        host = str(args.pop("host", "127.0.0.1"))
        if host == "auto":
            # the address other hosts reach this worker at
            from mlcomp_tpu_torch.scheduler.worker import host_address

            host = host_address()
        port = int(args.pop("port", 0))
        ckpt = args.pop("ckpt", None)
        storage_task = args.pop("storage_task", None)
        if not ckpt and storage_task:
            # resolved here, on the worker that serves: model storage lives
            # on this host, not wherever the fleet submitted the task from
            from mlcomp_tpu_torch.serve import resolve_storage_ckpt

            parts = str(storage_task).split("/")
            if len(parts) != 3:
                raise ValueError(f"storage_task must be PROJECT/DAG/TASK, got {storage_task!r}")
            ckpt = resolve_storage_ckpt(*parts)
        warmup = bool(args.pop("warmup", False))
        stop_poll_s = float(args.pop("stop_poll_s", 1.0))
        # the other args go to the GenerationService: the knobs `serve`
        # takes as flags
        service = load_service(model_cfg, ckpt_path=ckpt, device=ctx.device, **args)
        httpd = None
        url = None
        try:
            httpd = make_http_server(service, host, port, str(model_cfg.get("name", "model")))
            url = f"http://{host}:{httpd.server_address[1]}"
            if registry_path:
                # published before the warmup: the manager's health polls
                # read ready=false until it ends, and route around it
                update_entry(registry_path, replica, url=url, state="starting")
            ctx.log(f"replica {replica} serving at {url}")
            t = threading.Thread(target=httpd.serve_forever, daemon=True)
            t.start()
            if warmup:
                service.warmup()
            while self._still_mine(ctx):
                time.sleep(stop_poll_s)
            ctx.log(f"replica {replica} stopping (task no longer ours)")
            return {"url": url, "replica": replica,
                    **{k: service.stats().get(k) for k in ("requests", "healthy")}}
        finally:
            if httpd is not None:
                httpd.shutdown()
                httpd.server_close()
            service.close()
            if registry_path and url is not None:
                try:
                    remove_entry(registry_path, replica)
                except OSError:
                    pass

    @staticmethod
    def _still_mine(ctx: ExecutionContext) -> bool:
        """Keep serving only while the task row is IN_PROGRESS under our
        worker: a stop, a reap or a re-claim flips that within one poll."""
        if ctx.store is None:
            return True
        try:
            row = ctx.store.task_row(ctx.task_id)
        except Exception:
            return True  # a store hiccup must not kill the daemon
        if row is None or row["status"] != TaskStatus.IN_PROGRESS.value:
            return False
        return ctx.worker is None or row["worker"] == ctx.worker
