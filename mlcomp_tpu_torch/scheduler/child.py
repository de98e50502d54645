"""Per-task child process: the executor isolation boundary.

The port's copy of mlcomp_tpu/scheduler/child.py.  One OS process per
task with env-pinned device visibility.  The worker writes a spec JSON
({db, claim, workdir, process_id, device, ...}), spawns ``python -m
mlcomp_tpu_torch.scheduler.child <spec>``, and reads the result JSON
back.  What the boundary buys:

- a segfaulting / OOM-killed / fault-injected executor takes down only
  this process — the worker loop reaps the corpse and routes the task
  into the normal retry machinery;
- device pinning is real: the parent sets ``CUDA_VISIBLE_DEVICES`` before
  exec, so concurrent tasks on one host each see only their cards;
- the executor runs on the spec's ``device`` (the CLI's ``--device``).

Multi-host gang tasks fail here with a clear error: the port has no
distributed runtime yet.

Exit code 0 = executor returned; anything else (including death by
signal) = failure.  The result file is written atomically so the parent
never reads a half-written JSON.
"""

from __future__ import annotations

import json
import os
import sys
import traceback


def run_spec(spec_path: str) -> int:
    with open(spec_path) as f:
        spec = json.load(f)
    claim = spec["claim"]
    result_path = spec["result"]
    process_id = int(spec.get("process_id", 0))
    ok, result, err = False, None, None
    store = None
    try:
        # SIGTERM = preemption notice (spot TPU-VM reclaim, pool drain):
        # flag it so the train loop checkpoints and exits cleanly instead
        # of dying mid-step; the worker requeues preempted tasks without
        # consuming a retry (utils/preempt.py)
        from mlcomp_tpu_torch.utils.preempt import install_signal_handler

        install_signal_handler()

        if os.environ.get("MLCOMP_TPU_COORDINATOR"):
            raise NotImplementedError(
                "multi-host gang tasks (resources.hosts > 1) need the port's "
                "distributed runtime, which is not ported yet"
            )

        from mlcomp_tpu_torch import executors as _executors
        from mlcomp_tpu_torch.db.store import Store
        from mlcomp_tpu_torch.executors.base import ExecutionContext, run_task
        from mlcomp_tpu_torch.scheduler.worker import sync_code

        _executors.load_all()
        store = Store(spec["db"])
        args = json.loads(claim["args"])
        sync_code(args, claim["id"], spec["workdir"], store)
        ctx = ExecutionContext(
            dag_id=claim["dag_id"],
            task_id=claim["id"],
            task_name=claim["name"],
            args=args,
            store=store,
            workdir=spec["workdir"],
            chips=claim["chips"],
            stage=claim["stage"],
            primary=process_id == 0,
            worker=claim.get("worker"),
            device=spec.get("device"),
        )
        ok, result, err = run_task(claim["executor"], ctx)
    except Exception:
        err = traceback.format_exc()
    finally:
        if store is not None:
            try:
                if err and process_id != 0:
                    # slot>0 errors land in the shared task log (the task
                    # row itself is owned by slot 0)
                    store.log(
                        claim["id"], "error", f"[slot {process_id}] {err}"
                    )
                store.close()
            except Exception:
                pass
    tmp = result_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"ok": ok, "result": result, "error": err}, f)
    os.replace(tmp, result_path)
    return 0 if ok else 1


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("usage: python -m mlcomp_tpu_torch.scheduler.child <spec.json>",
              file=sys.stderr)
        return 2
    return run_spec(argv[0])


if __name__ == "__main__":
    sys.exit(main())
