"""Supervisor: DAG progression + failure detection.

The reference's Supervisor assigns DAG tasks to per-GPU Docker workers and
restarts work lost to dead workers (reference behavior: BASELINE.json:5 —
"the Supervisor/Worker scheduler provisions and pins TPU-VM slices in place
of per-GPU Docker workers").  This Supervisor is stateless between ticks:
every decision is recomputed from the store, so it can crash and resume, or
run as several replicas, without extra coordination.

Per tick, for every in-progress DAG:
  1. queue tasks whose dependencies all succeeded;
  2. skip tasks doomed by an upstream failure/stop;
  3. requeue (within retry budget) or fail tasks stranded on dead workers;
  4. finalize the DAG when every task reached a terminal status.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from mlcomp_tpu_torch.dag.graph import DagAnalyzer
from mlcomp_tpu_torch.dag.schema import TaskStatus
from mlcomp_tpu_torch.db.store import Store


class Supervisor:
    def __init__(
        self,
        store: Store,
        worker_timeout_s: float = 30.0,
        notifiers=None,
    ):
        self.store = store
        self.worker_timeout_s = worker_timeout_s
        # [{type: file|command|webhook, ...}] or pre-built Notifier objects
        from mlcomp_tpu_torch.utils.notify import create_notifiers

        self.notifiers = (
            create_notifiers(notifiers)
            if notifiers and isinstance(notifiers[0], dict)
            else list(notifiers or [])
        )
        # task sets are immutable after submit; one CSR build per DAG
        self._analyzers: Dict[int, DagAnalyzer] = {}

    def _notify(self, event: str, **detail) -> None:
        import logging

        from mlcomp_tpu_torch.utils.notify import notify_all

        notify_all(
            self.notifiers,
            event,
            on_error=logging.getLogger("mlcomp_tpu_torch.supervisor").warning,
            **detail,
        )

    def tick(self) -> Dict[int, str]:
        """One scheduling pass over all live DAGs; returns dag_id → status."""
        self._reap_dead_workers()
        out: Dict[int, str] = {}
        live = set()
        for dag in self.store.list_dags():
            if dag["status"] != "in_progress":
                out[dag["id"]] = dag["status"]
                continue
            live.add(dag["id"])
            out[dag["id"]] = self._advance_dag(dag["id"])
        # evict analyzers for DAGs finished elsewhere (a concurrent replica
        # may finalize a DAG this replica never advances again)
        for dag_id in list(self._analyzers):
            if dag_id not in live:
                del self._analyzers[dag_id]
        return out

    def _advance_dag(self, dag_id: int) -> str:
        analyzer = self._analyzers.get(dag_id)
        if analyzer is None:
            analyzer = self._analyzers[dag_id] = DagAnalyzer(
                self.store.task_specs(dag_id)
            )
        statuses = self.store.task_statuses(dag_id)

        # Conditional transitions (expect=NOT_RAN) keep concurrent supervisor
        # replicas with stale snapshots from re-queueing finished work.
        ready, doomed = analyzer.analyze(statuses)
        if ready:
            self.store.set_task_status(
                dag_id,
                [t.name for t in ready],
                TaskStatus.QUEUED,
                expect=TaskStatus.NOT_RAN,
            )
        if doomed:
            self.store.set_task_status(
                dag_id, doomed, TaskStatus.SKIPPED, expect=TaskStatus.NOT_RAN
            )

        statuses = self.store.task_statuses(dag_id)
        if all(s.finished for s in statuses.values()):
            final = (
                "success"
                if all(s == TaskStatus.SUCCESS for s in statuses.values())
                else "failed"
            )
            # set_dag_status returns True only for the replica that made
            # the transition, so multi-supervisor setups notify once
            if self.store.set_dag_status(dag_id, final, expect="in_progress"):
                self._notify(
                    "dag_finished",
                    dag_id=dag_id,
                    status=final,
                    tasks={n: s.value for n, s in statuses.items()},
                )
            self._analyzers.pop(dag_id, None)  # finished: drop the CSR cache
            return final
        return "in_progress"

    def _reap_dead_workers(self) -> None:
        """Requeue or fail tasks stranded on workers that stopped heartbeating."""
        for name in self.store.dead_workers(self.worker_timeout_s):
            for task in self.store.tasks_on_worker(name):
                if not self.store.requeue_task(task["id"], expect_worker=name):
                    if not self.store.finish_task(
                        task["id"],
                        TaskStatus.FAILED,
                        error=f"worker {name!r} died and retries exhausted",
                        expect_worker=name,
                    ):
                        continue  # task was stopped/re-claimed meanwhile
                    self._notify(
                        "task_failed",
                        task_id=task["id"],
                        task=task["name"],
                        dag_id=task["dag_id"],
                        error=f"worker {name!r} died and retries exhausted",
                    )
            # free any gang slots the dead worker held so a half-gathered
            # multi-host task can re-gather with live workers
            self.store.release_worker_gang_slots(name)
            self.store.mark_worker_dead(name)
            self._notify("worker_dead", worker=name)
        # a dead gang MEMBER (slot>0) doesn't own the task row, so the
        # per-worker loop above misses it: its surviving peers are wedged
        # in collectives against a vanished process — requeue the task
        # (which clears the gang; the stop-watch in the surviving workers
        # then kills their children)
        for task in self.store.broken_gang_tasks():
            # expect_worker: if the gang actually finished (or was stopped /
            # re-claimed) in the race window, neither transition may land
            if not self.store.requeue_task(
                task["id"], expect_worker=task["worker"]
            ):
                if self.store.finish_task(
                    task["id"],
                    TaskStatus.FAILED,
                    error="gang member died and retries exhausted",
                    expect_worker=task["worker"],
                ):
                    self._notify(
                        "task_failed",
                        task_id=task["id"],
                        task=task["name"],
                        dag_id=task["dag_id"],
                        error="gang member died and retries exhausted",
                    )

    def run_forever(self, poll_interval: float = 1.0) -> None:
        while True:
            self.tick()
            time.sleep(poll_interval)
