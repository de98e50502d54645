"""Embedded task store: dags, tasks, logs, metrics, workers.

The reference coordinates Supervisor/Workers through a shared PostgreSQL
database plus Redis (upstream mlcomp; BASELINE.json:5 keeps "the report
server and model storage ... on the TPU-VM host disk").  On a TPU-VM pod
there is no separate DB host — the natural TPU-native choice is an embedded
sqlite file on the head host's disk, WAL-journaled so many worker processes
can read/write concurrently, with claim semantics done as atomic UPDATEs
(no Redis needed).

All multi-process coordination goes through this one file; every method
opens a short transaction so crash recovery is just "reopen the file".
"""

from __future__ import annotations

import json
import math
import os
import sqlite3
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from mlcomp_tpu_torch.dag.schema import DagSpec, ResourceSpec, TaskSpec, TaskStatus

_SCHEMA = """
CREATE TABLE IF NOT EXISTS dags (
    id       INTEGER PRIMARY KEY AUTOINCREMENT,
    name     TEXT NOT NULL,
    project  TEXT NOT NULL,
    config   TEXT NOT NULL,
    status   TEXT NOT NULL DEFAULT 'in_progress',
    created  REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS tasks (
    id          INTEGER PRIMARY KEY AUTOINCREMENT,
    dag_id      INTEGER NOT NULL REFERENCES dags(id),
    name        TEXT NOT NULL,
    executor    TEXT NOT NULL,
    stage       TEXT NOT NULL,
    args        TEXT NOT NULL,
    depends     TEXT NOT NULL,
    chips       INTEGER NOT NULL DEFAULT 0,
    hosts       INTEGER NOT NULL DEFAULT 1,
    priority    INTEGER NOT NULL DEFAULT 0,
    max_retries INTEGER NOT NULL DEFAULT 0,
    retries     INTEGER NOT NULL DEFAULT 0,
    infra_requeues INTEGER NOT NULL DEFAULT 0,
    status      TEXT NOT NULL DEFAULT 'not_ran',
    worker      TEXT,
    started     REAL,
    finished    REAL,
    error       TEXT,
    result      TEXT,
    UNIQUE (dag_id, name)
);
CREATE INDEX IF NOT EXISTS idx_tasks_status ON tasks (dag_id, status);
CREATE TABLE IF NOT EXISTS logs (
    id      INTEGER PRIMARY KEY AUTOINCREMENT,
    task_id INTEGER NOT NULL,
    ts      REAL NOT NULL,
    level   TEXT NOT NULL,
    message TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS metrics (
    id      INTEGER PRIMARY KEY AUTOINCREMENT,
    task_id INTEGER NOT NULL,
    ts      REAL NOT NULL,
    name    TEXT NOT NULL,
    step    INTEGER NOT NULL DEFAULT 0,
    value   REAL
);
CREATE INDEX IF NOT EXISTS idx_metrics_task ON metrics (task_id, name, step);
CREATE TABLE IF NOT EXISTS reports (
    id      INTEGER PRIMARY KEY AUTOINCREMENT,
    task_id INTEGER NOT NULL,
    ts      REAL NOT NULL,
    name    TEXT NOT NULL,
    kind    TEXT NOT NULL,
    payload TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_reports_task ON reports (task_id);
CREATE TABLE IF NOT EXISTS workers (
    name      TEXT PRIMARY KEY,
    chips     INTEGER NOT NULL DEFAULT 0,
    busy_chips INTEGER NOT NULL DEFAULT 0,
    heartbeat REAL NOT NULL,
    status    TEXT NOT NULL DEFAULT 'alive',
    info      TEXT
);
CREATE TABLE IF NOT EXISTS gang (
    task_id     INTEGER NOT NULL,
    slot        INTEGER NOT NULL,
    worker      TEXT,
    coordinator TEXT,
    PRIMARY KEY (task_id, slot)
);
"""


class Store:
    """One sqlite connection per Store instance (per process/thread)."""

    def __init__(self, path: str):
        self.path = path
        if path != ":memory:":
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._conn = sqlite3.connect(path, timeout=30.0)
        self._conn.row_factory = sqlite3.Row
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.executescript(_SCHEMA)
        self._migrate()
        self._conn.commit()

    def _migrate(self) -> None:
        """Schema drift fixes for stores created by older builds.

        metrics.value was once NOT NULL; NaN metrics (diverged training)
        bind as NULL in sqlite, so legacy files must be rebuilt (ALTER
        can't drop NOT NULL).  The rebuild runs inside one BEGIN IMMEDIATE
        transaction: concurrent Store() opens serialize on the write lock
        and re-check the schema after acquiring it, and a crash mid-rebuild
        rolls back.  A stranded ``metrics_legacy`` (from a pre-atomic build
        dying mid-copy) is folded back in first."""

        # additive columns land with a plain ALTER (no rebuild needed);
        # concurrent opens of a legacy file can both see the column
        # missing, so the loser's duplicate ALTER is expected and benign
        worker_cols = {
            r["name"]
            for r in self._conn.execute("PRAGMA table_info(workers)")
        }
        if worker_cols and "info" not in worker_cols:
            try:
                self._conn.execute("ALTER TABLE workers ADD COLUMN info TEXT")
            except sqlite3.OperationalError as e:
                if "duplicate column" not in str(e):
                    raise
        task_cols = {
            r["name"]
            for r in self._conn.execute("PRAGMA table_info(tasks)")
        }
        if task_cols and "infra_requeues" not in task_cols:
            try:
                self._conn.execute(
                    "ALTER TABLE tasks ADD COLUMN infra_requeues"
                    " INTEGER NOT NULL DEFAULT 0"
                )
            except sqlite3.OperationalError as e:
                if "duplicate column" not in str(e):
                    raise

        def value_notnull() -> bool:
            cols = {
                r["name"]: r
                for r in self._conn.execute("PRAGMA table_info(metrics)")
            }
            return bool(cols) and bool(cols["value"]["notnull"])

        def legacy_present() -> bool:
            return (
                self._conn.execute(
                    "SELECT 1 FROM sqlite_master"
                    " WHERE type='table' AND name='metrics_legacy'"
                ).fetchone()
                is not None
            )

        if not value_notnull() and not legacy_present():
            return
        self._conn.commit()  # close the implicit schema-create transaction
        self._conn.execute("BEGIN IMMEDIATE")
        try:
            if legacy_present():  # recover rows stranded by an old build
                self._conn.execute(
                    "INSERT OR IGNORE INTO metrics"
                    " (id, task_id, ts, name, step, value)"
                    " SELECT id, task_id, ts, name, step, value"
                    " FROM metrics_legacy"
                )
                self._conn.execute("DROP TABLE metrics_legacy")
            if value_notnull():
                self._conn.execute(
                    "ALTER TABLE metrics RENAME TO metrics_legacy"
                )
                self._conn.execute(
                    "CREATE TABLE metrics ("
                    " id INTEGER PRIMARY KEY AUTOINCREMENT,"
                    " task_id INTEGER NOT NULL, ts REAL NOT NULL,"
                    " name TEXT NOT NULL, step INTEGER NOT NULL DEFAULT 0,"
                    " value REAL)"
                )
                self._conn.execute(
                    "INSERT INTO metrics (id, task_id, ts, name, step, value)"
                    " SELECT id, task_id, ts, name, step, value"
                    " FROM metrics_legacy"
                )
                self._conn.execute("DROP TABLE metrics_legacy")
                self._conn.execute(
                    "CREATE INDEX IF NOT EXISTS idx_metrics_task"
                    " ON metrics (task_id, name, step)"
                )
            self._conn.commit()
        except Exception:
            self._conn.rollback()
            raise

    def close(self) -> None:
        self._conn.close()

    @contextmanager
    def _tx(self):
        try:
            yield self._conn
            self._conn.commit()
        except Exception:
            self._conn.rollback()
            raise

    # ------------------------------------------------------------------ dags

    def submit_dag(self, dag: DagSpec) -> int:
        """Insert the dag and all its tasks as NOT_RAN; returns dag_id."""
        with self._tx() as c:
            cur = c.execute(
                "INSERT INTO dags (name, project, config, created) VALUES (?,?,?,?)",
                (dag.name, dag.project, json.dumps(dag.config), time.time()),
            )
            dag_id = int(cur.lastrowid)
            for t in dag.tasks:
                c.execute(
                    "INSERT INTO tasks (dag_id, name, executor, stage, args, depends,"
                    " chips, hosts, priority, max_retries, status)"
                    " VALUES (?,?,?,?,?,?,?,?,?,?,?)",
                    (
                        dag_id,
                        t.name,
                        t.executor,
                        t.stage,
                        json.dumps(t.args),
                        json.dumps(list(t.depends)),
                        t.resources.chips,
                        t.resources.hosts,
                        t.resources.priority,
                        t.max_retries,
                        TaskStatus.NOT_RAN.value,
                    ),
                )
        return dag_id

    def dag_status(self, dag_id: int) -> str:
        row = self._conn.execute(
            "SELECT status FROM dags WHERE id=?", (dag_id,)
        ).fetchone()
        if row is None:
            raise KeyError(f"no dag {dag_id}")
        return row["status"]

    def dag_created(self, dag_id: int) -> Optional[float]:
        """Submit timestamp of one DAG (None if unknown) — the stable
        component of the model-storage namespace."""
        row = self._conn.execute(
            "SELECT created FROM dags WHERE id=?", (dag_id,)
        ).fetchone()
        return None if row is None else float(row["created"])

    def set_dag_status(
        self, dag_id: int, status: str, expect: Optional[str] = None
    ) -> bool:
        """Set a dag's status; with ``expect`` the update is conditional
        (compare-and-set) and the return says whether THIS call made the
        transition — the once-only hook point for notifications."""
        with self._tx() as c:
            if expect is None:
                cur = c.execute(
                    "UPDATE dags SET status=? WHERE id=?", (status, dag_id)
                )
            else:
                cur = c.execute(
                    "UPDATE dags SET status=? WHERE id=? AND status=?",
                    (status, dag_id, expect),
                )
            return cur.rowcount > 0

    def stop_dag(self, dag_id: int) -> int:
        """Stop a DAG: every unfinished task goes STOPPED and the DAG is
        finalized as 'stopped'.  A worker mid-task keeps computing, but its
        late ``finish_task(expect_worker=...)`` is a conditional update on
        status=in_progress, so the stop cannot be clobbered.  Returns the
        number of tasks transitioned."""
        with self._tx() as c:
            cur = c.execute(
                "UPDATE tasks SET status=?, finished=? WHERE dag_id=?"
                " AND status IN (?,?,?)",
                (
                    TaskStatus.STOPPED.value,
                    time.time(),
                    dag_id,
                    TaskStatus.NOT_RAN.value,
                    TaskStatus.QUEUED.value,
                    TaskStatus.IN_PROGRESS.value,
                ),
            )
            c.execute(
                "UPDATE dags SET status='stopped' WHERE id=? AND"
                " status='in_progress'",
                (dag_id,),
            )
            c.execute(
                "DELETE FROM gang WHERE task_id IN"
                " (SELECT id FROM tasks WHERE dag_id=?)",
                (dag_id,),
            )
            return cur.rowcount

    def restart_dag(self, dag_id: int) -> int:
        """Re-run a finished/stopped DAG's unsuccessful tasks.

        FAILED/SKIPPED/STOPPED tasks reset to NOT_RAN with a fresh retry
        budget; SUCCESS tasks keep their results (their dependents see
        satisfied deps immediately).  The DAG returns to in_progress and
        the Supervisor re-queues from there.  Returns tasks reset."""
        with self._tx() as c:
            cur = c.execute(
                "UPDATE tasks SET status=?, worker=NULL, started=NULL,"
                " finished=NULL, error=NULL, retries=0 WHERE dag_id=?"
                " AND status IN (?,?,?)",
                (
                    TaskStatus.NOT_RAN.value,
                    dag_id,
                    TaskStatus.FAILED.value,
                    TaskStatus.SKIPPED.value,
                    TaskStatus.STOPPED.value,
                ),
            )
            # always reopen a stopped/failed DAG, even with zero tasks to
            # reset (e.g. stopped after every task already succeeded) —
            # the supervisor only finalizes in_progress DAGs
            c.execute(
                "UPDATE dags SET status='in_progress' WHERE id=?"
                " AND status IN ('stopped','failed')",
                (dag_id,),
            )
            c.execute(
                "DELETE FROM gang WHERE task_id IN"
                " (SELECT id FROM tasks WHERE dag_id=?)",
                (dag_id,),
            )
            return cur.rowcount

    def stop_task(self, task_id: int) -> bool:
        """Stop ONE task (not_ran/queued/in_progress → stopped).

        The DAG stays in_progress: the supervisor's next tick dooms the
        task's dependents (skip) and the normal rollup finalizes the DAG.
        Same late-``finish_task`` safety as :meth:`stop_dag` — a worker
        mid-task can't clobber the stop."""
        with self._tx() as c:
            cur = c.execute(
                "UPDATE tasks SET status=?, finished=? WHERE id=?"
                " AND status IN (?,?,?)",
                (
                    TaskStatus.STOPPED.value,
                    time.time(),
                    task_id,
                    TaskStatus.NOT_RAN.value,
                    TaskStatus.QUEUED.value,
                    TaskStatus.IN_PROGRESS.value,
                ),
            )
            if cur.rowcount:
                c.execute("DELETE FROM gang WHERE task_id=?", (task_id,))
            return cur.rowcount > 0

    def restart_task(self, task_id: int) -> int:
        """Re-run ONE finished task.

        Resets the task (fresh retry budget) plus any transitive
        dependents that are SKIPPED (doomed by this task's outcome),
        FAILED (possibly by this task's bad output — matching
        ``restart_dag``, which also re-runs failures), QUEUED, or
        IN_PROGRESS — the latter two must not run against the
        about-to-be-rewritten upstream output, so they are pulled back to
        NOT_RAN and re-queue only after the restarted task succeeds (a
        worker already mid-dependent keeps computing, but its late finish
        is a conditional update on status=in_progress and cannot land).
        Dependents that finished keep their results; ones skipped because
        of a *different* failed upstream get re-doomed by the supervisor
        on its next tick.  The DAG reopens to in_progress.  Returns tasks
        reset (0 when the task is not in a restartable status)."""
        restartable = (
            TaskStatus.FAILED.value,
            TaskStatus.SKIPPED.value,
            TaskStatus.STOPPED.value,
            TaskStatus.SUCCESS.value,
        )
        dependent_reset = (
            TaskStatus.SKIPPED.value,
            TaskStatus.QUEUED.value,
            TaskStatus.IN_PROGRESS.value,
            TaskStatus.FAILED.value,
        )
        with self._tx() as c:
            row = c.execute(
                "SELECT dag_id, name, status FROM tasks WHERE id=?", (task_id,)
            ).fetchone()
            if row is None or row["status"] not in restartable:
                return 0
            dag_id = row["dag_id"]
            rows = c.execute(
                "SELECT id, name, depends, status FROM tasks WHERE dag_id=?",
                (dag_id,),
            ).fetchall()
            children: Dict[str, List[sqlite3.Row]] = {}
            for r in rows:
                for dep in json.loads(r["depends"]):
                    children.setdefault(dep, []).append(r)
            to_reset = [task_id]
            frontier, seen = [row["name"]], {row["name"]}
            while frontier:
                nxt = []
                for name in frontier:
                    for r in children.get(name, []):
                        if r["name"] in seen:
                            continue
                        seen.add(r["name"])
                        if r["status"] in dependent_reset:
                            to_reset.append(r["id"])
                        nxt.append(r["name"])
                frontier = nxt
            marks = ",".join("?" * len(to_reset))
            cur = c.execute(
                f"UPDATE tasks SET status=?, worker=NULL, started=NULL,"
                f" finished=NULL, error=NULL, retries=0 WHERE id IN ({marks})",
                (TaskStatus.NOT_RAN.value, *to_reset),
            )
            c.execute(
                "UPDATE dags SET status='in_progress' WHERE id=?"
                " AND status IN ('stopped','failed','success')",
                (dag_id,),
            )
            c.execute(
                f"DELETE FROM gang WHERE task_id IN ({marks})", to_reset
            )
            return cur.rowcount

    def list_dags(self) -> List[Dict[str, Any]]:
        rows = self._conn.execute(
            "SELECT id, name, project, status, created FROM dags ORDER BY id"
        ).fetchall()
        return [dict(r) for r in rows]

    # ----------------------------------------------------------------- tasks

    def task_specs(self, dag_id: int) -> List[TaskSpec]:
        rows = self._conn.execute(
            "SELECT * FROM tasks WHERE dag_id=? ORDER BY id", (dag_id,)
        ).fetchall()
        return [self._row_to_spec(r) for r in rows]

    @staticmethod
    def _row_to_spec(r: sqlite3.Row) -> TaskSpec:
        return TaskSpec(
            name=r["name"],
            executor=r["executor"],
            args=json.loads(r["args"]),
            depends=tuple(json.loads(r["depends"])),
            stage=r["stage"],
            resources=ResourceSpec(
                chips=r["chips"], hosts=r["hosts"], priority=r["priority"]
            ),
            max_retries=r["max_retries"],
        )

    def task_statuses(self, dag_id: int) -> Dict[str, TaskStatus]:
        rows = self._conn.execute(
            "SELECT name, status FROM tasks WHERE dag_id=?", (dag_id,)
        ).fetchall()
        return {r["name"]: TaskStatus(r["status"]) for r in rows}

    def task_row(self, task_id: int) -> Optional[Dict[str, Any]]:
        row = self._conn.execute(
            "SELECT * FROM tasks WHERE id=?", (task_id,)
        ).fetchone()
        return dict(row) if row else None

    def task_rows(self, dag_id: int) -> List[Dict[str, Any]]:
        rows = self._conn.execute(
            "SELECT * FROM tasks WHERE dag_id=? ORDER BY id", (dag_id,)
        ).fetchall()
        return [dict(r) for r in rows]

    def set_task_status(
        self,
        dag_id: int,
        names: Iterable[str],
        status: TaskStatus,
        expect: Optional[TaskStatus] = None,
    ) -> int:
        """Set status; with ``expect``, only transition rows still in that
        state (conditional UPDATE — safe under concurrent supervisors whose
        snapshots may be stale).  Returns number of rows changed."""
        names = list(names)
        with self._tx() as c:
            # one executemany, not a Python loop of executes: the big
            # dispatch tick flips ~10k rows at once (a grid unblocking)
            # and per-statement Python overhead was most of its 104 ms
            # (bench.py scheduler line, r3)
            if expect is None:
                cur = c.executemany(
                    "UPDATE tasks SET status=? WHERE dag_id=? AND name=?",
                    [(status.value, dag_id, n) for n in names],
                )
            else:
                cur = c.executemany(
                    "UPDATE tasks SET status=? WHERE dag_id=? AND name=?"
                    " AND status=?",
                    [(status.value, dag_id, n, expect.value) for n in names],
                )
            return cur.rowcount

    def claim_task(
        self, worker: str, free_chips: int, free_hosts: int = 1
    ) -> Optional[Dict[str, Any]]:
        """Atomically claim the highest-priority queued task that fits.

        The UPDATE is conditional on status still being 'queued', which makes
        the claim race-free across worker processes sharing the file (this is
        the sqlite equivalent of the reference's Redis-locked assignment).
        """
        while True:
            row = self._conn.execute(
                "SELECT id FROM tasks WHERE status=? AND chips<=? AND hosts<=?"
                " ORDER BY priority DESC, id ASC LIMIT 1",
                (TaskStatus.QUEUED.value, free_chips, free_hosts),
            ).fetchone()
            if row is None:
                return None
            with self._tx() as c:
                cur = c.execute(
                    "UPDATE tasks SET status=?, worker=?, started=?"
                    " WHERE id=? AND status=?",
                    (
                        TaskStatus.IN_PROGRESS.value,
                        worker,
                        time.time(),
                        row["id"],
                        TaskStatus.QUEUED.value,
                    ),
                )
                if cur.rowcount == 1:
                    got = self._conn.execute(
                        "SELECT * FROM tasks WHERE id=?", (row["id"],)
                    ).fetchone()
                    return dict(got)
            # lost the race; try the next queued task

    def finish_task(
        self,
        task_id: int,
        status: TaskStatus,
        error: Optional[str] = None,
        result: Optional[Dict[str, Any]] = None,
        expect_worker: Optional[str] = None,
    ) -> bool:
        """Finish a task; with ``expect_worker``, only if still assigned to
        that worker and in progress (a stale worker whose task was reaped and
        requeued must not clobber the re-execution)."""
        q = "UPDATE tasks SET status=?, finished=?, error=?, result=? WHERE id=?"
        params: list = [
            status.value,
            time.time(),
            error,
            json.dumps(result) if result is not None else None,
            task_id,
        ]
        if expect_worker is not None:
            q += " AND worker=? AND status=?"
            params += [expect_worker, TaskStatus.IN_PROGRESS.value]
        with self._tx() as c:
            cur = c.execute(q, params)
            if cur.rowcount == 1:
                c.execute("DELETE FROM gang WHERE task_id=?", (task_id,))
            return cur.rowcount == 1

    def requeue_task(
        self,
        task_id: int,
        expect_worker: Optional[str] = None,
        consume_retry: bool = True,
    ) -> bool:
        """Put a task back in the queue, consuming one retry. False if spent.

        Only fires while the task is still IN_PROGRESS (a stopped or
        already-requeued task must not be resurrected by a stale worker);
        with ``expect_worker`` it additionally requires the task to still
        be assigned to that worker — the same guard ``finish_task`` has.

        ``consume_retry=False`` is for infrastructure failures that are
        not the task's fault (a stolen gang-coordinator port): the requeue
        ignores the retry budget and leaves the counter untouched, so a
        ``max_retries: 0`` task still recovers.  Callers must reserve it
        for transient conditions a fresh attempt actually fixes — it can
        loop forever on a persistent one."""
        if consume_retry:
            q = (
                "UPDATE tasks SET status=?, worker=NULL, started=NULL,"
                " retries=retries+1 WHERE id=? AND retries < max_retries"
                " AND status=?"
            )
        else:
            # the counter increments INSIDE the requeue UPDATE so the cap
            # (infra_requeue_count) can never miss a bypass to a crash
            # between two transactions
            q = (
                "UPDATE tasks SET status=?, worker=NULL, started=NULL,"
                " infra_requeues=infra_requeues+1 WHERE id=? AND status=?"
            )
        params: list = [
            TaskStatus.QUEUED.value,
            task_id,
            TaskStatus.IN_PROGRESS.value,
        ]
        if expect_worker is not None:
            q += " AND worker=?"
            params.append(expect_worker)
        with self._tx() as c:
            cur = c.execute(q, params)
            if cur.rowcount == 1:
                # a re-queued multi-host task re-gathers a fresh gang
                c.execute("DELETE FROM gang WHERE task_id=?", (task_id,))
            return cur.rowcount == 1

    def infra_requeue_count(self, task_id: int) -> int:
        """How many times this task was requeued without consuming a retry
        (a dedicated column incremented atomically inside the requeue
        UPDATE, so the cap holds across workers and worker restarts — a
        per-worker counter would multiply the max_retries bypass by the
        worker count)."""
        row = self._conn.execute(
            "SELECT infra_requeues FROM tasks WHERE id=?", (task_id,)
        ).fetchone()
        return int(row["infra_requeues"]) if row is not None else 0

    # ------------------------------------------------------------- gang claims
    #
    # A ``hosts: n`` task is GANG-scheduled: n workers each claim one slot
    # of the task's gang, slot 0 elects itself coordinator and publishes a
    # ``host:port`` rendezvous, and only when every slot is held does the
    # task itself go IN_PROGRESS (owned by slot 0's worker, so the
    # existing reap/requeue/finish machinery applies unchanged).  This is
    # the scheduler-side half of ``parallel/distributed.py``: the workers
    # spawn one child process per slot with MLCOMP_TPU_COORDINATOR /
    # _NUM_PROCESSES / _PROCESS_ID set from the gang row.

    def claim_gang_slot(
        self, worker: str, free_chips: int
    ) -> Optional[Dict[str, Any]]:
        """Claim one slot of a queued multi-host task (``chips`` is the
        per-host requirement).  Returns {"task": row, "slot": i, "hosts": n}
        or None.  A worker holds at most one slot per task."""
        rows = self._conn.execute(
            "SELECT id, hosts FROM tasks WHERE status=? AND hosts>1 AND"
            " chips<=? ORDER BY priority DESC, id ASC",
            (TaskStatus.QUEUED.value, free_chips),
        ).fetchall()
        for r in rows:
            try:
                with self._tx() as c:
                    # re-check INSIDE the tx: a stop/finish racing this
                    # claim must not get fresh gang rows resurrected under
                    # it (WAL snapshot conflicts abort us instead — caught
                    # below and treated as "lost the race")
                    chk = c.execute(
                        "SELECT status FROM tasks WHERE id=?", (r["id"],)
                    ).fetchone()
                    if chk is None or chk["status"] != TaskStatus.QUEUED.value:
                        continue
                    mine = c.execute(
                        "SELECT 1 FROM gang WHERE task_id=? AND worker=?",
                        (r["id"], worker),
                    ).fetchone()
                    if mine is not None:
                        continue
                    for s in range(r["hosts"]):
                        c.execute(
                            "INSERT OR IGNORE INTO gang (task_id, slot)"
                            " VALUES (?,?)",
                            (r["id"], s),
                        )
                    free = c.execute(
                        "SELECT MIN(slot) AS s FROM gang WHERE task_id=?"
                        " AND worker IS NULL",
                        (r["id"],),
                    ).fetchone()
                    if free["s"] is None:
                        continue
                    cur = c.execute(
                        "UPDATE gang SET worker=? WHERE task_id=? AND slot=?"
                        " AND worker IS NULL",
                        (worker, r["id"], free["s"]),
                    )
                    if cur.rowcount == 1:
                        task = dict(
                            c.execute(
                                "SELECT * FROM tasks WHERE id=?", (r["id"],)
                            ).fetchone()
                        )
                        return {"task": task, "slot": int(free["s"]),
                                "hosts": int(r["hosts"])}
            except sqlite3.OperationalError:
                continue  # concurrent writer won; try the next task
        return None

    def has_claimable_task(self, free_chips: int) -> bool:
        """Cheap peek: is any single-host task waiting that would fit?"""
        row = self._conn.execute(
            "SELECT 1 FROM tasks WHERE status=? AND hosts=1 AND chips<=?"
            " LIMIT 1",
            (TaskStatus.QUEUED.value, free_chips),
        ).fetchone()
        return row is not None

    def start_gang_task(self, task_id: int, worker: str) -> bool:
        """Slot 0 moves the gathered task to IN_PROGRESS under its name, so
        reap/requeue/finish treat a gang task exactly like any other."""
        with self._tx() as c:
            cur = c.execute(
                "UPDATE tasks SET status=?, worker=?, started=?"
                " WHERE id=? AND status=?",
                (
                    TaskStatus.IN_PROGRESS.value,
                    worker,
                    time.time(),
                    task_id,
                    TaskStatus.QUEUED.value,
                ),
            )
            return cur.rowcount == 1

    def publish_coordinator(self, task_id: int, address: str) -> None:
        """Slot 0 records the jax.distributed rendezvous address."""
        with self._tx() as c:
            c.execute(
                "UPDATE gang SET coordinator=? WHERE task_id=? AND slot=0",
                (address, task_id),
            )

    def gang_state(self, task_id: int) -> Dict[str, Any]:
        rows = self._conn.execute(
            "SELECT slot, worker, coordinator FROM gang WHERE task_id=?"
            " ORDER BY slot",
            (task_id,),
        ).fetchall()
        workers = {int(r["slot"]): r["worker"] for r in rows}
        return {
            "workers": workers,
            "coordinator": rows[0]["coordinator"] if rows else None,
            "filled": bool(rows) and all(w is not None for w in workers.values()),
        }

    def release_gang_slot(self, task_id: int, slot: int, worker: str) -> bool:
        """Give a slot back (gather timed out / task went away)."""
        with self._tx() as c:
            cur = c.execute(
                "UPDATE gang SET worker=NULL WHERE task_id=? AND slot=?"
                " AND worker=?",
                (task_id, slot, worker),
            )
            return cur.rowcount == 1

    def release_gang_slot_if_dormant(
        self, task_id: int, slot: int, worker: str
    ) -> bool:
        """Give a slot back ONLY while the gang is dormant: some slot still
        unheld, or the task no longer runnable.  The viability check and
        the release are ONE transaction — a bail path that reads "not
        filled" and then releases in a second tx can release after the
        gang fills, launching a gang whose member never comes (the child
        hangs in collectives until the supervisor requeues it, burning a
        retry).  False = the gang went live under us; the caller should
        join it instead of walking away."""
        with self._tx() as c:
            cur = c.execute(
                "UPDATE gang SET worker=NULL WHERE task_id=? AND slot=?"
                " AND worker=? AND NOT ("
                " (SELECT COUNT(*) FROM gang WHERE task_id=?"
                "  AND worker IS NULL)=0"
                " AND (SELECT status FROM tasks WHERE id=?) IN (?,?))",
                (
                    task_id, slot, worker, task_id, task_id,
                    TaskStatus.QUEUED.value, TaskStatus.IN_PROGRESS.value,
                ),
            )
            return cur.rowcount == 1

    def broken_gang_tasks(self) -> List[Dict[str, Any]]:
        """IN_PROGRESS gang tasks with an unheld slot: a member died after
        launch.  The remaining children are blocked in collectives against
        a peer that will never return, so the whole task must be requeued
        (a running gang cannot be rejoined — claim_gang_slot only matches
        queued tasks)."""
        rows = self._conn.execute(
            "SELECT DISTINCT t.* FROM tasks t JOIN gang g ON g.task_id=t.id"
            " WHERE g.worker IS NULL AND t.status=?",
            (TaskStatus.IN_PROGRESS.value,),
        ).fetchall()
        return [dict(r) for r in rows]

    def release_worker_gang_slots(self, worker: str) -> int:
        """Free every gang slot a (dead) worker held — a half-gathered gang
        must not wait forever on a claimer that will never spawn."""
        with self._tx() as c:
            cur = c.execute(
                "UPDATE gang SET worker=NULL WHERE worker=?", (worker,)
            )
            return cur.rowcount

    def tasks_on_worker(self, worker: str) -> List[Dict[str, Any]]:
        rows = self._conn.execute(
            "SELECT * FROM tasks WHERE worker=? AND status=?",
            (worker, TaskStatus.IN_PROGRESS.value),
        ).fetchall()
        return [dict(r) for r in rows]

    # ------------------------------------------------------------ logs/metrics

    def log(self, task_id: int, level: str, message: str) -> None:
        with self._tx() as c:
            c.execute(
                "INSERT INTO logs (task_id, ts, level, message) VALUES (?,?,?,?)",
                (task_id, time.time(), level, message),
            )

    def task_logs(self, task_id: int) -> List[Dict[str, Any]]:
        rows = self._conn.execute(
            "SELECT ts, level, message FROM logs WHERE task_id=? ORDER BY id",
            (task_id,),
        ).fetchall()
        return [dict(r) for r in rows]

    def metric(self, task_id: int, name: str, value: float, step: int = 0) -> None:
        # NaN/inf (diverged training) are recorded as NULL — sqlite binds
        # NaN to NULL anyway; making it explicit keeps the insert valid
        v = float(value)
        with self._tx() as c:
            c.execute(
                "INSERT INTO metrics (task_id, ts, name, step, value) VALUES (?,?,?,?,?)",
                (task_id, time.time(), name, step, v if math.isfinite(v) else None),
            )

    def metric_series(self, task_id: int, name: str) -> List[Tuple[int, float]]:
        rows = self._conn.execute(
            "SELECT step, value FROM metrics WHERE task_id=? AND name=?"
            " AND value IS NOT NULL ORDER BY step",
            (task_id, name),
        ).fetchall()
        return [(r["step"], r["value"]) for r in rows]

    def dag_metric_names(self, dag_id: int) -> List[str]:
        rows = self._conn.execute(
            "SELECT DISTINCT m.name FROM metrics m JOIN tasks t"
            " ON m.task_id = t.id WHERE t.dag_id=?"
            " AND m.value IS NOT NULL ORDER BY m.name",
            (dag_id,),
        ).fetchall()
        return [r["name"] for r in rows]

    def dag_metric_series(self, dag_id: int, name: str) -> Dict[str, List]:
        """One metric across every task of a DAG — the grid-search
        comparison view's data: {task_name: [[step, value], ...]}."""
        rows = self._conn.execute(
            "SELECT t.name AS task, m.step, m.value FROM metrics m"
            " JOIN tasks t ON m.task_id = t.id"
            " WHERE t.dag_id=? AND m.name=? AND m.value IS NOT NULL"
            " ORDER BY t.id, m.step",
            (dag_id, name),
        ).fetchall()
        out: Dict[str, List] = {}
        for r in rows:
            out.setdefault(r["task"], []).append([r["step"], r["value"]])
        return out

    def metric_names(self, task_id: int) -> List[str]:
        rows = self._conn.execute(
            "SELECT DISTINCT name FROM metrics WHERE task_id=? ORDER BY name",
            (task_id,),
        ).fetchall()
        return [r["name"] for r in rows]

    # --------------------------------------------------------------- reports

    def add_report(self, task_id: int, name: str, payload: Dict[str, Any]) -> int:
        """Persist a report artifact (classification/segmentation/... payload
        from report/artifacts.py); ``kind`` is read off the payload.

        Non-finite floats become null: bare ``NaN`` in the stored JSON is
        rejected by every spec-compliant parser (the dashboard's
        ``JSON.parse`` included), which would hide the whole report."""

        def clean(o):
            if isinstance(o, float):
                return o if math.isfinite(o) else None
            if isinstance(o, dict):
                return {k: clean(v) for k, v in o.items()}
            if isinstance(o, (list, tuple)):
                return [clean(v) for v in o]
            return o

        with self._tx() as c:
            cur = c.execute(
                "INSERT INTO reports (task_id, ts, name, kind, payload)"
                " VALUES (?,?,?,?,?)",
                (
                    task_id,
                    time.time(),
                    name,
                    str(payload.get("kind", "generic")),
                    json.dumps(clean(payload), allow_nan=False),
                ),
            )
            return int(cur.lastrowid)

    def reports(self, task_id: int) -> List[Dict[str, Any]]:
        rows = self._conn.execute(
            "SELECT id, ts, name, kind FROM reports WHERE task_id=? ORDER BY id",
            (task_id,),
        ).fetchall()
        return [dict(r) for r in rows]

    def report_payload(self, report_id: int) -> Optional[Dict[str, Any]]:
        row = self._conn.execute(
            "SELECT payload FROM reports WHERE id=?", (report_id,)
        ).fetchone()
        return json.loads(row["payload"]) if row else None

    # --------------------------------------------------------------- workers

    def heartbeat(
        self,
        worker: str,
        chips: int,
        busy_chips: int = 0,
        info: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Record liveness; ``info`` carries host metrics (loadavg, free
        RAM, running task ids — the TPU-VM analog of the reference's
        per-worker GPU utilization panel).  ``info=None`` keeps the last
        reported value so cheap liveness-only beats don't blank it."""
        with self._tx() as c:
            c.execute(
                "INSERT INTO workers (name, chips, busy_chips, heartbeat,"
                " status, info) VALUES (?,?,?,?,'alive',?)"
                " ON CONFLICT(name) DO UPDATE SET chips=excluded.chips,"
                " busy_chips=excluded.busy_chips, heartbeat=excluded.heartbeat,"
                " status='alive',"
                " info=COALESCE(excluded.info, workers.info)",
                (
                    worker, chips, busy_chips, time.time(),
                    json.dumps(info) if info is not None else None,
                ),
            )

    def workers(self) -> List[Dict[str, Any]]:
        rows = self._conn.execute("SELECT * FROM workers ORDER BY name").fetchall()
        return [dict(r) for r in rows]

    def dead_workers(self, timeout_s: float) -> List[str]:
        cutoff = time.time() - timeout_s
        rows = self._conn.execute(
            "SELECT name FROM workers WHERE status='alive' AND heartbeat < ?",
            (cutoff,),
        ).fetchall()
        return [r["name"] for r in rows]

    def mark_worker_dead(self, worker: str) -> None:
        with self._tx() as c:
            c.execute("UPDATE workers SET status='dead' WHERE name=?", (worker,))
