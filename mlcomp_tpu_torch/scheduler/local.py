"""Local DAG runner: supervisor + N worker threads in one process.

This is the ``mlcomp-tpu dag <yaml>`` path — the reference's "run this DAG
now" entry point, without standing daemons.  Worker threads each hold their
own sqlite connection; coordination still flows through the store so the
semantics match the distributed deployment exactly.
"""

from __future__ import annotations

import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Mapping, Optional, Union

from mlcomp_tpu_torch.dag.parser import parse_dag
from mlcomp_tpu_torch.dag.schema import TaskStatus
from mlcomp_tpu_torch.db.store import Store
from mlcomp_tpu_torch.scheduler.supervisor import Supervisor
from mlcomp_tpu_torch.scheduler.worker import Worker


def run_dag_local(
    source: Union[str, Path, Mapping],
    workers: int = 1,
    chips: Optional[int] = None,
    db_path: Optional[str] = None,
    workdir: str = ".",
    timeout_s: float = 24 * 3600.0,
    worker_timeout_s: float = 60.0,
    overrides: Optional[Mapping] = None,
    device: Optional[str] = None,
) -> Dict[str, TaskStatus]:
    """Parse, submit, and run a DAG to completion; returns task statuses.
    ``device`` is the torch device every task runs on (``None``: ``cuda``,
    which raises without a card)."""
    from mlcomp_tpu_torch.io.sync import inject_code_sync

    dag = parse_dag(source, overrides=overrides)
    base = Path(source).parent if isinstance(source, (str, Path)) and Path(
        str(source)
    ).exists() else Path(".")
    dag = inject_code_sync(dag, base_dir=base)
    if chips is None:
        chips = _local_chip_count(dag)
    if db_path is None:
        db_path = str(
            Path(tempfile.mkdtemp(prefix="mlcomp_tpu_")) / "mlcomp.sqlite"
        )

    # multi-host tasks gang-schedule: they need one worker PER slot and
    # isolated child processes (each slot runs its own jax.distributed
    # process) — on a dev box "multi-host" degrades gracefully to
    # multi-process on localhost
    max_hosts = max((t.resources.hosts for t in dag.tasks), default=1)
    isolate = max_hosts > 1
    workers = max(1, workers, max_hosts)

    store = Store(db_path)
    dag_id = store.submit_dag(dag)
    sup = Supervisor(store, worker_timeout_s=worker_timeout_s)

    stop = threading.Event()

    def worker_loop(idx: int):
        wstore = Store(db_path)
        w = Worker(wstore, name=f"local-{idx}", chips=chips, workdir=workdir,
                   isolate=isolate, device=device)
        while not stop.is_set():
            if not w.run_once():
                time.sleep(0.02)
        wstore.close()

    threads = [
        threading.Thread(target=worker_loop, args=(i,), daemon=True)
        for i in range(workers)
    ]
    for t in threads:
        t.start()

    deadline = time.time() + timeout_s
    try:
        while time.time() < deadline:
            status = sup.tick().get(dag_id, "in_progress")
            if status != "in_progress":
                break
            time.sleep(0.02)
        else:
            raise TimeoutError(f"dag {dag.name!r} did not finish in {timeout_s}s")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5.0)

    statuses = store.task_statuses(dag_id)
    store.close()
    return statuses


def _local_chip_count(dag) -> int:
    """Advertise enough chips for the largest task so a local run never
    deadlocks on resources (deliberate over-advertising: a chips:8 DAG must
    still run on a 1-chip or CPU-only dev box; executors read the real
    device count from jax, not from ctx.chips).  Deliberately does NOT
    touch jax here — backend init can take tens of seconds on a TPU-VM and
    the scheduler must stay hardware-agnostic."""
    return max((t.resources.chips for t in dag.tasks), default=0)
