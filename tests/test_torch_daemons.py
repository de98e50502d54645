"""The port's daemons on the CPU: ``supervisor`` and ``worker`` as
subprocesses over one store, ``submit``, ``stop`` and ``restart`` against
them, and ``pool`` bringing up a worker.

A DAG with a dependency, a tiny LM ``train`` task and a failing branch,
submitted to the port's daemons (``worker --device cpu``, each task in an
isolated child), ends in the task statuses that the port's
``run_dag_local`` and the JAX package's give on the same YAML.  ``stop``
and ``restart`` against the live daemons move the tasks that the JAX CLI
moves on a copy of the same store.
"""

import os
import shutil
import signal
import sqlite3
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

from mlcomp_tpu import cli as jcli
from mlcomp_tpu_torch import cli as tcli
from mlcomp_tpu_torch.db.store import Store

REPO = Path(__file__).resolve().parents[1]

torch.set_num_threads(1)

TERMINAL = {"success", "failed", "skipped", "stopped"}


def _dag_yaml(tmp_path: Path) -> Path:
    # batches of 8: the JAX Trainer shards them over the test run's 8 host
    # devices
    text = textwrap.dedent(f"""\
        info: {{name: daemon_dag, project: dm}}
        executors:
          prep: {{type: noop}}
          train:
            type: train
            depends: prep
            args:
              model: {{name: transformer_lm, vocab_size: 64, hidden: 32, layers: 1, heads: 2,
                       mlp_dim: 64, dtype: float32}}
              optimizer: {{name: adamw, lr: 1.0e-3}}
              loss: lm_cross_entropy
              metrics: []
              epochs: 1
              data:
                train: {{name: synthetic_tokens, n: 16, seq_len: 8, vocab_size: 64,
                         batch_size: 8}}
              storage_root: {tmp_path / "storage"}
              project: dm
              dag_name: daemon_dag
          bad: {{type: fail, depends: prep}}
          after_bad: {{type: noop, depends: bad}}
        """)
    path = tmp_path / "daemon_dag.yml"
    path.write_text(text)
    return path


def _env():
    return {**os.environ, "PYTHONPATH": str(REPO)}


def _spawn(*argv, cwd, log):
    return subprocess.Popen([sys.executable, "-m", "mlcomp_tpu_torch.cli", *argv],
                            cwd=str(cwd), env=_env(), stdout=open(log, "wb"),
                            stderr=subprocess.STDOUT, start_new_session=True)


def _end(procs):
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()


def _statuses(db, dag_id):
    store = Store(db)
    try:
        return {r["name"]: r["status"] for r in store.task_rows(dag_id)}
    finally:
        store.close()


def _wait(db, dag_id, pred, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = _statuses(db, dag_id)
        if pred(st):
            return st
        time.sleep(0.2)
    raise AssertionError(f"dag {dag_id} stuck at {_statuses(db, dag_id)}")


@pytest.fixture(scope="module")
def daemons(tmp_path_factory):
    """The port's supervisor and one isolated CPU worker over one store."""
    tmp = tmp_path_factory.mktemp("daemons")
    db = str(tmp / "db.sqlite")
    Store(db).close()
    (tmp / "work").mkdir()
    procs = [
        _spawn("supervisor", "--db", db, "--poll", "0.2", cwd=tmp, log=tmp / "sup.log"),
        _spawn("worker", "--db", db, "--name", "w0", "--poll", "0.2", "--workdir",
               str(tmp / "work"), "--device", "cpu", cwd=tmp, log=tmp / "worker.log"),
    ]
    yield tmp, db
    _end(procs)


def _submit(yaml_path, db, capsys):
    assert tcli.main(["submit", str(yaml_path), "--db", db]) == 0
    import json

    return json.loads(capsys.readouterr().out)["dag_id"]


def test_a_dag_through_the_daemons_ends_in_run_dag_locals_statuses(daemons, tmp_path, capsys):
    from mlcomp_tpu.scheduler.local import run_dag_local as j_run_dag_local
    from mlcomp_tpu_torch.scheduler.local import run_dag_local

    tmp, db = daemons
    dag_id = _submit(_dag_yaml(tmp), db, capsys)
    got = _wait(db, dag_id, lambda st: set(st.values()) <= TERMINAL)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port = run_dag_local(_dag_yaml(tmp_path / "port"), db_path=str(tmp_path / "port.sqlite"),
                         workdir=str(tmp_path / "port"), device="cpu")
    jax_ = j_run_dag_local(_dag_yaml(tmp_path / "jax"), db_path=str(tmp_path / "jax.sqlite"),
                           workdir=str(tmp_path / "jax"))
    want = {n: s.value for n, s in jax_.items()}
    assert got == {n: s.value for n, s in port.items()} == want == {
        "prep": "success", "train": "success", "bad": "failed", "after_bad": "skipped"}
    # the train task ran in the worker's isolated child: its checkpoint
    # and its loss are in the store
    store = Store(db)
    try:
        rows = {r["name"]: r for r in store.task_rows(dag_id)}
        assert rows["train"]["worker"] == "w0"
        assert len(store.metric_series(rows["train"]["id"], "train/loss")) == 1
    finally:
        store.close()
    assert (tmp / "storage" / "dm" / "daemon_dag" / "train" / "checkpoints").is_dir()
    assert tcli.main(["status", str(dag_id), "--db", db]) == 0
    assert "failed" in capsys.readouterr().out


def _tasks(db, dag_id):
    con = sqlite3.connect(db)
    try:
        return list(con.execute("SELECT id, name, status, retries FROM tasks WHERE dag_id = ?"
                                " ORDER BY id", (dag_id,)))
    finally:
        con.close()


def _both(argv, db, tmp_path, capsys, tag):
    """``argv`` through the JAX CLI on a copy of the live store, then
    through the port's CLI on the live store: (port's output, JAX's output,
    the copy's rows)."""
    copy = str(tmp_path / f"copy-{tag}.sqlite")
    con = sqlite3.connect(db)
    try:
        con.execute("PRAGMA wal_checkpoint(FULL)")
    finally:
        con.close()
    shutil.copy(db, copy)
    assert jcli.main([*argv, "--db", copy]) == 0
    want = capsys.readouterr().out
    assert tcli.main([*argv, "--db", db]) == 0
    got = capsys.readouterr().out
    return got, want, copy


def test_stop_and_restart_against_the_live_daemons(daemons, tmp_path, capsys):
    tmp, db = daemons
    marker = tmp_path / "held-once"
    path = tmp_path / "hold.yml"
    path.write_text(textwrap.dedent(f"""\
        info: {{name: hold, project: dm}}
        executors:
          hold:
            type: shell
            args: {{command: "test -f {marker} || (touch {marker}; sleep 120)"}}
          after: {{type: noop, depends: hold}}
        """))
    dag_id = _submit(path, db, capsys)
    _wait(db, dag_id, lambda st: st["hold"] == "in_progress" and marker.exists())
    got, want, copy = _both(["stop", str(dag_id)], db, tmp_path, capsys, "stop")
    assert got == want and '"stopped_tasks": 2' in got
    assert _tasks(db, dag_id) == _tasks(copy, dag_id)
    # the worker's stop-watch ends the held child: nothing runs on
    st = _wait(db, dag_id, lambda st: set(st.values()) == {"stopped"}, timeout=30)
    time.sleep(1.0)
    assert _statuses(db, dag_id) == st
    got, want, copy = _both(["restart", str(dag_id)], db, tmp_path, capsys, "restart")
    assert got == want and '"reset_tasks": 2' in got
    # the daemons take the reset tasks up again: the marker lets the shell
    # task end at once this time
    final = _wait(db, dag_id, lambda st: set(st.values()) <= TERMINAL and
                  "stopped" not in st.values())
    assert final == {"hold": "success", "after": "success"}


def test_pool_brings_up_a_port_worker_that_claims_a_task(tmp_path, capsys):
    from mlcomp_tpu_torch.scheduler.supervisor import Supervisor

    db = str(tmp_path / "pool.sqlite")
    path = tmp_path / "one.yml"
    path.write_text("info: {name: one, project: dm}\nexecutors:\n  only: {type: noop}\n")
    dag_id = _submit(path, db, capsys)
    # the localhost default template: `python -m mlcomp_tpu_torch.cli worker`
    pool = _spawn("pool", "--db", db, "--hosts", "localhost", "--workdir",
                  str(tmp_path / "pool"), "--poll", "0.5", cwd=tmp_path,
                  log=tmp_path / "pool.log")
    store = Store(db)
    try:
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline and _statuses(db, dag_id)["only"] != "success":
            Supervisor(store).tick()
            time.sleep(0.2)
        rows = store.task_rows(dag_id)
        workers = store.workers()
    finally:
        store.close()
        _end([pool])
    assert rows[0]["status"] == "success", (tmp_path / "pool.log").read_text()
    assert rows[0]["worker"] == "pool-0-localhost" == workers[0]["name"]
    assert "pool_drained" in (tmp_path / "pool.log").read_text()
