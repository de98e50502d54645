"""Gang tasks of the port: the child joins the slots' gloo group, slot 0
alone writes metrics and checkpoints, and the Trainer under the gang's
mesh trains as one process would (the mirror of tests/test_multihost.py's
gang train executor), plus ``configs/multihost_lm.yml`` cut small through
the local runner, the multi-process dry run, hybrid meshes and each
rank's rows of the global batch."""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from mlcomp_tpu_torch.dag.schema import DagSpec, ResourceSpec, TaskSpec
from mlcomp_tpu_torch.db.store import Store, TaskStatus
from mlcomp_tpu_torch.io.checkpoint import latest_step, restore_checkpoint
from mlcomp_tpu_torch.scheduler.worker import Worker
from mlcomp_tpu_torch.train.loop import Trainer
from torch_gang import free_port, result, run_gang

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def _run_worker_until(db_path, stop_evt, errors, **kw):
    ws = Store(db_path)
    try:
        w = Worker(ws, isolate=True, gang_wait_s=90.0, device="cpu", **kw)
        while not stop_evt.is_set():
            if not w.run_once():
                time.sleep(0.2)
    except Exception as e:  # a dead worker thread must show in the failure
        errors.append(e)
        raise
    finally:
        ws.close()


def test_gang_train_executor_two_processes(tmp_path, monkeypatch):
    """The train executor under hosts=2: two children join one gloo group,
    the Trainer's mesh spans both (dp 2), metrics are logged once per step
    (slot 1 is not primary), and slot 0 writes the checkpoint, which an
    unsharded Trainer loads."""
    monkeypatch.setenv("MLCOMP_TPU_STORAGE", str(tmp_path / "storage"))
    args = {
        "model": {"name": "mlp", "num_classes": 4, "hidden": [16], "dtype": "float32"},
        "optimizer": {"name": "adam", "lr": 1e-2},
        "loss": "cross_entropy", "metrics": ["accuracy"], "epochs": 1,
        "data": {"train": {"name": "synthetic_classification", "n": 64, "num_classes": 4,
                           "dim": 8, "batch_size": 32}},
        "storage_root": str(tmp_path / "storage"),
    }
    store = Store(str(tmp_path / "db.sqlite"))
    dag = DagSpec(name="mh", project="t", tasks=(TaskSpec(
        name="mh", executor="train", args=args, resources=ResourceSpec(hosts=2)),))
    dag_id = store.submit_dag(dag)
    store.set_task_status(dag_id, ["mh"], TaskStatus.QUEUED)
    tid = store.task_rows(dag_id)[0]["id"]
    stop, errors, threads = threading.Event(), [], []
    for i in range(2):
        wd = tmp_path / f"tw{i}"
        wd.mkdir()
        t = threading.Thread(target=_run_worker_until, args=(store.path, stop, errors),
                             kwargs={"name": f"tr-w{i}", "workdir": str(wd), "chips": 0},
                             daemon=True)
        t.start()
        threads.append(t)
    try:
        deadline = time.time() + 200
        while time.time() < deadline:
            row = store.task_row(tid)
            if row["status"] in (TaskStatus.SUCCESS.value, TaskStatus.FAILED.value):
                break
            time.sleep(0.5)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    row = store.task_row(tid)
    logs = "\n".join(l["message"] for l in store.task_logs(tid))
    assert not errors, errors
    assert row["status"] == TaskStatus.SUCCESS.value, (
        f"status={row['status']} error={row['error']}\nlogs:\n{logs}")
    # both slots joined one group of two
    assert "process_count=2 process_index=0" in logs and "process_count=2 process_index=1" in logs
    series = store.metric_series(tid, "train/loss")
    steps = [p[0] for p in series]
    assert len(steps) == len(set(steps)) > 0
    ckpt_dir = Path(json.loads(row["result"])["ckpt_dir"])
    assert latest_step(ckpt_dir) == 2
    # the gang's checkpoint loads into an unsharded Trainer
    t = Trainer({k: v for k, v in args.items() if k != "storage_root"}, device="cpu")
    restore_checkpoint(ckpt_dir, t.state)
    assert t.state.step == 2
    store.close()


def test_the_multihost_lm_dag_runs_as_two_gang_slots(tmp_path, monkeypatch):
    """configs/multihost_lm.yml cut small (hosts 2 kept, chips 0, mesh dp
    2): both slots succeed, and the loss equals one process's Trainer on
    the same config."""
    from mlcomp_tpu_torch.scheduler.local import run_dag_local

    monkeypatch.setenv("MLCOMP_TPU_STORAGE", str(tmp_path / "storage"))
    doc = yaml.safe_load((REPO / "configs" / "multihost_lm.yml").read_text())
    ex = doc["executors"]["pretrain"]
    assert ex["resources"] == {"chips": 4, "hosts": 2} and ex["args"]["mesh"] == {"dp": 8}
    small = {"name": "transformer_lm", "vocab_size": 64, "hidden": 32, "layers": 2,
             "heads": 4, "dtype": "float32"}
    ex["resources"] = {"chips": 0, "hosts": 2}
    ex["args"].update(model=small, mesh={"dp": 2}, dag_name="mh-small",
                      storage_root=str(tmp_path / "storage"),
                      data={"train": {"name": "synthetic_tokens", "n": 8, "seq_len": 64,
                                      "vocab_size": 64, "batch_size": 4}})
    doc["model"] = small
    path = tmp_path / "multihost_small.yml"
    path.write_text(yaml.safe_dump(doc))
    db = str(tmp_path / "db.sqlite")
    statuses = run_dag_local(str(path), db_path=db, workdir=str(tmp_path), timeout_s=200,
                             device="cpu")
    assert all(s == TaskStatus.SUCCESS for s in statuses.values()), statuses
    store = Store(db)
    try:
        tid = store.task_rows(1)[0]["id"]
        gang_loss = [v for _, v in store.metric_series(tid, "train/loss")]
    finally:
        store.close()
    cfg = {k: v for k, v in ex["args"].items()
           if k not in ("mesh", "project", "dag_name", "storage_root")}
    alone = Trainer(cfg, device="cpu").fit()
    assert len(gang_loss) == 1
    np.testing.assert_allclose(gang_loss[0], alone["train/loss"], rtol=1e-5)


def test_the_multi_process_dry_run_passes():
    port = free_port()
    env = {**os.environ, "MLCOMP_TPU_COORDINATOR": f"127.0.0.1:{port}",
           "MLCOMP_TPU_NUM_PROCESSES": "2", "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, "-m", "mlcomp_tpu_torch.parallel.dryrun_mp"],
                              env={**env, "MLCOMP_TPU_PROCESS_ID": str(i)}, cwd=str(REPO),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            outs.append(out)
            assert p.returncode == 0, err[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    losses = {o.strip().rsplit(" ", 1)[-1] for o in outs}
    assert len(losses) == 1 and all("2 ranks" in o for o in outs), outs


@pytest.fixture(scope="module")
def gang():
    rng = np.random.default_rng(0)
    batch = {"x": rng.normal(size=(8, 3)).astype(np.float32), "y": np.arange(8)}
    cases = [
        ("hybrid_one_slice", "hybrid", dict(spec={"dp": 2, "tp": 2}, dcn={"dp": 1},
                                            ranks_per_slice=4)),
        ("hybrid_two_slices", "hybrid", dict(spec={"dp": 2, "tp": 2}, dcn={"dp": 2},
                                             ranks_per_slice=2)),
        ("hybrid_slice_mismatch", "hybrid", dict(spec={"dp": 4}, dcn={"dp": 4},
                                                 ranks_per_slice=2)),
        ("hybrid_no_dcn_axis", "hybrid", dict(spec={"dp": 4}, dcn={}, ranks_per_slice=2)),
        ("rows_dp4", "batch_rows", dict(spec={"dp": 4}, batch=batch)),
        ("rows_dp2_fsdp2", "batch_rows", dict(spec={"dp": 2, "fsdp": 1, "tp": 2}, batch=batch)),
    ]
    return run_gang(4, cases), batch


def test_a_hybrid_mesh_of_one_slice_is_the_plain_mesh(gang):
    res, _ = gang
    got = result(res, 0, "hybrid_one_slice")
    assert got["names"] == ["dp", "fsdp", "pp", "sp", "ep", "tp"]
    assert got["shape"] == {"dp": 2, "fsdp": 1, "pp": 1, "sp": 1, "ep": 1, "tp": 2}


def test_a_hybrid_mesh_lays_dp_across_slices(gang):
    """Two slices of two ranks, dp crossing them: each tp pair stays
    inside one slice."""
    res, _ = gang
    ranks = np.asarray(result(res, 0, "hybrid_two_slices")["ranks"]).reshape(2, 2)
    assert ranks.tolist() == [[0, 1], [2, 3]]
    for row in ranks:
        assert len({r // 2 for r in row}) == 1


@pytest.mark.parametrize("name,match", [("hybrid_slice_mismatch", "slices"),
                                        ("hybrid_no_dcn_axis", "slices")])
def test_a_hybrid_mesh_refuses_a_wrong_slice_count(gang, name, match):
    res, _ = gang
    assert match in result(res, 0, name)["error_msg"]


@pytest.mark.parametrize("name,count", [("rows_dp4", 4), ("rows_dp2_fsdp2", 2)])
def test_each_rank_feeds_its_rows_of_the_global_batch(gang, name, count):
    res, batch = gang
    per = 8 // count
    for r in range(4):
        got = result(res, r, name)
        index, n = got["shard"]
        assert n == count
        for k, v in batch.items():
            np.testing.assert_array_equal(got["rows"][k], v[index * per:(index + 1) * per])
