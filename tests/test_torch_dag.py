"""The port's DAG path: parser, store, scheduler and the train executor.

The copied ``dag.parser`` must read every shipped config as the JAX
parser does; a tiny LM train DAG runs to ``success`` through
``run_dag_local`` (inline and isolated workers) and through ``python -m
mlcomp_tpu_torch.cli dag`` on the CPU; and without ``--device`` the task
asks for the card and fails instead of running on the CPU.
"""

import dataclasses
import enum
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from mlcomp_tpu.dag.parser import parse_dag as jax_parse_dag
from mlcomp_tpu_torch.dag.parser import parse_dag
from mlcomp_tpu_torch.dag.schema import TaskStatus
from mlcomp_tpu_torch.db.store import Store
from mlcomp_tpu_torch.io.checkpoint import latest_step
from mlcomp_tpu_torch.scheduler.local import run_dag_local

REPO = Path(__file__).resolve().parents[1]

torch.set_num_threads(2)


def _plain(obj):
    """A DagSpec as plain data: dataclasses to dicts, enums to values."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


@pytest.mark.parametrize("config", sorted(p.name for p in (REPO / "configs").glob("*.yml")))
def test_parser_copy_reads_every_config_as_the_jax_parser(config):
    path = REPO / "configs" / config
    assert _plain(parse_dag(path)) == _plain(jax_parse_dag(path))


def _dag_yaml(tmp_path: Path, epochs: int = 1) -> Path:
    storage = tmp_path / "storage"
    text = textwrap.dedent(f"""\
        info: {{name: tiny_lm, project: lm}}
        executors:
          pretrain:
            type: train
            args:
              model: {{name: transformer_lm, vocab_size: 128, hidden: 32, layers: 1,
                       heads: 2, dtype: float32}}
              optimizer: {{name: adafactor, grad_clip: 1.0,
                           lr: {{name: warmup_cosine, lr: 3.0e-3, warmup_steps: 1,
                                 decay_steps: 10}}}}
              loss: lm_cross_entropy
              metrics: []
              epochs: {epochs}
              data:
                train: {{name: synthetic_tokens, n: 6, seq_len: 16, vocab_size: 128,
                         batch_size: 2}}
              storage_root: {storage}
              project: lm
              dag_name: tiny
        """)
    path = tmp_path / "lm.yml"
    path.write_text(text)
    return path


def _ckpt_dir(tmp_path: Path) -> Path:
    return tmp_path / "storage" / "lm" / "tiny" / "pretrain" / "checkpoints"


def test_run_dag_local_trains_on_the_cpu(tmp_path):
    statuses = run_dag_local(_dag_yaml(tmp_path, epochs=2), db_path=str(tmp_path / "db.sqlite"),
                             workdir=str(tmp_path), device="cpu")
    assert statuses == {"pretrain": TaskStatus.SUCCESS}
    assert latest_step(_ckpt_dir(tmp_path)) == 6         # 2 epochs of 3 steps
    store = Store(str(tmp_path / "db.sqlite"))
    try:
        losses = store.metric_series(1, "train/loss")
    finally:
        store.close()
    assert [s for s, _ in losses] == [0, 1]
    assert all(v == v and abs(v) < 1e3 for _, v in losses)


def test_isolated_worker_hands_the_device_to_its_child(tmp_path):
    from mlcomp_tpu_torch.scheduler.supervisor import Supervisor
    from mlcomp_tpu_torch.scheduler.worker import Worker

    store = Store(str(tmp_path / "db.sqlite"))
    try:
        store.submit_dag(parse_dag(_dag_yaml(tmp_path)))
        Supervisor(store).tick()                          # queue the ready task
        w = Worker(store, name="w", workdir=str(tmp_path / "work"), isolate=True, device="cpu")
        assert w.run_once()
        rows = store.task_rows(1)
    finally:
        store.close()
    assert rows[0]["status"] == "success", rows[0]["error"]
    assert latest_step(_ckpt_dir(tmp_path)) == 3


def _cli(tmp_path, *extra):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    return subprocess.run(
        [sys.executable, "-m", "mlcomp_tpu_torch.cli", "dag", str(_dag_yaml(tmp_path)),
         "--db", str(tmp_path / "db.sqlite"), "--workdir", str(tmp_path), *extra],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=300)


def test_cli_dag_runs_on_the_cpu_when_asked(tmp_path):
    out = _cli(tmp_path, "--device", "cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    assert '"pretrain": "success"' in out.stdout
    assert latest_step(_ckpt_dir(tmp_path)) == 3


def test_cli_dag_without_a_card_fails_instead_of_running_on_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device would run")
    out = _cli(tmp_path)
    assert out.returncode != 0
    assert '"pretrain": "failed"' in out.stdout
    store = Store(str(tmp_path / "db.sqlite"))
    try:
        row = store.task_rows(1)[0]
    finally:
        store.close()
    assert "no CUDA device is available" in (row["error"] or "")
    assert latest_step(_ckpt_dir(tmp_path)) is None


def test_gang_tasks_fail_in_the_child_until_the_port_is_distributed(tmp_path, monkeypatch):
    from mlcomp_tpu_torch.scheduler import child

    spec = tmp_path / "spec.json"
    result = tmp_path / "result.json"
    spec.write_text(
        '{"db": "%s", "claim": {"id": 1, "dag_id": 1, "name": "t", "args": "{}",'
        ' "chips": 0, "stage": "train", "executor": "noop"}, "workdir": "%s",'
        ' "result": "%s", "process_id": 0}' % (tmp_path / "db.sqlite", tmp_path, result))
    monkeypatch.setenv("MLCOMP_TPU_COORDINATOR", "127.0.0.1:1")
    assert child.run_spec(str(spec)) == 1
    assert "gang tasks" in result.read_text()
