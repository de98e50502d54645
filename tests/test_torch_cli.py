"""The port's CLI against the JAX package's: ``validate``, the store
commands (``submit``, ``status``, ``stop``, ``restart``), ``tokenize`` and
``pool``'s launch template.

Both CLIs run in this process on the same inputs.  The store commands run
on copies of one store, one copy a CLI, and must print the same lines and
leave the same rows (timestamps aside); each CLI also reads a store the
other wrote.
"""

import json
import shutil
import sqlite3
from pathlib import Path

import pytest
import torch

from mlcomp_tpu import cli as jcli
from mlcomp_tpu_torch import cli as tcli

REPO = Path(__file__).resolve().parents[1]

torch.set_num_threads(1)

# columns that read the clock
CLOCK = {"created", "updated", "started", "finished", "ts", "heartbeat"}


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _rows(db):
    """Every table of a store, clock columns dropped."""
    con = sqlite3.connect(db)
    try:
        out = {}
        tables = [r[0] for r in con.execute(
            "SELECT name FROM sqlite_master WHERE type='table' AND name NOT LIKE 'sqlite_%'"
            " ORDER BY name")]
        for t in tables:
            cur = con.execute(f"SELECT * FROM {t} ORDER BY rowid")
            cols = [d[0] for d in cur.description]
            out[t] = [{c: v for c, v in zip(cols, row) if c not in CLOCK} for row in cur]
        return out
    finally:
        con.close()


@pytest.mark.parametrize("config", sorted(p.name for p in (REPO / "configs").glob("*.yml")))
def test_validate_prints_the_jax_commands_lines(config, capsys):
    path = str(REPO / "configs" / config)
    want = _run(jcli.main, ["validate", path], capsys)
    got = _run(tcli.main, ["validate", path], capsys)
    assert got == want
    assert want[0] == 0 and want[1].startswith("dag ")


def _dag(tmp_path):
    path = tmp_path / "queue.yml"
    path.write_text(
        "info: {name: queue, project: cli}\n"
        "executors:\n"
        "  prep: {type: noop}\n"
        "  train:\n"
        "    type: noop\n"
        "    depends: prep\n"
        "    grid: {lr: [0.1, 0.01]}\n"
        "  bad: {type: fail, depends: prep, resources: {chips: 2}}\n"
        "  after: {type: noop, depends: [train, bad]}\n")
    return str(path)


# each step: the argv after the CLI name; run on both stores in turn
STEPS = [
    ["status"],
    ["status", "1"],
    ["stop", "--task", "2"],
    ["status", "1"],
    ["restart", "--task", "2"],
    ["stop", "1"],
    ["status"],
    ["status", "1"],
    ["restart", "1"],
    ["status", "1"],
    ["stop"],                       # neither a DAG nor --task: exit 2
    ["restart", "1", "--task", "3"],  # both: exit 2
    ["stop", "--task", "99"],
]


def test_store_commands_print_the_same_and_leave_the_same_rows(tmp_path, capsys):
    base = str(tmp_path / "base.sqlite")
    assert _run(jcli.main, ["submit", _dag(tmp_path), "--db", base], capsys)[0] == 0
    # a task in flight, one failed: stop and restart move something
    from mlcomp_tpu_torch.db.store import Store

    store = Store(base)
    try:
        rows = {r["name"]: r["id"] for r in store.task_rows(1)}
        from mlcomp_tpu_torch.dag.schema import TaskStatus

        store.set_task_status(1, ["prep"], TaskStatus.SUCCESS)
        store.set_task_status(1, ["bad"], TaskStatus.FAILED)
        store.set_task_status(1, [n for n in rows if n.startswith("train")],
                              TaskStatus.IN_PROGRESS)
    finally:
        store.close()
    dbs = {}
    for name in ("jax", "port"):
        dbs[name] = str(tmp_path / f"{name}.sqlite")
        shutil.copy(base, dbs[name])
    printed = {}
    for step in STEPS:
        want = _run(jcli.main, [*step, "--db", dbs["jax"]], capsys)
        got = _run(tcli.main, [*step, "--db", dbs["port"]], capsys)
        assert got == want, step
        assert _rows(dbs["port"]) == _rows(dbs["jax"]), step
        printed[" ".join(step)] = got[1]
    # the sequence moved tasks both ways
    assert json.loads(printed["stop 1"])["stopped_tasks"] > 0
    assert json.loads(printed["restart 1"])["reset_tasks"] > 0
    assert json.loads(printed["stop --task 2"])["stopped"] is True


def test_each_cli_reads_the_store_the_other_wrote(tmp_path, capsys):
    dag = _dag(tmp_path)
    dbs = {name: str(tmp_path / f"{name}.sqlite") for name in ("jax", "port")}
    sub_j = _run(jcli.main, ["submit", dag, "--db", dbs["jax"]], capsys)
    sub_t = _run(tcli.main, ["submit", dag, "--db", dbs["port"]], capsys)
    assert sub_t == sub_j and json.loads(sub_t[1]) == {"dag_id": 1, "name": "queue", "tasks": 5}
    assert _rows(dbs["port"]) == _rows(dbs["jax"])
    for argv in (["status"], ["status", "1"]):
        # the port's CLI on the JAX CLI's store, and the reverse
        assert (_run(tcli.main, [*argv, "--db", dbs["jax"]], capsys)
                == _run(jcli.main, [*argv, "--db", dbs["port"]], capsys))


def _corpus(root: Path) -> Path:
    (root / "docs" / "sub").mkdir(parents=True)
    (root / "docs" / "a.txt").write_text("hello world\n" * 3 + "naïve café, 東京, ñandú 🙂\n")
    (root / "docs" / "sub" / "b.md").write_text("Grüße — ΑΒΓ δ\n\tend\n")
    (root / "docs" / "sub" / "bad.txt").write_bytes(b"bytes \xff\xfe not utf-8 \xc3\n")
    (root / "docs" / ".hidden").mkdir()
    (root / "docs" / ".hidden" / "skip.txt").write_text("never read\n")
    (root / "extra.txt").write_text("a lone file argument\n")
    return root


def test_tokenize_writes_the_same_bin_and_sidecar(tmp_path, capsys):
    root = _corpus(tmp_path)
    outs = {}
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        out = tmp_path / f"{name}.bin"
        rc, printed, _ = _run(main, ["tokenize", str(root / "docs"), str(root / "extra.txt"),
                                     "-o", str(out)], capsys)
        assert rc == 0
        meta = json.loads(printed)
        assert json.loads((tmp_path / f"{name}.bin.json").read_text()) == meta
        outs[name] = (out.read_bytes(), meta)
    assert outs["port"] == outs["jax"]
    data, meta = outs["port"]
    assert meta["documents"] == 4 and meta["tokenizer"] == "byte" and meta["eos_id"] == 256
    assert len(data) == 2 * meta["tokens"]


def test_tokenize_refuses_what_the_jax_command_refuses(tmp_path, capsys):
    for argv in (["tokenize", str(tmp_path / "missing"), "-o", str(tmp_path / "x.bin")],
                 ["tokenize", str(tmp_path), "-o", str(tmp_path / "x.bin")]):
        want = _run(jcli.main, argv, capsys)
        got = _run(tcli.main, argv, capsys)
        assert got == want and got[0] == 2


def test_tokenize_without_transformers_fails_in_one_line(tmp_path, capsys, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_transformers(name, *a, **kw):
        if name.split(".")[0] == "transformers":
            raise ImportError("No module named 'transformers'")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_transformers)
    (tmp_path / "t.txt").write_text("text\n")
    rc, out, err = _run(tcli.main, ["tokenize", str(tmp_path / "t.txt"), "-o",
                                    str(tmp_path / "t.bin"), "--hf-tokenizer",
                                    str(tmp_path / "tok")], capsys)
    assert rc == 2 and out == "" and len(err.strip().splitlines()) == 1
    assert "transformers" in err


def test_pool_default_launch_names_the_ports_cli(tmp_path):
    from mlcomp_tpu.scheduler import pool as jpool
    from mlcomp_tpu_torch.db.store import Store
    from mlcomp_tpu_torch.scheduler import pool as tpool

    assert tpool.LOCAL_TEMPLATE == jpool.LOCAL_TEMPLATE.replace("mlcomp_tpu.cli",
                                                                "mlcomp_tpu_torch.cli")
    store = Store(str(tmp_path / "db.sqlite"))
    try:
        pool = tpool.WorkerPool(store, tpool.parse_inventory("localhost chips=2\ngpu-3"),
                                base_workdir=str(tmp_path))
        local, remote = (pool._render(m) for m in pool._members)
    finally:
        store.close()
    assert local[1:5] == ["-m", "mlcomp_tpu_torch.cli", "worker", "--db"]
    assert "--chips" in local and local[local.index("--chips") + 1] == "2"
    assert remote[:4] == ["ssh", "-o", "BatchMode=yes", "gpu-3"]
    assert "mlcomp_tpu_torch.cli" in remote and "mlcomp_tpu.cli" not in remote


@pytest.mark.parametrize("extra", [
    [], ["--ckpt", "w.npz", "--port-range", "8901-8999"],
    ["--ckpt", "w.npz", "--phase-split", "1:1", "--scheduler"],
    ["--ckpt", "w.npz", "--phase-split", "1:1", "--autoscale-dry-run"],
    ["--ckpt", "w.npz", "--phase-split", "0:1"], ["--ckpt", "w.npz", "--phase-split", "two"]])
def test_fleet_refuses_what_the_jax_command_refuses(extra, tmp_path, capsys):
    argv = ["fleet", "--model", str(tmp_path / "m.yml"), "--registry",
            str(tmp_path / "reg.json"), *extra]
    want = _run(jcli.main, argv, capsys)
    got = _run(tcli.main, argv, capsys)
    assert got == want and got[0] == 2 and got[2].startswith("error: ")
