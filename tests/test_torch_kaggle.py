"""The port's ``kaggle_download`` / ``kaggle_submit`` executors against the
JAX package's, on the same fake ``kaggle`` binary: the argv each records,
the files a download leaves (its zips unpacked), the results, and the
errors (no binary, no credentials, both or neither source, a failing
CLI, no file to submit).  The analogues of tests/test_extras.py's kaggle
tests."""

import json
import stat
import zipfile

import pytest
import torch

from mlcomp_tpu.executors import load_all as j_load_all
from mlcomp_tpu.executors.base import ExecutionContext as JContext
from mlcomp_tpu.executors.base import create_executor as j_create
from mlcomp_tpu_torch.executors import load_all
from mlcomp_tpu_torch.executors.base import ExecutionContext, create_executor

torch.set_num_threads(1)

PACKAGES = {"jax": (j_load_all, j_create, JContext), "port": (load_all, create_executor,
                                                            ExecutionContext)}


class _Store:
    """The two calls the executors make of a store: the DAG's task rows
    (the dependency edge to an infer task's ``preds``) and its logs."""

    def __init__(self, rows):
        self.rows, self.logs = rows, []

    def task_rows(self, dag_id):
        return self.rows

    def log(self, task_id, level, message):
        self.logs.append((level, message))


def _fake_kaggle(d, fail=False):
    """A stand-in ``kaggle`` that records its argv; ``download`` leaves a
    zip holding two files in its ``-p`` directory."""
    log = d / "argv.log"
    binary = d / "kaggle"
    binary.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {log}\n'
        + ('echo "403 Forbidden" >&2\nexit 3\n' if fail else "")
        + 'if [ "$2" = download ]; then\n'
        '  out=""; prev=""\n'
        '  for a in "$@"; do [ "$prev" = "-p" ] && out="$a"; prev="$a"; done\n'
        f'  cp {d}/data.zip "$out/data.zip"\n'
        "fi\n"
        'echo "ok"\n')
    binary.chmod(binary.stat().st_mode | stat.S_IEXEC)
    with zipfile.ZipFile(d / "data.zip", "w") as z:
        z.writestr("train.csv", "a,b\n1,2\n")
        z.writestr("test.csv", "a\n1\n")
    return binary, log


def _run(pkg, tmp, name, args, store=None):
    """Run one executor of ``pkg`` in its own directory (``DIR/`` in an
    argument names a path in it); returns (the result, or the error's type
    and message, and the argv lines the binary recorded), with that
    directory written as ``DIR``."""
    load, create, ctx_cls = PACKAGES[pkg]
    load()
    d = tmp / pkg
    d.mkdir(exist_ok=True)
    args = {k: (str(d / v[4:]) if isinstance(v, str) and v.startswith("DIR/") else v)
            for k, v in args.items()}
    ex = create(name, args)
    ctx = ctx_cls(dag_id=1, task_id=1, task_name="sub", args=ex.args, workdir=str(d),
                  store=store)
    try:
        out = ex.work(ctx)
    except Exception as e:
        out = (type(e).__name__, str(e).replace(str(d), "DIR"))
    log = tmp / "bin" / "argv.log"
    argv = log.read_text().replace(str(d), "DIR").splitlines() if log.exists() else []
    if log.exists():
        log.unlink()
    if isinstance(out, dict):
        out = json.loads(json.dumps(out).replace(str(d), "DIR"))
    return out, argv


@pytest.fixture
def fake(tmp_path, monkeypatch):
    (tmp_path / "bin").mkdir()
    binary, _ = _fake_kaggle(tmp_path / "bin")
    monkeypatch.setenv("KAGGLE_USERNAME", "u")
    monkeypatch.setenv("KAGGLE_KEY", "k")
    return binary


@pytest.mark.parametrize("source", [{"competition": "titanic"}, {"dataset": "owner/data"}])
@pytest.mark.parametrize("unzip", [True, False])
def test_download_records_the_jax_executors_argv_and_files(tmp_path, fake, source, unzip):
    args = {**source, "out": "DIR/data", "kaggle_bin": str(fake), "unzip": unzip}
    want = _run("jax", tmp_path, "kaggle_download", args)
    got = _run("port", tmp_path, "kaggle_download", args)
    assert got == want
    res, argv = got
    assert res["path"] == "DIR/data"
    assert res["files"] == (["test.csv", "train.csv"] if unzip else ["data.zip"])
    assert argv[0].startswith("competitions download -c titanic" if "competition" in source
                              else "datasets download -d owner/data")


def test_download_defaults_into_the_workdir_through_path(tmp_path, fake, monkeypatch):
    monkeypatch.setenv("PATH", str(fake.parent))
    want = _run("jax", tmp_path, "kaggle_download", {"competition": "titanic"})
    got = _run("port", tmp_path, "kaggle_download", {"competition": "titanic"})
    assert got == want and got[0]["path"] == "DIR/kaggle"


def test_submit_follows_the_dependency_result(tmp_path, fake):
    rows = [{"name": "infer", "depends": "[]", "result": json.dumps({"preds": "/p/preds.csv"})},
            {"name": "sub", "depends": json.dumps(["infer"]), "result": None}]
    args = {"competition": "titanic", "message": "run 1", "kaggle_bin": str(fake)}
    stores = [_Store(rows), _Store(rows)]
    want = _run("jax", tmp_path, "kaggle_submit", args, store=stores[0])
    got = _run("port", tmp_path, "kaggle_submit", args, store=stores[1])
    assert got == want
    assert got[0] == {"competition": "titanic", "file": "/p/preds.csv", "output": "ok"}
    assert got[1] == ["competitions submit -c titanic -f /p/preds.csv -m run 1"]
    assert stores[0].logs == stores[1].logs and stores[1].logs


def test_submit_with_a_file_and_the_default_message(tmp_path, fake):
    args = {"competition": "titanic", "file": "/x/preds.csv", "kaggle_bin": str(fake)}
    want = _run("jax", tmp_path, "kaggle_submit", args)
    got = _run("port", tmp_path, "kaggle_submit", args)
    assert got == want
    assert got[1] == ["competitions submit -c titanic -f /x/preds.csv -m sub (dag 1)"]


@pytest.mark.parametrize("case", ["no_binary", "no_creds", "both_sources", "no_source",
                                  "cli_fails", "submit_no_file", "submit_no_competition"])
def test_errors_equal_the_jax_executors(tmp_path, fake, monkeypatch, case):
    name, args = "kaggle_download", {"competition": "titanic", "kaggle_bin": str(fake)}
    if case == "no_binary":
        monkeypatch.setenv("PATH", str(tmp_path / "empty"))
        args = {"competition": "titanic"}
    elif case == "no_creds":
        monkeypatch.delenv("KAGGLE_USERNAME")
        monkeypatch.setenv("HOME", str(tmp_path / "home"))
    elif case == "both_sources":
        args = {"competition": "a", "dataset": "b", "kaggle_bin": str(fake)}
    elif case == "no_source":
        args = {"kaggle_bin": str(fake)}
    elif case == "cli_fails":
        failing, _ = _fake_kaggle(tmp_path / "bin", fail=True)
        args = {"competition": "titanic", "kaggle_bin": str(failing)}
    elif case == "submit_no_file":
        name, args = "kaggle_submit", {"competition": "titanic", "kaggle_bin": str(fake)}
    else:
        name, args = "kaggle_submit", {"file": "p.csv", "kaggle_bin": str(fake)}
    want = _run("jax", tmp_path, name, args)
    got = _run("port", tmp_path, name, args)
    assert got == want
    assert isinstance(got[0], tuple) and got[0][0] in ("RuntimeError", "ValueError")
    if case == "cli_fails":
        assert "403 Forbidden" in got[0][1] and "(3)" in got[0][1]


def test_the_executors_are_registered():
    from mlcomp_tpu_torch.executors.base import EXECUTORS

    load_all()
    for name in ("kaggle_download", "kaggle_submit"):
        assert EXECUTORS.get(name).__module__ == "mlcomp_tpu_torch.executors.kaggle"
