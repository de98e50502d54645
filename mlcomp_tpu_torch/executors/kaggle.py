"""Kaggle integration executors (upstream mlcomp ships kaggle download /
submit stages in its DAG vocabulary): the port's copy of
mlcomp_tpu/executors/kaggle.py, which needs no device.

Both executors drive the ``kaggle`` CLI via subprocess — the official
client is not baked into this image and the TPU-VM fleet may have no
egress, so availability is checked up front and the failure message says
exactly what is missing (binary vs credentials) instead of surfacing an
opaque stack trace mid-DAG.  ``kaggle_bin`` arg overrides the binary for
air-gapped mirrors (and the tests).
"""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path
from typing import Any, Dict, Optional

from mlcomp_tpu_torch.executors.base import ExecutionContext, Executor


def _check_kaggle(kaggle_bin: str) -> str:
    path = shutil.which(kaggle_bin)
    if path is None:
        raise RuntimeError(
            f"kaggle CLI {kaggle_bin!r} not found on PATH; install the "
            "official client (pip install kaggle) or set kaggle_bin"
        )
    has_creds = (
        (Path.home() / ".kaggle" / "kaggle.json").exists()
        or ("KAGGLE_USERNAME" in os.environ and "KAGGLE_KEY" in os.environ)
    )
    if not has_creds:
        raise RuntimeError(
            "no kaggle credentials: put an API token at ~/.kaggle/kaggle.json "
            "or set KAGGLE_USERNAME + KAGGLE_KEY"
        )
    return path


def _run(args, timeout_s: float) -> str:
    proc = subprocess.run(
        args, capture_output=True, text=True, timeout=timeout_s
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"{' '.join(args)} failed ({proc.returncode}): "
            f"{proc.stderr.strip() or proc.stdout.strip()}"
        )
    return proc.stdout


class KaggleDownloadExecutor(Executor):
    """Download a competition's (or dataset's) files before training.

    args: ``competition`` or ``dataset``, ``out`` dir (default workdir),
    ``unzip`` (default True), ``kaggle_bin``, ``timeout_s``.
    """

    name = "kaggle_download"

    def work(self, ctx: ExecutionContext) -> Optional[Dict[str, Any]]:
        args = dict(self.args)
        comp = args.get("competition")
        dataset = args.get("dataset")
        if bool(comp) == bool(dataset):
            raise ValueError("give exactly one of competition / dataset")
        out = Path(args.get("out", Path(ctx.workdir) / "kaggle"))
        out.mkdir(parents=True, exist_ok=True)
        binary = _check_kaggle(args.get("kaggle_bin", "kaggle"))
        cmd = (
            [binary, "competitions", "download", "-c", comp]
            if comp
            else [binary, "datasets", "download", "-d", dataset]
        )
        cmd += ["-p", str(out)]
        _run(cmd, float(args.get("timeout_s", 3600)))
        if args.get("unzip", True):
            import zipfile

            for z in sorted(out.glob("*.zip")):
                with zipfile.ZipFile(z) as f:
                    f.extractall(out)
                z.unlink()
        files = sorted(p.name for p in out.iterdir())
        ctx.log(f"kaggle download -> {out} ({len(files)} files)")
        return {"path": str(out), "files": files}


class KaggleSubmitExecutor(Executor):
    """Submit a predictions file to a competition (the reference DAGs'
    terminal stage).  args: ``competition``, ``file`` (or the ``preds``
    result of the task this one depends on), ``message``, ``kaggle_bin``,
    ``timeout_s``."""

    name = "kaggle_submit"

    def work(self, ctx: ExecutionContext) -> Optional[Dict[str, Any]]:
        import json

        args = dict(self.args)
        comp = args.get("competition")
        if not comp:
            raise ValueError("kaggle_submit needs a competition")
        path = args.get("file")
        if not path and ctx.store is not None:
            # follow the dependency edge to an infer task's output
            rows = {r["name"]: r for r in ctx.store.task_rows(ctx.dag_id)}
            me = rows.get(ctx.task_name)
            for name in json.loads(me["depends"]) if me else []:
                row = rows.get(name)
                if row and row["result"]:
                    res = json.loads(row["result"])
                    if isinstance(res, dict) and "preds" in res:
                        path = res["preds"]
                        break
        if not path:
            raise ValueError("kaggle_submit: no file arg and no upstream preds")
        binary = _check_kaggle(args.get("kaggle_bin", "kaggle"))
        message = args.get("message", f"{ctx.task_name} (dag {ctx.dag_id})")
        out = _run(
            [binary, "competitions", "submit", "-c", comp, "-f", str(path),
             "-m", message],
            float(args.get("timeout_s", 600)),
        )
        ctx.log(f"kaggle submit {path} -> {comp}: {out.strip()}")
        return {"competition": comp, "file": str(path), "output": out.strip()}
