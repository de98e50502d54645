"""Built-in non-JAX executors: noop, shell, python-callable, submit.

Upstream mlcomp ships utility executors beside the Catalyst wrappers
(preprocess / submit packaging); these are their TPU-framework equivalents
and double as scheduler test fixtures.
"""

from __future__ import annotations

import importlib
import subprocess
import tarfile
from pathlib import Path
from typing import Any, Dict, Optional

from mlcomp_tpu_torch.executors.base import ExecutionContext, Executor


class Noop(Executor):
    name = "noop"

    def work(self, ctx: ExecutionContext) -> Optional[Dict[str, Any]]:
        ctx.log(f"noop task {ctx.task_name}")
        return {"ok": True}


class Fail(Executor):
    """Deterministic failure — scheduler/retry test fixture."""

    name = "fail"

    def work(self, ctx: ExecutionContext) -> Optional[Dict[str, Any]]:
        raise RuntimeError(self.args.get("message", "intentional failure"))


class Shell(Executor):
    """Run a shell command; fails the task on non-zero exit."""

    name = "shell"

    def work(self, ctx: ExecutionContext) -> Optional[Dict[str, Any]]:
        cmd = self.args["command"]
        ctx.log(f"$ {cmd}")
        proc = subprocess.run(
            cmd, shell=True, capture_output=True, text=True, cwd=ctx.workdir
        )
        if proc.stdout:
            ctx.log(proc.stdout.rstrip())
        if proc.stderr:
            ctx.log(proc.stderr.rstrip(), level="error")
        if proc.returncode != 0:
            raise RuntimeError(f"command exited {proc.returncode}: {cmd}")
        return {"returncode": proc.returncode}


class PyFunc(Executor):
    """Call ``module.path:function(**kwargs)`` — escape hatch for custom steps."""

    name = "pyfunc"

    def work(self, ctx: ExecutionContext) -> Optional[Dict[str, Any]]:
        target = self.args["target"]
        mod_name, _, fn_name = target.partition(":")
        if not fn_name:
            raise ValueError(f"pyfunc target must be 'module:function', got {target!r}")
        fn = getattr(importlib.import_module(mod_name), fn_name)
        out = fn(ctx=ctx, **self.args.get("kwargs", {}))
        return out if isinstance(out, dict) else {"value": out}


class Submit(Executor):
    """Package artifacts into a tarball (the reference's submission packaging)."""

    name = "submit"

    def work(self, ctx: ExecutionContext) -> Optional[Dict[str, Any]]:
        sources = self.args.get("sources", [])
        out = Path(self.args.get("out", Path(ctx.workdir) / "submission.tar.gz"))
        out.parent.mkdir(parents=True, exist_ok=True)
        n = 0
        with tarfile.open(out, "w:gz") as tar:
            for src in sources:
                p = Path(src)
                if p.exists():
                    tar.add(p, arcname=p.name)
                    n += 1
                else:
                    ctx.log(f"missing artifact: {p}", level="warning")
        ctx.log(f"packaged {n} artifacts -> {out}")
        return {"path": str(out), "artifacts": n}
