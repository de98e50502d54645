"""Executor base class, registry, and execution context.

The reference's Executor base is the unit of work a task runs; subclasses
are registered by name so YAML can reference them, and the worker
instantiates one per task (reference behavior: BASELINE.json:5 — "the
Executor base and catalyst-runner wrapper emit ... train steps").  Here an
executor's ``work()`` produces/consumes host-side state and launches JAX
computations; everything it needs from the scheduler arrives through the
``ExecutionContext``.
"""

from __future__ import annotations

import traceback
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from mlcomp_tpu_torch.utils.registry import Registry

EXECUTORS: Registry = Registry("executors")


@dataclass
class ExecutionContext:
    """Scheduler-provided handle a running executor talks back through."""

    dag_id: int
    task_id: int
    task_name: str
    args: Dict[str, Any]
    store: Any = None          # db.Store; None in unit tests
    workdir: str = "."
    chips: int = 0             # chips granted to this task
    stage: str = "generic"
    # False on non-zero slots of a multi-host gang: those processes run
    # the same SPMD program and would write duplicate metric points; logs
    # stay on (prefixed by the child runner) for debuggability
    primary: bool = True
    # the worker name this attempt runs under (from the claim row); lets
    # long-running executors re-check ownership before side effects that
    # could race a reassigned attempt (e.g. the preemption checkpoint)
    worker: Optional[str] = None
    # the torch device the executor runs on (``None``: ``cuda``); the
    # CLI's ``--device``, through the worker (inline) or the child's spec
    device: Optional[str] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    def log(self, message: str, level: str = "info") -> None:
        if self.store is not None:
            self.store.log(self.task_id, level, message)

    def metric(self, name: str, value: float, step: int = 0) -> None:
        if self.store is not None and self.primary:
            self.store.metric(self.task_id, name, value, step)

    def report(self, name: str, payload: Dict[str, Any]) -> None:
        """Persist a report artifact (report/artifacts.py payload)."""
        if self.store is not None and self.primary:
            self.store.add_report(self.task_id, name, payload)


class Executor:
    """Base executor: subclass, set ``name``, implement ``work()``.

    ``work()`` returns an optional JSON-serializable result dict that is
    stored on the task row (downstream tasks and the report server read it).
    """

    #: override in subclasses; used for registration via __init_subclass__
    name: Optional[str] = None

    def __init__(self, **args: Any):
        self.args = args

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if cls.name:
            EXECUTORS.register(cls.name, obj=cls)

    # -- lifecycle -----------------------------------------------------------

    def work(self, ctx: ExecutionContext) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def __call__(self, ctx: ExecutionContext) -> Optional[Dict[str, Any]]:
        return self.work(ctx)


def create_executor(type_name: str, args: Dict[str, Any]) -> Executor:
    cls = EXECUTORS.get(type_name)
    return cls(**args)


def run_task(
    type_name: str, ctx: ExecutionContext
) -> tuple[bool, Optional[Dict[str, Any]], Optional[str]]:
    """Instantiate + run an executor; never raises.

    Returns ``(ok, result, error_traceback)`` — the worker's single entry
    point so scheduling code has exactly one failure boundary.
    """
    try:
        from mlcomp_tpu_torch.utils.faults import inject

        inject("executor.work")  # chaos hook: die like a real OOM/segv would
        ex = create_executor(type_name, ctx.args)
        result = ex(ctx)
        return True, result, None
    except Exception:
        return False, None, traceback.format_exc()
