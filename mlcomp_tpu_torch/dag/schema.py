"""DAG / task data model.

mlcomp represents work as a DAG of tasks; each task names an executor and
may depend on other tasks (reference behavior: BASELINE.json:5 — "YAML DAGs
(train/infer/valid stages)"; upstream mlcomp stores Dag/Task rows in
PostgreSQL with statuses queued→in_progress→success/failed).  Here the
model is a frozen dataclass layer shared by the parser, the sqlite store,
and the scheduler.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


class TaskStatus(str, enum.Enum):
    NOT_RAN = "not_ran"
    QUEUED = "queued"
    IN_PROGRESS = "in_progress"
    SUCCESS = "success"
    FAILED = "failed"
    SKIPPED = "skipped"
    STOPPED = "stopped"

    @property
    def finished(self) -> bool:
        return self in (
            TaskStatus.SUCCESS,
            TaskStatus.FAILED,
            TaskStatus.SKIPPED,
            TaskStatus.STOPPED,
        )


# Stages a task can belong to; mirrors the reference's train/infer/valid
# pipeline stages (BASELINE.json:5).
STAGES = ("train", "valid", "infer", "preprocess", "submit", "generic")


@dataclass(frozen=True)
class ResourceSpec:
    """What a task needs from the scheduler.

    The reference pins per-GPU Docker workers; here the unit is TPU chips
    on a TPU-VM slice (BASELINE.json:5 — "provisions and pins TPU-VM
    slices in place of per-GPU Docker workers").
    """

    chips: int = 0          # TPU chips required (0 = CPU-only task)
    hosts: int = 1          # TPU-VM hosts (multi-host slice if > 1)
    memory_gb: float = 0.0  # host RAM hint
    priority: int = 0       # higher runs first

    def fits(self, free_chips: int, free_hosts: int = 1) -> bool:
        return self.chips <= free_chips and self.hosts <= free_hosts


@dataclass(frozen=True)
class TaskSpec:
    """One node of a DAG: an executor invocation."""

    name: str
    executor: str                       # registered executor type
    args: Dict[str, Any] = field(default_factory=dict)
    depends: Tuple[str, ...] = ()
    stage: str = "generic"
    resources: ResourceSpec = field(default_factory=ResourceSpec)
    max_retries: int = 0
    grid_index: Optional[int] = None    # set for grid-expanded tasks
    grid_params: Optional[Tuple[Tuple[str, Any], ...]] = None

    def with_depends(self, depends: Tuple[str, ...]) -> "TaskSpec":
        return dataclasses.replace(self, depends=depends)


@dataclass(frozen=True)
class DagSpec:
    """A parsed, grid-expanded DAG ready for scheduling."""

    name: str
    project: str
    tasks: Tuple[TaskSpec, ...]
    config: Dict[str, Any] = field(default_factory=dict)  # raw YAML for audit

    def task(self, name: str) -> TaskSpec:
        for t in self.tasks:
            if t.name == name:
                return t
        raise KeyError(f"no task named {name!r} in dag {self.name!r}")

    @property
    def task_names(self) -> List[str]:
        return [t.name for t in self.tasks]
