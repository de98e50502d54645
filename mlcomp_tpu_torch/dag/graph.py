"""DAG graph algorithms: validation, topological order, ready-set.

The Supervisor needs (a) cycle detection at submit time and (b) the set of
tasks whose dependencies are all satisfied, each scheduling tick (reference
behavior: BASELINE.json:5 — "Supervisor/Worker scheduler").
"""

from __future__ import annotations

import os
from collections import deque
from typing import Dict, Iterable, List, Mapping, Set

import numpy as np

from mlcomp_tpu_torch import native
from mlcomp_tpu_torch.dag.schema import DagSpec, TaskSpec, TaskStatus


class DagValidationError(ValueError):
    pass


def validate_dag(dag: DagSpec) -> None:
    names = [t.name for t in dag.tasks]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise DagValidationError(f"duplicate task names: {sorted(dupes)}")
    name_set = set(names)
    for t in dag.tasks:
        for d in t.depends:
            if d not in name_set:
                raise DagValidationError(
                    f"task {t.name!r} depends on unknown task {d!r}"
                )
            if d == t.name:
                raise DagValidationError(f"task {t.name!r} depends on itself")
    topo_sort(dag.tasks)  # raises on cycle
    races = detect_write_races(dag.tasks)
    if races:
        raise DagValidationError(
            "write-write races (same output path, no dependency ordering): "
            + "; ".join(races)
        )


#: task-arg keys that declare an output location the task will write.
#: NOTE: ``ckpt_dir`` is deliberately absent — executors treat it as a
#: read-only restore source (executors/infer.py), and parallel readers of
#: one checkpoint are the normal fan-out pattern, not a race.
_OUTPUT_KEYS = ("out",)


def detect_write_races(tasks: Iterable[TaskSpec]) -> List[str]:
    """Static data-race detector over declared output paths.

    Two tasks that can run CONCURRENTLY (no dependency path between them)
    and declare the same output location (``out`` arg) race on the
    filesystem — the classic scheduler hazard the aux race-detection
    subsystem exists to catch before any worker runs.  Ordered writers
    (one is a transitive dependency of the other) are allowed: overwrite
    is deliberate staging there.
    """
    tasks = list(tasks)
    writers: Dict[str, List[str]] = {}
    for t in tasks:
        # set: a task writing one path under several keys isn't self-racing
        for path in {
            os.path.normpath(t.args[key])
            for key in _OUTPUT_KEYS
            if isinstance(t.args.get(key), str) and t.args[key]
        }:
            writers.setdefault(path, []).append(t.name)

    collisions = {p: ns for p, ns in writers.items() if len(ns) > 1}
    if not collisions:
        return []

    # ancestor sets only for colliding tasks (BFS up the dependency edges)
    by_name = {t.name: t for t in tasks}

    def ancestors(name: str) -> Set[str]:
        seen: Set[str] = set()
        stack = list(by_name[name].depends)
        while stack:
            d = stack.pop()
            if d in seen:
                continue
            seen.add(d)
            stack.extend(by_name[d].depends)
        return seen

    races = []
    for path, names in sorted(collisions.items()):
        anc = {n: ancestors(n) for n in names}
        for i, a in enumerate(names):
            for b in names[i + 1 :]:
                if a not in anc[b] and b not in anc[a]:
                    races.append(f"{a!r} and {b!r} both write {path!r}")
    return races


def topo_sort(tasks: Iterable[TaskSpec]) -> List[TaskSpec]:
    """Kahn's algorithm; deterministic (input order) among ready tasks."""
    tasks = list(tasks)
    indeg: Dict[str, int] = {t.name: len(t.depends) for t in tasks}
    dependents: Dict[str, List[str]] = {t.name: [] for t in tasks}
    by_name = {t.name: t for t in tasks}
    for t in tasks:
        for d in t.depends:
            dependents[d].append(t.name)
    queue = deque([t.name for t in tasks if indeg[t.name] == 0])
    order: List[TaskSpec] = []
    while queue:
        n = queue.popleft()
        order.append(by_name[n])
        for m in dependents[n]:
            indeg[m] -= 1
            if indeg[m] == 0:
                queue.append(m)
    if len(order) != len(tasks):
        stuck = sorted(set(by_name) - {t.name for t in order})
        raise DagValidationError(f"cycle detected involving: {stuck}")
    return order


def ready_tasks(
    tasks: Iterable[TaskSpec], statuses: Mapping[str, TaskStatus]
) -> List[TaskSpec]:
    """Tasks that are NOT_RAN and whose deps all succeeded.

    A failed/skipped/stopped dependency does NOT make a task ready; the
    scheduler marks such downstream tasks SKIPPED (see supervisor).
    """
    out = []
    for t in tasks:
        if statuses.get(t.name, TaskStatus.NOT_RAN) != TaskStatus.NOT_RAN:
            continue
        if all(statuses.get(d) == TaskStatus.SUCCESS for d in t.depends):
            out.append(t)
    return out


class DagAnalyzer:
    """Per-DAG scheduling analysis with a native fast path.

    Builds the dependency CSR once (task sets are immutable after submit),
    then each ``analyze`` call returns ``(ready, doomed)`` in one O(V+E)
    native pass (``mlcomp_tpu_torch/native/schedcore.cpp``); the Python
    walk below is the always-available fallback with the same results.
    Ready tasks come back sorted by (-priority, declaration order)."""

    def __init__(self, tasks: Iterable[TaskSpec]):
        self.tasks = list(tasks)
        self._index = {t.name: i for i, t in enumerate(self.tasks)}
        offsets = [0]
        deps: List[int] = []
        for t in self.tasks:
            deps.extend(self._index[d] for d in t.depends)
            offsets.append(len(deps))
        self._dep_off = np.asarray(offsets, dtype=np.int64)
        self._deps = np.asarray(deps, dtype=np.int64)
        self._prio = np.asarray([t.resources.priority for t in self.tasks], dtype=np.int64)

    _STATUS_CODE = {
        TaskStatus.NOT_RAN: 0,
        TaskStatus.SUCCESS: 2,
        TaskStatus.FAILED: 3,
        TaskStatus.SKIPPED: 3,
        TaskStatus.STOPPED: 3,
    }

    def analyze(
        self, statuses: Mapping[str, TaskStatus]
    ) -> tuple[List[TaskSpec], Set[str]]:
        status = np.asarray(
            [self._STATUS_CODE.get(statuses.get(t.name, TaskStatus.NOT_RAN), 1)
             for t in self.tasks],
            dtype=np.int8,
        )
        res = native.dag_analyze(self._dep_off, self._deps, status, self._prio)
        if res is None:  # no toolchain, or a cycle: the Python walk
            ready = sorted(
                ready_tasks(self.tasks, statuses),
                key=lambda t: (-t.resources.priority, self._index[t.name]),
            )
            return ready, doomed_tasks(self.tasks, statuses)
        ready_idx, doomed_idx = res
        return (
            [self.tasks[i] for i in ready_idx],
            {self.tasks[i].name for i in doomed_idx},
        )


def doomed_tasks(
    tasks: Iterable[TaskSpec], statuses: Mapping[str, TaskStatus]
) -> Set[str]:
    """Transitive closure of tasks downstream of a failure/skip/stop."""
    bad = {
        n
        for n, s in statuses.items()
        if s in (TaskStatus.FAILED, TaskStatus.SKIPPED, TaskStatus.STOPPED)
    }
    tasks = list(tasks)
    changed = True
    doomed: Set[str] = set()
    while changed:
        changed = False
        for t in tasks:
            if t.name in bad or t.name in doomed:
                continue
            if any(d in bad or d in doomed for d in t.depends):
                if statuses.get(t.name, TaskStatus.NOT_RAN) == TaskStatus.NOT_RAN:
                    doomed.add(t.name)
                    changed = True
    return doomed
