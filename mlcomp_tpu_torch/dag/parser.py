"""YAML → DagSpec: the "pipe" interpreter and grid-search expansion.

The reference runs YAML DAG files with an ``info:`` header and an
``executors:`` map; grid-search configs expand a parameter grid into
parallel tasks fanned out by the Supervisor (reference behavior:
BASELINE.json:5 and BASELINE.json:11 — "Grid-search multi-task DAG
(Supervisor fan-out across TPU workers)").  The accepted schema:

.. code-block:: yaml

    info:
      name: mnist
      project: examples
    executors:
      preprocess:
        type: preprocess
        args: {out: /tmp/data}
      train:
        type: train
        depends: preprocess        # str or list
        stage: train
        resources: {chips: 8}
        grid:                      # optional: cartesian fan-out
          lr: [1e-3, 1e-4]
          model.width: [128, 256]
        args:
          epochs: 3

``grid:`` expands the task into one task per point of the cartesian
product; dotted keys index into nested ``args``.  Downstream tasks that
depended on the gridded task depend on *all* expansions (a join), matching
the Supervisor fan-out/fan-in semantics.
"""

from __future__ import annotations

import copy
import itertools
from pathlib import Path
from typing import Any, Dict, Iterable, List, Mapping, Sequence, Tuple, Union

from mlcomp_tpu_torch.dag.schema import DagSpec, ResourceSpec, TaskSpec, STAGES
from mlcomp_tpu_torch.utils.config import ConfigError, load_config, loads_config


def _as_tuple(value: Union[None, str, Sequence[str]]) -> Tuple[str, ...]:
    if value is None:
        return ()
    if isinstance(value, str):
        return (value,)
    return tuple(value)


def _set_dotted(d: Dict[str, Any], dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    cur = d
    for p in parts[:-1]:
        cur = cur.setdefault(p, {})
        if not isinstance(cur, dict):
            raise ConfigError(f"grid key {dotted!r} collides with non-dict value")
    cur[parts[-1]] = value


def expand_grid(
    name: str, grid: Mapping[str, Sequence[Any]], base_args: Mapping[str, Any]
) -> List[Tuple[str, Dict[str, Any], Tuple[Tuple[str, Any], ...]]]:
    """Cartesian expansion of ``grid`` over ``base_args``.

    Returns ``[(task_name, args, grid_params), ...]`` with deterministic
    ordering (YAML key order × value order).
    """
    if not grid:
        return [(name, dict(base_args), ())]
    keys = list(grid.keys())
    value_lists = []
    for k in keys:
        vals = grid[k]
        if not isinstance(vals, (list, tuple)) or not vals:
            raise ConfigError(f"grid key {k!r} must map to a non-empty list")
        value_lists.append(list(vals))
    out = []
    for i, combo in enumerate(itertools.product(*value_lists)):
        # deep copy per point: grid keys mutate nested dicts in place
        args: Dict[str, Any] = copy.deepcopy(dict(base_args))
        for k, v in zip(keys, combo):
            _set_dotted(args, k, v)
        out.append((f"{name}[{i}]", args, tuple(zip(keys, combo))))
    return out


def parse_dag(
    source: Union[str, Path, Mapping[str, Any]],
    overrides: Mapping[str, Any] | None = None,
) -> DagSpec:
    """Parse a YAML file path, YAML text, or pre-loaded mapping into a DagSpec."""
    from mlcomp_tpu_torch.utils.config import interpolate, merge_config

    if isinstance(source, Mapping):
        cfg = dict(source)
        if overrides:
            cfg = merge_config(cfg, dict(overrides))
        cfg = interpolate(cfg)
    else:
        p = Path(source)
        if p.suffix in (".yml", ".yaml") or p.exists():
            cfg = load_config(p, overrides=overrides)
        else:
            cfg = loads_config(str(source), overrides=overrides)

    info = cfg.get("info", {})
    if not isinstance(info, Mapping) or "name" not in info:
        raise ConfigError("dag config must have info.name")
    executors = cfg.get("executors")
    if not isinstance(executors, Mapping) or not executors:
        raise ConfigError("dag config must have a non-empty executors map")

    tasks: List[TaskSpec] = []
    # name → list of concrete task names (≠1 when grid-expanded)
    produced: Dict[str, List[str]] = {}

    for ex_name, spec in executors.items():
        if not isinstance(spec, Mapping):
            raise ConfigError(f"executor {ex_name!r} must be a mapping")
        ex_type = spec.get("type", ex_name)
        stage = spec.get("stage", "generic")
        if stage not in STAGES:
            raise ConfigError(
                f"executor {ex_name!r}: unknown stage {stage!r}; valid: {STAGES}"
            )
        res_cfg = spec.get("resources", {}) or {}
        resources = ResourceSpec(
            chips=int(res_cfg.get("chips", 0)),
            hosts=int(res_cfg.get("hosts", 1)),
            memory_gb=float(res_cfg.get("memory_gb", 0.0)),
            priority=int(res_cfg.get("priority", 0)),
        )
        base_args = dict(spec.get("args", {}) or {})
        grid = spec.get("grid", {}) or {}
        expansions = expand_grid(ex_name, grid, base_args)
        produced[ex_name] = [n for n, _, _ in expansions]

        raw_depends = _as_tuple(spec.get("depends"))
        for gi, (task_name, args, grid_params) in enumerate(expansions):
            tasks.append(
                TaskSpec(
                    name=task_name,
                    executor=str(ex_type),
                    args=args,
                    depends=raw_depends,  # resolved to concrete names below
                    stage=stage,
                    resources=resources,
                    max_retries=int(spec.get("max_retries", 0)),
                    grid_index=gi if grid else None,
                    grid_params=grid_params if grid else None,
                )
            )

    # Resolve declared dependencies (executor names) to concrete task names;
    # a dependency on a gridded executor joins on all of its expansions.
    resolved: List[TaskSpec] = []
    for t in tasks:
        deps: List[str] = []
        for d in t.depends:
            if d not in produced:
                raise ConfigError(
                    f"task {t.name!r} depends on unknown executor {d!r}"
                )
            deps.extend(produced[d])
        resolved.append(t.with_depends(tuple(deps)))

    dag = DagSpec(
        name=str(info["name"]),
        project=str(info.get("project", "default")),
        tasks=tuple(resolved),
        config=dict(cfg),
    )
    # fail fast on cycles / dangling names
    from mlcomp_tpu_torch.dag.graph import validate_dag

    validate_dag(dag)
    return dag
