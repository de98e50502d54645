from mlcomp_tpu_torch.dag.schema import DagSpec, TaskSpec, TaskStatus
from mlcomp_tpu_torch.dag.parser import parse_dag, expand_grid
from mlcomp_tpu_torch.dag.graph import topo_sort, ready_tasks, validate_dag

__all__ = [
    "DagSpec",
    "TaskSpec",
    "TaskStatus",
    "parse_dag",
    "expand_grid",
    "topo_sort",
    "ready_tasks",
    "validate_dag",
]
