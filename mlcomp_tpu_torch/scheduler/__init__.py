from mlcomp_tpu_torch.scheduler.supervisor import Supervisor
from mlcomp_tpu_torch.scheduler.worker import Worker
from mlcomp_tpu_torch.scheduler.local import run_dag_local

__all__ = ["Supervisor", "Worker", "run_dag_local"]
