"""Executors of the port: the counterpart of mlcomp_tpu/executors.

This slice registers ``train`` (and its ``catalyst`` alias) beside the
basic executors; ``valid``, ``infer``, ``generate``, ``kaggle`` and
``serve_replica`` are not ported yet.
"""

from mlcomp_tpu_torch.executors.base import (
    EXECUTORS,
    ExecutionContext,
    Executor,
    create_executor,
)

# Import built-in executors so registration side effects run.
from mlcomp_tpu_torch.executors import basic as _basic  # noqa: F401

__all__ = ["EXECUTORS", "ExecutionContext", "Executor", "create_executor"]


def load_all() -> None:
    """Import every ported executor module for its registration."""
    from mlcomp_tpu_torch.executors import train as _train  # noqa: F401
