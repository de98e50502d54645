"""Executors of the port: the counterpart of mlcomp_tpu/executors.

Registered: the basic executors, ``train`` (and its ``catalyst`` alias),
``valid``, ``infer``, ``generate``, ``serve_replica``, ``kaggle_download``
and ``kaggle_submit``.
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
    from mlcomp_tpu_torch.executors import infer as _infer  # noqa: F401
    from mlcomp_tpu_torch.executors import kaggle as _kaggle  # noqa: F401
    from mlcomp_tpu_torch.executors import serve as _serve  # noqa: F401
    from mlcomp_tpu_torch.executors import train as _train  # noqa: F401
