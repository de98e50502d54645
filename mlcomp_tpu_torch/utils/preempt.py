"""Preemption handling: turn SIGTERM into a checkpoint + free requeue.

Spot/preemptible TPU-VMs get a SIGTERM (then ~30 s of grace) before the
VM is reclaimed — the dominant interruption mode for cheap fleet
capacity, and one a retry budget should not be spent on.  The pieces:

- the task child installs :func:`install_signal_handler`
  (scheduler/child.py) so SIGTERM sets a flag instead of killing the
  process mid-step;
- the Trainer checks the flag between steps (train/loop.py) and raises
  :class:`TaskPreempted`;
- the train executor catches it, saves a checkpoint at the current
  step, and re-raises (executors/train.py);
- the worker recognizes the marker in the failure and requeues WITHOUT
  consuming a retry (scheduler/worker.py ``_finalize`` — same durable
  cap as the coordinator-port path, so a pathological loop stays
  bounded); the resumed attempt restores the checkpoint and continues.

Non-training executors don't poll the flag; for them SIGTERM simply no
longer kills the child process itself — the worker's group-kill
escalates to SIGKILL after its grace period, and shell executors'
subprocesses still receive the group SIGTERM directly.
"""

from __future__ import annotations

import threading

_flag = threading.Event()


class TaskPreempted(RuntimeError):
    """Raised by the train loop when a preemption was requested; carries
    the marker the worker's requeue classification matches on."""


def install_signal_handler() -> None:
    """Route SIGTERM (and SIGUSR1, common in custom preemption notifiers)
    to the flag.  Call from the process MAIN thread only (signal module
    contract)."""
    import signal

    def handler(signum, frame):
        _flag.set()

    signal.signal(signal.SIGTERM, handler)
    signal.signal(signal.SIGUSR1, handler)


def request_preemption() -> None:
    """Set the flag programmatically (tests, custom notifier daemons)."""
    _flag.set()


def preemption_requested() -> bool:
    return _flag.is_set()


def clear() -> None:
    """Reset the flag (test isolation; a fresh child starts clear)."""
    _flag.clear()
