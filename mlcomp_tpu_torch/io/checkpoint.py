"""Checkpoint save/restore of the port's TrainState.

The port of mlcomp_tpu/io/checkpoint.py's training half.  The format is
the port's own, not orbax's: a checkpoint is a step-numbered directory
``<directory>/<step>/`` holding ``state.pt``, a ``torch.save`` of
``TrainState.state_dict()`` (step, parameters by flax path, optimizer
state, EMA parameters) with every tensor copied to the host.  A save
writes into a temporary directory and renames it, so a reader sees a
whole checkpoint or none; the newest ``max_to_keep`` are kept.
:class:`AsyncCheckpointWriter` copies the state to the host before
``save`` returns (the next step may update the parameters in place) and
writes it on a background thread.  ``read_weights``, ``restore_eval_state``
and ``average_checkpoints`` come with the valid/infer executors.
"""

from __future__ import annotations

import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import torch

_FILE = "state.pt"


def _steps(directory: Path):
    if not directory.is_dir():
        return []
    return sorted(int(p.name) for p in directory.iterdir()
                  if p.name.isdigit() and (p / _FILE).exists())


def latest_step(directory: str | Path) -> Optional[int]:
    """The newest complete checkpoint's step under ``directory``, or None."""
    steps = _steps(Path(directory))
    return steps[-1] if steps else None


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _write(directory: Path, host_state: Dict[str, Any], step: int, max_to_keep: int) -> str:
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / str(int(step))
    tmp = directory / f".tmp-{int(step)}-{os.getpid()}-{threading.get_ident()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    torch.save(host_state, tmp / _FILE)
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    for old in _steps(directory)[:-max_to_keep]:
        shutil.rmtree(directory / str(old), ignore_errors=True)
    return str(final)


def save_checkpoint(directory: str | Path, state: Any, step: int,
                    max_to_keep: int = 3) -> str:
    """Save ``state`` (a TrainState, or any object with ``state_dict()``,
    or a plain dict) as step ``step``; returns the step directory."""
    payload = state.state_dict() if hasattr(state, "state_dict") else state
    return _write(Path(directory).absolute(), _to_host(payload), step, max_to_keep)


def restore_checkpoint(directory: str | Path, target: Any, step: Optional[int] = None) -> Any:
    """Load step ``step`` (default the newest) into ``target`` in place
    (``target.load_state_dict``) and return it.  A TrainState adapts to
    an EMA mismatch as the JAX package's restore does (see
    ``TrainState.load_state_dict``)."""
    directory = Path(directory).absolute()
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    payload = torch.load(directory / str(int(step)) / _FILE, map_location="cpu",
                         weights_only=False)
    target.load_state_dict(payload)
    return target


class AsyncCheckpointWriter:
    """Saves that overlap training: ``save`` copies the state to the host
    and returns; a background thread writes it.  ``wait()`` joins the
    outstanding write; always ``close()`` before reading ``latest_step``
    or restoring from the same directory."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.max_to_keep = max_to_keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, state: Any, step: int) -> None:
        self.wait()
        payload = state.state_dict() if hasattr(state, "state_dict") else state
        host = _to_host(payload)

        def run():
            try:
                _write(self.directory, host, step, self.max_to_keep)
            except BaseException as e:  # re-raised by wait() on the caller's thread
                self._error = e

        self._thread = threading.Thread(target=run, name="ckpt-writer", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()

    def __enter__(self) -> "AsyncCheckpointWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
