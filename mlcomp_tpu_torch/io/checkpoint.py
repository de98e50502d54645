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
writes it on a background thread.  A model with BatchNorm statistics
carries them as ``model_state`` (``batch_stats/<flax path>``), which every
reader below restores beside the weights and the average averages.

The eval side reads weights only: :func:`read_weights` (the flax-layout
params tree, EMA weights preferred), :func:`restore_eval_state` (those
weights into a TrainState, for the valid/infer/generate executors) and
:func:`average_checkpoints` (a weight-space average saved as a
weights-only checkpoint, which both readers and ``serve --ckpt`` take).

A sharded state (a Trainer under a mesh) saves the same file: its
``state_dict`` gathers every shard (a collective, so every rank calls the
save), and only the primary rank (gang slot 0, ``primary=True``) writes.
So an unsharded Trainer and ``serve --ckpt`` load a sharded run's
checkpoint, and restoring places each saved tensor's shards on the ranks
(``TrainState.load_state_dict``), so an unsharded checkpoint resumes
under a mesh.
"""

from __future__ import annotations

import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np
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
                    max_to_keep: int = 3, primary: bool = True) -> str:
    """Save ``state`` (a TrainState, or any object with ``state_dict()``,
    or a plain dict) as step ``step``; returns the step directory.  Every
    rank of a sharded state calls it; only the ``primary`` one writes."""
    payload = state.state_dict() if hasattr(state, "state_dict") else state
    directory = Path(directory).absolute()
    if not primary:
        return str(directory / str(int(step)))
    return _write(directory, _to_host(payload), step, max_to_keep)


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

    def __init__(self, directory: str | Path, max_to_keep: int = 3, primary: bool = True):
        self.directory = Path(directory).absolute()
        self.max_to_keep = max_to_keep
        # every rank of a sharded state saves (the gather is a collective);
        # only the primary writes
        self.primary = primary
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, state: Any, step: int) -> None:
        self.wait()
        payload = state.state_dict() if hasattr(state, "state_dict") else state
        if not self.primary:
            return
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


def _read(directory: str | Path, step: Optional[int]) -> Dict[str, Any]:
    directory = Path(directory).absolute()
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    # mmap: the optimizer state is not read unless touched
    payload = torch.load(directory / str(int(step)) / _FILE, map_location="cpu",
                         weights_only=False, mmap=True)
    payload.setdefault("step", step)
    return payload


def _flat_weights(payload: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The weights a checkpoint serves, by flax path: the EMA parameters
    when it tracked them, else the parameters."""
    return payload.get("ema_params") or payload["params"]


def read_weights(directory: str | Path, step: Optional[int] = None) -> Dict[str, Any]:
    """Weights-only read to the host: ``{"params": the flax-layout tree
    (nested dicts of CPU tensors in the training shapes), "model_state":
    {"batch_stats": tree} or {}, "step"}``, preferring the EMA weights when
    the checkpoint carries them.  Needs no TrainState: the building block of ``serve --ckpt DIR``
    and of :func:`average_checkpoints`."""
    from mlcomp_tpu_torch.io.weights import unflatten

    payload = _read(directory, step)
    return {"params": unflatten(dict(_flat_weights(payload))),
            "model_state": unflatten(dict(payload.get("model_state") or {})),
            "step": int(payload["step"])}


def restore_eval_state(directory: str | Path, state: Any, step: Optional[int] = None) -> Any:
    """Weights-only restore for the eval/infer/generate executors: the
    checkpoint's weights (EMA preferred) into ``state.params`` and its
    BatchNorm statistics into ``state.model_state``, in place, and its step; the optimizer state on disk is never read, so these
    stages need not repeat the train task's optimizer config.  The EMA
    weights become the parameters, and ``state.ema_params`` is dropped, as
    in the JAX package.  Returns ``state``."""
    payload = _read(directory, step)
    src = _flat_weights(payload)
    missing = sorted(set(state.params) - set(src))
    if missing:
        raise ValueError(f"checkpoint under {directory} lacks {missing[:3]}... (another model?)")
    with torch.no_grad():
        for k, p in state.params.items():
            if tuple(src[k].shape) != tuple(p.shape):
                raise ValueError(f"checkpoint leaf {k} is {tuple(src[k].shape)}; the model's "
                                 f"is {tuple(p.shape)}")
            p.copy_(src[k])
        stats = payload.get("model_state") or {}
        missing = sorted(set(state.model_state) - set(stats))
        if missing:
            raise ValueError(f"checkpoint under {directory} lacks {missing[:3]}... (another "
                             "model?)")
        for k, t in state.model_state.items():
            t.copy_(stats[k])
    state.ema_params = None
    state.step = int(payload["step"])
    return state


def _parse_source(src) -> "tuple[str, Optional[int]]":
    """``"dir"``, ``"dir:step"`` or a (dir, step) pair."""
    if isinstance(src, (tuple, list)):
        return str(src[0]), (None if len(src) < 2 else int(src[1]))
    s = str(src)
    if ":" in s:
        head, _, tail = s.rpartition(":")
        if tail.isdigit():
            return head, int(tail)
    return s, None


def average_checkpoints(sources: Sequence[Any], out_dir: str | Path,
                        weights: Optional[Sequence[float]] = None) -> str:
    """Weight-space average of checkpoints (SWA, a model soup): ``sources``
    are ``"dir"`` or ``"dir:step"`` strings (or (dir, step) pairs), each
    contributing its EMA weights when it has them, and its BatchNorm
    statistics (``model_state``) averaged alike; ``weights`` (normalised)
    default to equal.  The sums run in float64, as the JAX package's
    average does, and each leaf casts back to the first source's dtype.
    The result is saved weights-only at the largest source step; it
    restores through :func:`read_weights`, :func:`restore_eval_state` and
    ``serve --ckpt``.  Returns the step directory."""
    parsed = [_parse_source(s) for s in sources]
    if len(parsed) < 2:
        raise ValueError(f"averaging needs >= 2 checkpoints, got {len(parsed)}")
    if weights is None:
        weights = [1.0 / len(parsed)] * len(parsed)
    if len(weights) != len(parsed):
        raise ValueError(f"{len(weights)} weights for {len(parsed)} checkpoints")
    total = float(sum(weights))
    if total <= 0:
        raise ValueError("weights must sum to a positive value")
    acc: Optional[Dict[str, Dict[str, np.ndarray]]] = None
    dtypes: Dict[str, Dict[str, torch.dtype]] = {}
    max_step = 0
    for (d, step), w in zip(parsed, weights):
        payload = _read(d, step)
        max_step = max(max_step, int(payload["step"]))
        trees = {"params": _flat_weights(payload), "model_state": payload.get("model_state") or {}}
        if acc is None:
            acc = {part: {k: np.zeros(tuple(v.shape), np.float64) for k, v in flat.items()}
                   for part, flat in trees.items()}
            dtypes = {part: {k: v.dtype for k, v in flat.items()} for part, flat in trees.items()}
        elif any(set(flat) != set(acc[part])
                 or any(tuple(flat[k].shape) != acc[part][k].shape for k in flat)
                 for part, flat in trees.items()):
            raise ValueError(f"checkpoint {d} has a different parameter structure")
        for part, flat in trees.items():
            for k, v in flat.items():
                acc[part][k] += v.detach().double().numpy() * (float(w) / total)
    out = {"step": max_step,
           **{part: {k: torch.from_numpy(a).to(dtypes[part][k]) for k, a in flat.items()}
              for part, flat in acc.items()}}
    return _write(Path(out_dir).absolute(), out, max_step, max_to_keep=3)
