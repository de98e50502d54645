"""Fault injection: deterministic crash/raise points for recovery testing.

The scheduler's failure-detection contract (heartbeat reaping, retry
budgets, conditional status transitions) is only trustworthy if it is
exercised against real mid-flight deaths.  This module provides named
injection points the runtime calls at its state-transition edges; tests
(or a chaos run) arm them either programmatically (``arm``) or through
``MLCOMP_FAULTS`` in a subprocess's environment.

Flavors:
- ``raise``  — raise ``FaultInjected`` (exception path: executor failure)
- ``kill``   — ``os._exit(137)`` (hard process death: no cleanup, no
  finally blocks — what a OOM-kill or preemption looks like)
- ``sleep``  — block the calling thread for ``seconds`` (a wedged
  runtime / slow dependency: what the serving watchdog's
  stall-detection contract is exercised against; ``sleep=2.5`` in the
  env syntax)

``MLCOMP_FAULTS`` syntax: ``point[:flavor][:times]`` comma-separated,
e.g. ``worker.before_finish:kill:1,supervisor.tick:raise`` or
``engine.dispatch:sleep=2.5:1``.
``times`` bounds how often the point fires (default 1; ``*`` = always).

Serving fault points (this repo's chaos surface, exercised by
``tools/chaoscheck.py``): ``engine.dispatch`` (raise = dispatch
exception, sleep = wedged dispatch), ``engine.resolve`` (sleep = slow
output readback), ``engine.fused_prefill`` (raise = host-side fault
while preparing a fused admission chunk — contained to the admitting
request; the decode fleet falls back to a plain dispatch),
``cache.lookup`` / ``cache.capture`` (raise = prefix-cache fault,
contained to degraded-bypass / insert_errors).

Points are no-ops unless armed — zero overhead in production paths beyond
an emptiness check and a dict lookup.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Tuple

__all__ = ["FaultInjected", "arm", "disarm_all", "inject"]


class FaultInjected(RuntimeError):
    """Raised by an armed ``raise``-flavor injection point."""


_lock = threading.Lock()
# point -> (flavor, remaining, seconds) ; remaining < 0 means unlimited
_armed: Dict[str, Tuple[str, int, float]] = {}
_env_loaded = False


def _parse_flavor(spec: str) -> Tuple[str, float]:
    """``sleep=2.5`` -> ("sleep", 2.5); plain flavors carry 0 seconds."""
    flavor, _, arg = spec.partition("=")
    if flavor not in ("raise", "kill", "sleep"):
        raise ValueError(f"unknown fault flavor {flavor!r}")
    if arg and flavor != "sleep":
        raise ValueError(f"flavor {flavor!r} takes no argument")
    return flavor, float(arg) if arg else 0.0


def _load_env() -> None:
    global _env_loaded
    if _env_loaded:
        return
    _env_loaded = True
    spec = os.environ.get("MLCOMP_FAULTS", "")
    for item in filter(None, (s.strip() for s in spec.split(","))):
        parts = item.split(":")
        point = parts[0]
        flavor, seconds = _parse_flavor(parts[1] if len(parts) > 1
                                        else "raise")
        times = parts[2] if len(parts) > 2 else "1"
        _armed[point] = (flavor, -1 if times == "*" else int(times), seconds)


def arm(point: str, flavor: str = "raise", times: int = 1,
        seconds: float = 0.0) -> None:
    """Arm ``point`` to fire ``times`` times with ``flavor``.
    ``seconds`` is the ``sleep`` flavor's stall duration."""
    flavor, env_seconds = _parse_flavor(flavor)
    with _lock:
        _armed[point] = (flavor, times, seconds or env_seconds)


def disarm_all() -> None:
    with _lock:
        _armed.clear()


def inject(point: str) -> None:
    """Fire ``point`` if armed; called by the runtime at transition edges."""
    _load_env()
    if not _armed:  # hot-path fast exit: serving calls this per dispatch
        return
    with _lock:
        entry = _armed.get(point)
        if entry is None:
            return
        flavor, remaining, seconds = entry
        if remaining == 0:
            return
        if remaining > 0:
            _armed[point] = (flavor, remaining - 1, seconds)
    if flavor == "kill":
        os._exit(137)
    if flavor == "sleep":
        time.sleep(seconds)
        return
    raise FaultInjected(f"injected fault at {point!r}")
