"""Device profiling: capture a window of train steps with ``torch.profiler``.

The port's counterpart of mlcomp_tpu/utils/profile.py.  The host-side span
tracer (utils/trace.py) answers "is the input pipeline starving the card";
this module answers "what is the card doing inside a step" (kernels,
copies, their device times) by starting and stopping a
``torch.profiler.profile`` around a configured step window.  The capture
lands in ``dir`` as Kineto's Chrome trace JSON (``chrome://tracing``,
Perfetto, ``obs/devprof.py``).

Trainer config::

    profile: {dir: prof/, start_step: 5, num_steps: 3}

A short window a few steps in records steady state: the first steps pay
kernel builds, allocator growth and warm caches.

The same window idiom drives the serving engine's on-demand capture
(``DecodeEngine.profile`` / ``GET /profile?dispatches=N``): the drive loop
opens the window at its first profiled dispatch and closes it, behind a
synchronize of the card, after N of them.
"""

from __future__ import annotations

import os
import socket
import time
from typing import Any, Dict, Optional

import torch

# idle seconds at each edge of a CUDA window.  The profiler keeps the
# card's activities that fall inside the window's bounds on the host's
# clock; a window whose launches began as it opened has lost an edge's
# kernels on an H100.  So the window opens this long before its first
# launch and closes this long after its last kernel completed
EDGE_S = 0.05


class StepProfiler:
    """Start/stop ``torch.profiler`` around a global-step window.

    Call :meth:`step` with the upcoming global step number right before
    each train step; the profiler starts at ``start_step`` and stops after
    ``num_steps`` steps (or at :meth:`close`, whichever is first).  Safe on
    resume: a restored trainer whose step counter is already past the
    window never starts a trace.  ``device`` is the profiled device: on a
    CUDA device the window records the card's activity too, and every stop
    first synchronizes it, so that launches still queued when the window
    closes are not lost (the reference's ``pending`` barrier).  The
    profiler records the operators of the thread that opened it;
    ``host_ops=False`` leaves the host's operators out of a CUDA device's
    window (each costs host time at every launch, which inflates the
    window's wall; the card's lanes do not need them).
    """

    def __init__(self, dir: str, start_step: int = 5, num_steps: int = 3, device=None,
                 host_ops: bool = True):
        self.dir = str(dir)
        self.start_step = int(start_step)
        self.stop_step = self.start_step + int(num_steps)
        self.device = None if device is None else torch.device(device)
        self.host_ops = bool(host_ops)
        self.trace_path: Optional[str] = None
        self._prof = None
        self._done = False

    @property
    def active(self) -> bool:
        """True while a trace window is open (started, not yet stopped)."""
        return self._prof is not None

    @property
    def done(self) -> bool:
        """True once the window has closed for good (stop or close); a
        done profiler never starts another trace."""
        return self._done

    def step(self, global_step: int) -> None:
        if not self._done and not self.active and (
                self.start_step <= global_step < self.stop_step):
            self._start()
        elif self.active and global_step >= self.stop_step:
            self.close()

    def close(self) -> None:
        """Close an open window: synchronize the card (and wait
        :data:`EDGE_S`), stop, write the trace.  The profiler is then
        done.  Idempotent."""
        prof, self._prof = self._prof, None
        if prof is None:
            return
        self._done = True
        try:
            if self._cuda:
                torch.cuda.synchronize(self.device)
                time.sleep(EDGE_S)
        finally:
            prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"{socket.gethostname()}_{os.getpid()}."
                                      f"{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        self.trace_path = path

    @property
    def _cuda(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    def _start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU] if self.host_ops or not self._cuda else []
        if self._cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        self._prof = prof
        if self._cuda:
            time.sleep(EDGE_S)


def create_profiler(cfg: Optional[Dict[str, Any]], device=None) -> Optional[StepProfiler]:
    """``profile: {dir, start_step, num_steps}`` (or ``true``) -> profiler."""
    if not cfg:
        return None
    if cfg is True:
        cfg = {}
    return StepProfiler(
        dir=cfg.get("dir", "profile"),
        start_step=int(cfg.get("start_step", 5)),
        num_steps=int(cfg.get("num_steps", 3)),
        device=device,
    )
