"""Host-side span tracer: the port's copy of the ``Tracer`` of
mlcomp_tpu/utils/trace.py (with its trace-id helpers).

``Tracer`` records wall-clock spans, counters and async events (thread
aware) and serializes them to Chrome trace-event JSON, viewable in
``chrome://tracing`` / Perfetto.  The Trainer wraps epochs, data loading
and step dispatch in spans when ``cfg["trace"]`` is set.  Host spans
measure host time: under CUDA's asynchronous launches a long ``step``
span means the host waited on the device (a full launch queue, a sync).
``device_profile`` and ``annotate`` are the reference's, on
``torch.profiler`` in place of ``jax.profiler``.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

# W3C trace-context shapes (https://www.w3.org/TR/trace-context/):
# a trace id is 32 lowercase hex chars, not all-zero; a traceparent
# header is ``version-traceid-parentid-flags``.  The serving path mints
# one per request at submit (or inherits the client's via the
# ``traceparent`` header) and threads it through every span the request
# touches, so one id follows a request across daemons.
_TRACE_ID_RE = re.compile(r"^[0-9a-f]{32}$")
_HEX_RE = re.compile(r"^[0-9a-f]+$")


def make_trace_id() -> str:
    """A fresh W3C-shape trace id (32 hex chars, never all-zero)."""
    while True:
        tid = os.urandom(16).hex()
        if tid != "0" * 32:
            return tid


def valid_trace_id(tid: Any) -> bool:
    # fullmatch, not match: '$' would accept a trailing newline, which
    # then embeds verbatim in span args and can never be matched by
    # the (stripped) ?trace_id= filter
    return isinstance(tid, str) and bool(
        _TRACE_ID_RE.fullmatch(tid)
    ) and tid != "0" * 32


def parse_traceparent(header: Optional[str]) -> Optional[str]:
    """The trace id out of a ``traceparent`` header, or None when the
    header is absent/malformed (a bad header must not fail the request
    — the daemon just mints a fresh id)."""
    if not header:
        return None
    parts = header.strip().lower().split("-")
    if len(parts) < 4:
        return None
    ver, tid, parent = parts[0], parts[1], parts[2]
    if len(ver) != 2 or not _HEX_RE.match(ver) or ver == "ff":
        return None
    if not valid_trace_id(tid):
        return None
    if len(parent) != 16 or not _HEX_RE.match(parent) or (
        parent == "0" * 16
    ):
        return None
    return tid


def filter_export(body: Dict[str, Any], trace_id: Optional[str] = None,
                  rid: Optional[int] = None) -> Dict[str, Any]:
    """Restrict a Chrome-trace export body to ONE request's events —
    the ``GET /trace?trace_id=`` / ``?rid=`` filters.

    Request-lifecycle async events correlate by ``cat="req"`` with the
    rid as their id; per-request spans (admit, prefix/registry lookups,
    prefill chunks, insert) carry ``rid`` — and the lifecycle begin
    carries ``trace_id`` — in their args.  A trace-id filter first
    resolves the matching rid(s) from the lifecycle begins, then keeps
    exactly the events either filter would: track metadata always,
    ``cat="req"`` events whose id matches, and any event whose args
    carry a matching rid or trace_id."""
    evs = body.get("traceEvents", [])
    rids = set()
    if rid is not None:
        rids.add(int(rid))
    if trace_id is not None:
        for e in evs:
            if (e.get("cat") == "req" and e.get("ph") == "b"
                    and (e.get("args") or {}).get("trace_id") == trace_id):
                try:
                    rids.add(int(e.get("id")))
                except (TypeError, ValueError):
                    pass
    rid_strs = {str(r) for r in rids}
    kept = []
    for e in evs:
        if e.get("ph") == "M":
            kept.append(e)
            continue
        if e.get("cat") == "req" and e.get("id") in rid_strs:
            kept.append(e)
            continue
        args = e.get("args") or {}
        if args.get("rid") in rids or (
            trace_id is not None and args.get("trace_id") == trace_id
        ):
            kept.append(e)
    out = dict(body)
    out["traceEvents"] = kept
    other = dict(out.get("otherData") or {})
    other["filter"] = {"trace_id": trace_id, "rids": sorted(rids)}
    out["otherData"] = other
    return out


class Tracer:
    """Span recorder emitting Chrome trace-event format.

    Thread-safe: spans carry the recording thread's id, so worker threads
    (data prefetch, heartbeat) show as separate tracks.  ``max_events``
    bounds memory as a ring buffer (flight-recorder mode); unset keeps
    the original grow-forever list for short traced runs.
    """

    def __init__(self, path: Optional[str] = None,
                 max_events: Optional[int] = None):
        self.path = path
        self.max_events = int(max_events) if max_events else None
        if self.max_events is not None and self.max_events < 1:
            raise ValueError(f"max_events must be >= 1, got {max_events}")
        self._events: "deque | List[Dict[str, Any]]" = (
            deque(maxlen=self.max_events) if self.max_events else []
        )
        self._dropped = 0
        self._tracks: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _tid(self, track: Optional[str]) -> int:
        """Real thread id, or the named logical track's synthetic tid
        (small ints; pthread idents are pointer-sized, so they cannot
        collide in practice).  Caller holds the lock."""
        if track is None:
            return threading.get_ident()
        tid = self._tracks.get(track)
        if tid is None:
            tid = self._tracks[track] = len(self._tracks) + 1
        return tid

    def _append(self, ev: Dict[str, Any], track: Optional[str]) -> None:
        with self._lock:
            ev["pid"] = os.getpid()
            ev["tid"] = self._tid(track)
            if (self.max_events is not None
                    and len(self._events) == self.max_events):
                self._dropped += 1  # deque evicts the oldest on append
            self._events.append(ev)

    @contextmanager
    def span(self, name: str, track: Optional[str] = None, **args):
        """Complete ("X") span around the with-block.  Yields the args
        dict so the body can attach results (they serialize at exit):

            with tracer.span("prefix_cache.lookup", prompt=n) as sp:
                sp["hit_tokens"] = hit
        """
        start = self._now_us()
        try:
            yield args
        finally:
            end = self._now_us()
            self._append(
                {
                    "name": name,
                    "ph": "X",
                    "ts": start,
                    "dur": end - start,
                    "args": args,
                },
                track,
            )

    def instant(self, name: str, track: Optional[str] = None,
                **args) -> None:
        self._append(
            {"name": name, "ph": "i", "ts": self._now_us(), "s": "t",
             "args": args},
            track,
        )

    def to_trace_us(self, t_perf: float) -> float:
        """Map a ``time.perf_counter()`` reading onto this recorder's
        timeline (µs since construction) — how externally-timestamped
        spans (a parsed device capture) align with the live host spans."""
        return (t_perf - self._t0) * 1e6

    def complete(self, name: str, ts_us: float, dur_us: float,
                 track: Optional[str] = None, **args) -> None:
        """Record a complete ("X") span at an EXPLICIT timestamp — the
        merge path for events that did not happen on this thread's
        clock (device program spans parsed out of an xplane capture
        land on their named track aligned with the host spans that
        issued them)."""
        self._append(
            {"name": name, "ph": "X", "ts": float(ts_us),
             "dur": float(dur_us), "args": args},
            track,
        )

    def counter(self, name: str, values: Dict[str, float]) -> None:
        """Counter track (e.g. loss over time) rendered as a graph."""
        self._append(
            {"name": name, "ph": "C", "ts": self._now_us(),
             "args": {k: float(v) for k, v in values.items()}},
            None,
        )

    # -- async (overlapping) events: correlate by (cat, id) -----------

    def _async(self, ph: str, name: str, aid, cat: str,
               track: Optional[str], args: Dict[str, Any]) -> None:
        self._append(
            {"name": name, "ph": ph, "cat": cat, "id": str(aid),
             "ts": self._now_us(), "args": args},
            track,
        )

    def async_begin(self, name: str, aid, cat: str = "async",
                    track: Optional[str] = None, **args) -> None:
        self._async("b", name, aid, cat, track, args)

    def async_instant(self, name: str, aid, cat: str = "async",
                      track: Optional[str] = None, **args) -> None:
        self._async("n", name, aid, cat, track, args)

    def async_end(self, name: str, aid, cat: str = "async",
                  track: Optional[str] = None, **args) -> None:
        self._async("e", name, aid, cat, track, args)

    # -- export --------------------------------------------------------

    @property
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def export(self, last_ms: Optional[float] = None) -> Dict[str, Any]:
        """Chrome trace JSON body (Perfetto-loadable).  ``last_ms``
        keeps only events whose span intersects the trailing window —
        the flight-recorder fetch ("what just happened") without
        shipping the whole ring."""
        with self._lock:
            evs = list(self._events)
            tracks = dict(self._tracks)
            dropped = self._dropped
        if last_ms is not None:
            cutoff = self._now_us() - float(last_ms) * 1e3
            kept = [
                e for e in evs
                if e["ts"] + e.get("dur", 0.0) >= cutoff
            ]
            # async begins carry no duration, so the intersection test
            # above would clip the "b" of any span still open at the
            # cutoff — and Perfetto cannot draw a span from an
            # unmatched end.  Re-admit pre-cutoff begins whose span is
            # either still open (no "e" anywhere in the ring) or whose
            # end/instants made the window.
            kept_ids = {
                (e.get("cat"), e.get("id"))
                for e in kept if e["ph"] in ("e", "n")
            }
            ended = {
                (e.get("cat"), e.get("id"))
                for e in evs if e["ph"] == "e"
            }
            evs = [
                e for e in evs
                if e["ph"] == "b" and e["ts"] < cutoff and (
                    (e.get("cat"), e.get("id")) in kept_ids
                    or (e.get("cat"), e.get("id")) not in ended
                )
            ] + kept
        pid = os.getpid()
        meta = [
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": track}}
            for track, tid in sorted(tracks.items(), key=lambda kv: kv[1])
        ]
        # shared clock contract: every export is stamped with the wall
        # clock AND the recorder clock read back to back, so any
        # consumer (the report server's fleet merger, an external
        # trace store) can map event timestamps onto unix time —
        # unix_us(event) = ts + clock_offset_us — without guessing
        # which process epoch a windowed export came from.
        export_unix_us = time.time() * 1e6
        export_trace_us = self._now_us()
        return {
            "traceEvents": meta + evs,
            "displayTimeUnit": "ms",
            "otherData": {
                "dropped_events": dropped,
                "max_events": self.max_events,
                "export_unix_us": export_unix_us,
                "export_trace_us": export_trace_us,
                "clock_offset_us": export_unix_us - export_trace_us,
            },
        }

    def save(self, path: Optional[str] = None) -> str:
        """Write Chrome trace JSON; returns the path written.  The
        event list is SNAPSHOTTED under the lock (``export``) before
        serialization — ``json.dump`` over the live list raced
        concurrent ``span()`` appends ("deque/list mutated during
        iteration")."""
        path = path or self.path
        if not path:
            raise ValueError("no trace path configured")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        body = self.export()
        with open(path, "w") as f:
            json.dump(body, f)
        return path


class _NullTracer(Tracer):
    """No-op recorder so call sites never need an `if tracer:` guard."""

    def __init__(self):
        super().__init__()

    @contextmanager
    def span(self, name: str, track: Optional[str] = None, **args):
        yield args

    def instant(self, name: str, track: Optional[str] = None,
                **args) -> None:
        pass

    def complete(self, name: str, ts_us: float, dur_us: float,
                 track: Optional[str] = None, **args) -> None:
        pass

    def counter(self, name: str, values: Dict[str, float]) -> None:
        pass

    def _async(self, ph, name, aid, cat, track, args) -> None:
        pass

    def save(self, path: Optional[str] = None) -> str:
        raise ValueError("null tracer has nothing to save")


_NULL = _NullTracer()
_current: List[Tracer] = []


def null_tracer() -> Tracer:
    """The shared no-op tracer — a default for components that accept
    an optional recorder (e.g. the prefix cache's capture worker)."""
    return _NULL


def set_tracer(tracer: Optional[Tracer]) -> None:
    """Install the process-wide tracer (Trainer does this); None clears."""
    _current.clear()
    if tracer is not None:
        _current.append(tracer)


def get_tracer() -> Tracer:
    """The installed tracer, or a no-op one."""
    return _current[0] if _current else _NULL


@contextmanager
def device_profile(log_dir: str, device=None):
    """Capture a torch.profiler profile of the enclosed work into
    ``log_dir`` (Kineto's Chrome trace JSON, read by ``obs/devprof.py``):
    host operators, and on a CUDA ``device`` the card's kernels, copies
    and fills, the card synchronized before the stop."""
    from mlcomp_tpu_torch.utils.profile import StepProfiler

    prof = StepProfiler(log_dir, start_step=0, num_steps=1, device=device)
    prof.step(0)
    try:
        yield log_dir
    finally:
        prof.close()


def annotate(name: str):
    """Named region visible in the profile's host track (and, on the
    card, its GPU annotation track): use around code inside a profiled
    section (cheap; a no-op outside profiling)."""
    import torch

    return torch.profiler.record_function(name)
