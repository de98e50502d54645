"""Device-lane truth from a torch.profiler capture, with no extra package.

The port's counterpart of mlcomp_tpu/obs/devprof.py, which walks the
``*.xplane.pb`` that ``jax.profiler`` writes.  ``torch.profiler`` (Kineto)
writes a Chrome trace-event JSON instead (``export_chrome_trace``, or the
``*.pt.trace.json`` of its TensorBoard handler), which the standard
library reads: no TensorBoard plugin and no other package.

Device-lane selection: on the card, the GPU activities that CUPTI stamps
on the device's own clock are the lanes, one per CUDA stream: kernels
(``cat`` "kernel"), copies ("gpu_memcpy") and fills ("gpu_memset").  A
CPU capture has none; there the operators the host ran ("cpu_op", the
outermost of each nest on each thread, since ATen operators nest) are the
same ground truth for "what executed", so they are the fallback lanes, as
the XLA:CPU threadpool's lines are for the JAX reader.  Busy time is the
INTERVAL UNION across the selected lanes: concurrent streams, or threads,
must not count twice.

Times are Kineto's: microseconds on the capture's clock.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: the categories of GPU activity that are device lanes
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the fallback lanes of a capture with no device activity
CPU_CAT = "cpu_op"

# data-sheet peak memory bandwidth (GB/s) of the cards the port runs on,
# matched against ``torch.cuda.get_device_name`` (most specific first):
# the roofline's denominator when MLCOMP_TPU_HBM_GBPS is unset
HBM_GBPS = (("H200", 4800.0), ("H100 NVL", 3900.0), ("H100 PCIE", 2000.0), ("H100", 3350.0))


class Event:
    """One timeline event: its name, start and duration (us), lane."""

    __slots__ = ("name", "ts", "dur", "lane")

    def __init__(self, name: str, ts: float, dur: float, lane: str):
        self.name, self.ts, self.dur, self.lane = name, float(ts), float(dur), lane

    def __repr__(self):  # pragma: no cover - debug aid
        return f"Event({self.name!r}, ts={self.ts}, dur={self.dur}, lane={self.lane!r})"


class Trace:
    """A loaded capture: its complete ("X") events and its process names."""

    def __init__(self, events: List[Dict[str, Any]], processes: Dict[Any, str]):
        self.events = events
        self.processes = processes


def parse_trace(doc: Any) -> Trace:
    """A Chrome trace-event document (the dict Kineto writes, or a bare
    event list) -> :class:`Trace`."""
    raw = doc.get("traceEvents", []) if isinstance(doc, dict) else list(doc)
    events, procs = [], {}
    for e in raw:
        ph = e.get("ph")
        if ph == "X":
            events.append(e)
        elif ph == "M" and e.get("name") == "process_name":
            procs[e.get("pid")] = str((e.get("args") or {}).get("name", e.get("pid")))
    return Trace(events, procs)


def load_trace(path: str) -> Trace:
    with open(path) as f:
        return parse_trace(json.load(f))


def find_trace(logdir: str) -> str:
    """Newest ``*.json`` capture under ``logdir`` (the counterpart of
    ``find_xplane``)."""
    found = glob.glob(os.path.join(logdir, "**", "*.json"), recursive=True)
    if not found:
        raise FileNotFoundError(f"no *.json capture under {logdir}")
    return max(found, key=os.path.getmtime)


def short_op(name: str) -> str:
    """A readable kernel name: the return type, anonymous namespaces and
    the parameter list dropped, ``__nv_bfloat16`` as bf16, and short
    template arguments kept (they tell instances apart:
    ``qmm_gemv_tc_kernel<bf16, true, 8>`` is the norm-prologue instance);
    long or nested ones, as ATen's, collapse to ``<...>``.  CPU operator
    names (``aten::mm``) pass through."""
    s = name.strip().replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    depth = 0
    for i, c in enumerate(s):
        if c == "<":
            depth += 1
        elif c == ">":
            depth -= 1
        elif c == "(" and depth == 0 and i > 0:
            s = s[:i]
            break
    s = s.replace("__nv_bfloat16", "bf16").strip()
    lt = s.find("<")
    if lt > 0 and (len(s) - lt > 40 or "<" in s[lt + 1:]):
        s = s[:lt] + "<...>"
    return s


def _lane(e: Dict[str, Any], trace: Trace) -> str:
    pid, tid = e.get("pid"), e.get("tid")
    proc = trace.processes.get(pid, str(pid))
    return f"{proc}/stream {tid}" if e.get("cat") in DEVICE_CATS else f"{proc}/thread {tid}"


def _outermost(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The events of one thread that no other event of it contains."""
    out: List[Dict[str, Any]] = []
    end = float("-inf")
    for e in sorted(events, key=lambda e: (float(e["ts"]), -float(e.get("dur", 0)))):
        if float(e["ts"]) >= end:
            out.append(e)
            end = float(e["ts"]) + float(e.get("dur", 0))
        else:
            end = max(end, float(e["ts"]) + float(e.get("dur", 0)))
    return out


def device_lines(trace: Trace) -> Dict[str, List[Event]]:
    """The lanes whose durations are ground truth, by lane name: the
    card's kernels, copies and fills per stream; in a capture without
    them, the outermost CPU operators per thread."""
    dev = [e for e in trace.events if e.get("cat") in DEVICE_CATS]
    if not dev:
        by_thread: Dict[Tuple[Any, Any], List[Dict[str, Any]]] = {}
        for e in trace.events:
            if e.get("cat") == CPU_CAT:
                by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
        dev = [e for evs in by_thread.values() for e in _outermost(evs)]
    lanes: Dict[str, List[Event]] = {}
    for e in dev:
        ev = Event(str(e.get("name", "")), e.get("ts", 0.0), e.get("dur", 0.0), _lane(e, trace))
        lanes.setdefault(ev.lane, []).append(ev)
    for evs in lanes.values():
        evs.sort(key=lambda ev: ev.ts)
    return lanes


def _intervals(lanes: Dict[str, List[Event]]) -> List[Tuple[float, float, Event]]:
    """(start_us, end_us, event) over every lane, by start."""
    out = [(ev.ts, ev.ts + ev.dur, ev) for evs in lanes.values() for ev in evs if ev.dur > 0]
    out.sort(key=lambda t: t[0])
    return out


def busy_ms(intervals: Sequence[Tuple[float, float, Any]]) -> float:
    """Interval-union busy time (ms) of (start_us, end_us, _) intervals
    sorted by start: overlapping lanes count wall time once."""
    total = 0.0
    cur_lo = cur_hi = None
    for lo, hi, _ in intervals:
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        elif hi > cur_hi:
            cur_hi = hi
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total / 1e3


def op_totals(lanes: Dict[str, List[Event]], top: int = 20) -> List[Dict[str, Any]]:
    """Top device kernels by summed duration, under :func:`short_op`
    names, with their counts."""
    tot: Dict[str, float] = {}
    cnt: Dict[str, int] = {}
    for evs in lanes.values():
        for ev in evs:
            if ev.dur <= 0:
                continue
            k = short_op(ev.name)
            tot[k] = tot.get(k, 0.0) + ev.dur / 1e3
            cnt[k] = cnt.get(k, 0) + 1
    ranked = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    return [{"name": k, "total_ms": round(ms, 4), "count": cnt[k]} for k, ms in ranked]


def attribution(trace: Trace, wall_ms: Optional[float] = None,
                top_kernels: int = 20) -> Dict[str, Any]:
    """Capture-level device/host split: device busy time (interval union
    over the device lanes), the kernel-name breakdown, and, when the
    caller gives the capture's host wall, the host gap (wall the device
    spent NOT executing: launch cost, pipeline bubble, admission stall).
    The keys are the JAX reader's; ``planes`` names the capture's
    processes."""
    lanes = device_lines(trace)
    dev_ms = busy_ms(_intervals(lanes))
    out: Dict[str, Any] = {
        "device_time_ms": round(dev_ms, 4),
        "device_events": sum(len(evs) for evs in lanes.values()),
        "device_lanes": sorted(lanes)[:16],
        "planes": sorted(set(trace.processes.values())),
        "kernels": op_totals(lanes, top=top_kernels),
    }
    if wall_ms is not None:
        out["wall_ms"] = round(float(wall_ms), 4)
        out["host_gap_ms"] = round(max(float(wall_ms) - dev_ms, 0.0), 4)
    return out


def device_spans_us(trace: Trace, limit: int = 768
                    ) -> Tuple[List[Tuple[float, float, str]], int]:
    """Device events as ``(start_us, dur_us, name)`` relative to the
    capture's earliest device event: the flight recorder's device track.
    Returns ``(spans, dropped)``: past ``limit`` events the LONGEST
    survive, and ``dropped`` says how many were shed."""
    ivs = _intervals(device_lines(trace))
    if not ivs:
        return [], 0
    t0 = ivs[0][0]
    dropped = 0
    if len(ivs) > limit:
        dropped = len(ivs) - limit
        ivs = sorted(ivs, key=lambda t: t[0] - t[1])[:limit]
        ivs.sort(key=lambda t: t[0])
    return [(lo - t0, hi - lo, ev.name) for lo, hi, ev in ivs], dropped


def hbm_gbps(device) -> Optional[float]:
    """The memory bandwidth (GB/s) a roofline divides by on ``device``:
    ``MLCOMP_TPU_HBM_GBPS`` when set, else the data-sheet peak of the
    card ``torch.cuda.get_device_name`` names (:data:`HBM_GBPS`); None on
    the CPU or an unknown card."""
    env = os.environ.get("MLCOMP_TPU_HBM_GBPS")
    if env:
        return float(env)
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).upper()
    return next((gbps for key, gbps in HBM_GBPS if key in name), None)
