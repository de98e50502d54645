"""Continuous-batching decode engine: the counterpart of
mlcomp_tpu/engine.py (``DecodeEngine``), with the dense and the paged KV
layouts.

- A fixed pool of ``slots`` decode rows shares one (slots, L) KV cache
  (``kv_layout="dense"``); per-row cache cursors (``cache_cursor``,
  models/transformer.py) let every row sit at its own depth.  Each
  dispatch runs K single-token steps for every slot; a row that hits EOS
  or its budget stops emitting ON THE
  DEVICE (its later steps are masked and its cursor freezes), so the host
  reads one packed (3, K, slots) buffer back per dispatch.
- A new request PREFILLS in chunks of ``prefill_chunk`` tokens against its
  own (1, L) admission cache, whose index starts past the prompt's all-pad
  chunks (the pads' slots are never read), then its cache row is INSERTED
  into a free slot.  With fused admission (the default) each chunk is
  issued right behind a decode dispatch, with no host sync between them,
  so decoding never pauses for a prefill; only the final insert drains
  the pipeline.  ``fused_admission=False`` runs every chunk as its own
  step at a drained boundary (the bisect mode).
- Up to ``pipeline_depth`` dispatches are in flight: dispatch N+1 is
  issued before dispatch N's tokens are read back.  The readback is a
  non-blocking copy into pinned host memory plus a CUDA event, waited on
  FIFO.  Depth 1 is the synchronous loop (the bisect mode).
- K is ``steps_per_dispatch``: an int pins it, ``"adaptive"`` lets
  ``dispatch_control.AdaptiveKController`` pick a rung of the ladder at
  every boundary from the queue depth and slot occupancy.  Each request
  samples from its own counter-keyed stream (engine seed, request seed,
  token position), so tokens do not depend on K, the pipeline depth or
  when neighbours joined.
- Requests carry deadlines and a cancel handle; a watchdog thread fails
  the waiters of a dispatch stuck past ``dispatch_stall_timeout`` and
  restarts a dead drive loop once on a fresh device state.
- ``kv_layout="paged"`` (mlcomp_tpu_torch/kvpool) keeps the KV cache as
  pages of ``kv_page_tokens`` slots addressed through a (slots, max_pages)
  int32 table.  An insert writes the prefilled row into the slot's
  private pages; decode pages are allocated lazily as cursors approach
  them; admission waits for free pages at the request's initial need; a
  request whose worst case exceeds the pool fails with ``NoFreePages``;
  the live slot count grows by doubling (up to ``max_slots``) under
  queued traffic when pages allow and shrinks back at quiesce.  The int8
  family attends through the table (B6); the bf16 family over each
  layer's gathered view (B8).  Tokens equal the dense layout's.

PyTorch runs eagerly, so the JAX package's jitted, donated programs
become Python code that launches into preallocated device tensors updated
in place.  The static buffers leave room to capture one CUDA graph per K
rung; none is captured yet.

Not in this engine (the JAX engine has them; see ROADMAP.md): speculative
dispatch, prefix caches and the device prefix-page registry, meshes and
distributed gangs, prefill-only export and handoff import, the flight
recorder, metrics and device profiling, fault injection.
"""

from __future__ import annotations

import itertools
import math
import queue
import threading
import time
import warnings
from collections import deque
from concurrent.futures import Future
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mlcomp_tpu_torch.dispatch_control import DEFAULT_LADDER, AdaptiveKController
from mlcomp_tpu_torch.kvpool import (
    GRAVE_PAGE,
    RESERVED_PAGES,
    NoFreePages,
    PagedKV,
    PagedLayout,
    PagePool,
)
from mlcomp_tpu_torch.models.generation import sample_token_rowwise_keyed
from mlcomp_tpu_torch.serve import (
    _bucket,
    _fail_future,
    left_pad_row,
    make_trace_id,
    valid_trace_id,
)

_POISON = object()  # close() wakes a blocked queue.get with this


class DeadlineExceeded(RuntimeError):
    """The request's ``deadline_s`` passed before it finished; it was
    retired at the next dispatch boundary.  HTTP maps this to 504."""

    status = "deadline_exceeded"


class RequestCancelled(RuntimeError):
    """The request was cancelled (``cancel(rid)``, e.g. the HTTP client
    disconnected) and retired at the next dispatch boundary."""

    status = "cancelled"


class EngineStalled(RuntimeError):
    """The watchdog declared a dispatch wedged (it exceeded
    ``dispatch_stall_timeout``) or found the drive loop dead."""

    status = "engine_stalled"


def _set_result(fut: Future, result) -> None:
    """Resolve a future idempotently: the watchdog may have failed it."""
    try:
        if not fut.done():
            fut.set_result(result)
    except Exception:  # InvalidStateError: lost the race
        pass


class _Slot:
    """The host mirror of a decoding row: its request and what it emitted."""

    __slots__ = ("req", "remaining", "emitted", "t_first", "cursor", "span_end",
                 "alloc_upto")

    def __init__(self, req, remaining, cursor):
        self.req = req
        self.remaining = remaining    # tokens still allowed
        self.emitted: List[Tuple[int, float]] = []
        self.t_first: Optional[float] = None   # host time the first token landed
        self.cursor = cursor          # next cache slot the row writes (host view)
        # paged: the row's write span end and the slots its pages cover
        self.span_end: Optional[int] = None
        self.alloc_upto: Optional[int] = None


class _Admission:
    """A prefill in progress: one chunk per loop boundary."""

    __slots__ = ("req", "s_bucket", "chunk", "n_chunks", "next_chunk", "row",
                 "positions", "kv_start", "last_logits", "fused_any")

    def __init__(self, req, s_bucket, chunk, first_chunk):
        self.req = req
        self.s_bucket = s_bucket
        self.chunk = chunk
        self.n_chunks = s_bucket // chunk
        self.next_chunk = first_chunk   # all-pad chunks before are skipped
        self.row = None                 # (1, s_bucket) ids on the device
        self.positions = None           # (1, s_bucket) RoPE positions on the device
        self.kv_start = None            # (1,) first real slot on the device
        self.last_logits = None         # (1, V) of the last chunk run
        self.fused_any = False          # any chunk issued behind a decode dispatch


class _Inflight:
    """An issued dispatch whose tokens are not read yet."""

    __slots__ = ("host", "event", "t_issue", "k")

    def __init__(self, host, event, t_issue, k):
        self.host, self.event, self.t_issue, self.k = host, event, t_issue, k


class DecodeEngine:
    """Fixed-slot continuous batcher around a loaded ``TransformerLM``.

    ``model`` carries its weights (``models.generation.prep_decode_variables``)
    and its device.  ``submit`` returns a Future resolving to the result
    dict; pass ``stream`` (a ``queue.Queue``) to also receive per-token
    dicts ``{"token", "logprob", "step"}`` as they land, then ``None``.
    Greedy outputs equal ``generate`` on the same weights: the prefill and
    the steps run the same model code, and a row's logits never depend on
    its neighbours."""

    def __init__(
        self,
        model,
        slots: int = 8,
        prompt_buckets: Sequence[int] = (128, 256, 512, 1024),
        max_new_cap: int = 128,
        pad_id: int = 0,
        seed: int = 0,
        steps_per_dispatch: "Optional[int | str]" = None,
        prefill_chunk: int = 256,
        pipeline_depth: Optional[int] = None,
        dispatch_stall_timeout: Optional[float] = None,
        fused_admission: Optional[bool] = None,
        kv_layout: str = "dense",
        kv_page_tokens: Optional[int] = None,
        kv_pages: Optional[int] = None,
        max_slots: Optional[int] = None,
    ):
        self.model = model
        self.device = torch.device(model.device)
        self.slots = int(slots)
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.prompt_buckets = tuple(sorted(prompt_buckets))
        self.max_new_cap = int(max_new_cap)
        self.pad_id = int(pad_id)
        self._seed = int(seed)
        # steps_per_dispatch: an int PINS K (the bisect mode); "adaptive"
        # runs the load-to-K ladder controller; None is 4, as in JAX
        adaptive = (isinstance(steps_per_dispatch, str)
                    and steps_per_dispatch.strip().lower() == "adaptive")
        if isinstance(steps_per_dispatch, str) and not adaptive:
            raise ValueError("steps_per_dispatch must be an int, None, or "
                             f"'adaptive'; got {steps_per_dispatch!r}")
        self._k_controller: Optional[AdaptiveKController] = None
        if adaptive:
            self._k_controller = AdaptiveKController(DEFAULT_LADDER)
            self.k_ladder = self._k_controller.ladder
            steps_per_dispatch = self.k_ladder[0]
        self.steps_per_dispatch = int(4 if steps_per_dispatch is None else steps_per_dispatch)
        if self.steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        if not adaptive:
            self.k_ladder = (self.steps_per_dispatch,)
        self.adaptive_k = adaptive
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.fused_admission = True if fused_admission is None else bool(fused_admission)
        self.pipeline_depth = 2 if pipeline_depth is None else int(pipeline_depth)
        if self.pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
        # +1 scratch slot: a RETIRED row's frozen cursor still receives each
        # step's K/V write (the device retires rows by masking emission,
        # not by skipping the forward), one past its last budgeted slot
        self.l_buf = self.prompt_buckets[-1] + self.max_new_cap + 1
        self.vocab = int(model.vocab_size)
        self._cuda = self.device.type == "cuda"
        self.kv_layout = str(kv_layout)
        if self.kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout must be 'dense' or 'paged', got {kv_layout!r}")
        self._pool: Optional[PagePool] = None
        self._layout: Optional[PagedLayout] = None
        self.max_slots = self.slots
        if self.kv_layout == "dense":
            if max_slots is not None and int(max_slots) != self.slots:
                raise ValueError("elastic slots (max_slots) need kv_layout='paged'; the dense "
                                 "layout reserves worst-case KV per slot at construction")
            if kv_page_tokens is not None or kv_pages is not None:
                raise ValueError("kv_page_tokens / kv_pages only apply to kv_layout='paged'")

        with torch.inference_mode():
            # the admission's (1, L) cache and the packed-token rings are
            # static: allocated once, reused by every admission / dispatch
            self._adm_cache = model.init_cache(1, self.l_buf)
            if self.kv_layout == "paged":
                self._init_pool(kv_page_tokens, kv_pages, max_slots)
            self._d = self._fresh_dstate()
            kmax = max(self.k_ladder)
            ring = self.pipeline_depth + 1
            n = 3 * kmax * self.max_slots
            self._ring_dev = [torch.zeros(n, device=self.device) for _ in range(ring)]
            self._ring_host = [torch.zeros(n, pin_memory=self._cuda) for _ in range(ring)]
        self._ring_i = 0
        self._host: List[Optional[_Slot]] = [None] * self.slots
        self._adm: Optional[_Admission] = None
        self._broken: Optional[Exception] = None
        self._abandoned = False
        self._queue: "queue.Queue" = queue.Queue()
        # loop-owned admission order: submit() enqueues into _queue; the
        # loop pumps it into _pending, where the deadline/cancel sweep can
        # retire QUEUED requests at a dispatch boundary
        self._pending: Deque[Dict[str, Any]] = deque()
        self._cancelled: set = set()
        self._stats: Dict[str, Any] = {
            "requests": 0, "steps": 0, "prefills": 0, "dispatches": 0,
            "prefill_chunks": 0, "emitted_tokens": 0, "fused_chunks": 0,
            "admissions_overlapped": 0, "deadline_exceeded": 0, "cancelled": 0,
            "watchdog_stalls": 0, "watchdog_restarts": 0, "dispatch_k_changes": 0,
        }
        if self._pool is not None:
            # elastic resizes, pages allocated as cursors crossed page
            # boundaries, and rows failed by a dry pool at such a crossing
            self._stats.update(slots_scaled=0, peak_live_slots=self.slots,
                               kv_pages_lazy_allocated=0, kv_decode_page_failures=0)
        self._dispatches_by_k: Dict[int, int] = {}
        self._inflight: Deque[_Inflight] = deque()
        self._pstats = {"issued": 0, "hidden_ms": 0.0, "wait_ms": 0.0,
                        "inflight_sum": 0, "peak_inflight": 0}
        self._lat_ttft: Deque[float] = deque(maxlen=2048)
        self._lat_tok: Deque[float] = deque(maxlen=2048)
        self._lat_ttft_n = 0
        self._rid = itertools.count(1)
        self.step_count = 0
        self._stop = threading.Event()
        # watchdog state: _busy_since marks when the loop thread entered a
        # call that may wedge (issue, readback wait, chunk, insert)
        self.dispatch_stall_timeout = (float(dispatch_stall_timeout)
                                       if dispatch_stall_timeout else None)
        self._busy_since: Optional[float] = None
        self._exit_loop = threading.Event()
        self._unhealthy_reason: Optional[str] = None
        self._dispatches_at_restart: Optional[int] = None
        self._thread = threading.Thread(target=self._loop, daemon=True, name="engine-loop")
        self._thread.start()
        self._watchdog: Optional[threading.Thread] = None
        if self.dispatch_stall_timeout is not None:
            self._watchdog = threading.Thread(target=self._watchdog_loop, daemon=True,
                                              name="engine-watchdog")
            self._watchdog.start()

    def _init_pool(self, kv_page_tokens, kv_pages, max_slots) -> None:
        """The paged layout and its pool: page size from the admission
        geometry, the default budget the dense layout's KV bytes (``slots``
        worst-case rows of pages), ``max_slots`` 4 x ``slots``."""
        t = self._page_quantum(kv_page_tokens)
        layout = PagedLayout(self._adm_cache, self.l_buf, t)
        if kv_pages is None:
            kv_pages = RESERVED_PAGES + self.slots * layout.max_pages
        layout.num_pages = int(kv_pages)
        if layout.num_pages - RESERVED_PAGES < layout.max_pages:
            raise ValueError(f"kv_pages={kv_pages} cannot hold even one worst-case request "
                             f"({layout.max_pages} pages of {t} tokens + {RESERVED_PAGES} "
                             "reserved)")
        self.max_slots = 4 * self.slots if max_slots is None else int(max_slots)
        if self.max_slots < self.slots:
            raise ValueError(f"max_slots={max_slots} below slots={self.slots}")
        self._layout = layout
        self._pool = PagePool(layout, max_slots=self.max_slots)

    def _page_quantum(self, kv_page_tokens) -> int:
        """The page size: the gcd of every bucket's chunk width when
        ``kv_page_tokens`` is unset, else the explicit value, which must
        tile every chunk (chunk-aligned prefix boundaries land on page
        boundaries)."""
        widths = {self._chunk_width(s) for s in self.prompt_buckets}
        t = math.gcd(*widths) if kv_page_tokens is None else int(kv_page_tokens)
        bad = sorted(c for c in widths if t < 1 or c % t)
        if bad:
            raise ValueError(f"kv_page_tokens={t} must divide every prefill chunk width "
                             f"(got chunk(s) {bad})")
        return t

    def _fresh_dstate(self) -> Dict[str, Any]:
        """ALL decode state lives on the device, preallocated and updated in
        place; the host keeps a _Slot mirror for futures, streams and
        emitted tokens.  A watchdog restart rebuilds it from scratch.  The
        paged layout keeps its KV in slot-count-independent pages and a
        (slots, max_pages) table, every row on the graveyard at first (an
        unused row's frozen-cursor write must never land on the shared
        zero page)."""
        if self._layout is None:
            kv = {"cache": self.model.init_cache(self.slots, self.l_buf)}
        else:
            kv = {"pages": self._layout.fresh_pages(self.device)}
        return {**kv, **self._fresh_rows(self.slots)}

    def _fresh_rows(self, ns: int) -> Dict[str, torch.Tensor]:
        """The per-slot device state of ``ns`` inactive rows."""
        dev, v = self.device, self.vocab
        i32, i64, f32 = torch.int32, torch.int64, torch.float32
        rows = {
            "last_logits": torch.zeros((ns, v), dtype=f32, device=dev),
            "presence": torch.zeros((ns, v), dtype=torch.bool, device=dev),
            "cursors": torch.zeros((ns,), dtype=i32, device=dev),
            "kv_start": torch.zeros((ns,), dtype=i32, device=dev),
            "positions": torch.zeros((ns,), dtype=i64, device=dev),
            "active": torch.zeros((ns,), dtype=torch.bool, device=dev),
            "remaining": torch.zeros((ns,), dtype=i32, device=dev),
            "eos": torch.full((ns,), -1, dtype=i64, device=dev),
            "t": torch.zeros((ns,), dtype=f32, device=dev),
            "k": torch.full((ns,), v, dtype=i64, device=dev),
            "p": torch.ones((ns,), dtype=f32, device=dev),
            "rp": torch.ones((ns,), dtype=f32, device=dev),
            # per-slot REQUEST seed (the rid, set at insert): row r's draw
            # for its token at position p is keyed by (engine seed,
            # rseed[r], p) — never by dispatch grouping
            "rseed": torch.zeros((ns,), dtype=i64, device=dev),
        }
        if self._layout is not None:
            rows["table"] = torch.full((ns, self._layout.max_pages), GRAVE_PAGE, dtype=i32,
                                       device=dev)
        return rows

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        """Host -> device without a stream sync: through pinned memory on a
        card (the pinned block stays alive until the copy ran)."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if not self._cuda:
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    # ------------------------------------------------------------- public

    def submit(
        self,
        prompt_ids: Sequence[int],
        max_new_tokens: int,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        eos_id: Optional[int] = None,
        logprobs: bool = False,
        repetition_penalty: float = 1.0,
        stream: Optional["queue.Queue"] = None,
        deadline_s: Optional[float] = None,
        trace_id: Optional[str] = None,
    ) -> Future:
        ids = [int(t) for t in prompt_ids]
        if not ids:
            raise ValueError("prompt must be non-empty")
        n_new = int(max_new_tokens)
        if n_new <= 0:
            raise ValueError("max_new_tokens must be positive")
        if n_new > self.max_new_cap:
            raise ValueError(f"max_new_tokens {n_new} exceeds the engine cap {self.max_new_cap}")
        self._bucket(len(ids))  # validate now, in the caller thread
        if self._stop.is_set():
            raise RuntimeError("decode engine closed")
        if self._broken is not None:
            raise RuntimeError(f"decode engine is down: {self._broken!r}") from self._broken
        if deadline_s is not None and float(deadline_s) <= 0:
            raise ValueError(f"deadline_s must be positive, got {deadline_s}")
        if trace_id is None:
            trace_id = make_trace_id()
        elif not valid_trace_id(trace_id):
            raise ValueError(f"trace_id must be 32 lowercase hex chars, got {trace_id!r}")
        fut: Future = Future()
        rid = next(self._rid)
        fut.rid = rid  # the cancel(rid) handle callers key on
        fut.trace_id = trace_id
        now = time.perf_counter()
        self._queue.put({
            "ids": ids, "n_new": n_new, "future": fut,
            "temperature": float(temperature),
            "top_k": self.vocab if top_k is None else int(top_k),
            "top_p": 1.0 if top_p is None else float(top_p),
            "eos_id": -1 if eos_id is None else int(eos_id),
            "logprobs": bool(logprobs),
            "repetition_penalty": float(repetition_penalty),
            "stream": stream,
            "t_submit": now,
            "t_deadline": None if deadline_s is None else now + float(deadline_s),
            "rid": rid,
            "trace_id": trace_id,
        })
        if self._stop.is_set() or self._broken is not None:
            # close() (or a dying loop) may have drained the queue between
            # the checks above and our put: resolve the future ourselves
            if stream is not None:
                stream.put(None)
            _fail_future(fut, self._broken or RuntimeError("decode engine closed"))
        self._stats["requests"] += 1
        return fut

    def cancel(self, rid: int) -> bool:
        """Request cancellation of a live request by its rid (the ``rid``
        attribute of the Future ``submit`` returned).  The loop retires it
        at the next dispatch boundary.  Returns True if the rid matched a
        live request (best effort: it may finish first)."""
        rid = int(rid)
        if rid <= 0:
            return False

        def is_live() -> bool:
            # the loop thread mutates _pending concurrently; a deque
            # iterated mid-mutation raises RuntimeError — retry, and if it
            # keeps churning assume live
            for _ in range(3):
                try:
                    if any(sl is not None and sl.req["rid"] == rid for sl in self._host) or any(
                            req["rid"] == rid for req in list(self._pending)):
                        return True
                    break
                except RuntimeError:
                    continue
            else:
                return True
            adm = self._adm
            if adm is not None and adm.req["rid"] == rid:
                return True
            with self._queue.mutex:
                return any(isinstance(r, dict) and r["rid"] == rid for r in self._queue.queue)

        if not is_live():
            return False
        self._cancelled.add(rid)
        if not is_live():  # finished between the scan and the add
            self._cancelled.discard(rid)
            return False
        return True

    @property
    def healthy(self) -> bool:
        """False once the drive loop is broken, abandoned or dead (until a
        watchdog restart brings it back): /healthz's ``ok``."""
        return self._broken is None and not self._abandoned and self._thread.is_alive()

    @staticmethod
    def _percentiles(samples) -> Optional[Dict[str, float]]:
        if not samples:
            return None
        p50, p95, p99 = np.percentile(np.asarray(samples, np.float64), [50, 95, 99])
        return {"p50": round(float(p50), 3), "p95": round(float(p95), 3),
                "p99": round(float(p99), 3)}

    def stats(self) -> Dict[str, Any]:
        p = dict(self._pstats)  # snapshot: the loop thread mutates it
        done = self._stats["dispatches"]
        busy = p["hidden_ms"] + p["wait_ms"]
        out = {
            **self._stats,
            "queue_depth": self._queue.qsize() + len(self._pending),
            "active_slots": sum(1 for s in self._host if s is not None),
            "slots": self.slots,
            "steps_per_dispatch": self.steps_per_dispatch,
            "adaptive_k": self.adaptive_k,
            "k_ladder": list(self.k_ladder),
            "dispatches_by_k": dict(self._dispatches_by_k),
            "prefill_chunk": self.prefill_chunk,
            "fused_admission": self.fused_admission,
            "kv_layout": self.kv_layout,
            "healthy": self.healthy,
            "watchdog": {
                "dispatch_stall_timeout_s": self.dispatch_stall_timeout,
                "stalls": self._stats["watchdog_stalls"],
                "restarts": self._stats["watchdog_restarts"],
                "unhealthy_reason": self._unhealthy_reason,
            },
            "pipeline": {
                "depth": self.pipeline_depth,
                "inflight": len(self._inflight),
                "peak_inflight": p["peak_inflight"],
                "issued": p["issued"],
                "occupancy": round(p["inflight_sum"] / p["issued"], 3) if p["issued"] else None,
                "host_hidden_ms_per_dispatch": round(p["hidden_ms"] / done, 3) if done else None,
                "resolve_wait_ms_per_dispatch": round(p["wait_ms"] / done, 3) if done else None,
                "overlap_efficiency": round(p["hidden_ms"] / busy, 4) if busy > 0 else None,
            },
            "latency": {
                "samples": len(self._lat_ttft),
                "lifetime_samples": self._lat_ttft_n,
                "ttft_ms": self._percentiles(self._lat_ttft),
                "per_token_ms": self._percentiles(self._lat_tok),
            },
        }
        if self._pool is not None:
            out["live_slots"] = len(self._host)
            out["max_slots"] = self.max_slots
            out["kv_pool"] = self._pool_stats()
        return out

    def close(self, timeout: Optional[float] = 60.0) -> None:
        """Stop the loop thread, then fail everything still in flight.  Shared
        state is touched only after the thread has provably exited; if it
        does not exit within ``timeout`` (a dispatch wedged on the device)
        the engine is abandoned: submits fail, queued requests fail, and
        state the thread may still touch is left alone."""
        self._stop.set()
        self._queue.put(_POISON)  # wake a blocked queue.get NOW
        self._thread.join(timeout=timeout)
        if self._watchdog is not None:
            self._watchdog.join(timeout=5.0)
        err = RuntimeError("decode engine closed")
        if self._thread.is_alive():
            self._abandoned = True
            self._broken = RuntimeError("decode engine close timed out; step thread abandoned")
            self._unhealthy_reason = f"close() join timed out after {timeout}s"
            warnings.warn(f"decode engine close(): step thread did not exit within {timeout}s; "
                          "abandoning it", stacklevel=2)
            self._drain_queue(err)
            return
        for i in range(len(self._host)):
            self._finish(i, error=err)
        self._fail_admission(err)
        self._drain_pending(err)
        self._drain_queue(err)

    # ---------------------------------------------------------- teardown

    def _fail_admission(self, err: Exception) -> None:
        if self._adm is None:
            return
        adm, self._adm = self._adm, None
        self._fail_queued(adm.req, err)

    def _drain_queue(self, err: Exception) -> None:
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not _POISON:
                self._fail_queued(req, err)

    def _drain_pending(self, err: Exception) -> None:
        while self._pending:
            self._fail_queued(self._pending.popleft(), err)

    def _fail_queued(self, req: Dict[str, Any], err: Exception) -> None:
        """Fail a request that holds no slot: stream closed, future failed,
        each once."""
        self._cancelled.discard(req["rid"])
        if req["future"].done():
            return  # failed already (submit's close race, the watchdog)
        if req["stream"] is not None:
            req["stream"].put(None)
        _fail_future(req["future"], err)

    # ------------------------------------------------------ device work

    def _bucket(self, n: int) -> int:
        return _bucket(n, self.prompt_buckets, "prompt length")

    def _chunk_width(self, s_bucket: int) -> int:
        """The configured ``prefill_chunk`` when it divides the bucket,
        else one chunk for the whole bucket."""
        c = min(self.prefill_chunk, s_bucket)
        return s_bucket if s_bucket % c else c

    def _decode_steps(self, k: int, out: torch.Tensor) -> None:
        """K single-token steps of every slot, in place on the device state;
        step j's (tokens, logprobs, live) land in ``out[:, j]`` (3, K,
        slots).  A row whose budget or EOS lands mid-dispatch stops
        emitting and its cursor freezes; the state comes back with it
        inactive.  Nothing here waits for the device."""
        d = self._d
        rows = torch.arange(len(self._host), device=self.device)
        cache = d["cache"] if self._layout is None else PagedKV(
            self._layout, d["pages"], d["table"])
        # host-side verdicts on work the steps may skip: the host view
        # holds every row the device may still have live
        reqs = [sl.req for sl in self._host if sl is not None]
        any_sampled = any(r["temperature"] > 0 for r in reqs)
        penalty_on = any(r["repetition_penalty"] != 1.0 for r in reqs)
        live = d["active"].clone()
        for j in range(k):
            raw = d["last_logits"]
            adj = raw
            if penalty_on:
                rp = d["rp"][:, None]
                adj = torch.where(d["presence"], torch.where(raw > 0, raw / rp, raw * rp), raw)
            tok = sample_token_rowwise_keyed(self._seed, d["rseed"], d["positions"], adj,
                                             d["t"], d["k"], d["p"], any_sampled)
            tok = torch.where(live, tok, torch.full_like(tok, self.pad_id))
            lp = torch.log_softmax(raw, dim=-1).gather(-1, tok[:, None])[:, 0]
            if penalty_on:
                # only the penalty reads presence (a row's own is reset at
                # insert), so with no penalised row the update is skipped
                d["presence"][rows, tok] = d["presence"][rows, tok] | live
            d["remaining"].copy_(torch.where(live, d["remaining"] - 1, d["remaining"]))
            done_now = live & ((tok == d["eos"]) | (d["remaining"] <= 0))
            logits = self.model(tok[:, None], positions=d["positions"][:, None],
                                cache=cache, last_only=True,
                                cache_cursor=d["cursors"], kv_start=d["kv_start"])
            d["last_logits"].copy_(logits[:, -1])
            d["cursors"].copy_(torch.where(live, d["cursors"] + 1, d["cursors"]))
            d["positions"].copy_(torch.where(live, d["positions"] + 1, d["positions"]))
            out[0, j].copy_(tok)
            out[1, j].copy_(lp)
            out[2, j].copy_(live)
            live = live & ~done_now
        d["active"].copy_(live)

    def _run_chunk(self, adm: _Admission) -> None:
        """One (1, c) prefill chunk against the admission cache (its index
        is the chunk's first slot); keeps the chunk's last-token logits."""
        c = adm.chunk
        lo = adm.next_chunk * c
        logits = self.model(adm.row[:, lo:lo + c], positions=adm.positions[:, lo:lo + c],
                            cache=self._adm_cache, last_only=True, kv_start=adm.kv_start)
        adm.last_logits = logits[:, -1]
        adm.next_chunk += 1
        self._stats["prefill_chunks"] += 1

    def _start_admission(self, req) -> None:
        """Begin a chunked prefill (a free slot exists: the caller checked,
        and slots only free up while it runs).  The admission cache starts
        at the first chunk holding a real token: the all-pad chunks before
        it are skipped, their slots never read."""
        ids = req["ids"]
        s_bucket = self._bucket(len(ids))
        c = self._chunk_width(s_bucket)
        start_pad = s_bucket - len(ids)
        first_chunk = start_pad // c
        adm = _Admission(req, s_bucket, c, first_chunk)
        row, rmask = left_pad_row(ids, s_bucket, self.pad_id)
        positions = np.maximum(np.cumsum(rmask.astype(np.int64)) - 1, 0)
        adm.row = self._upload(row[None])
        adm.positions = self._upload(positions[None])
        adm.kv_start = self._upload(np.asarray([start_pad], np.int32))
        cache = self._adm_cache
        for layer in cache.layers:
            for t in vars(layer).values():
                t.zero_()
        cache.index = first_chunk * c
        self._adm = adm

    def _run_admission_chunk(self) -> None:
        """One STAGED chunk at a drained boundary (``fused_admission=False``,
        or no decode rows to ride); completes the admission after its last
        chunk."""
        adm = self._adm
        self._busy_since = time.perf_counter()
        try:
            self._run_chunk(adm)
        finally:
            self._busy_since = None
        if adm.next_chunk >= adm.n_chunks:
            self._complete_admission()

    def _complete_admission(self) -> None:
        """The final admission boundary: insert the prefilled row at a free
        slot.  The caller drained the pipeline (the slot comes from the host
        view, which must be fresh)."""
        adm = self._adm
        self._busy_since = time.perf_counter()
        try:
            self._insert_admission(adm)
        finally:
            self._busy_since = None
        if adm.fused_any:
            self._stats["admissions_overlapped"] += 1
        self._stats["prefills"] += 1
        self._adm = None

    def _insert_admission(self, adm: _Admission) -> None:
        req = adm.req
        s_bucket, n_ids = adm.s_bucket, len(req["ids"])
        slot = self._host.index(None)
        d = self._d
        span = None
        if self._pool is None:
            for dst, src in zip(d["cache"].layers, self._adm_cache.layers):
                for name, t in vars(dst).items():
                    t[slot].copy_(getattr(src, name)[0])
        else:
            span = self._insert_pages(slot, s_bucket, n_ids, req["n_new"])
        d["last_logits"][slot].copy_(adm.last_logits[0])
        d["presence"][slot].zero_()
        if req["repetition_penalty"] != 1.0:
            d["presence"][slot, adm.row[0, s_bucket - n_ids:]] = True
        for key, value in (("cursors", s_bucket), ("positions", n_ids),
                           ("kv_start", s_bucket - n_ids), ("remaining", req["n_new"]),
                           ("eos", req["eos_id"]), ("t", req["temperature"]),
                           ("k", req["top_k"]), ("p", req["top_p"]),
                           ("rp", req["repetition_penalty"]), ("rseed", req["rid"])):
            d[key][slot] = value
        d["active"][slot] = True
        sl = _Slot(req, remaining=req["n_new"], cursor=s_bucket)
        if span is not None:
            sl.span_end, sl.alloc_upto = span
        self._host[slot] = sl

    # ------------------------------------------------------------ paging

    def _insert_pages(self, slot: int, s_bucket: int, n_ids: int, n_new: int):
        """The paged insert: compose the slot's table row (NULL for pad and
        beyond-allocation pages, private pages for the prefill span plus
        one dispatch of lookahead), write the admission cache into those
        pages only (everything else routes to GRAVE), then flip the
        slot's device table row.  All or nothing: ``NoFreePages`` here
        (lazy growth of the running rows took the pages the gate saw)
        fails the joiner and leaks nothing.  Returns the row's (span end,
        page-aligned allocated end)."""
        pool = self._pool
        start_pad, span_end = self._slot_span(s_bucket, n_ids, n_new)
        alloc_end = self._alloc_end(s_bucket, span_end)
        row, mask, _ = pool.build_slot_row(start_pad, span_end, alloc_end=alloc_end)
        try:
            wsel = np.where(mask, row, GRAVE_PAGE).astype(np.int32)
            self._layout.insert_rows(self._d["pages"], self._upload(wsel), self._adm_cache)
            self._d["table"][slot].copy_(self._upload(row))
        except Exception:
            pool.release_row(row)
            raise
        pool.commit_slot_row(slot, row)
        t = pool.page_tokens
        return span_end, -(-alloc_end // t) * t

    def _slot_span(self, s_bucket: int, n_ids: int, n_new: int) -> Tuple[int, int]:
        """A slot's WRITE span in cache-slot coordinates: from the left-pad
        boundary to the budget plus the scratch slot a retired row's frozen
        cursor still writes.  Pages wholly inside the pad prefix (or past
        the span) map NULL and cost nothing."""
        return s_bucket - n_ids, s_bucket + int(n_new) + 1

    def _alloc_end(self, s_bucket: int, span_end: int) -> int:
        """The span the INSERT backs with pages: the prefill plus one
        dispatch of decode lookahead; the rest is allocated lazily."""
        return min(span_end, s_bucket + self.steps_per_dispatch + 1)

    def _req_span(self, req: Dict[str, Any]) -> Tuple[int, int, int]:
        s_bucket = self._bucket(len(req["ids"]))
        start_pad, span_end = self._slot_span(s_bucket, len(req["ids"]), req["n_new"])
        return s_bucket, start_pad, span_end

    def _pages_worst(self, req: Dict[str, Any]) -> int:
        """Pages a request can occupy at most: what must fit the whole pool
        for it to be servable at all."""
        _, start_pad, span_end = self._req_span(req)
        return self._pool.pages_needed(start_pad, span_end)

    def _pages_initial(self, req: Dict[str, Any]) -> int:
        """Pages a request needs AT ADMISSION (prefill plus one dispatch of
        lookahead): the admission gate's currency.  The pool overcommits
        against decode budgets; a dry pool at a later page crossing is a
        bounded failure of the starved row."""
        s_bucket, start_pad, span_end = self._req_span(req)
        return self._pool.pages_needed(start_pad, self._alloc_end(s_bucket, span_end))

    def _pop_admittable(self) -> Optional[Dict[str, Any]]:
        """The FIFO head of the pending requests if it can be admitted now.
        Dense: always.  Paged: its initial pages must be free, else it
        waits (rows retiring free pages; FIFO order is kept), and a
        request whose worst case exceeds the whole pool fails at once."""
        if self._pool is None:
            return self._pending.popleft()
        req = self._pending[0]
        worst = self._pages_worst(req)
        total = self._pool.alloc.total_pages
        if worst > total:
            self._pending.popleft()
            self._fail_queued(req, NoFreePages(
                f"request needs {worst} pages worst-case; the pool holds {total} (raise "
                "kv_pages or shrink the request)"))
            return None
        if self._pages_initial(req) > self._pool.alloc.free_pages:
            return None
        return self._pending.popleft()

    def _lazy_extend_tick(self) -> None:
        """Before each issue, make every live row's pages cover the slots
        the dispatches in flight and the one about to go out can write:
        ``cursor + lookahead``, capped at the row's span, where in-flight
        dispatches count at the K they were issued with.  A dry pool fails
        only the starved row, typed (``NoFreePages``); its pages free and
        the others decode on.  One table upload for all rows that grew."""
        if self._pool is None:
            return
        pool = self._pool
        t = pool.page_tokens
        lookahead = sum(inf.k for inf in self._inflight) + self.steps_per_dispatch + 1
        grew = False
        for i, sl in enumerate(self._host):
            if sl is None or sl.span_end is None:
                continue
            target = min(sl.span_end, sl.cursor + lookahead)
            if target <= sl.alloc_upto:
                continue
            p0, p1 = sl.alloc_upto // t, -(-target // t)
            try:
                pool.extend_slot_row(i, p0, p1)
            except NoFreePages:
                self._stats["kv_decode_page_failures"] += 1
                err = NoFreePages(
                    f"KV page pool exhausted mid-decode: slot {i} needed {p1 - p0} page(s) "
                    f"at cursor {sl.cursor} (lazy decode allocation overcommits the pool; "
                    "raise kv_pages or lower concurrency)")
                # device first, then host, as the deadline/cancel retirement
                self._d["active"][i] = False
                self._d["remaining"][i] = 0
                self._finish(i, error=err)
                self._release_slot_pages(i)
                continue
            self._stats["kv_pages_lazy_allocated"] += p1 - p0
            sl.alloc_upto = p1 * t
            grew = True
        if grew:
            # stream-ordered behind the dispatches in flight, which read the
            # old rows (their lookahead was covered when they were issued)
            self._d["table"].copy_(self._upload(pool.tables[: len(self._host)]))

    def _release_slot_pages(self, slot: int) -> None:
        """Live-path slot teardown (paged): the device table row goes to
        the graveyard (stream-ordered behind the dispatches in flight and
        ahead of any insert that reuses the pages), then the host releases
        the row's page references.  Teardown and restart rebuild the
        state and ``pool.reset()`` instead."""
        if self._pool is None:
            return
        self._d["table"][slot].fill_(GRAVE_PAGE)
        self._pool.free_slot(slot)

    def _scale_slots(self, ns2: int) -> None:
        """Resize the live slot count (the caller drained the pipeline:
        in-flight readbacks are shaped at the old width).  New rows start
        inactive on the graveyard; a shrink runs only at full quiesce."""
        ns = len(self._host)
        if ns2 == ns:
            return
        self._busy_since = time.perf_counter()
        try:
            fresh = self._fresh_rows(max(ns2 - ns, 0))
            for key, t in fresh.items():
                old = self._d[key]
                self._d[key] = torch.cat([old, t]) if ns2 > ns else old[:ns2].contiguous()
        finally:
            self._busy_since = None
        if ns2 > ns:
            self._host.extend([None] * (ns2 - ns))
        else:
            self._host = self._host[:ns2]
        self._stats["slots_scaled"] += 1
        self._stats["peak_live_slots"] = max(self._stats["peak_live_slots"], ns2)

    def _elastic_tick(self) -> None:
        """Elastic slots (paged): GROW by doubling, up to ``max_slots``,
        when traffic queues behind a full slot pool and the head request
        fits the free pages; SHRINK back to ``slots`` at full quiesce."""
        ns = len(self._host)
        if (self._adm is None and self._pending and None not in self._host
                and ns < self.max_slots):
            if self._pages_initial(self._pending[0]) <= self._pool.alloc.free_pages:
                self._drain_inflight()
                self._scale_slots(min(self.max_slots, ns * 2))
        elif (ns > self.slots and self._adm is None and not self._pending
                and not self._inflight and all(s is None for s in self._host)):
            self._scale_slots(self.slots)

    def _pool_stats(self) -> Dict[str, Any]:
        """The pool's stats, with the read race of an HTTP thread handled:
        the pool is loop-owned and its scans walk dicts the loop resizes."""
        for _ in range(3):
            try:
                return self._pool.stats()
            except RuntimeError:
                continue
        a = self._pool.alloc
        return {"pages_total": a.total_pages, "pages_free": a.free_pages,
                "pages_used": a.used_pages, **a.counters}

    def _issue_dispatch(self, fused: Optional[_Admission] = None) -> None:
        """Issue ONE dispatch and return without waiting for it: K decode
        steps, then the non-blocking readback of their packed tokens behind
        a CUDA event.  ``fused`` issues the admission's next chunk right
        behind the steps, with no host sync in between."""
        # lazy page growth first: this dispatch and those in flight must
        # find every slot they can write backed by a page
        self._lazy_extend_tick()
        k, ns = self.steps_per_dispatch, len(self._host)
        n = 3 * k * ns
        dev = self._ring_dev[self._ring_i][:n].view(3, k, ns)
        host = self._ring_host[self._ring_i][:n].view(3, k, ns)
        self._ring_i = (self._ring_i + 1) % len(self._ring_dev)
        self._busy_since = time.perf_counter()
        event = None
        try:
            self._decode_steps(k, dev)
            if self._cuda:
                host.copy_(dev, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                host.copy_(dev)
            if fused is not None:
                self._run_chunk(fused)
                fused.fused_any = True
                self._stats["fused_chunks"] += 1
        finally:
            self._busy_since = None
        self._inflight.append(_Inflight(host, event, time.perf_counter(), k))
        self._dispatches_by_k[k] = self._dispatches_by_k.get(k, 0) + 1
        p = self._pstats
        p["issued"] += 1
        p["inflight_sum"] += len(self._inflight)
        p["peak_inflight"] = max(p["peak_inflight"], len(self._inflight))

    def _process_oldest(self) -> None:
        """Wait for the OLDEST in-flight dispatch's tokens and run the host
        half: stream and record its tokens, retire finished rows.  FIFO
        order keeps step numbering, stream order and retirement identical
        at any pipeline depth."""
        inf = self._inflight.popleft()
        t_block = time.perf_counter()
        self._busy_since = t_block
        try:
            if inf.event is not None:
                inf.event.synchronize()
            arr = inf.host.numpy().copy()
        finally:
            self._busy_since = None
        t_done = time.perf_counter()
        p = self._pstats
        p["hidden_ms"] += (t_block - inf.t_issue) * 1e3
        p["wait_ms"] += (t_done - t_block) * 1e3
        toks = arr[0].astype(np.int64)
        lps = arr[1]
        valid = arr[2] > 0.5
        self._stats["dispatches"] += 1
        self._stats["steps"] += toks.shape[0]
        self._stats["emitted_tokens"] += int(valid.sum())
        for kk in range(toks.shape[0]):
            self.step_count += 1
            for i, sl in enumerate(self._host):
                if sl is None or not valid[kk, i]:
                    continue
                tok, lp = int(toks[kk, i]), float(lps[kk, i])
                if sl.t_first is None:
                    sl.t_first = t_done
                sl.emitted.append((tok, lp))
                if sl.req["stream"] is not None:
                    sl.req["stream"].put({"token": tok, "logprob": round(lp, 5),
                                          "step": self.step_count})
                sl.cursor += 1
                sl.remaining -= 1
                if sl.remaining <= 0 or tok == sl.req["eos_id"]:
                    self._finish(i)
                    self._release_slot_pages(i)

    def _drain_inflight(self) -> None:
        while self._inflight:
            self._process_oldest()

    def _finish(self, slot_idx: int, error: Optional[Exception] = None) -> None:
        sl = self._host[slot_idx]
        self._host[slot_idx] = None
        if sl is None:
            return
        req = sl.req
        self._cancelled.discard(req["rid"])
        if req["future"].done():
            return  # the watchdog failed it and closed its stream
        if req["stream"] is not None:
            req["stream"].put(None)
        if error is not None:
            _fail_future(req["future"], error)
            return
        now = time.perf_counter()
        if sl.t_first is not None:
            self._lat_ttft.append((sl.t_first - req["t_submit"]) * 1e3)
            self._lat_ttft_n += 1
            n = len(sl.emitted)
            if n > 1:
                self._lat_tok.append((now - sl.t_first) * 1e3 / (n - 1))
        result = {
            "ids": [t for t, _ in sl.emitted],
            "latency_ms": round((now - req["t_submit"]) * 1e3, 2),
            "batched_with": self.slots,
            "trace_id": req["trace_id"],
        }
        if req["logprobs"]:
            result["logprobs"] = [round(lp, 5) for _, lp in sl.emitted]
        _set_result(req["future"], result)

    # ------------------------------------------------------------ loop

    def _loop(self) -> None:
        try:
            if self._cuda and self.device.index is not None:
                torch.cuda.set_device(self.device)
            with torch.inference_mode():
                self._loop_body()
        except Exception as e:  # died outside the body's own handler
            self._broken = e
            self._unhealthy_reason = f"drive loop error: {type(e).__name__}: {e}"
        finally:
            # whatever ended the loop (close, an error, a watchdog verdict),
            # nothing may be left waiting on a future this thread will never
            # resolve; unread in-flight outputs are dropped
            err = self._broken or RuntimeError("decode engine closed")
            self._inflight.clear()
            for i in range(len(self._host)):
                self._finish(i, error=err)
            self._fail_admission(err)
            self._drain_pending(err)
            self._drain_queue(err)

    def _pump_queue(self, block_s: float = 0.0) -> None:
        """Move everything parked in the submit queue into ``_pending``;
        block up to ``block_s`` for the first item when idle."""
        try:
            item = self._queue.get(timeout=block_s) if block_s else self._queue.get_nowait()
            while True:
                # skip poison pills and futures already failed by submit's
                # close race or the watchdog
                if item is not _POISON and not item["future"].done():
                    self._pending.append(item)
                item = self._queue.get_nowait()
        except queue.Empty:
            pass

    def _retire_check(self, req: Dict[str, Any], now: Optional[float] = None
                      ) -> Optional[Exception]:
        rid = req["rid"]
        if rid in self._cancelled:
            return RequestCancelled(f"request {rid} cancelled")
        td = req["t_deadline"]
        if td is not None and (time.perf_counter() if now is None else now) >= td:
            return DeadlineExceeded(f"request {rid} exceeded its deadline")
        return None

    def _count_retire(self, err: Exception, req: Dict[str, Any]) -> None:
        key = "cancelled" if isinstance(err, RequestCancelled) else "deadline_exceeded"
        self._stats[key] += 1
        self._cancelled.discard(req["rid"])

    def _boundary_maintenance(self, block_s: float = 0.0) -> None:
        """Pump the submit queue, then retire queued and active requests
        whose deadline passed or whose rid was cancelled.  An active row is
        deactivated on the device first (stream-ordered behind in-flight
        dispatches), then its slot freed."""
        self._pump_queue(block_s)
        if (not self._pending and not self._cancelled
                and all(s is None or s.req["t_deadline"] is None for s in self._host)):
            return
        now = time.perf_counter()
        kept: Deque[Dict[str, Any]] = deque()
        for req in self._pending:
            err = self._retire_check(req, now)
            if err is None:
                kept.append(req)
            else:
                self._count_retire(err, req)
                self._fail_queued(req, err)
        self._pending = kept
        for i, sl in enumerate(self._host):
            if sl is None:
                continue
            err = self._retire_check(sl.req, now)
            if err is None:
                continue
            self._count_retire(err, sl.req)
            self._d["active"][i] = False
            self._d["remaining"][i] = 0
            self._finish(i, error=err)
            self._release_slot_pages(i)

    def _adaptive_tick(self) -> None:
        """One controller decision per boundary; a switch retargets the next
        issue, nothing drains (in-flight readbacks carry their own K)."""
        ctl = self._k_controller
        if ctl is None:
            return
        depth = self._queue.qsize() + len(self._pending)
        active = sum(1 for s in self._host if s is not None)
        k2 = ctl.decide(depth, active, len(self._host))
        if k2 != self.steps_per_dispatch:
            self.steps_per_dispatch = k2
            self._stats["dispatch_k_changes"] += 1

    def _admission_tick(self) -> bool:
        """Start the next admission, retire a cancelled/expired one, advance
        one chunk (fused behind this boundary's dispatch when rows are
        decoding, staged otherwise), and insert a finished one.  Returns
        True when a fused dispatch was issued."""
        req = None
        if self._adm is None and None in self._host and self._pending:
            req = self._pop_admittable()
        if req is not None:
            if not self.fused_admission:
                self._drain_inflight()
            try:
                self._start_admission(req)
            except Exception as e:
                self._fail_queued(req, e)
        if self._adm is not None:
            err = self._retire_check(self._adm.req)
            if err is not None:
                self._count_retire(err, self._adm.req)
                self._fail_admission(err)
        issued = False
        adm = self._adm
        if adm is not None and adm.next_chunk < adm.n_chunks:
            if self.fused_admission and any(s is not None for s in self._host):
                self._issue_dispatch(fused=adm)
                issued = True
            else:
                self._drain_inflight()
                try:
                    self._run_admission_chunk()
                except Exception as e:
                    self._fail_admission(e)
        adm = self._adm
        if adm is not None and adm.next_chunk >= adm.n_chunks:
            # all chunks issued (the last may be in flight behind a fused
            # dispatch): drain at loop level, where a dispatch failure is
            # the fleet's error, then insert (admission-scoped faults)
            self._drain_inflight()
            try:
                self._complete_admission()
            except Exception as e:
                self._fail_admission(e)
        return issued

    def _loop_body(self) -> None:
        while not (self._stop.is_set() or self._exit_loop.is_set()):
            if self._broken is not None:
                return
            try:
                idle = (self._adm is None and not self._inflight and not self._pending
                        and all(s is None for s in self._host))
                self._boundary_maintenance(block_s=0.2 if idle else 0.0)
                self._adaptive_tick()
                if self._pool is not None:
                    self._elastic_tick()
                issued = self._admission_tick()
                if not issued and any(s is not None for s in self._host):
                    self._issue_dispatch()
                    issued = True
                # keep pipeline_depth dispatches in flight in steady state;
                # staged-admission boundaries run synchronous, and with
                # nothing newly issued whatever remains resolves now
                keep = self.pipeline_depth - 1 if (
                    issued and (self._adm is None or self.fused_admission)) else 0
                while len(self._inflight) > keep:
                    self._process_oldest()
            except Exception as e:  # engine-level failure
                self._broken = e
                if self._unhealthy_reason is None:
                    self._unhealthy_reason = f"drive loop error: {type(e).__name__}: {e}"
                self._inflight.clear()
                return

    # ---------------------------------------------------------- watchdog

    def _watchdog_loop(self) -> None:
        """Declare a stall when the loop sits in one device call past
        ``dispatch_stall_timeout`` (fail the waiters, ask the loop to exit
        when it unsticks), and restart a provably dead loop once per
        incident if it made progress since the last restart."""
        stall_declared = False
        while True:
            timeout = self.dispatch_stall_timeout
            if self._stop.wait(min(max((timeout or 1.0) / 4.0, 0.02), 1.0)):
                return
            try:
                busy = self._busy_since
                if (timeout and not stall_declared and busy is not None
                        and time.perf_counter() - busy > timeout and self._thread.is_alive()):
                    stall_declared = True
                    self._fire_stall(time.perf_counter() - busy)
                if not self._thread.is_alive() and not self._stop.is_set():
                    if self._maybe_restart():
                        stall_declared = False
            except Exception as e:  # the backstop must survive its own races
                warnings.warn(f"engine watchdog tick failed ({e!r}); retrying next tick")

    def _fire_stall(self, stuck_s: float) -> None:
        err = EngineStalled(f"dispatch exceeded dispatch_stall_timeout="
                            f"{self.dispatch_stall_timeout}s (stuck {stuck_s:.1f}s)")
        self._stats["watchdog_stalls"] += 1
        self._unhealthy_reason = str(err)
        self._broken = err      # submits fail fast from here on
        self._exit_loop.set()   # the loop dies when the call returns
        # fail the WAITERS now; slot and queue bookkeeping stays loop-owned
        waiters = [sl.req for sl in list(self._host) if sl is not None]
        adm = self._adm
        if adm is not None:
            waiters.append(adm.req)
        for _ in range(3):
            try:
                waiters += list(self._pending)
                break
            except RuntimeError:  # the unsticking loop mutated it
                continue
        with self._queue.mutex:
            waiters += [r for r in self._queue.queue if isinstance(r, dict)]
        for req in waiters:
            if req["stream"] is not None and not req["future"].done():
                req["stream"].put(None)
            _fail_future(req["future"], err)

    def _maybe_restart(self) -> bool:
        """One bounded restart of a dead drive loop on a fresh device state;
        refused when closing, abandoned, or without progress since the last
        restart."""
        if self._abandoned or self._stop.is_set():
            return False
        d = self._stats["dispatches"]
        if self._dispatches_at_restart is not None and d <= self._dispatches_at_restart:
            self._unhealthy_reason = ("drive loop died again with no progress since the last "
                                      "watchdog restart; staying down")
            return False
        self._dispatches_at_restart = d
        err = self._broken or EngineStalled("drive loop died")
        self._inflight.clear()
        for i in range(len(self._host)):
            self._finish(i, error=err)
        self._fail_admission(err)
        self._drain_pending(err)
        self._host = [None] * self.slots
        self._busy_since = None
        with torch.inference_mode():
            self._d = self._fresh_dstate()
        if self._pool is not None:
            # fresh zero pages: every host-side mapping is stale
            self._pool.reset()
        self._stats["watchdog_restarts"] += 1
        self._exit_loop.clear()
        self._broken = None
        self._unhealthy_reason = None
        self._thread = threading.Thread(target=self._loop, daemon=True, name="engine-loop")
        self._thread.start()
        return True
