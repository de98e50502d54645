"""LM serving over HTTP: the counterpart of mlcomp_tpu/serve.py.

Three batchers, picked by ``GenerationService(batcher=)``:

- ``"continuous"`` (the default; ``"auto"`` means it): the slot engine
  (``engine.DecodeEngine``).  Requests join a running decode at a dispatch
  boundary, finished rows free their slot at once, tokens stream as they
  land, and requests carry deadlines and can be cancelled.
  ``kv_layout="paged"`` keeps its KV cache in pages (``kvpool``):
  admission waits for free pages, the slot count is elastic up to
  ``max_slots``, and ``/stats`` carries the pool's counters under
  ``engine.kv_pool``.
- ``"window"``: requests that arrive within a short window and share a
  ``max_new`` bucket decode together through one
  ``models.generation.generate`` call: prompts left-pad into a length
  bucket, the batch pads to a batch-size bucket with copies of row 0, and
  per-request sampling knobs ride as per-row arrays.  One background
  thread owns all device work.
- ``"speculative"``: the B = 1 latency mode.  Each request runs alone
  through ``models.speculative.speculative_generate`` (bigram draft,
  K+1-wide verify; greedy only, no logprobs, no repetition penalty), one
  request at a time on the window batcher's thread.

``engine_spec_k`` makes the continuous engine speculate (its dispatch is
then a verify of ``engine_spec_k + 1`` positions a row; greedy only).

``phase`` is the disaggregated serving role: ``"both"`` (the default) the
monolithic daemon; ``"prefill"`` runs the continuous engine's admission
core only (``prefill_only``) and answers ``POST /prefill`` with KV-page
handoff blobs; ``"decode"`` is a paged daemon that also admits handoffs
through ``POST /import``, skipping the prefill with the tokens a local
admission gives.  Any paged daemon takes ``/import``.

HTTP handler threads enqueue requests and wait on futures.  HTTP surface
(stdlib ``http.server``):

    POST /generate  {"prompt": [ids...], "max_new_tokens": 64,
                     "temperature": 0.8, "top_k": 50, "top_p": 0.95,
                     "eos_id": 2, "logprobs": true,
                     "repetition_penalty": 1.1, "deadline_s": 30,
                     "stream": false}
        -> {"ids": [...generated ids...], "latency_ms": ...,
            "batched_with": n, "trace_id": "...", "logprobs": [...]}
        With "stream": true (continuous batcher) the answer is server-sent
        events: one ``data: {"token", "logprob", "step"}`` per token, then
        ``data: {"done": true, **result}``; a client that disconnects
        cancels its request.
    GET  /healthz   -> {"ok": ..., "ready": ..., "model": ..., **stats}
        ``ok`` is liveness (503 when the engine is down), ``ready`` is
        whether to send new traffic (false while draining).
    POST /prefill   the /generate body (phase=prefill replicas)
        -> the handoff blob as application/octet-stream, its summary
           (pages, prefill_tokens, latency_ms, trace_id) as JSON in the
           ``x-mlcomp-handoff`` header; 409 ``wrong_phase`` off a prefill
           replica, which in turn answers /generate with 409
    POST /import    a handoff blob (paged replicas); ``?stream=1`` streams
        SSE as /generate does, else the /generate result; a truncated or
        mismatched blob answers 400 ``bad_handoff`` with nothing allocated,
        a pool that cannot hold its pages 429 ``no_free_pages``
    POST /drain     {"draining": true} -> {"ok": true, "draining": true}
    GET  /stats     -> the service counters
    GET  /cache/stats -> the host prefix cache's counters (404 unless the
        service was built with ``prefix_cache=True``); with the cache on,
        every result carries ``cache_hit_tokens``
    GET  /metrics   -> Prometheus text exposition (``obs/metrics.py``):
        the engine's, the prefix cache's and the service's families
    GET  /trace?last_ms=N[&trace_id=<32 hex>][&rid=N] -> the engine's
        flight recorder as Chrome trace-event JSON, or one request's
        events (404 on the window batcher).  A request adopts the client's
        W3C ``traceparent`` trace id, else mints one; every answer echoes it
    GET  /slo, GET /metrics/history?window_s=N -> the SLO burn rates and
        the metrics-history ring (``obs/slo.py``, ``obs/history.py``; 404
        with ``metrics_history_interval=0``)
    GET  /profile?dispatches=N -> arm a ``torch.profiler`` capture around
        the engine's next N dispatch boundaries (default 8, at most 256)
        and answer with its attribution JSON: device_time_ms, host_gap_ms,
        the kernels by name, the wrappers' launches over the window, the
        roofline share per dispatch family.  The capture's device spans
        join the flight recorder, so a later /trace shows them under the
        host spans.  It needs decode traffic to complete (the window is
        dispatch-gated): 504 ``profile_timeout`` (the capture disarmed)
        when none came; 404 on the window batcher, 400 on a bad N, 409
        ``profile_busy`` while another capture is armed or open

Serving under a mesh (``mesh=``, ``dist=``; ``load_service(mesh_cfg=)``,
``serve --mesh ... --distributed``): one process a rank, each holding its
tensor-parallel shards of the weights and of the KV cache, the continuous
engine running as a gang (``engine.py``).  Rank 0, the coordinator, fronts
HTTP; a follower replays its boundaries, answers ``/healthz`` with
``ready: false`` and ``/generate`` with 503 ``not_coordinator``.
``/healthz`` carries the ``mesh`` block and ``/metrics`` the
``mlcomp_engine_mesh_devices`` and ``mlcomp_engine_is_coordinator``
gauges.

Admission control: the paged layout's free-page gate (always on) and the
optional ``max_queue_depth`` / ``max_concurrent_requests`` caps answer
429 with ``Retry-After`` (reasons ``no_free_pages``, ``queue_full``,
``concurrency``) instead of queueing without bound.  ``warmup()`` launches
every kernel of the served configuration with ``ready: false`` until it
is done.
"""

from __future__ import annotations

import json
import math
import queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutTimeout
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from mlcomp_tpu_torch.obs.metrics import Registry
from mlcomp_tpu_torch.utils.trace import (
    filter_export,
    make_trace_id,
    parse_traceparent,
    valid_trace_id,
)


class BackpressureError(RuntimeError):
    """Admission control rejected the request (the paged layout's free
    pages, the bounded queue or the concurrency cap): a fast failure with a
    drain estimate instead of unbounded queueing.  HTTP maps this to 429 +
    ``Retry-After``."""

    def __init__(self, msg: str, reason: str, retry_after_s: float):
        super().__init__(msg)
        self.reason = reason
        self.retry_after_s = float(retry_after_s)


def _bucket(value: int, buckets: Sequence[int], what: str) -> int:
    for b in sorted(buckets):
        if value <= b:
            return b
    raise ValueError(
        f"{what} {value} exceeds the largest configured bucket "
        f"{max(buckets)}; raise the bucket list"
    )


def _trim_generated(row: np.ndarray, s_bucket: int, item: Dict[str, Any]) -> List[int]:
    """Request-visible ids from a full output row: drop the bucketed
    prompt, cap at the request's n_new, trim pads after EOS."""
    gen = row[s_bucket: s_bucket + item["n_new"]].tolist()
    eos = item.get("eos_id", -1)
    if eos >= 0 and eos in gen:
        gen = gen[: gen.index(eos) + 1]
    return gen


def left_pad_row(ids: Sequence[int], s_bucket: int, pad_id: int):
    """The serving LEFT-padding contract: the (s_bucket,) id row and its
    bool validity mask."""
    row = np.full(s_bucket, pad_id, np.int64)
    mask = np.zeros(s_bucket, bool)
    row[s_bucket - len(ids):] = ids
    mask[s_bucket - len(ids):] = True
    return row, mask


def _fail_future(fut: Future, err: BaseException) -> None:
    """Fail a future idempotently: a close race and a drain can both reach
    the same future."""
    try:
        if not fut.done():
            fut.set_exception(err)
    except Exception:  # InvalidStateError: the other side resolved it
        pass


class GenerationService:
    """The serving front of one model: the continuous engine or the window
    batcher (module docstring).

    ``params`` is a flax-layout params tree (``io.weights``); ``quantize``
    False, ``"int8"`` (storage: dequantized once at load) or ``"kernel"``
    (int8 weights consumed by the CUDA int8 matmul).  The weights load into
    ``model`` on its device.  The continuous engine takes ``batch_sizes[-1]``
    slots, the prompt buckets, ``max_new_buckets[-1]`` as its budget cap,
    and the engine knobs (``steps_per_dispatch`` default ``"adaptive"``;
    ``kv_layout``, ``kv_page_tokens``, ``kv_pages`` and ``max_slots`` for
    the paged layout, ``max_slots`` defaulting to 4 x the slots).
    ``phase`` is the disaggregated serving role (module docstring).

    ``spec_k`` is the speculative batcher's draft length; ``engine_spec_k``
    turns on the continuous engine's speculative dispatch.

    Continuous batcher only: ``prefix_cache`` turns on the host prefix
    cache (``prefix_cache_bytes`` its budget); ``flight_recorder_events``
    bounds the engine's recorder; ``max_queue_depth`` and
    ``max_concurrent_requests`` (0: unbounded) cap admission.  Any
    batcher: ``metrics_history_interval`` (0 disables) samples the metrics
    registry for ``/metrics/history`` and the SLOs of ``slo_config``.

    ``mesh`` (a ``DeviceMesh`` over the process group: dp, tp, ep) loads the
    rank's shards and runs the engine under it; ``dist`` (a
    ``parallel.distributed.BoundaryChannel``) makes the service a gang
    member, rank 0 the coordinator (module docstring)."""

    def __init__(
        self,
        model,
        params,
        batch_sizes: Sequence[int] = (1, 2, 4, 8),
        prompt_buckets: Sequence[int] = (128, 256, 512, 1024),
        max_new_buckets: Sequence[int] = (32, 128),
        batch_window_ms: float = 10.0,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        eos_id: Optional[int] = None,
        pad_id: int = 0,
        quantize: "bool | str" = False,
        seed: int = 0,
        repetition_penalty: float = 1.0,
        request_timeout_s: float = 600.0,
        batcher: str = "auto",
        steps_per_dispatch: "Optional[int | str]" = None,
        prefill_chunk: int = 256,
        engine_pipeline_depth: Optional[int] = None,
        engine_fused_admission: Optional[bool] = None,
        dispatch_stall_timeout: Optional[float] = None,
        kv_layout: str = "dense",
        kv_page_tokens: Optional[int] = None,
        kv_pages: Optional[int] = None,
        max_slots: Optional[int] = None,
        spec_k: int = 8,
        engine_spec_k: Optional[int] = None,
        phase: str = "both",
        prefix_cache: bool = False,
        prefix_cache_bytes: int = 1 << 31,
        flight_recorder_events: Optional[int] = 32768,
        max_queue_depth: int = 0,
        max_concurrent_requests: int = 0,
        metrics_history_interval: Optional[float] = 5.0,
        slo_config: Optional[Dict[str, Any]] = None,
        mesh=None,
        dist=None,
    ):
        from mlcomp_tpu_torch.models.generation import load_decode_weights

        if batcher == "auto":
            batcher = "continuous"
        if batcher not in ("continuous", "window", "speculative"):
            raise ValueError("batcher: expected 'auto'/'continuous'/'window'/'speculative', got "
                             f"{batcher!r}")
        self.mesh = mesh
        self.dist = dist
        self._validate_mesh(model, mesh, dist, batcher, batch_sizes, quantize)
        if batcher != "continuous" and (
                engine_fused_admission is not None
                or (engine_pipeline_depth is not None and int(engine_pipeline_depth) > 1)):
            raise ValueError("engine_pipeline_depth > 1 and engine_fused_admission need "
                             "the continuous batcher")
        if batcher != "continuous" and (kv_layout != "dense" or kv_page_tokens is not None
                                    or kv_pages is not None or max_slots is not None):
            raise ValueError("kv_layout / kv_page_tokens / kv_pages / max_slots need the "
                             "continuous batcher (only the slot engine owns a device KV pool)")
        self.phase = str(phase)
        if self.phase not in ("both", "prefill", "decode"):
            raise ValueError(f"phase must be 'both', 'prefill', or 'decode'; got {phase!r}")
        if self.phase != "both" and batcher != "continuous":
            raise ValueError("phase-split serving needs the continuous batcher (only the slot "
                             "engine owns an admission core)")
        if self.phase != "both" and (mesh is not None or dist is not None):
            raise ValueError("phase-split serving is single-process single-chip for now "
                             "(sharded prefill tiers and gang imports are named follow-ups); "
                             "drop --mesh/--distributed or phase")
        if self.phase == "prefill" and engine_spec_k is not None:
            raise ValueError("a prefill replica runs no decode dispatch; drop engine_spec_k")
        if self.phase == "decode" and kv_layout != "paged":
            raise ValueError("phase='decode' needs kv_layout='paged': handoff imports land "
                             "as pages in the engine's PagePool")
        if prefix_cache and batcher != "continuous":
            # only the slot engine has admissions to serve from the cache
            raise ValueError("prefix_cache needs the continuous batcher")
        if prefix_cache and mesh is not None:
            raise ValueError("the prefix KV cache is single-chip for now; drop prefix_cache or "
                             "the mesh")
        history_interval = float(metrics_history_interval) if metrics_history_interval else 0.0
        if history_interval < 0:
            raise ValueError(f"metrics_history_interval must be >= 0 (0 disables), got "
                             f"{metrics_history_interval}")
        if history_interval > 0:
            from mlcomp_tpu_torch.obs.slo import validate_config

            validate_config(slo_config)   # fail at construction, not at a tick
        elif slo_config is not None:
            raise ValueError("slo_config needs the metrics-history sampler; don't set "
                             "metrics_history_interval to 0 with an SLO config")
        self.batcher = batcher
        self.model = model
        self.batch_sizes = tuple(sorted(batch_sizes))
        self.prompt_buckets = tuple(sorted(prompt_buckets))
        self.max_new_buckets = tuple(sorted(max_new_buckets))
        self.batch_window_s = batch_window_ms / 1e3
        self.pad_id = int(pad_id)
        self.defaults: Dict[str, Any] = {
            "temperature": float(temperature), "top_k": top_k, "top_p": top_p,
            "eos_id": eos_id, "repetition_penalty": float(repetition_penalty),
        }
        self._neutral_k = int(model.vocab_size)
        self.spec_k = int(spec_k)
        if batcher == "speculative":
            if self.spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
            if mesh is not None:
                raise ValueError("the speculative batcher is single-chip (B=1 latency mode); use "
                                 "the continuous batcher under a mesh")
            if self.defaults["temperature"] != 0.0:
                raise ValueError("the speculative batcher is greedy-only; set the service "
                                 "default temperature to 0")
            if self.defaults["repetition_penalty"] != 1.0:
                raise ValueError("repetition_penalty is not supported by the speculative "
                                 "batcher; drop the service default")
            # one request a call, B = 1 by design
            self.batch_sizes = (1,)
        if engine_spec_k is not None:
            if batcher != "continuous":
                raise ValueError("engine_spec_k needs the continuous batcher")
            if self.defaults["temperature"] != 0.0 or self.defaults["repetition_penalty"] != 1.0:
                raise ValueError("engine_spec_k engines are greedy-only: service defaults must "
                                 "keep temperature 0 and repetition_penalty 1")
        self.quant_mode = load_decode_weights(model, params, quantize, mesh=mesh)
        self.request_timeout_s = float(request_timeout_s)
        if self.request_timeout_s <= 0:
            raise ValueError(f"request_timeout_s must be positive, got {request_timeout_s}")
        self.max_queue_depth = int(max_queue_depth or 0)
        self.max_concurrent_requests = int(max_concurrent_requests or 0)
        self._rejects = {"queue_full": 0, "concurrency": 0, "no_free_pages": 0}
        self._queue: "queue.Queue" = queue.Queue()
        self._deferred: List[Dict[str, Any]] = []
        self._stats = {"requests": 0, "batches": 0, "batched_rows": 0}
        if batcher == "speculative":
            self._stats.update(spec_tokens=0, spec_forwards=0)
        self._stop = threading.Event()
        # the scrape registry behind GET /metrics: the engine registers its
        # collector and histograms into it, the service its own counters
        self.metrics = Registry()
        self.metrics.register_collector(self._collect_metrics)
        self.history = None
        self.slo = None
        # readiness vs liveness: a draining or warming daemon is ok (keep
        # it) but not ready (send it no new traffic)
        self._draining = False
        self._warming = False
        self.engine = None
        self._thread = None
        self.prefix_cache = None
        if prefix_cache:
            from mlcomp_tpu_torch.cache import PrefixKVCache

            self.prefix_cache = PrefixKVCache(max_bytes=int(prefix_cache_bytes))
        if batcher == "continuous":
            from mlcomp_tpu_torch.engine import DecodeEngine

            self.engine = DecodeEngine(
                model, slots=self.batch_sizes[-1], prompt_buckets=self.prompt_buckets,
                max_new_cap=self.max_new_buckets[-1], pad_id=self.pad_id, seed=seed,
                # adaptive K by default; a spec engine reads no K
                steps_per_dispatch=("adaptive" if steps_per_dispatch is None
                                    and engine_spec_k is None else steps_per_dispatch),
                spec_k=engine_spec_k,
                prefill_chunk=prefill_chunk, pipeline_depth=engine_pipeline_depth,
                fused_admission=engine_fused_admission,
                dispatch_stall_timeout=dispatch_stall_timeout,
                kv_layout=kv_layout, kv_page_tokens=kv_page_tokens, kv_pages=kv_pages,
                max_slots=max_slots, prefill_only=self.phase == "prefill",
                prefix_cache=self.prefix_cache, flight_recorder_events=flight_recorder_events,
                metrics=self.metrics, mesh=mesh, dist=dist,
            )
        else:
            self._gen = torch.Generator(device=model.device).manual_seed(seed)
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        if history_interval > 0:
            from mlcomp_tpu_torch.obs.history import MetricsHistory
            from mlcomp_tpu_torch.obs.slo import SLOEngine

            self.history = MetricsHistory(self.metrics, interval_s=history_interval)
            self.slo = SLOEngine(self.history, config=slo_config, registry=self.metrics,
                                 recorder=self.engine.recorder if self.engine is not None
                                 else None)
            # burn rates re-evaluate at every sampler tick
            self.history.add_callback(self.slo.evaluate)

    @staticmethod
    def _validate_mesh(model, mesh, dist, batcher, batch_sizes, quantize) -> None:
        """The JAX service's checks of a mesh, and the port's own: a mesh
        wider than one rank is a gang, which only the continuous engine's
        boundary loop can keep in step."""
        from mlcomp_tpu_torch.ops.quant import mesh_gate
        from mlcomp_tpu_torch.parallel.mesh import mesh_shape

        if dist is not None:
            if batcher != "continuous":
                raise ValueError("distributed serving needs the continuous batcher (only the "
                                 "slot engine has a boundary loop to synchronize)")
            if mesh is None:
                raise ValueError("distributed serving needs a mesh (--mesh): the gang runs one "
                                 "program a rank over the global mesh")
        if mesh is None:
            return
        shape = mesh_shape(mesh)
        dbatch = shape.get("dp", 1) * shape.get("fsdp", 1)
        bad = [b for b in batch_sizes if b % dbatch]
        if bad:
            raise ValueError(f"batch sizes {bad} don't divide the mesh's data axes "
                             f"(dp*fsdp = {dbatch}); fix --batch-sizes")
        kernels = getattr(model, "kv_quant", False) or str(quantize).strip().lower() == "kernel"
        if kernels and shape.get("fsdp", 1) > 1:
            raise ValueError("quantize='kernel' / kv_quant need a tp/dp mesh; fsdp-sharded "
                             "serving runs bf16 or entry-dequant int8")
        tp = shape.get("tp", 1)
        heads = getattr(model, "heads", None)
        if kernels and tp > 1 and heads:
            kv_heads = getattr(model, "kv_heads", None) or heads
            if heads % tp or kv_heads % tp:
                raise ValueError(f"tp={tp} must divide heads ({heads}) and kv_heads "
                                 f"({kv_heads}) for the CUDA serving kernels")
        if mesh_gate(mesh) is not None and batcher != "continuous":
            raise ValueError(f"a mesh over {math.prod(shape.values())} ranks serves through the "
                             "continuous batcher: every rank is a process, and only the slot "
                             "engine's boundary loop keeps the gang in step")

    # ------------------------------------------------------------- public

    def submit(self, prompt_ids: Sequence[int], max_new_tokens: int,
               temperature: Optional[float] = None, top_k: Optional[int] = None,
               top_p: Optional[float] = None, eos_id: Optional[int] = None,
               logprobs: bool = False, repetition_penalty: Optional[float] = None,
               trace_id: Optional[str] = None, stream: Optional["queue.Queue"] = None,
               deadline_s: Optional[float] = None) -> Future:
        """Enqueue one request; the future resolves to ``{"ids": generated
        ids (prompt excluded, capped at ``max_new_tokens``, pads after EOS
        trimmed), "latency_ms", "batched_with", "trace_id"}`` and
        ``"logprobs"`` when asked.

        Continuous batcher only: ``stream`` (a ``queue.Queue``) receives
        ``{"token", "logprob", "step"}`` dicts as tokens land, then
        ``None``; ``deadline_s`` (default, and upper clamp, the service's
        ``request_timeout_s``) retires the request at the next dispatch
        boundary past it with ``DeadlineExceeded``.  The future carries
        ``rid``, the handle :meth:`cancel` takes.  Admission control may
        reject before queueing with ``BackpressureError`` (HTTP 429).
        ``trace_id`` (32 hex) is adopted, else one is minted."""
        if trace_id is not None and not valid_trace_id(trace_id):
            raise ValueError(f"trace_id must be 32 lowercase hex chars, got {trace_id!r}")
        ids = [int(t) for t in prompt_ids]
        if not ids:
            raise ValueError("prompt must be non-empty")
        n_new = int(max_new_tokens)
        if n_new <= 0:
            raise ValueError("max_new_tokens must be positive")
        t = self.defaults["temperature"] if temperature is None else float(temperature)
        if not 0.0 <= t <= 100.0:
            raise ValueError(f"temperature must be in [0, 100], got {t}")
        k = self.defaults["top_k"] if top_k is None else int(top_k)
        if k is not None and k < 1:
            raise ValueError(f"top_k must be >= 1, got {k}")
        if k is not None:
            k = min(k, self._neutral_k)
        p = self.defaults["top_p"] if top_p is None else float(top_p)
        if p is not None and not 0.0 < p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {p}")
        rp = (self.defaults["repetition_penalty"] if repetition_penalty is None
              else float(repetition_penalty))
        if not 0.0 < rp <= 10.0:
            raise ValueError(f"repetition_penalty must be in (0, 10], got {rp}")
        if not isinstance(logprobs, bool):
            raise ValueError(f"logprobs must be a JSON boolean, got {logprobs!r}")
        eos = self.defaults["eos_id"] if eos_id is None else int(eos_id)
        if eos is not None and not 0 <= eos < 2 ** 31:
            if eos == -1 or eos_id is None:
                eos = None
            else:
                raise ValueError(f"eos_id must be in [0, 2^31), or -1 for none; got {eos}")
        if any(not 0 <= i < self._neutral_k for i in ids):
            raise ValueError(f"prompt ids must lie in [0, {self._neutral_k})")
        _bucket(len(ids), self.prompt_buckets, "prompt length")
        nb = _bucket(n_new, self.max_new_buckets, "max_new_tokens")
        if self.batcher == "speculative":
            if t != 0.0:
                raise ValueError("the speculative batcher is greedy-only (temperature 0); use "
                                 "the continuous batcher for sampling")
            if rp != 1.0:
                raise ValueError("repetition_penalty is not supported by the speculative "
                                 "batcher")
            if logprobs:
                raise ValueError("logprobs are not supported by the speculative batcher")
        if self.engine is not None:
            self._admission_check(ids, n_new)
            # a client may only tighten the operator's request timeout
            eff = self.request_timeout_s if deadline_s is None else min(
                float(deadline_s), self.request_timeout_s)
            return self.engine.submit(
                ids, n_new, temperature=t, top_k=k, top_p=p, eos_id=eos, logprobs=logprobs,
                repetition_penalty=rp, stream=stream, deadline_s=eff, trace_id=trace_id)
        if stream is not None or deadline_s is not None:
            raise ValueError("token streaming and per-request deadlines need the continuous "
                             "batcher; this service runs the window batcher")
        self._stats["requests"] += 1
        fut: Future = Future()
        tid = trace_id if trace_id is not None else make_trace_id()
        fut.trace_id = tid
        self._queue.put({
            "ids": ids, "n_new": n_new, "bucket_new": nb, "future": fut,
            "temperature": t,
            "top_k": self._neutral_k if k is None else k,
            "top_p": 1.0 if p is None else p,
            "eos_id": -1 if eos is None else eos,
            "logprobs": bool(logprobs),
            "repetition_penalty": rp,
            "trace_id": tid,
        })
        return fut

    def generate(self, prompt_ids, max_new_tokens, **knobs):
        return self.submit(prompt_ids, max_new_tokens, **knobs).result()

    def cancel(self, rid: int) -> bool:
        """Cancel a live continuous-engine request by rid (the ``rid`` of
        its Future); False for the window batcher, which cannot."""
        return self.engine.cancel(rid) if self.engine is not None else False

    def import_pages(self, blob: bytes, stream: Optional["queue.Queue"] = None,
                     deadline_s: Optional[float] = None,
                     trace_id: Optional[str] = None) -> Future:
        """Admit a disaggregated handoff (behind ``POST /import``): validate
        the blob against this engine's paged geometry (typed
        ``HandoffError`` on a truncated or mismatched transfer, nothing
        allocated), gate it on the pool's free pages (``BackpressureError``
        ``no_free_pages``, nothing allocated), the queue caps and the
        service's ``max_new`` buckets, and queue the import.  The future resolves to
        the /generate result; the tokens equal a local admission's."""
        if self.engine is None or self.engine._pool is None:
            raise ValueError("handoff import needs a continuous paged engine (phase='decode', "
                             "or any kv_layout='paged' service)")
        parsed = self.engine.validate_handoff(blob)
        meta = parsed[0]
        _bucket(int(meta["n_new"]), self.max_new_buckets, "max_new_tokens")
        self._admission_check(meta["ids"], int(meta["n_new"]))
        eff = self.request_timeout_s if deadline_s is None else min(
            float(deadline_s), self.request_timeout_s)
        return self.engine.import_pages(blob, stream=stream, deadline_s=eff, trace_id=trace_id,
                                        parsed=parsed)

    def _per_token_p50_ms(self) -> Optional[float]:
        try:
            samples = list(self.engine._lat_tok)
        except RuntimeError:  # the loop appended mid-copy
            samples = []
        return float(np.median(np.asarray(samples))) if samples else None

    def _retry_after_s(self, needed_pages: Optional[int] = None) -> float:
        """The drain estimate behind a 429's ``Retry-After``.  Slot pool
        (dense): (waiting + active) requests x the mean tokens each emits
        x the p50 per-token ms, spread over the slots.  Paged
        (``needed_pages``): walk the active rows soonest-retiring first,
        adding the pages each returns, and answer the remaining-token clock
        of the row whose retirement covers the need.  1 s before any
        latency sample; clamped to [1, 60]."""
        eng = self.engine
        per_tok = self._per_token_p50_ms()
        if per_tok is None:
            return 1.0
        if needed_pages is not None and eng._pool is not None:
            from mlcomp_tpu_torch.kvpool import RESERVED_PAGES

            try:
                pool = eng._pool
                freed = pool.alloc.free_pages + pool.reclaimable_pages()
                rows = sorted((sl.remaining, i) for i, sl in enumerate(list(eng._host))
                              if sl is not None)
                eta_tokens = None
                for remaining, i in rows:
                    freed += int((pool.tables[i] >= RESERVED_PAGES).sum())
                    if freed >= needed_pages:
                        eta_tokens = remaining
                        break
                if eta_tokens is None:
                    return 60.0
                return float(min(max(eta_tokens * per_tok / 1e3, 1.0), 60.0))
            except RuntimeError:
                pass  # a torn read mid-mutation: the slot-pool estimate below
        st = eng._stats
        finished = max(1, eng._lat_ttft_n)
        mean_tokens = max(1.0, st["emitted_tokens"] / finished)
        waiting = eng._queue.qsize() + len(eng._pending) + 1
        active = sum(1 for s in eng._host if s is not None)
        eta = (waiting + active) * mean_tokens * per_tok / (eng.slots * 1e3)
        return float(min(max(eta, 1.0), 60.0))

    def _reject(self, reason: str, msg: str, needed_pages: Optional[int] = None) -> None:
        self._rejects[reason] += 1
        self.engine.recorder.instant("reject", track="service", reason=reason)
        raise BackpressureError(msg, reason, self._retry_after_s(needed_pages=needed_pages))

    def _page_budget_check(self, ids, n_new: int) -> None:
        """The paged layout's free-page gate: the request's INITIAL page
        need (prefill span plus one dispatch of decode lookahead) against
        the free and reclaimable pages less what the queued backlog needs
        at its own admission.  Pages commit only at insert, so without the
        backlog term a flood would all pass the same reading and queue
        without bound.  Approximate (racing callers may both pass); the
        engine's own boundary gate defers whatever slips through."""
        eng = self.engine
        try:
            need = eng._pages_initial({"ids": ids, "n_new": n_new})
            pool = eng._pool
            avail = pool.alloc.free_pages + pool.reclaimable_pages()
            backlog = sum(eng._pages_initial(r) for r in list(eng._pending))
            with eng._queue.mutex:
                parked = [r for r in eng._queue.queue if isinstance(r, dict)]
            backlog += sum(eng._pages_initial(r) for r in parked)
            adm = eng._adm
            if adm is not None:
                backlog += eng._pages_initial(adm.req)
        except RuntimeError:
            return  # a torn read mid-mutation: admit, the engine re-gates
        if need <= avail - backlog:
            return
        self._reject("no_free_pages",
                     f"request needs {need} KV pages at admission; {max(avail - backlog, 0)} "
                     f"free after the queued backlog (pool: {pool.alloc.total_pages})",
                     needed_pages=need + backlog)

    def _admission_check(self, ids, n_new: int) -> None:
        """Admission fast-fail (continuous engine): the paged layout's
        free-page budget first (the hard physical bound), then the opt-in
        queue and concurrency caps.  Approximate by design: two racing
        submits may both pass a cap-1 check."""
        eng = self.engine
        if eng._pool is not None:
            self._page_budget_check(ids, int(n_new))
        if self.max_queue_depth <= 0 and self.max_concurrent_requests <= 0:
            return
        depth = eng._queue.qsize() + len(eng._pending)
        if 0 < self.max_queue_depth <= depth:
            self._reject("queue_full", f"submit queue is full ({depth} >= max_queue_depth="
                         f"{self.max_queue_depth})")
        active = sum(1 for s in eng._host if s is not None)
        inflight = depth + active + (1 if eng._adm is not None else 0)
        if 0 < self.max_concurrent_requests <= inflight:
            self._reject("concurrency", f"{inflight} requests in flight >= "
                         f"max_concurrent_requests={self.max_concurrent_requests}")

    def set_draining(self, draining: bool) -> bool:
        """The drain bit behind ``POST /drain``: a draining service keeps
        serving what it holds and stays ok, but reads ``ready: false``."""
        self._draining = bool(draining)
        return self._draining

    def warmup(self) -> int:
        """Launch every kernel of the served configuration before traffic:
        build the CUDA libraries (a failed build raises: the daemon fails,
        it never falls back to the plain versions), then, on the
        continuous engine, one dummy request per prompt bucket (chunks,
        insert, decode) kept out of the stats, the prefix cache and the
        registry, one decode dispatch per K rung, one fused dispatch per
        chunk width, the prefix cache's copies and the registry's gather;
        on the window batcher one generate per max_new bucket at the
        smallest and largest batch; on the speculative batcher one
        speculative decode per (prompt, max_new) bucket.  ``ready`` reads
        false meanwhile.
        Returns the number of warm runs."""
        self._warming = True
        try:
            return self._warmup_inner()
        finally:
            self._warming = False

    def _warmup_inner(self) -> int:
        if torch.device(self.model.device).type == "cuda":
            from mlcomp_tpu_torch.ops.cuda import build

            build.build_all()
        eng = self.engine
        if eng is not None:
            if self.dist is not None and not eng.is_coordinator:
                # a follower warms by replay: the coordinator's warmup requests
                # and its warm control record reach its loop in order
                return 0
            n_new = min(2, eng.max_new_cap)
            futs = [eng.submit([1] * s, n_new, _count=False) for s in self.prompt_buckets]
            for f in futs:
                f.result(timeout=self.request_timeout_s)
            if self.dist is not None:
                # a gang's warm functions run on the loop at a broadcast
                # boundary, where every rank runs them
                return len(futs) + eng.warm_on_loop().result(timeout=self.request_timeout_s)
            return (len(futs) + eng.warm_prefix_fns() + eng.warm_dispatch_fns()
                    + eng.warm_fused_fns() + eng.warm_registry_fns())
        if self.batcher == "speculative":
            from mlcomp_tpu_torch.models.speculative import speculative_generate

            n = 0
            for s in self.prompt_buckets:
                for nb in self.max_new_buckets:
                    row, mask = left_pad_row([1], s, self.pad_id)
                    speculative_generate(self.model, torch.from_numpy(row[None]), nb,
                                         prompt_mask=torch.from_numpy(mask[None]),
                                         spec_k=self.spec_k, pad_id=self.pad_id).cpu()
                    n += 1
            return n
        from mlcomp_tpu_torch.models.generation import generate

        n = 0
        s = self.prompt_buckets[-1]
        knob = {"temperature": 0.0, "top_k": self._neutral_k, "top_p": 1.0,
                "repetition_penalty": self.defaults["repetition_penalty"]}
        for nb in self.max_new_buckets:
            for b in sorted({self.batch_sizes[0], self.batch_sizes[-1]}):
                out, _ = generate(
                    self.model, torch.ones((b, s), dtype=torch.int64), nb,
                    prompt_mask=torch.ones((b, s), dtype=torch.bool), pad_id=self.pad_id,
                    generator=torch.Generator(device=self.model.device).manual_seed(0),
                    with_logprobs=True, **self._knob_rows([knob] * b, b))
                out.cpu()
                n += 1
        return n

    def stats(self) -> Dict[str, Any]:
        out = {
            **self._stats,
            "queue_depth": self._queue.qsize() + len(self._deferred),
            "quantize": self.quant_mode,
            "batcher": self.batcher,
            "device": str(self.model.device),
            "rejected": dict(self._rejects),
            "request_timeout_s": self.request_timeout_s,
            "phase": self.phase,
        }
        if self.engine is not None:
            eng = self.engine.stats()
            out["queue_depth"] = eng.pop("queue_depth")
            out["requests"] = eng["requests"]
            out["healthy"] = eng["healthy"]
            out["latency"] = eng["latency"]
            if "spec" in eng:
                # the acceptance block rides /healthz's top level
                out["spec"] = eng["spec"]
            if "kv_pool" in eng:
                out["kv_pool"] = eng["kv_pool"]
                out["live_slots"] = eng.get("live_slots")
            if "mesh" in eng:
                # the gang's layout at the top level: which daemon fronts it
                out["mesh"] = eng["mesh"]
            out["engine"] = eng
        else:
            out["healthy"] = self._thread.is_alive()
        if self.slo is not None:
            # the SLO verdict rides /healthz
            out["slo"] = self.slo.summary()
        if self.history is not None:
            out["metrics_history"] = self.history.stats()
        out["draining"] = self._draining
        # a gang's follower owns no submit queue: never ready, so that no
        # router sends it traffic
        out["ready"] = bool(out["healthy"] and not self._draining and not self._warming
                            and not self._stop.is_set()
                            and (self.dist is None or self.dist.is_coordinator))
        return out

    def cache_stats(self) -> Optional[Dict[str, Any]]:
        """The prefix cache's counters (behind GET /cache/stats), or None
        without a prefix cache."""
        if self.prefix_cache is None:
            return None
        return self.prefix_cache.stats()

    def _collect_metrics(self) -> None:
        """Scrape-time collector of the service's own counters (the engine
        registers its own)."""
        m = self.metrics
        st = self._stats
        m.gauge("mlcomp_service_info", "Service configuration (value is always 1)",
                labelnames=("batcher", "quantize")).set(
            1, batcher=self.batcher, quantize=str(self.quant_mode))
        rej = m.counter("mlcomp_serving_requests_rejected_total",
                        "Requests fast-failed by admission control", labelnames=("reason",))
        for reason, n in self._rejects.items():
            rej.set_total(n, reason=reason)
        m.counter("mlcomp_service_batches_total",
                  "Batches run (window/speculative batchers)").set_total(st["batches"])
        m.counter("mlcomp_service_batched_rows_total",
                  "Request rows across those batches").set_total(st["batched_rows"])
        if self.engine is None:
            # continuous mode: the engine collector owns requests and depth
            m.counter("mlcomp_service_requests_total",
                      "Requests submitted (window/speculative batchers)").set_total(
                st["requests"])
            m.gauge("mlcomp_service_queue_depth", "Requests waiting for a batch").set(
                self._queue.qsize() + len(self._deferred))

    def trace(self, last_ms: Optional[float] = None, trace_id: Optional[str] = None,
              rid: Optional[int] = None) -> Dict[str, Any]:
        """The engine flight recorder's Chrome-trace export (behind GET
        /trace); ``trace_id`` / ``rid`` keep one request's events.  Raises
        on the window batcher (HTTP 404)."""
        if self.engine is None:
            raise ValueError("the flight recorder needs the continuous batcher; this service "
                             f"runs the {self.batcher} batcher")
        body = self.engine.recorder.export(last_ms=last_ms)
        if trace_id is not None or rid is not None:
            body = filter_export(body, trace_id=trace_id, rid=rid)
        return body

    def slo_status(self) -> Dict[str, Any]:
        """The SLO engine's status (behind GET /slo); raises when the
        history sampler is off (HTTP 404)."""
        if self.slo is None:
            raise ValueError("SLOs need the metrics-history sampler; this service was built "
                             "with metrics_history_interval=0")
        return self.slo.status()

    def metrics_history(self, window_s: Optional[float] = None) -> Dict[str, Any]:
        """The metrics-history ring as JSON (behind GET /metrics/history);
        raises when disabled (HTTP 404)."""
        if self.history is None:
            raise ValueError("metrics history is disabled; this service was built with "
                             "metrics_history_interval=0")
        return self.history.query(window_s=window_s)

    def profile(self, dispatches: int = 8) -> Future:
        """Arm an on-demand device capture (behind GET /profile): resolves
        to the attribution JSON once the engine's next ``dispatches``
        dispatch boundaries were captured and read.  Raises for batchers
        without a drive loop (HTTP 404, as /trace) and ``ProfileBusy``
        while another capture is in flight (HTTP 409)."""
        if self.engine is None:
            raise ValueError("device profiling needs the continuous batcher; this service "
                             f"runs the {self.batcher} batcher")
        return self.engine.profile(dispatches=dispatches)

    def profile_cancel(self, fut: Future) -> bool:
        """Disarm a capture that has not started (the HTTP timeout path)."""
        if self.engine is None:
            return False
        return self.engine.profile_cancel(fut)

    def close(self) -> None:
        self._stop.set()
        if self.history is not None:
            # stop the sampler (and its SLO callbacks) before the engine
            self.history.close()
        if getattr(self, "_owns_process_mesh", False):
            # load_service installed the mesh process-wide: take it out
            from mlcomp_tpu_torch.parallel.mesh import set_current_mesh

            set_current_mesh(None)
            self._owns_process_mesh = False
        if self.engine is not None:
            self.engine.close()
            return
        self._thread.join(timeout=5.0)
        err = RuntimeError("generation service closed")
        if not self._thread.is_alive():
            for item in self._deferred:
                _fail_future(item["future"], err)
            self._deferred = []
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            _fail_future(item["future"], err)

    # ------------------------------------------------------------ batcher

    def _knob_rows(self, batch, b_bucket: int) -> Dict[str, Any]:
        """Per-row sampling arrays; filler rows decode greedily."""
        t = np.zeros(b_bucket, np.float32)
        k = np.full(b_bucket, self._neutral_k, np.int64)
        p = np.ones(b_bucket, np.float32)
        e = np.full(b_bucket, -1, np.int64)
        rp = np.ones(b_bucket, np.float32)
        for r, item in enumerate(batch):
            t[r], k[r], p[r] = item["temperature"], item["top_k"], item["top_p"]
            e[r] = item.get("eos_id", -1)
            rp[r] = item.get("repetition_penalty", 1.0)
        rows = {"temperature": t, "top_k": k, "top_p": p, "eos_id": e}
        if not np.all(rp == 1.0):
            # the penalty costs a (B, V) presence mask and a per-token
            # update: only when some row asks
            rows["repetition_penalty"] = rp
        return rows

    def _collect(self) -> List[Dict[str, Any]]:
        """Block for one request, then sweep same-bucket requests arriving
        within the window, up to the largest batch size.  Requests of
        another ``max_new`` bucket are deferred and head the next batch."""
        if self._deferred:
            first = self._deferred.pop(0)
        else:
            try:
                first = self._queue.get(timeout=0.2)
            except queue.Empty:
                return []
        batch = [first]
        limit = self.batch_sizes[-1]
        rest: List[Dict[str, Any]] = []
        for item in self._deferred:
            if len(batch) < limit and item["bucket_new"] == first["bucket_new"]:
                batch.append(item)
            else:
                rest.append(item)
        self._deferred = rest
        deadline = time.time() + self.batch_window_s
        while len(batch) < limit:
            remaining = deadline - time.time()
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item["bucket_new"] != first["bucket_new"]:
                self._deferred.append(item)
                continue
            batch.append(item)
        return batch

    def _loop(self) -> None:
        try:
            while not self._stop.is_set():
                batch = self._collect()
                if not batch:
                    continue
                try:
                    if self.batcher == "speculative":
                        self._run_spec(batch[0])   # batch_sizes == (1,)
                    else:
                        self._run_batch(batch)
                except Exception as e:  # surface to the waiting requests
                    for item in batch:
                        _fail_future(item["future"], e)
        finally:
            err = RuntimeError("generation service closed")
            for item in self._deferred:
                _fail_future(item["future"], err)
            self._deferred = []
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                _fail_future(item["future"], err)

    def _run_spec(self, item: Dict[str, Any]) -> None:
        """One request through ``speculative_generate`` (the speculative
        batcher): its prompt left-padded into its bucket, its ``max_new``
        bucket as the budget, the ids trimmed as the window batcher's."""
        from mlcomp_tpu_torch.models.speculative import speculative_generate

        t0 = time.perf_counter()
        s_bucket = _bucket(len(item["ids"]), self.prompt_buckets, "prompt")
        row, mask = left_pad_row(item["ids"], s_bucket, self.pad_id)
        eos = item.get("eos_id", -1)
        out, st = speculative_generate(
            self.model, torch.from_numpy(row[None]), item["bucket_new"],
            prompt_mask=torch.from_numpy(mask[None]), spec_k=self.spec_k,
            eos_id=None if eos < 0 else eos, pad_id=self.pad_id, with_stats=True)
        gen = _trim_generated(out[0].cpu().numpy(), s_bucket, item)
        self._stats["batches"] += 1
        self._stats["batched_rows"] += 1
        self._stats["spec_tokens"] += int(st["emitted"])
        self._stats["spec_forwards"] += int(st["steps"])
        item["future"].set_result({
            "ids": gen,
            "latency_ms": round((time.perf_counter() - t0) * 1e3, 2),
            "batched_with": 1,
            "trace_id": item.get("trace_id"),
        })

    def _run_batch(self, batch: List[Dict[str, Any]]) -> None:
        from mlcomp_tpu_torch.models.generation import generate

        t0 = time.perf_counter()
        nb = batch[0]["bucket_new"]
        s_bucket = _bucket(max(len(i["ids"]) for i in batch), self.prompt_buckets, "prompt")
        b_bucket = _bucket(len(batch), self.batch_sizes, "batch")
        prompts = np.full((b_bucket, s_bucket), self.pad_id, np.int64)
        mask = np.zeros((b_bucket, s_bucket), bool)
        for r, item in enumerate(batch):
            prompts[r], mask[r] = left_pad_row(item["ids"], s_bucket, self.pad_id)
        for r in range(len(batch), b_bucket):
            # filler rows replicate row 0 (never returned)
            prompts[r], mask[r] = prompts[0], mask[0]
        out, lps = generate(
            self.model, torch.from_numpy(prompts), nb,
            prompt_mask=torch.from_numpy(mask), pad_id=self.pad_id,
            generator=self._gen, with_logprobs=True, **self._knob_rows(batch, b_bucket),
        )
        out, lps = out.cpu().numpy(), lps.cpu().numpy()
        latency_ms = (time.perf_counter() - t0) * 1e3
        self._stats["batches"] += 1
        self._stats["batched_rows"] += len(batch)
        for r, item in enumerate(batch):
            gen = _trim_generated(out[r], s_bucket, item)
            result = {"ids": gen, "latency_ms": round(latency_ms, 2),
                      "batched_with": len(batch), "trace_id": item.get("trace_id")}
            if item.get("logprobs"):
                result["logprobs"] = [round(float(v), 5) for v in lps[r, : len(gen)]]
            item["future"].set_result(result)


# --------------------------------------------------------------- loading


def load_service(model_cfg: Dict[str, Any], ckpt_path: Optional[str] = None,
                 params=None, device=None, mesh_cfg: Optional[Dict[str, int]] = None,
                 **service_kw) -> GenerationService:
    """Build the model on ``device`` (default ``cuda``; raises when there is
    no card and ``device="cpu"`` was not asked for), take its weights from
    ``params`` (a flax-layout tree), ``ckpt_path`` (a training checkpoint
    directory, read through ``io.checkpoint.read_weights`` with its EMA
    weights preferred, or an ``.npz``), or ``io.weights.init_params(model_cfg,
    0)``, and wrap it in a :class:`GenerationService`.  ``decode_fused:
    true`` fuses the training-layout projections once here.

    ``mesh_cfg`` (``{"tp": 2}``, ``{"dp": 2}``; axes not named fold into
    dp) serves sharded over a mesh of the process group's ranks (joined
    here from ``MLCOMP_TPU_COORDINATOR`` / ``_NUM_PROCESSES`` /
    ``_PROCESS_ID`` when it is not up yet; a process alone becomes a world
    of one), installed process-wide until the service closes.  Every rank
    quantizes whole leaves on its card, then keeps its shards.  A mesh
    wider than one rank needs ``dist=`` (a ``BoundaryChannel``) in
    ``service_kw``."""
    import os

    from mlcomp_tpu_torch.io.checkpoint import read_weights
    from mlcomp_tpu_torch.io.weights import init_params, load_npz
    from mlcomp_tpu_torch.models import create_model
    from mlcomp_tpu_torch.models.transformer import fuse_decode_params
    from mlcomp_tpu_torch.ops.quant import as_tensor, is_quantized_leaf, tree_map_with_path
    from mlcomp_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    model_cfg = dict(model_cfg)
    decode_fused = bool(model_cfg.pop("decode_fused", False))
    if decode_fused and mesh_cfg:
        raise ValueError("decode_fused serving is single-chip (the Megatron tp rules shard the "
                         "unfused projections); drop one of them")
    mesh = None
    if mesh_cfg:
        from mlcomp_tpu_torch.parallel.mesh import MeshSpec, make_mesh, set_current_mesh

        spec = MeshSpec.from_config(mesh_cfg)
        join_process_group(dev)
        mesh = make_mesh(spec, device_type=dev.type)
        # installed process-wide, as the Trainer does; close() takes it out
        set_current_mesh(mesh)
    if params is None:
        if ckpt_path and os.path.isdir(ckpt_path):
            params = read_weights(ckpt_path)["params"]
        else:
            params = load_npz(ckpt_path) if ckpt_path else init_params(model_cfg, 0)
        # weights from a file reach the device before the int8 quantization:
        # CUDA computes the scale's division by 127 as a multiply by its
        # reciprocal, one ulp off the CPU's, so codes quantized on the host
        # differ from those of the same tree handed over on the card
        params = tree_map_with_path(
            lambda _, leaf: ({k: as_tensor(v).to(dev) for k, v in leaf.items()}
                             if is_quantized_leaf(leaf) else as_tensor(leaf).to(dev)), params)
    if decode_fused:
        params = fuse_decode_params(params)
    model = create_model({**model_cfg, "decode_fused": decode_fused}, device=dev)
    try:
        service = GenerationService(model, params, mesh=mesh, **service_kw)
    except BaseException:
        if mesh is not None:
            from mlcomp_tpu_torch.parallel.mesh import set_current_mesh

            set_current_mesh(None)
        raise
    service._owns_process_mesh = mesh is not None
    return service


def join_process_group(device) -> None:
    """Make sure this process is in a ``torch.distributed`` group: the
    gang's (``parallel.distributed.init_distributed`` from the
    ``MLCOMP_TPU_*`` environment), else a world of one on a free local
    port (a mesh of one rank)."""
    import socket

    import torch.distributed as tdist

    from mlcomp_tpu_torch.parallel.distributed import init_distributed

    if tdist.is_initialized() or init_distributed(device=device):
        return
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_distributed(f"127.0.0.1:{port}", 1, 0, device=device)


def resolve_storage_ckpt(project: str, dag_name: str, task: str) -> str:
    """The checkpoint directory the train executor writes for
    ``project/dag_name/task`` under model storage (``io.storage``); an
    explicit ``--ckpt`` wins over it.  Raises when it holds no
    checkpoint."""
    from mlcomp_tpu_torch.io.checkpoint import latest_step
    from mlcomp_tpu_torch.io.storage import ModelStorage

    d = ModelStorage().root / project / dag_name / task / "checkpoints"
    if latest_step(d) is None:
        raise FileNotFoundError(f"no checkpoints under {d} (train first, or pass --ckpt)")
    return str(d)


# ------------------------------------------------------------------ HTTP


def make_http_server(service: GenerationService, host: str = "127.0.0.1",
                     port: int = 8900, model_name: str = "model"):
    """Build (without starting) the HTTP server; port 0 picks a free one."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from mlcomp_tpu_torch.engine import NotCoordinator

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet access log
            pass

        def _json(self, obj, code=200, close=False):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if close:
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            from urllib.parse import parse_qs

            route, _, query = self.path.partition("?")
            if route == "/healthz":
                st = service.stats()
                ok = bool(st["healthy"])
                # 503 while the engine is down; the body says why
                return self._json({"ok": ok, "model": model_name, **st}, 200 if ok else 503)
            if route == "/stats":
                return self._json(service.stats())
            if route == "/metrics":
                from mlcomp_tpu_torch.obs.metrics import CONTENT_TYPE

                body = service.metrics.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return None
            if route == "/trace":
                if service.engine is None:
                    return self._json({"error": "the flight recorder needs the continuous "
                                       f"batcher; this service runs the {service.batcher} "
                                       "batcher"}, 404)
                try:
                    qs = parse_qs(query)
                    last_ms = None
                    if qs.get("last_ms"):
                        last_ms = float(qs["last_ms"][0])
                        if last_ms <= 0:
                            raise ValueError(f"last_ms must be positive, got {last_ms}")
                    trace_id = None
                    if qs.get("trace_id"):
                        trace_id = qs["trace_id"][0].strip().lower()
                        if not valid_trace_id(trace_id):
                            raise ValueError(f"trace_id must be 32 hex chars, got "
                                             f"{qs['trace_id'][0]!r}")
                    rid = None
                    if qs.get("rid"):
                        rid = int(qs["rid"][0])
                        if rid <= 0:
                            raise ValueError(f"rid must be positive, got {rid}")
                    return self._json(service.trace(last_ms=last_ms, trace_id=trace_id,
                                                    rid=rid))
                except ValueError as e:
                    return self._json({"error": f"{type(e).__name__}: {e}"}, 400)
            if route == "/slo":
                try:
                    return self._json(service.slo_status())
                except ValueError as e:  # the sampler is off: an absent surface
                    return self._json({"error": f"{type(e).__name__}: {e}"}, 404)
            if route == "/metrics/history":
                try:
                    qs = parse_qs(query)
                    window_s = None
                    if qs.get("window_s"):
                        window_s = float(qs["window_s"][0])
                        if window_s <= 0:
                            raise ValueError(f"window_s must be positive, got {window_s}")
                except ValueError as e:
                    return self._json({"error": f"{type(e).__name__}: {e}"}, 400)
                try:
                    return self._json(service.metrics_history(window_s=window_s))
                except ValueError as e:
                    return self._json({"error": f"{type(e).__name__}: {e}"}, 404)
            if route == "/profile":
                from mlcomp_tpu_torch.engine import ProfileBusy

                if service.engine is None:
                    return self._json({"error": "device profiling needs the continuous "
                                       f"batcher; this service runs the {service.batcher} "
                                       "batcher"}, 404)
                try:
                    qs = parse_qs(query)
                    n = int(qs["dispatches"][0]) if qs.get("dispatches") else 8
                    # tighter than the engine's [1, 1024]: the trace is read
                    # on the drive loop at the window's close
                    if not 1 <= n <= 256:
                        raise ValueError(f"dispatches must be in [1, 256], got {n}")
                except (ValueError, TypeError) as e:
                    return self._json({"error": f"{type(e).__name__}: {e}"}, 400)
                try:
                    fut = service.profile(dispatches=n)
                except ProfileBusy as e:
                    return self._json({"error": str(e), "status": e.status}, 409)
                except Exception as e:
                    return self._json({"error": f"{type(e).__name__}: {e}"}, 500)
                try:
                    # the capture is dispatch-gated: it needs decode traffic
                    return self._json(fut.result(timeout=service.request_timeout_s + 30.0))
                except FutTimeout:
                    service.profile_cancel(fut)
                    return self._json({"error": "capture did not complete (no decode traffic "
                                       "inside the window?)", "status": "profile_timeout"},
                                      504)
                except Exception as e:
                    return self._json({"error": f"{type(e).__name__}: {e}"}, 500)
            if route == "/cache/stats":
                stats = service.cache_stats()
                if stats is None:
                    return self._json({"error": "prefix cache disabled (start with "
                                       "--prefix-cache)"}, 404)
                return self._json(stats)
            return self._json({"error": "not found"}, 404)

        def _stream(self, fut, toks: "queue.Queue"):
            """Server-sent events: one ``data:`` line per token as it lands,
            a final ``done`` event with the whole result, then close.  Never
            raises once the headers are out: a failure ends the stream with
            an ``error`` event.  A broken pipe means the client left: the
            request is cancelled so its row frees its slot."""
            timeout = service.request_timeout_s + 30.0
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            try:
                while True:
                    item = toks.get(timeout=timeout)
                    if item is None:
                        break
                    self.wfile.write(f"data: {json.dumps(item)}\n\n".encode())
                    self.wfile.flush()
                final = fut.result(timeout=timeout)
                self.wfile.write(f"data: {json.dumps({'done': True, **final})}\n\n".encode())
                self.wfile.flush()
            except ConnectionError:
                service.cancel(getattr(fut, "rid", 0))
            except Exception as e:
                status = getattr(e, "status", None)
                err = json.dumps({"error": f"{type(e).__name__}: {e}",
                                  "trace_id": getattr(fut, "trace_id", None),
                                  **({"status": status} if status else {})})
                try:
                    self.wfile.write(f"data: {err}\n\n".encode())
                    self.wfile.flush()
                except OSError:
                    pass

        def _reject_429(self, e: BackpressureError, tid: str):
            """The one admission-control 429 every POST route answers."""
            body = json.dumps({"error": str(e), "status": "rejected", "reason": e.reason,
                               "retry_after_s": round(e.retry_after_s, 1),
                               "trace_id": tid}).encode()
            self.send_response(429)
            self.send_header("Content-Type", "application/json")
            self.send_header("Retry-After", str(max(1, int(round(e.retry_after_s)))))
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, e: Exception, tid: str):
            """The error answer /generate, /prefill and /import share."""
            if isinstance(e, BackpressureError):
                return self._reject_429(e, tid)
            if isinstance(e, NotCoordinator):
                # a gang's follower: traffic belongs at the coordinator
                return self._json({"error": str(e), "status": e.status, "trace_id": tid}, 503)
            if isinstance(e, FutTimeout):
                return self._json({"error": f"{type(e).__name__}: {e}",
                                   "status": "deadline_exceeded", "trace_id": tid}, 504)
            status = getattr(e, "status", None)
            if isinstance(e, (KeyError, ValueError, TypeError)):
                # a bad handoff is a ValueError too, typed by its status
                return self._json({"error": f"{type(e).__name__}: {e}", "trace_id": tid,
                                   **({"status": status} if status else {})}, 400)
            code = 504 if status == "deadline_exceeded" else 500
            return self._json({"error": f"{type(e).__name__}: {e}", "trace_id": tid,
                               **({"status": status} if status else {})}, code)

        def _prefill(self, tid):
            """POST /prefill (phase=prefill replicas): run the admission core
            on a /generate-shaped request and answer with the serialized
            KV-page handoff, the blob a decode replica's POST /import takes."""
            if service.engine is None or not service.engine.prefill_only:
                return self._json({"error": "this replica does not serve phase=prefill; POST "
                                   "/generate instead", "status": "wrong_phase",
                                   "trace_id": tid}, 409, close=True)
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                fut = service.submit(
                    req["prompt"], int(req.get("max_new_tokens", 32)),
                    temperature=req.get("temperature"), top_k=req.get("top_k"),
                    top_p=req.get("top_p"), eos_id=req.get("eos_id"),
                    logprobs=req.get("logprobs", False),
                    repetition_penalty=req.get("repetition_penalty"), trace_id=tid,
                    deadline_s=req.get("deadline_s"),
                )
                res = fut.result(timeout=service.request_timeout_s + 30.0)
            except Exception as e:
                return self._error(e, tid)
            blob = res.pop("handoff")
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(blob)))
            # the summary rides a header so that the body stays the raw blob
            self.send_header("x-mlcomp-handoff", json.dumps(res))
            self.end_headers()
            self.wfile.write(blob)
            return None

        def _import(self, tid):
            """POST /import (paged replicas, usually phase=decode): admit a
            KV-page handoff blob; ``?stream=1`` streams tokens over SSE as
            /generate does."""
            try:
                n = int(self.headers.get("Content-Length", 0))
                blob = self.rfile.read(n)
                qs = self.path.partition("?")[2]
                toks = queue.Queue() if ("stream=1" in qs or "stream=true" in qs) else None
                fut = service.import_pages(blob, stream=toks, trace_id=tid)
                if toks is not None:
                    return self._stream(fut, toks)
                return self._json(fut.result(timeout=service.request_timeout_s + 30.0))
            except Exception as e:
                return self._error(e, tid)

        def do_POST(self):  # noqa: N802
            route = self.path.split("?", 1)[0]
            if route == "/drain":
                # flip ready without touching ok; {"draining": false} undoes it
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    draining = json.loads(self.rfile.read(n) or b"{}").get("draining", True)
                    if not isinstance(draining, bool):
                        raise ValueError(f"draining must be a JSON boolean, got {draining!r}")
                except (ValueError, TypeError, AttributeError) as e:
                    return self._json({"error": f"{type(e).__name__}: {e}"}, 400)
                return self._json({"ok": True, "draining": service.set_draining(draining)})
            if route not in ("/generate", "/prefill", "/import"):
                return self._json({"error": "not found"}, 404, close=True)
            # trace context: the client's W3C traceparent trace id when one
            # arrives well-formed, else a fresh one; every answer echoes it
            tid = parse_traceparent(self.headers.get("traceparent")) or make_trace_id()
            if route == "/prefill":
                return self._prefill(tid)
            if route == "/import":
                return self._import(tid)
            if service.phase == "prefill":
                # a prefill replica owns no decode loop
                return self._json({"error": "this replica serves phase=prefill (POST /prefill "
                                   "for a KV-page handoff); send generation to a decode or "
                                   "monolithic replica", "status": "wrong_phase",
                                   "trace_id": tid}, 409, close=True)
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                toks: Optional["queue.Queue"] = queue.Queue() if req.get("stream") else None
                fut = service.submit(
                    req["prompt"], int(req.get("max_new_tokens", 32)),
                    temperature=req.get("temperature"), top_k=req.get("top_k"),
                    top_p=req.get("top_p"), eos_id=req.get("eos_id"),
                    logprobs=req.get("logprobs", False),
                    repetition_penalty=req.get("repetition_penalty"), trace_id=tid,
                    stream=toks, deadline_s=req.get("deadline_s"),
                )
                if toks is not None:
                    return self._stream(fut, toks)
                return self._json(fut.result(timeout=service.request_timeout_s + 30.0))
            except Exception as e:
                return self._error(e, tid)

    return ThreadingHTTPServer((host, port), Handler)


def start_warmup(service: GenerationService, on_error) -> threading.Thread:
    """Run :meth:`GenerationService.warmup` on a thread of its own, the
    service reading ``ready: false`` from this call on until it ends;
    ``on_error(exc)`` is called if it fails (a CUDA build, a launch)."""
    def warm():
        try:
            n = service.warmup()
            print(json.dumps({"event": "warmup", "programs": n}), flush=True)
        except BaseException as e:
            on_error(e)

    service._warming = True   # not ready from the first answer on
    t = threading.Thread(target=warm, daemon=True, name="warmup")
    t.start()
    return t


def serve_http(service: GenerationService, host: str = "127.0.0.1", port: int = 8900,
               model_name: str = "model", warmup: bool = False):
    """Blocking HTTP front end.  ``warmup`` runs :meth:`GenerationService.
    warmup` while the server already answers (``ready: false`` until it
    ends); a failed warmup stops the server and raises: the daemon fails,
    it never serves on the plain versions."""
    httpd = make_http_server(service, host, port, model_name)
    failed: List[BaseException] = []
    if service.dist is not None and not service.dist.is_coordinator:
        # a follower serves until the coordinator's stop record ends its loop
        def follow():
            service.engine._thread.join()
            httpd.shutdown()

        threading.Thread(target=follow, daemon=True, name="follower-watch").start()

    def fail(e):
        failed.append(e)
        httpd.shutdown()

    if warmup:
        start_warmup(service, fail)
    print(json.dumps({"event": "serving", "host": host, "port": httpd.server_address[1],
                      "model": model_name, **service.stats()}), flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        service.close()
    if failed:
        raise RuntimeError(f"warmup failed: {failed[0]!r}") from failed[0]
