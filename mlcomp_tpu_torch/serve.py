"""LM serving over HTTP: the counterpart of mlcomp_tpu/serve.py.

Two batchers, picked by ``GenerationService(batcher=)``:

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
"""

from __future__ import annotations

import json
import math
import os
import queue
import re
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutTimeout
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

_TRACE_ID_RE = re.compile(r"[0-9a-f]{32}")


def make_trace_id() -> str:
    """A fresh W3C-shape trace id (32 hex chars, never all zero)."""
    while True:
        tid = os.urandom(16).hex()
        if tid != "0" * 32:
            return tid


def valid_trace_id(tid: Any) -> bool:
    return isinstance(tid, str) and bool(_TRACE_ID_RE.fullmatch(tid)) and tid != "0" * 32


class BackpressureError(RuntimeError):
    """Admission control rejected the request (here: a handoff import
    whose pages the pool cannot hold): a fast failure with a retry hint
    instead of unbounded queueing.  HTTP maps this to 429 +
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
    ``phase`` is the disaggregated serving role (module docstring)."""

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
        phase: str = "both",
    ):
        from mlcomp_tpu_torch.models.generation import prep_decode_variables
        from mlcomp_tpu_torch.ops.quant import quantize_params

        if batcher == "auto":
            batcher = "continuous"
        if batcher not in ("continuous", "window"):
            raise ValueError(f"batcher: expected 'auto'/'continuous'/'window', got {batcher!r}")
        if batcher == "window" and (
                engine_fused_admission is not None
                or (engine_pipeline_depth is not None and int(engine_pipeline_depth) > 1)):
            raise ValueError("engine_pipeline_depth > 1 and engine_fused_admission need "
                             "the continuous batcher")
        if batcher == "window" and (kv_layout != "dense" or kv_page_tokens is not None
                                    or kv_pages is not None or max_slots is not None):
            raise ValueError("kv_layout / kv_page_tokens / kv_pages / max_slots need the "
                             "continuous batcher (only the slot engine owns a device KV pool)")
        self.phase = str(phase)
        if self.phase not in ("both", "prefill", "decode"):
            raise ValueError(f"phase must be 'both', 'prefill', or 'decode'; got {phase!r}")
        if self.phase != "both" and batcher != "continuous":
            raise ValueError("phase-split serving needs the continuous batcher (only the slot "
                             "engine owns an admission core)")
        if self.phase == "decode" and kv_layout != "paged":
            raise ValueError("phase='decode' needs kv_layout='paged': handoff imports land "
                             "as pages in the engine's PagePool")
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
        self.quant_mode = None
        if quantize:
            self.quant_mode = "int8" if quantize is True else str(quantize).strip().lower()
            if self.quant_mode not in ("int8", "kernel"):
                raise ValueError(f"quantize: expected False/'int8'/'kernel', got {quantize!r}")
            params = quantize_params(params)
        prep_decode_variables(model, params, quant_kernel=self.quant_mode == "kernel")
        self.request_timeout_s = float(request_timeout_s)
        if self.request_timeout_s <= 0:
            raise ValueError(f"request_timeout_s must be positive, got {request_timeout_s}")
        self._queue: "queue.Queue" = queue.Queue()
        self._deferred: List[Dict[str, Any]] = []
        self._stats = {"requests": 0, "batches": 0, "batched_rows": 0}
        self._stop = threading.Event()
        # readiness vs liveness: a draining daemon is ok (keep it) but not
        # ready (send it no new traffic)
        self._draining = False
        self.engine = None
        self._thread = None
        if batcher == "continuous":
            from mlcomp_tpu_torch.engine import DecodeEngine

            self.engine = DecodeEngine(
                model, slots=self.batch_sizes[-1], prompt_buckets=self.prompt_buckets,
                max_new_cap=self.max_new_buckets[-1], pad_id=self.pad_id, seed=seed,
                steps_per_dispatch=("adaptive" if steps_per_dispatch is None
                                    else steps_per_dispatch),
                prefill_chunk=prefill_chunk, pipeline_depth=engine_pipeline_depth,
                fused_admission=engine_fused_admission,
                dispatch_stall_timeout=dispatch_stall_timeout,
                kv_layout=kv_layout, kv_page_tokens=kv_page_tokens, kv_pages=kv_pages,
                max_slots=max_slots, prefill_only=self.phase == "prefill",
            )
        else:
            self._gen = torch.Generator(device=model.device).manual_seed(seed)
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

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
        ``rid``, the handle :meth:`cancel` takes."""
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
        if self.engine is not None:
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
        ``no_free_pages``, nothing allocated) and on the service's
        ``max_new`` buckets, and queue the import.  The future resolves to
        the /generate result; the tokens equal a local admission's."""
        if self.engine is None or self.engine._pool is None:
            raise ValueError("handoff import needs a continuous paged engine (phase='decode', "
                             "or any kv_layout='paged' service)")
        parsed = self.engine.validate_handoff(blob)
        meta = parsed[0]
        _bucket(int(meta["n_new"]), self.max_new_buckets, "max_new_tokens")
        self._page_budget_check(meta["ids"], int(meta["n_new"]))
        eff = self.request_timeout_s if deadline_s is None else min(
            float(deadline_s), self.request_timeout_s)
        return self.engine.import_pages(blob, stream=stream, deadline_s=eff, trace_id=trace_id,
                                        parsed=parsed)

    def _page_budget_check(self, ids, n_new: int) -> None:
        """The paged layout's free-page gate: the request's INITIAL page
        need (prefill span plus one dispatch of decode lookahead) against
        the free and reclaimable pages less what the queued backlog needs
        at its own admission.  Approximate (racing callers may both pass);
        the engine's own boundary gate defers whatever slips through."""
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
        raise BackpressureError(
            f"request needs {need} KV pages at admission; {max(avail - backlog, 0)} free after "
            f"the queued backlog (pool: {pool.alloc.total_pages})", "no_free_pages", 1.0)

    def set_draining(self, draining: bool) -> bool:
        """The drain bit behind ``POST /drain``: a draining service keeps
        serving what it holds and stays ok, but reads ``ready: false``."""
        self._draining = bool(draining)
        return self._draining

    def stats(self) -> Dict[str, Any]:
        out = {
            **self._stats,
            "queue_depth": self._queue.qsize() + len(self._deferred),
            "quantize": self.quant_mode,
            "batcher": self.batcher,
            "device": str(self.model.device),
            "request_timeout_s": self.request_timeout_s,
            "phase": self.phase,
        }
        if self.engine is not None:
            eng = self.engine.stats()
            out["queue_depth"] = eng.pop("queue_depth")
            out["requests"] = eng["requests"]
            out["healthy"] = eng["healthy"]
            out["latency"] = eng["latency"]
            out["engine"] = eng
        else:
            out["healthy"] = self._thread.is_alive()
        out["draining"] = self._draining
        out["ready"] = bool(out["healthy"] and not self._draining and not self._stop.is_set())
        return out

    def close(self) -> None:
        self._stop.set()
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
                 params=None, device=None, **service_kw) -> GenerationService:
    """Build the model on ``device`` (default ``cuda``; raises when there is
    no card and ``device="cpu"`` was not asked for), take its weights from
    ``params`` (a flax-layout tree), the ``.npz`` at ``ckpt_path``, or
    ``io.weights.init_params(model_cfg, 0)``, and wrap it in a
    :class:`GenerationService`.  ``decode_fused: true`` fuses the
    training-layout projections once here."""
    from mlcomp_tpu_torch.io.weights import init_params, load_npz
    from mlcomp_tpu_torch.models import create_model
    from mlcomp_tpu_torch.models.transformer import fuse_decode_params
    from mlcomp_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    model_cfg = dict(model_cfg)
    decode_fused = bool(model_cfg.pop("decode_fused", False))
    if params is None:
        params = load_npz(ckpt_path) if ckpt_path else init_params(model_cfg, 0)
    if decode_fused:
        params = fuse_decode_params(params)
    model = create_model({**model_cfg, "decode_fused": decode_fused}, device=dev)
    return GenerationService(model, params, **service_kw)


# ------------------------------------------------------------------ HTTP


def make_http_server(service: GenerationService, host: str = "127.0.0.1",
                     port: int = 8900, model_name: str = "model"):
    """Build (without starting) the HTTP server; port 0 picks a free one."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

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
            route = self.path.partition("?")[0]
            if route == "/healthz":
                st = service.stats()
                ok = bool(st["healthy"])
                # 503 while the engine is down; the body says why
                return self._json({"ok": ok, "model": model_name, **st}, 200 if ok else 503)
            if route == "/stats":
                return self._json(service.stats())
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
            body = json.dumps({"error": str(e), "status": e.reason, "trace_id": tid}).encode()
            self.send_response(429)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Retry-After", str(max(1, int(math.ceil(e.retry_after_s)))))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, e: Exception, tid: str):
            """The error answer /generate, /prefill and /import share."""
            if isinstance(e, BackpressureError):
                return self._reject_429(e, tid)
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
            tid = make_trace_id()
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


def serve_http(service: GenerationService, host: str = "127.0.0.1", port: int = 8900,
               model_name: str = "model"):
    """Blocking HTTP front end."""
    httpd = make_http_server(service, host, port, model_name)
    print(json.dumps({"event": "serving", "host": host, "port": httpd.server_address[1],
                      "model": model_name, **service.stats()}), flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        service.close()
