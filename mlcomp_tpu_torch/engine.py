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
  layer's gathered view (B8).  Tokens equal the dense layout's.  Every
  inserted prompt's prefix pages are pinned in the pool's device
  prefix-page registry under their placement key; a later admission of a
  prompt that shares a page-aligned prefix at the same placement gathers
  those rows into its admission cache (B8), starts at its first uncached
  chunk, and maps the pages into its table copy-on-write.
- Disaggregated serving (``kvpool/transfer.py``): a ``prefill_only``
  engine runs only the admission core and resolves each request with the
  finished prompt's KV as page payloads (a handoff blob); a paged engine
  imports such a blob with :meth:`DecodeEngine.import_pages`, writing the
  pages straight into its pool and decoding from the prompt's end, with
  the tokens a local admission gives.

- The host prefix cache (``cache/``, ``prefix_cache=``): an admission
  that the device registry did not serve looks its prompt up in a
  host-RAM radix trie; a hit writes the cached rows into the admission
  cache through the registry hit's writer and starts at the first
  uncached chunk (B4 then attends over rows that came from host RAM).
  Every finished prefill's new rows are copied out of the admission cache
  before it is reused and inserted off the loop by the cache's worker.  A
  fault in the lookup, assemble or upload degrades that admission to a
  cold prefill (``cache_degraded``); a kernel launch is never contained.
- A flight recorder (``utils/trace.Tracer`` in ring mode): admission,
  dispatch issue/resolve, prefill chunks, prefix and registry lookups,
  inserts, exports and request lifecycles, each with its ``rid`` and
  ``trace_id`` (``GET /trace``); scrape-time metrics into ``metrics``
  (``obs/metrics.Registry``, ``GET /metrics``); the fault points of
  ``utils/faults.py`` (``engine.dispatch``, ``engine.resolve``,
  ``engine.fused_prefill``, ``engine.export``, ``cache.lookup``,
  ``cache.capture``); and warm functions that launch every kernel of the
  served configuration before a daemon reports ready.

- Speculative dispatch (``spec_k``, greedy only): each dispatch takes
  every live row's next token, drafts ``spec_k`` more by bigram
  prompt-lookup over the row's device-carried token history
  (``models/speculative.ngram_propose``), scores all K+1 in ONE
  per-row-cursor forward (the chunk kernel B4 on the dense int8 cache,
  B7 through pages) and advances each row by its accepted prefix plus one
  token, all on the device; the packed readback is (3, K+1, slots).

PyTorch runs eagerly, so the JAX package's jitted, donated programs
become Python code that launches into preallocated device tensors updated
in place.  The static buffers leave room to capture one CUDA graph per K
rung; none is captured yet.

- On-demand device capture (``profile(dispatches=N)``, ``GET /profile``):
  the loop opens a ``torch.profiler`` window at its next boundary with
  work, closes it after N dispatches behind a synchronize of the card, and
  resolves the capture with the device/host split (``obs/devprof.py``),
  the kernels by name, the wrappers' launches over the window and the
  roofline share: the bytes a dispatch must move over the card's memory
  bandwidth (``MLCOMP_TPU_HBM_GBPS``, else the card's data sheet; none on
  the CPU).  The device spans join the flight recorder as the
  ``engine.device`` track; ``stats()["device"]`` and the
  ``mlcomp_engine_device_time_ms`` / ``_roofline_utilization`` families
  carry the last capture (else the steady-state estimate).

- Under a mesh (``mesh=``, a ``DeviceMesh`` over the process group: one
  rank a card) the engine is a gang (``dist=``, a
  ``parallel/distributed.BoundaryChannel``): rank 0, the coordinator, owns
  the submit queue and at every dispatch boundary broadcasts its
  admissions, retirements, K and control items; every other rank, a
  follower, replays them, so that every rank issues the same dispatch
  sequence and so the same collectives.  Each rank holds its
  tensor-parallel shard of every weight and the KV of its ``kv_heads /
  tp`` heads (``models/transformer.set_serving_tp``); the tables and the
  per-row bookkeeping are replicated, and the decode forward runs each dp
  rank's rows, their logits gathered over dp, so every rank samples every
  row from the same logits with the same keys.  dp splits the decode
  work, not the memory: every rank runs every admission and holds every
  slot's KV (the cache is replicated over dp), its copy of the other dp
  ranks' rows stale once they decode, so the slot counts must split over
  dp (``_dp_rows``).  Each rank launches the
  one-card kernels on its local shapes.  A mesh of one rank is the
  one-card engine, bit for bit.  Speculative dispatch, the prefix cache,
  prefill-only engines, imports and device captures stay single-card.
"""

from __future__ import annotations

import itertools
import math
import queue
import shutil
import tempfile
import threading
import time
import warnings
from collections import deque
from concurrent.futures import Future
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mlcomp_tpu_torch.cache.kv_store import (
    StagedRows,
    rows_to_device,
    stage_slot_rows,
    write_slot_rows,
)
from mlcomp_tpu_torch.dispatch_control import DEFAULT_LADDER, AdaptiveKController
from mlcomp_tpu_torch.kvpool import (
    GRAVE_PAGE,
    RESERVED_PAGES,
    NoFreePages,
    PagedKV,
    PagedLayout,
    PagePool,
)
from mlcomp_tpu_torch.kvpool.transfer import (
    HandoffError,
    decode_handoff,
    encode_handoff,
    rows_to_page_tiles,
)
from mlcomp_tpu_torch.models.generation import sample_token_rowwise_keyed
from mlcomp_tpu_torch.models.speculative import ngram_propose
from mlcomp_tpu_torch.obs import devprof
from mlcomp_tpu_torch.obs.metrics import DEFAULT_MS_BUCKETS, Registry
from mlcomp_tpu_torch.ops.cuda import launch_counts
from mlcomp_tpu_torch.ops.cuda.quant_matmul import GEMV_ROWS
from mlcomp_tpu_torch.ops.quant import Int8Linear, mesh_gate
from mlcomp_tpu_torch.parallel import collectives as col
from mlcomp_tpu_torch.parallel.distributed import ChannelClosed, process_count, process_index
from mlcomp_tpu_torch.parallel.mesh import batch_sharding, mesh_shape
from mlcomp_tpu_torch.serve import _bucket, _fail_future, left_pad_row
from mlcomp_tpu_torch.utils.faults import inject as _inject_fault
from mlcomp_tpu_torch.utils.profile import StepProfiler
from mlcomp_tpu_torch.utils.trace import Tracer, make_trace_id, null_tracer, valid_trace_id

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


class NotCoordinator(RuntimeError):
    """This process is a FOLLOWER in a distributed serve gang: it replays
    the coordinator's broadcast dispatch sequence and owns no submit queue.
    Send traffic to the coordinator (rank 0), whose ``/healthz`` answers
    ``ready: true``; followers answer false.  HTTP maps this to 503."""

    status = "not_coordinator"


class ProfileBusy(RuntimeError):
    """A second ``profile()`` arrived while a device capture was already
    armed or mid-window: one capture at a time (the profiler session is
    process-global).  HTTP maps this to 409."""

    status = "profile_busy"


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
                 "positions", "kv_start", "last_logits", "fused_any", "page_lease",
                 "handoff", "stall_ms", "skip_capture", "capture_lo")

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
        self.page_lease = None          # a device prefix-registry hit's pages
        self.handoff = None             # an import's parsed blob (born complete)
        # host ms the decode rows waited on this admission (staged chunks,
        # the prefix lookup/upload and the insert while rows decode)
        self.stall_ms = 0.0
        self.skip_capture = False       # a host-cache lease covered the prompt
        self.capture_lo = 0             # first slot the capture takes (first run chunk)


class _Inflight:
    """An issued dispatch whose tokens are not read yet."""

    __slots__ = ("host", "event", "t_issue", "k", "seq")

    def __init__(self, host, event, t_issue, k, seq):
        self.host, self.event, self.t_issue, self.k = host, event, t_issue, k
        self.seq = seq      # the flight recorder's dispatch span id


class DecodeEngine:
    """Fixed-slot continuous batcher around a loaded ``TransformerLM``.

    ``model`` carries its weights (``models.generation.prep_decode_variables``)
    and its device.  ``submit`` returns a Future resolving to the result
    dict; pass ``stream`` (a ``queue.Queue``) to also receive per-token
    dicts ``{"token", "logprob", "step"}`` as they land, then ``None``.
    Greedy outputs equal ``generate`` on the same weights: the prefill and
    the steps run the same model code, and a row's logits never depend on
    its neighbours.

    ``prefill_only`` makes the prefill half of disaggregated serving: the
    engine runs only the admission core on the dense admission cache (one
    throwaway slot, no decode dispatch ever issues, chunks run staged) and
    each future resolves with ``{"handoff": blob, "pages", ...}``;
    ``kv_page_tokens`` then picks the export page size.

    ``spec_k`` turns on speculative dispatch (module docstring): K+1
    positions a row a dispatch, greedy requests only; ``steps_per_dispatch``
    is then 1 and unread.

    ``prefix_cache`` (a ``cache.PrefixKVCache``) turns on the host prefix
    cache; ``flight_recorder_events`` bounds the recorder's ring (0
    disables it); ``metrics`` is the registry the engine's collector and
    histograms join (a private one by default).

    ``mesh`` serves a model loaded with the rank's shards
    (``models.generation.prep_decode_variables(..., mesh=)``) and ``dist``
    (a ``BoundaryChannel``) makes this rank the gang's coordinator or a
    follower (module docstring); a mesh wider than one rank needs it."""

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
        prefill_only: bool = False,
        spec_k: Optional[int] = None,
        prefix_cache=None,
        flight_recorder_events: Optional[int] = 32768,
        metrics: Optional[Registry] = None,
        mesh=None,
        dist=None,
    ):
        self.model = model
        self.device = torch.device(model.device)
        self.prefill_only = bool(prefill_only)
        self.mesh = mesh
        # the serve gang's boundary channel: rank 0 broadcasts each
        # boundary's decisions, the others replay them (_sync_boundary)
        self._dist = dist
        if dist is not None and mesh is None:
            raise ValueError("distributed serving (dist=...) needs a mesh: the gang runs one "
                             "program a rank over the global mesh")
        self._check_mesh(mesh, dist)
        if self.prefill_only:
            if spec_k is not None:
                raise ValueError("prefill_only engines run no decode dispatch; drop spec_k")
            if dist is not None:
                raise ValueError("prefill_only does not compose with distributed serving (the "
                                 "gang synchronizes DECODE boundaries); run prefill replicas "
                                 "single-process")
            if mesh is not None:
                raise ValueError("prefill_only is single-chip for now (the export capture "
                                 "fetches host rows, which does not compose with a sharded "
                                 "admission cache; the sharded prefill tier is a named "
                                 "follow-up); drop the mesh")
            if kv_layout != "dense":
                raise ValueError("prefill_only engines keep the dense admission cache (there "
                                 "are no decode slots to page); pass kv_page_tokens to pick "
                                 "the EXPORT page size")
            if kv_pages is not None or max_slots is not None:
                raise ValueError("kv_pages / max_slots need a decode slot pool; a "
                                 "prefill_only engine has none")
            # one throwaway carry row: no decode dispatch ever issues
            slots, pipeline_depth, fused_admission = 1, 1, False
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
        if adaptive and spec_k is not None:
            # a verify has no K-step scan to adapt: say so rather than drop
            # the knob silently
            warnings.warn(f"spec_k={spec_k} engines ignore steps_per_dispatch='adaptive' (a "
                          "speculative dispatch drafts and verifies spec_k+1 positions in one "
                          "forward; there is no K-step scan to adapt); drop the knob or spec_k",
                          stacklevel=2)
            adaptive = False
            steps_per_dispatch = None
        self._k_controller: Optional[AdaptiveKController] = None
        if adaptive:
            self._k_controller = AdaptiveKController(DEFAULT_LADDER)
            self.k_ladder = self._k_controller.ladder
            steps_per_dispatch = self.k_ladder[0]
        if steps_per_dispatch is None:
            steps_per_dispatch = 1 if spec_k is not None else 4
        self.steps_per_dispatch = int(steps_per_dispatch)
        if self.steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        if not adaptive:
            self.k_ladder = (self.steps_per_dispatch,)
        self.adaptive_k = adaptive
        if spec_k is not None and self.steps_per_dispatch != 1:
            warnings.warn(f"spec_k={spec_k} engines ignore steps_per_dispatch (got "
                          f"{self.steps_per_dispatch}): a speculative dispatch drafts and "
                          "verifies spec_k+1 positions in one forward; drop steps_per_dispatch "
                          "(or pass 1)", stacklevel=2)
        self.spec_k = None if spec_k is None else int(spec_k)
        if self.spec_k is not None and mesh is not None:
            raise ValueError("speculative dispatch is single-chip for now (the multi-query "
                             "verify has no sharded drafter; a sharded drafter is the "
                             "sharded-serving PR's named follow-up); drop spec_k or the mesh")
        # int8 weights through the kernel: the verify's products run
        # slots*(spec_k+1) rows, and past GEMV_ROWS they leave the decode
        # kernel for the tiled path
        self._int8_kernel = any(isinstance(m, Int8Linear) for m in model.modules())
        self._fatblock_scale_warned = False
        if self.spec_k is not None:
            if self.spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
            if self._int8_kernel and self.slots * (self.spec_k + 1) > GEMV_ROWS:
                warnings.warn(
                    f"slots*(spec_k+1) = {self.slots}*{self.spec_k + 1} = "
                    f"{self.slots * (self.spec_k + 1)} exceeds the int8 kernel's fat-block "
                    f"decode boundary (GEMV_ROWS = {GEMV_ROWS}): the speculative verify's "
                    "products leave the decode kernel for the tiled path; shrink slots or "
                    "spec_k so their product stays within budget", stacklevel=2)
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.fused_admission = True if fused_admission is None else bool(fused_admission)
        self.prefix_cache = prefix_cache
        if prefix_cache is not None and mesh is not None:
            raise ValueError("the prefix KV cache is single-chip for now (host-side row inserts "
                             "don't compose with a sharded cache; sharding the capture/assemble "
                             "tier is the sharded-serving PR's named follow-up, and the device "
                             "prefix-page registry already serves sharded paged engines); drop "
                             "prefix_cache or the mesh")
        if prefix_cache is not None:
            # hits skip whole chunks only: a bucket that prefills as ONE
            # chunk can never hit (its captures feed other buckets)
            mono = [s for s in self.prompt_buckets
                    if s <= self.prefill_chunk or s % min(self.prefill_chunk, s)]
            if mono:
                warnings.warn(f"prefix-cache hits are impossible at prompt bucket(s) {mono}: "
                              f"each prefills as a single chunk (prefill_chunk="
                              f"{self.prefill_chunk}), and hits skip whole chunks only; shrink "
                              "prefill_chunk to a divisor of every bucket to cache-serve them",
                              stacklevel=2)
        # depth 2 by default, mesh or not: every rank chains its dispatches
        # on its own stream as one card does
        self.pipeline_depth = 2 if pipeline_depth is None else int(pipeline_depth)
        if self.pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
        # +1 scratch slot: a RETIRED row's frozen cursor still receives each
        # step's K/V write (the device retires rows by masking emission,
        # not by skipping the forward), one past its last budgeted slot; a
        # verify writes spec_k more.  Without that slack RowCursors clamps
        # a late row's K+1 writes back onto its own real K/V
        self.l_buf = self.prompt_buckets[-1] + self.max_new_cap + (self.spec_k or 0) + 1
        if self.spec_k is not None:
            # the per-row token history the draft reads: real ids only,
            # left-aligned (one scratch column past it takes the verify's
            # invalid lanes: torch has no drop-mode scatter)
            self.t_ids = self.prompt_buckets[-1] + self.max_new_cap
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
            if (kv_page_tokens is not None and not self.prefill_only) or kv_pages is not None:
                raise ValueError("kv_page_tokens / kv_pages only apply to kv_layout='paged' "
                                 "(kv_page_tokens also picks a prefill_only engine's export "
                                 "page size)")

        with torch.inference_mode():
            # the admission's (1, L) cache and the packed-token rings are
            # static: allocated once, reused by every admission / dispatch
            self._adm_cache = model.init_cache(1, self.l_buf)
            if self.kv_layout == "paged":
                self._init_pool(kv_page_tokens, kv_pages, max_slots)
            if self.slots % self._dp_count or self.max_slots % self._dp_count:
                raise ValueError(f"slots={self.slots} and max_slots={self.max_slots} must "
                                 f"split over dp={self._dp_count}: each dp rank decodes its "
                                 "share of the rows")
            # the EXPORT geometry (prefill_only): pages must tile every
            # chunk, so the prompt span exports as whole tiles of the
            # admission cache's leaves
            self._export: Optional[PagedLayout] = None
            if self.prefill_only:
                self._export = PagedLayout(self._adm_cache, self.l_buf,
                                           self._page_quantum(kv_page_tokens))
            self._d = self._fresh_dstate()
            ring = self.pipeline_depth + 1
            n = 3 * max(self._rows_out(k) for k in self.k_ladder) * self.max_slots
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
            "cache_degraded": 0, "watchdog_stalls": 0, "watchdog_restarts": 0,
            "dispatch_k_changes": 0, "profile_captures": 0,
        }
        if self.spec_k is not None:
            # live row-forwards across verifies: emitted_tokens / spec_rows
            # is the measured acceptance (<= 1: speculation is a pure loss)
            self._stats["spec_rows"] = 0
        self._spec_warned = False
        # sticky: flips once measured acceptance is <= 1 past 64 rows
        self._spec_ineffective = False
        if self._pool is not None:
            # elastic resizes, pages allocated as cursors crossed page
            # boundaries, and rows failed by a dry pool at such a crossing
            self._stats.update(slots_scaled=0, peak_live_slots=self.slots,
                               kv_pages_lazy_allocated=0, kv_decode_page_failures=0)
            # prompt tokens whose prefill a registry hit skipped, and the
            # decode side of disaggregation: handoffs imported, their pages
            # and bytes, and blobs rejected typed before any allocation
            self._stats.update(kv_registry_hit_tokens=0, handoffs_imported=0,
                               kv_pages_imported=0, handoff_bytes_imported=0,
                               handoff_rejects=0)
        if self.prefill_only:
            self._stats.update(handoffs_exported=0, kv_pages_exported=0,
                               handoff_bytes_exported=0)
        self._dispatches_by_k: Dict[int, int] = {}
        self._inflight: Deque[_Inflight] = deque()
        self._pstats = {"issued": 0, "hidden_ms": 0.0, "wait_ms": 0.0,
                        "inflight_sum": 0, "peak_inflight": 0}
        self._lat_ttft: Deque[float] = deque(maxlen=2048)
        self._lat_tok: Deque[float] = deque(maxlen=2048)
        self._lat_ttft_n = 0
        self._rid = itertools.count(1)
        self._dispatch_seq = itertools.count(1)
        # the flight recorder: a bounded ring of admission, dispatch,
        # prefix-cache and request-lifecycle events (GET /trace)
        self.recorder: Tracer = (Tracer(max_events=int(flight_recorder_events))
                                 if flight_recorder_events else null_tracer())
        if prefix_cache is not None:
            # the capture worker's spans land on its own thread track
            prefix_cache.tracer = self.recorder
            prefix_cache.bind_layout(self._adm_cache)
        self.metrics = metrics if metrics is not None else Registry()
        self._hist_ttft = self.metrics.histogram(
            "mlcomp_engine_ttft_ms", "Submit -> first token at the host, per finished request",
            buckets=DEFAULT_MS_BUCKETS)
        self._hist_tok = self.metrics.histogram(
            "mlcomp_engine_per_token_ms",
            "Mean decode interval after the first token, per request", buckets=DEFAULT_MS_BUCKETS)
        self._hist_stall = self.metrics.histogram(
            "mlcomp_engine_admission_stall_ms",
            "Host-observed decode-stream stall per completed admission (staged chunks run "
            "while rows decode + the insert boundary; ~0 when every chunk rides a fused "
            "dispatch)", buckets=DEFAULT_MS_BUCKETS)
        self._hist_device = self.metrics.histogram(
            "mlcomp_engine_device_time_ms",
            "Device-lane busy ms per dispatch (one observation per /profile capture: "
            "interval union over the card's lanes / dispatches)", buckets=DEFAULT_MS_BUCKETS)
        self.metrics.register_collector(self._collect_metrics)
        # on-demand device capture (GET /profile): one armed or active
        # capture at a time; HTTP threads arm it under _prof_lock, the loop
        # thread starts, stops and attributes it at dispatch boundaries
        self._prof_lock = threading.Lock()
        self._profile: Optional[Dict[str, Any]] = None
        self._last_attr: Optional[Dict[str, Any]] = None
        # the roofline: one forward reads every weight once, plus its KV
        # working set; the bandwidth is MLCOMP_TPU_HBM_GBPS or the card's
        # data sheet, None on the CPU (no roofline there)
        self._w_bytes = sum(t.numel() * t.element_size()
                            for t in itertools.chain(model.parameters(), model.buffers()))
        self._hbm_gbps = devprof.hbm_gbps(self.device)
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

    def _check_mesh(self, mesh, dist) -> None:
        """The mesh's groups, or the refusals: a gang shards over dp, tp and
        ep (the other axes serve nothing here), and a mesh wider than one
        rank needs the boundary channel (every rank must issue the same
        dispatch sequence)."""
        self._dp_group = None
        self._dp_index, self._dp_count = 0, 1
        wide = mesh_gate(mesh) if isinstance(mesh, dict) or hasattr(mesh, "mesh_dim_names") \
            else None
        if wide is None:
            return
        shape = mesh_shape(wide)
        other = {a: n for a, n in shape.items() if a not in ("dp", "tp", "ep") and n > 1}
        if other:
            raise ValueError(f"serving under a mesh shards over dp, tp and ep (moe_lm's "
                             f"experts); axes {other} have no serving layout")
        if dist is None:
            raise ValueError(f"a mesh over {math.prod(shape.values())} ranks needs dist= (a "
                             "parallel.distributed.BoundaryChannel): every rank is a process, "
                             "and the followers replay the coordinator's boundaries")
        self._dp_index, self._dp_count = batch_sharding(wide)
        self._dp_group = col.group_of(wide, "dp")

    def _dp_rows(self, ns: int) -> Optional[Tuple[int, int]]:
        """This rank's rows ``[lo, hi)`` of an ``ns``-row decode forward
        under dp, or None (no dp axis).  Every rank holds every slot's KV
        (the cache is replicated over dp), but a decode step writes only the
        rows it runs: the other dp ranks' rows of this rank's cache are
        stale from their first decode step on, and are read only because
        every step splits the rows the same way.  So a row count that dp
        does not divide is refused here (the constructor refuses such slot
        counts)."""
        if self._dp_group is None:
            return None
        if ns % self._dp_count:
            raise RuntimeError(f"{ns} decode rows do not split over dp={self._dp_count}: the "
                               "other dp ranks' rows of this rank's cache are stale")
        per = ns // self._dp_count
        return self._dp_index * per, (self._dp_index + 1) * per

    def _forward_rows(self, ids, positions, cache, cursors, kv_start) -> torch.Tensor:
        """The decode forward of every slot (last-position logits): under dp
        each rank runs its rows on their rows of the cache (a view) and the
        logits are gathered over dp, so every rank holds every row's."""
        rows = self._dp_rows(ids.shape[0])
        if rows is None:
            return self.model(ids, positions=positions, cache=cache, last_only=True,
                              cache_cursor=cursors, kv_start=kv_start)
        lo, hi = rows
        if isinstance(cache, PagedKV):
            part = PagedKV(cache.layout, cache.pages, cache.table[lo:hi])
        else:
            part = type(cache)([type(layer)(**{n: t[lo:hi] for n, t in vars(layer).items()})
                                for layer in cache.layers], cache.index)
        logits = self.model(ids[lo:hi], positions=positions[lo:hi], cache=part, last_only=True,
                            cache_cursor=cursors[lo:hi], kv_start=kv_start[lo:hi])
        return col.gather_dim(logits.contiguous(), self._dp_group, 0)

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
        if self.spec_k is not None:
            rows["ids"] = torch.zeros((ns, self.t_ids + 1), dtype=i64, device=dev)
            rows["ids_len"] = torch.zeros((ns,), dtype=i32, device=dev)
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
        _count: bool = True,
    ) -> Future:
        """Queue one request (class docstring).  ``_count=False`` marks
        warmup's dummy requests: no rid, no lifecycle trace, no request
        count, latency sample, prefix-cache lookup or capture, or registry
        entry."""
        ids = [int(t) for t in prompt_ids]
        if not ids:
            raise ValueError("prompt must be non-empty")
        n_new = int(max_new_tokens)
        if n_new <= 0:
            raise ValueError("max_new_tokens must be positive")
        if n_new > self.max_new_cap:
            raise ValueError(f"max_new_tokens {n_new} exceeds the engine cap {self.max_new_cap}")
        self._bucket(len(ids))  # validate now, in the caller thread
        if not self.is_coordinator:
            raise NotCoordinator("this process is a follower in a distributed serve gang; "
                                 "submit to the coordinator (process 0)")
        if self.spec_k is not None and (float(temperature) != 0.0
                                        or float(repetition_penalty) != 1.0):
            raise ValueError("a speculative engine (spec_k set) is greedy-only: temperature "
                             "must be 0 and repetition_penalty 1")
        if self.prefill_only and stream is not None:
            raise ValueError("a prefill_only engine emits no tokens to stream: the future "
                             "resolves with the handoff payload (decode, and stream, on a "
                             "decode replica through import_pages)")
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
        rid = next(self._rid) if _count else 0
        fut.rid = rid  # the cancel(rid) handle callers key on
        fut.trace_id = trace_id
        if rid:
            self.recorder.async_begin("request", rid, cat="req", prompt=len(ids), n_new=n_new,
                                      trace_id=trace_id)
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
            "warmup": not _count,
        })
        if self._stop.is_set() or self._broken is not None:
            # close() (or a dying loop) may have drained the queue between
            # the checks above and our put: resolve the future ourselves
            if stream is not None:
                stream.put(None)
            _fail_future(fut, self._broken or RuntimeError("decode engine closed"))
        if _count:
            self._stats["requests"] += 1
        return fut

    def validate_handoff(self, blob: bytes):
        """Parse a handoff blob and check it against THIS engine's paged
        geometry: every violation raises the typed ``HandoffError`` (and
        counts in ``handoff_rejects``) BEFORE any page, lease or slot is
        touched.  Returns the parsed ``(meta, last_logits, payloads)`` for
        :meth:`import_pages`."""
        if self._pool is None:
            raise ValueError("import_pages needs kv_layout='paged': the handoff's currency is "
                             "pages in this engine's PagePool")
        try:
            return self._validate_handoff(blob)
        except HandoffError:
            self._stats["handoff_rejects"] += 1
            raise

    def _validate_handoff(self, blob: bytes):
        meta, logits, payloads = decode_handoff(blob)
        pool, layout = self._pool, self._layout
        t = int(meta.get("page_tokens") or 0)
        if t != pool.page_tokens:
            raise HandoffError(f"handoff pages hold {t} tokens; this pool's hold "
                               f"{pool.page_tokens}: prefill and decode replicas must share "
                               "the page quantum (kv_page_tokens)")
        try:
            ids = [int(x) for x in meta["ids"]]
            s_bucket = int(meta["s_bucket"])
            start_pad = int(meta["start_pad"])
            n_new = int(meta["n_new"])
        except (KeyError, TypeError, ValueError) as e:
            raise HandoffError(f"bad handoff metadata: {e}") from None
        if not ids or n_new <= 0:
            raise HandoffError("handoff carries no prompt or no budget")
        if n_new > self.max_new_cap:
            raise HandoffError(f"handoff max_new_tokens {n_new} exceeds this engine's cap "
                               f"{self.max_new_cap}")
        try:
            want_bucket = self._bucket(len(ids))
        except ValueError as e:
            raise HandoffError(f"handoff prompt does not fit this engine's buckets: {e}; "
                               "prefill and decode replicas must share prompt buckets") from None
        if s_bucket != want_bucket or start_pad != s_bucket - len(ids):
            raise HandoffError(f"handoff placement (s_bucket={s_bucket}, start_pad="
                               f"{start_pad}) does not match this engine's bucket for a "
                               f"{len(ids)}-token prompt: prefill and decode replicas must "
                               "share prompt buckets")
        if s_bucket % t:
            raise HandoffError(f"s_bucket={s_bucket} is not page-aligned at T={t}")
        n_pages = s_bucket // t - start_pad // t
        leaves = meta.get("leaves")
        if (not isinstance(leaves, list) or len(leaves) != len(layout.kv_specs)
                or len(payloads) != len(layout.kv_specs)):
            raise HandoffError(f"handoff carries {len(payloads)} KV leaves; this engine's "
                               f"cache has {len(layout.kv_specs)}")
        for lv, spec, pl in zip(leaves, layout.kv_specs, payloads):
            want = (n_pages,) + layout._page_rest(spec)
            if not isinstance(lv, dict) or lv.get("key") != spec.keystr:
                key = lv.get("key") if isinstance(lv, dict) else lv
                raise HandoffError(f"handoff leaf {key!r} does not match this engine's "
                                   f"{spec.keystr!r} (different model or cache family)")
            if tuple(pl.shape) != want or pl.dtype != spec.dtype:
                raise HandoffError(f"handoff leaf {spec.keystr}: payload {pl.dtype}"
                                   f"{tuple(pl.shape)} vs expected {spec.dtype}{want}")
        if tuple(logits.shape) != (1, self.vocab):
            raise HandoffError(f"handoff logits shaped {tuple(logits.shape)}; this engine's "
                               f"vocab row is (1, {self.vocab})")
        return meta, logits, payloads

    def import_pages(self, blob: bytes, stream: Optional["queue.Queue"] = None,
                     deadline_s: Optional[float] = None, trace_id: Optional[str] = None,
                     parsed=None) -> Future:
        """Admit a request by IMPORTING its finished prefill: the decode
        half of a disaggregated handoff.  The payload pages are written
        straight into the pool at the admission boundary (registered in the
        prefix-page registry) and the slot starts decoding at the prompt's
        end; no prefill chunk runs, and the tokens equal a local admission
        of the same prompt (same KV bytes, same final logits, the prefill
        side's sampling-stream seed).

        Validation happens HERE, on the caller's thread: a truncated or
        mismatched blob raises the typed ``HandoffError`` with no page,
        lease or slot touched.  ``parsed`` (what :meth:`validate_handoff`
        returned) skips a second parse."""
        if self._dist is not None:
            raise RuntimeError("import_pages does not compose with distributed serving yet "
                               "(imports are not broadcast to the gang): the named follow-up")
        meta, logits, payloads = parsed if parsed is not None else self.validate_handoff(blob)
        if self._stop.is_set():
            raise RuntimeError("decode engine closed")
        if self._broken is not None:
            raise RuntimeError(f"decode engine is down: {self._broken!r}") from self._broken
        if deadline_s is not None and float(deadline_s) <= 0:
            raise ValueError(f"deadline_s must be positive, got {deadline_s}")
        knobs = dict(meta.get("req") or {})
        if trace_id is None:
            trace_id = meta.get("trace_id")
        if trace_id is None or not valid_trace_id(trace_id):
            trace_id = make_trace_id()
        fut: Future = Future()
        rid = next(self._rid)
        fut.rid = rid
        fut.trace_id = trace_id
        self.recorder.async_begin("request", rid, cat="req", prompt=len(meta["ids"]),
                                  n_new=int(meta["n_new"]), trace_id=trace_id, imported=True)
        now = time.perf_counter()
        eos = knobs.get("eos_id")
        self._queue.put({
            "ids": [int(t) for t in meta["ids"]], "n_new": int(meta["n_new"]), "future": fut,
            "temperature": float(knobs.get("temperature", 0.0)),
            "top_k": int(knobs.get("top_k") or self.vocab),
            "top_p": float(knobs.get("top_p") or 1.0),
            "eos_id": -1 if eos is None else int(eos),
            "logprobs": bool(knobs.get("logprobs", False)),
            "repetition_penalty": float(knobs.get("repetition_penalty", 1.0)),
            "stream": stream,
            "t_submit": now,
            "t_deadline": None if deadline_s is None else now + float(deadline_s),
            "rid": rid,
            "trace_id": trace_id,
            # the parsed handoff rides the request into the loop; the
            # completion boundary writes the pages and inserts the slot
            "handoff": {"meta": meta, "logits": logits, "payloads": payloads,
                        "bytes": len(blob) if blob is not None else 0},
        })
        if self._stop.is_set() or self._broken is not None:
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
                return any(isinstance(r, dict) and r.get("rid") == rid for r in self._queue.queue)

        if not is_live():
            return False
        self._cancelled.add(rid)
        if not is_live():  # finished between the scan and the add
            self._cancelled.discard(rid)
            return False
        return True

    def profile(self, dispatches: int = 8, trace_dir: Optional[str] = None) -> Future:
        """Arm a windowed device capture around the next ``dispatches``
        dispatch boundaries (``GET /profile``).  The drive loop opens a
        ``torch.profiler`` window at its next boundary with work (the
        ``utils/profile.StepProfiler`` idiom), closes it behind a
        synchronize of the card after N resolved dispatches, reads the
        trace (``obs/devprof.py``) and resolves the returned Future with
        the attribution: ``device_time_ms`` (interval union over the
        card's lanes), ``host_gap_ms`` (wall the card sat idle: launch
        cost, pipeline bubble, admission stall), the kernels by name, the
        wrappers' ``launches`` over the window, and the roofline share per
        dispatch family.  The device spans also join the flight recorder
        as the ``engine.device`` track.

        One capture at a time (the profiler session is process-global): a
        second arm raises :class:`ProfileBusy` (HTTP 409).  A capture's
        failure fails its future only."""
        n = int(dispatches)
        if self._dist is not None:
            raise RuntimeError("on-demand device capture does not compose with distributed "
                               "serving yet (the window's drains run on one process only, "
                               "which would desequence the gang); profile a single-card daemon: "
                               "the gang-wide capture is the named follow-up")
        if not 1 <= n <= 1024:
            # the trace is read on the loop thread at the window's close:
            # the cap keeps that stall proportionate
            raise ValueError(f"dispatches must be in [1, 1024], got {dispatches}")
        if self._broken is not None:
            raise RuntimeError(f"decode engine is down: {self._broken!r}") from self._broken
        if self._stop.is_set():
            raise RuntimeError("decode engine closed")
        fut: Future = Future()
        with self._prof_lock:
            if self._profile is not None:
                raise ProfileBusy("a device-profile capture is already armed or in flight; "
                                  "retry after it resolves")
            d = trace_dir or tempfile.mkdtemp(prefix="mlcomp_devprof_")
            self._profile = {
                "n": n, "dir": d, "future": fut, "owns_dir": trace_dir is None,
                # the card's lanes only: recording host operators would add
                # host time to every launch of the window it measures
                "profiler": StepProfiler(d, start_step=0, num_steps=n, device=self.device,
                                         host_ops=False),
                "families": {}, "t0": None, "t1": None, "resolved": 0,
            }
        if self._stop.is_set() or self._broken is not None:
            # close() (or a dying loop) may have drained the profile between
            # the checks above and the arm: resolve it here (idempotent)
            self._finish_profile(error=self._broken or RuntimeError("decode engine closed"))
        return fut

    def profile_cancel(self, fut: Future) -> bool:
        """Disarm a capture that has NOT started tracing (the HTTP layer's
        timeout path).  An open window is never cancelled from outside: the
        loop thread owns it and closes it at its boundary."""
        with self._prof_lock:
            pr = self._profile
            if pr is None or pr["future"] is not fut or pr["profiler"].active:
                return False
            self._profile = None
        _fail_future(fut, RuntimeError("profile capture cancelled"))
        if pr["owns_dir"]:
            shutil.rmtree(pr["dir"], ignore_errors=True)
        return True

    @property
    def is_coordinator(self) -> bool:
        """True for a single-card engine and for rank 0 of a distributed
        serve gang: the process that owns the submit queue and broadcasts
        the boundary decisions."""
        return self._dist is None or self._dist.is_coordinator

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
        if self.mesh is not None:
            # the /healthz mesh block: which process fronts the gang and how
            # the mesh is carved up
            out["mesh"] = self._mesh_info()
        if self._pool is not None:
            out["live_slots"] = len(self._host)
            out["max_slots"] = self.max_slots
            out["kv_pool"] = self._pool_stats()
        if self.spec_k is not None:
            rows = self._stats["spec_rows"]
            acc = self._stats["emitted_tokens"] / rows if rows else None
            out["spec"] = {
                "spec_k": self.spec_k,
                # tokens a row a verify; a plain step emits exactly 1
                "acceptance_tokens_per_row": round(acc, 3) if acc is not None else None,
                "spec_net_gain": round(acc - 1.0, 3) if acc is not None else None,
                "spec_ineffective": self._spec_ineffective,
            }
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats()
        # the device/host split: the last capture's, else the steady-state
        # estimate
        out["device"] = self._device_summary()
        return out

    def _mesh_info(self) -> Dict[str, Any]:
        """The mesh block behind stats() and the mesh gauges (a placeholder
        mesh object degrades the axis and device fields to None)."""
        try:
            axes = {str(k): int(v) for k, v in mesh_shape(self.mesh).items()}
            devices = math.prod(axes.values())
        except Exception:
            axes, devices = None, None
        return {"axes": axes, "devices": devices, "processes": process_count(),
                "process_index": process_index(), "coordinator": self.is_coordinator,
                "distributed": self._dist is not None}

    @property
    def _forwards(self) -> int:
        """Model forwards one dispatch runs: the current K, one a verify."""
        return 1 if self.spec_k is not None else self.steps_per_dispatch

    def _kv_dense_bytes(self) -> int:
        """Bytes of the dense layout's whole KV buffer."""
        return sum(t.numel() * t.element_size() for layer in self._d["cache"].layers
                   for t in vars(layer).values())

    def _kv_live_bytes(self) -> int:
        """Paged: bytes of the live page mappings, counted per slot-table
        entry (a shared prefix page is read once for each row that maps
        it).  A read from another thread may see the tables mid-update: a
        torn count is acceptable monitoring."""
        return int((self._pool.tables[: len(self._host)] >= RESERVED_PAGES).sum()) * (
            self._layout.page_bytes())

    def _kv_bytes_moved_per_dispatch(self) -> int:
        """Estimated KV bytes one dispatch moves through device memory: K
        forwards (one for a verify) each read the dense buffer, or the live
        page mappings through the table (the int8 family), or the live pages
        gathered into each layer's dense view and that view read (the bf16
        family's gather path)."""
        fw = self._forwards
        if self._pool is None:
            return fw * self._kv_dense_bytes()
        live = self._kv_live_bytes()
        specs = self._layout.kv_specs
        if any(s.field == "kq" for s in specs):
            return fw * live
        dense = len(self._host) * sum(int(np.prod(s.shape)) * s.dtype.itemsize for s in specs)
        return fw * (live + 2 * dense)

    def _roofline_bytes(self) -> int:
        """Bytes one dispatch MUST move: every weight once a forward, plus
        its KV working set (the dense buffer, or the live pages)."""
        kv = self._kv_live_bytes() if self._pool is not None else self._kv_dense_bytes()
        return self._forwards * (self._w_bytes + kv)

    def _roofline_ms(self) -> Optional[float]:
        """The least time the card could take for a dispatch: its bytes over
        the memory bandwidth; None where there is none (the CPU)."""
        if self._hbm_gbps is None:
            return None
        return self._roofline_bytes() / (self._hbm_gbps * 1e9) * 1e3

    def _collect_metrics(self) -> None:
        """Scrape-time collector: the engine's monotonic stats into the
        registry (``set_total`` keeps counters monotonic across scrapes);
        the hot path pays nothing for /metrics.  The JAX engine's
        families."""
        m = self.metrics
        st = self._stats

        def ctr(name, help, value):
            m.counter(name, help).set_total(value)

        def gau(name, help, value):
            m.gauge(name, help).set(value)

        ctr("mlcomp_engine_requests_total", "Real (non-warmup) requests submitted",
            st["requests"])
        ctr("mlcomp_engine_dispatches_total", "Decode dispatches resolved", st["dispatches"])
        ctr("mlcomp_engine_steps_total", "Device decode forwards", st["steps"])
        ctr("mlcomp_engine_emitted_tokens_total", "Tokens emitted to requests",
            st["emitted_tokens"])
        ctr("mlcomp_engine_prefills_total", "Admissions completed (rows inserted)",
            st["prefills"])
        ctr("mlcomp_engine_prefill_chunks_total", "Prefill chunks run", st["prefill_chunks"])
        ctr("mlcomp_engine_fused_prefill_chunks_total",
            "Prefill chunks that rode a decode dispatch (subset of prefill_chunks)",
            st["fused_chunks"])
        ctr("mlcomp_engine_admissions_overlapped_total",
            "Completed admissions with at least one fused chunk", st["admissions_overlapped"])
        if self.spec_k is not None and st.get("spec_rows"):
            gau("mlcomp_engine_spec_net_gain", "Accepted tokens per row per verify forward "
                "minus 1 (<= 0: speculation is a measured net loss)",
                st["emitted_tokens"] / st["spec_rows"] - 1.0)
        if self.spec_k is not None:
            gau("mlcomp_engine_spec_ineffective", "1 once measured acceptance fell to <= 1 "
                "token/row/forward past the 64-row window (sticky): speculation is burning "
                "fat-block rows for nothing", 1 if self._spec_ineffective else 0)
        gau("mlcomp_engine_dispatch_k", "Decode steps per dispatch currently in effect (the "
            "adaptive controller's pick, or the pinned K)", self.steps_per_dispatch)
        ctr("mlcomp_engine_dispatch_k_changes_total",
            "Adaptive-K controller switches of steps_per_dispatch", st["dispatch_k_changes"])
        ctr("mlcomp_engine_latency_samples_total",
            "Requests behind the TTFT percentiles (lifetime)", self._lat_ttft_n)
        ctr("mlcomp_engine_deadline_exceeded_total", "Requests retired past their deadline",
            st["deadline_exceeded"])
        ctr("mlcomp_engine_cancelled_total", "Requests retired by cancel()", st["cancelled"])
        ctr("mlcomp_cache_degraded_total", "Prefix-cache faults contained to a cache-bypass",
            st["cache_degraded"])
        ctr("mlcomp_engine_watchdog_stalls_total", "Watchdog stall/dead-loop detections",
            st["watchdog_stalls"])
        ctr("mlcomp_engine_watchdog_restarts_total",
            "Drive-loop restarts the watchdog performed", st["watchdog_restarts"])
        gau("mlcomp_engine_healthy", "1 while the drive loop is alive and unbroken, else 0",
            1 if self.healthy else 0)
        gau("mlcomp_engine_slots", "Configured decode slots", self.slots)
        gau("mlcomp_engine_active_slots", "Slots currently decoding",
            sum(1 for s in self._host if s is not None))
        gau("mlcomp_engine_queue_depth", "Requests waiting for a slot",
            self._queue.qsize() + len(self._pending))
        p = dict(self._pstats)
        ctr("mlcomp_engine_pipeline_issued_total", "Dispatches issued into the pipeline",
            p["issued"])
        ctr("mlcomp_engine_pipeline_hidden_ms_total",
            "Host ms hidden behind in-flight device compute", p["hidden_ms"])
        ctr("mlcomp_engine_pipeline_wait_ms_total", "Host ms blocked on dispatch outputs",
            p["wait_ms"])
        gau("mlcomp_engine_pipeline_depth", "Configured pipeline depth", self.pipeline_depth)
        gau("mlcomp_engine_pipeline_inflight", "Dispatches currently in flight",
            len(self._inflight))
        gau("mlcomp_engine_pipeline_peak_inflight", "Peak in-flight dispatch depth",
            p["peak_inflight"])
        busy = p["hidden_ms"] + p["wait_ms"]
        gau("mlcomp_engine_pipeline_overlap_efficiency",
            "hidden_ms / (hidden_ms + wait_ms) since start",
            p["hidden_ms"] / busy if busy > 0 else 0.0)
        ctr("mlcomp_engine_trace_events_dropped_total", "Flight-recorder ring evictions",
            self.recorder.dropped)
        ctr("mlcomp_engine_profile_captures_total",
            "On-demand device-profile captures completed (/profile)", st["profile_captures"])
        dev = self._device_summary()
        if dev["device_time_ms_per_dispatch"] is not None:
            gau("mlcomp_engine_device_time_ms_per_dispatch",
                "Device-lane busy ms per dispatch (last capture, else the steady-state "
                "estimate: dispatch wall minus measured host work)",
                dev["device_time_ms_per_dispatch"])
        if dev["host_overhead_ms_per_dispatch"] is not None:
            gau("mlcomp_engine_host_overhead_ms_per_dispatch",
                "Non-device ms per dispatch (capture host gap, else the pipeline's measured "
                "hidden host work)", dev["host_overhead_ms_per_dispatch"])
        if dev["roofline_utilization"] is not None:
            gau("mlcomp_engine_roofline_utilization",
                "Roofline dispatch time / measured device time (1.0 = decode runs at what "
                "the card's memory can deliver)", dev["roofline_utilization"])
        if self._pool is not None:
            ps = self._pool_stats()
            gau("mlcomp_engine_kv_pages_total", "Allocatable device KV pages (paged layout; "
                "reserved NULL/GRAVE pages excluded)", ps.get("pages_total", 0))
            gau("mlcomp_engine_kv_pages_free", "Device KV pages on the free list",
                ps.get("pages_free", 0))
            gau("mlcomp_engine_kv_pages_shared",
                "Pages mapped by more than one reference (prefix sharing)",
                ps.get("pages_shared", 0))
            ctr("mlcomp_engine_kv_page_cow_forks_total",
                "Copy-on-write forks: shared prefix pages privately re-allocated because the "
                "slot's write span crossed the share boundary", ps.get("cow_forks", 0))
            ctr("mlcomp_engine_slots_scaled_total", "Elastic slot-count resizes (grow + shrink)",
                st["slots_scaled"])
            gau("mlcomp_engine_live_slots",
                "Current elastic slot count (floor = slots, cap = max_slots)", len(self._host))
            gau("mlcomp_engine_max_slots", "Elastic slot-count cap", self.max_slots)
            ctr("mlcomp_engine_kv_registry_hits_total", "Device prefix-page registry hits "
                "(shared pages mapped with no host round-trip)", ps.get("registry_hits", 0))
            ctr("mlcomp_engine_kv_registry_hit_tokens_total",
                "Prompt tokens whose prefill a registry hit skipped",
                st["kv_registry_hit_tokens"])
            ctr("mlcomp_engine_kv_pages_lazy_allocated_total",
                "Decode pages allocated lazily as cursors crossed page boundaries mid-stream "
                "(instead of worst-case at insert)", st["kv_pages_lazy_allocated"])
            ctr("mlcomp_engine_kv_decode_page_failures_total",
                "Requests failed mid-decode by a dry page pool at a lazy page crossing "
                "(bounded failure)", st["kv_decode_page_failures"])
            ctr("mlcomp_engine_handoffs_imported_total",
                "Disaggregated handoffs admitted via import_pages (prefill skipped; payload "
                "pages written straight into the pool)", st["handoffs_imported"])
            ctr("mlcomp_engine_kv_pages_imported_total",
                "KV pages received through handoff imports", st["kv_pages_imported"])
            ctr("mlcomp_engine_handoff_bytes_imported_total",
                "Handoff payload bytes received (wire size of accepted imports)",
                st["handoff_bytes_imported"])
            ctr("mlcomp_engine_handoff_rejects_total",
                "Handoff blobs rejected typed before any allocation (truncated transfer, "
                "geometry mismatch)", st["handoff_rejects"])
        if self.prefill_only:
            ctr("mlcomp_engine_handoffs_exported_total",
                "Completed admissions exported as page-payload handoffs (prefill-only engines)",
                st["handoffs_exported"])
            ctr("mlcomp_engine_kv_pages_exported_total",
                "KV pages serialized into exported handoffs", st["kv_pages_exported"])
            ctr("mlcomp_engine_handoff_bytes_exported_total",
                "Handoff payload bytes serialized (wire size of exports)",
                st["handoff_bytes_exported"])
        gau("mlcomp_engine_kv_bytes_moved_per_dispatch",
            "Estimated KV bytes one dispatch moves through device memory (dense: K forwards x "
            "buffer; paged through the table: K forwards x live pages; paged gather: + the "
            "dense-view round trip)", self._kv_bytes_moved_per_dispatch())
        if self.mesh is not None:
            info = self._mesh_info()
            gau("mlcomp_engine_mesh_devices", "Devices in the serving mesh (sharded engines only)",
                info["devices"] or 0)
            gau("mlcomp_engine_is_coordinator",
                "1 on the process that owns the submit queue (always 1 single-host; process 0 "
                "of a distributed gang)", 1 if info["coordinator"] else 0)
        if self.prefix_cache is not None:
            cs = self.prefix_cache.stats()
            for key in ("lookups", "hits", "misses", "matched_tokens", "used_hits",
                        "used_hit_tokens", "inserted_tokens", "evictions", "evicted_tokens",
                        "insert_errors", "insert_dropped"):
                ctr(f"mlcomp_prefix_cache_{key}_total",
                    f"Prefix KV cache {key.replace('_', ' ')}", cs[key])
            for key in ("bytes", "max_bytes", "nodes", "pinned_nodes", "outstanding_leases",
                        "capture_queue_depth"):
                gau(f"mlcomp_prefix_cache_{key}", f"Prefix KV cache {key.replace('_', ' ')}",
                    cs[key])

    def close(self, timeout: Optional[float] = 60.0) -> None:
        """Stop the loop thread, then fail everything still in flight.  Shared
        state is touched only after the thread has provably exited; if it
        does not exit within ``timeout`` (a dispatch wedged on the device)
        the engine is abandoned: submits fail, queued requests fail, and
        state the thread may still touch is left alone."""
        self._stop.set()
        self._queue.put(_POISON)  # wake a blocked queue.get NOW
        if self._dist is not None and not self._dist.is_coordinator:
            # a follower's loop blocks in the channel's recv, not the queue:
            # closing the channel is its poison pill
            self._dist.close()
        self._thread.join(timeout=timeout)
        if self._dist is not None:
            # the coordinator's loop sent the stop record on its way out;
            # release the sockets (idempotent)
            self._dist.close()
        if self._watchdog is not None:
            self._watchdog.join(timeout=5.0)
        if self.prefix_cache is not None:
            # drop queued captures and stop the cache's worker thread
            self.prefix_cache.close()
        err = RuntimeError("decode engine closed")
        if self._thread.is_alive():
            self._abandoned = True
            self._broken = RuntimeError("decode engine close timed out; step thread abandoned")
            self._unhealthy_reason = f"close() join timed out after {timeout}s"
            warnings.warn(f"decode engine close(): step thread did not exit within {timeout}s; "
                          "abandoning it", stacklevel=2)
            self._drain_queue(err)
            pr = self._profile
            if pr is not None:
                # fail the waiter; the wedged loop still owns any open window
                _fail_future(pr["future"], self._broken)
            return
        self._finish_profile(error=err)   # a backstop: the loop's own drain runs first
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
        if adm.page_lease is not None:
            # a dead admission must not pin its registry hit's pages
            adm.page_lease.release()
            adm.page_lease = None
        self._fail_queued(adm.req, err)

    def _drain_queue(self, err: Exception) -> None:
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is _POISON:
                continue
            if "ctrl" in req:
                _fail_future(req["future"], err)
            else:
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
        if req["rid"]:
            self.recorder.async_end("request", req["rid"], cat="req", error=True)
        _fail_future(req["future"], err)

    # ------------------------------------------------------ device work

    def _bucket(self, n: int) -> int:
        return _bucket(n, self.prompt_buckets, "prompt length")

    def _chunk_width(self, s_bucket: int) -> int:
        """The configured ``prefill_chunk`` when it divides the bucket,
        else one chunk for the whole bucket."""
        c = min(self.prefill_chunk, s_bucket)
        return s_bucket if s_bucket % c else c

    def _decode_steps(self, k: int, out: torch.Tensor, d: Optional[Dict[str, Any]] = None
                      ) -> None:
        """K single-token steps of every slot, in place on the device state
        (``d``, default the live one; warmup passes a throwaway state);
        step j's (tokens, logprobs, live) land in ``out[:, j]`` (3, K,
        slots).  A row whose budget or EOS lands mid-dispatch stops
        emitting and its cursor freezes; the state comes back with it
        inactive.  Nothing here waits for the device."""
        live_state = d is None
        d = self._d if live_state else d
        rows = torch.arange(d["active"].shape[0], device=self.device)
        cache = d["cache"] if self._layout is None else PagedKV(
            self._layout, d["pages"], d["table"])
        # host-side verdicts on work the steps may skip: the host view
        # holds every row the device may still have live
        reqs = [sl.req for sl in self._host if sl is not None] if live_state else []
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
            logits = self._forward_rows(tok[:, None], d["positions"][:, None], cache,
                                        d["cursors"], d["kv_start"])
            d["last_logits"].copy_(logits[:, -1])
            d["cursors"].copy_(torch.where(live, d["cursors"] + 1, d["cursors"]))
            d["positions"].copy_(torch.where(live, d["positions"] + 1, d["positions"]))
            out[0, j].copy_(tok)
            out[1, j].copy_(lp)
            out[2, j].copy_(live)
            live = live & ~done_now
        d["active"].copy_(live)

    def _spec_steps(self, out: torch.Tensor, d: Optional[Dict[str, Any]] = None) -> None:
        """One speculative VERIFY of every slot, in place on the device state
        (``d`` as in :meth:`_decode_steps`): each live row takes its greedy
        token 0, drafts ``spec_k`` more from its token history, scores all
        K+1 in one per-row-cursor forward (B4 dense, B7 paged), accepts the
        draft's agreeing prefix (cut at EOS and at the budget) and advances
        cursor, position, budget and history by the e tokens emitted; the
        next dispatch starts from the logits after the last of them.  The
        rejected positions' K/V lie past the new cursor, masked, and the
        next verify overwrites them.  Token j's logprob scores it against
        the logits before it.  (tokens, logprobs, valid) land in ``out``
        (3, K+1, slots).  Nothing here waits for the device."""
        d = self._d if d is None else d
        kk = self.spec_k
        dev = self.device
        ns = d["active"].shape[0]
        rows = torch.arange(ns, device=dev)
        cache = d["cache"] if self._layout is None else PagedKV(
            self._layout, d["pages"], d["table"])
        live0 = d["active"].clone()
        tok0 = torch.argmax(d["last_logits"], dim=-1)
        tok0 = torch.where(live0, tok0, torch.full_like(tok0, self.pad_id))
        prop = ngram_propose(d["ids"][:, : self.t_ids], d["ids_len"], tok0, kk, self.pad_id)
        seq = torch.cat([tok0[:, None], prop], dim=1)                  # (slots, K+1)
        j = torch.arange(kk + 1, device=dev)[None]
        lg = self.model(seq, positions=d["positions"][:, None] + j, cache=cache,
                        cache_cursor=d["cursors"], kv_start=d["kv_start"])  # (slots, K+1, V)
        greedy = torch.argmax(lg, dim=-1)
        accepted = torch.cumprod((prop == greedy[:, :kk]).long(), dim=1).sum(1)
        e = torch.minimum(accepted + 1, d["remaining"].long())
        eos_hit = (seq == d["eos"][:, None]) & (j < e[:, None])
        any_eos = eos_hit.any(dim=1)
        first = torch.argmax(eos_hit.int(), dim=1)
        e = torch.where(any_eos, torch.minimum(e, first + 1), e)
        e = torch.where(live0, e, torch.zeros_like(e))
        prevl = torch.cat([d["last_logits"][:, None], lg[:, :kk]], dim=1)
        lp = torch.log_softmax(prevl, dim=-1).gather(-1, seq[..., None])[..., 0]
        valid = j < e[:, None]
        # invalid lanes write the scratch column past the history
        write_idx = torch.where(valid, d["ids_len"].long()[:, None] + j,
                                torch.full_like(seq, self.t_ids))
        d["ids"].scatter_(1, write_idx, seq)
        e32 = e.to(torch.int32)
        d["ids_len"].add_(e32)
        d["cursors"].add_(e32)
        d["positions"].add_(e)
        d["remaining"].sub_(e32)
        d["active"].copy_(live0 & ~any_eos & (d["remaining"] > 0))
        d["last_logits"].copy_(lg[rows, torch.clamp(e - 1, min=0)])
        out[0].copy_(seq.T)
        out[1].copy_(lp.T)
        out[2].copy_(valid.T)

    def _dispatch_steps(self, k: int, out: torch.Tensor, d: Optional[Dict[str, Any]] = None
                        ) -> None:
        """The dispatch body: a verify on a speculative engine, else K
        decode steps."""
        if self.spec_k is not None:
            self._spec_steps(out, d)
        else:
            self._decode_steps(k, out, d)

    # ------------------------------------------------------------ warmup

    def warm_dispatch_fns(self) -> int:
        """Run one decode dispatch per rung of the K ladder (one verify on
        a speculative engine: B4, or B7 through pages) on a throwaway state
        (service warmup): every decode-path kernel launches (and builds, on
        a card) before the first request.  Nothing the drive loop owns is
        touched; it idles while this runs."""
        if self.prefill_only:
            return 0  # no decode dispatch ever issues
        with torch.inference_mode():
            d = self._fresh_dstate()
            for k in self.k_ladder:
                out = torch.zeros((3, self._rows_out(k), self.slots), device=self.device)
                self._dispatch_steps(k, out, d)
                out.cpu()   # wait until it ran
        return len(self.k_ladder)

    def _rows_out(self, k: int) -> int:
        """Packed rows a dispatch returns: K+1 for a verify, else K."""
        return self.spec_k + 1 if self.spec_k is not None else k

    def warm_fused_fns(self) -> int:
        """One fused dispatch per distinct chunk width on throwaway state
        (service warmup): K decode steps, then one (1, c) prefill chunk on
        a fresh admission-shaped cache."""
        if not self.fused_admission or self.prefill_only:
            return 0
        widths = sorted({self._chunk_width(s) for s in self.prompt_buckets})
        with torch.inference_mode():
            d = self._fresh_dstate()
            k = self.k_ladder[0]
            for c in widths:
                out = torch.zeros((3, self._rows_out(k), self.slots), device=self.device)
                self._dispatch_steps(k, out, d)
                cache = self.model.init_cache(1, self.l_buf)
                ids = torch.ones((1, c), dtype=torch.int64, device=self.device)
                pos = torch.arange(c, device=self.device)[None]
                start = torch.zeros((1,), dtype=torch.int32, device=self.device)
                self.model(ids, positions=pos, cache=cache, last_only=True,
                           kv_start=start).cpu()
        return len(widths)

    def warm_prefix_fns(self) -> int:
        """Run the host prefix cache's device paths once per chunk boundary
        of every bucket on a throwaway cache (service warmup): the capture
        of rows [k c, s) into host memory and the write of a hit's rows
        [0, k c).  Copies only, no model forward."""
        if self.prefix_cache is None:
            return 0
        n = 0
        with torch.inference_mode():
            cache = self.model.init_cache(1, self.l_buf)
            for s in self.prompt_buckets:
                c = self._chunk_width(s)
                for k in range(s // c):
                    stage_slot_rows(cache, k * c, s).rows()
                    n += 1
                    if k == 0:
                        continue  # a width-0 write cannot happen (no hit)
                    host = stage_slot_rows(cache, 0, k * c).rows()
                    write_slot_rows(cache, rows_to_device(host, cache, self.device), k * c)
                    n += 1
        return n

    def warm_registry_fns(self) -> int:
        """The paged layout's registry-hit gather (B8 on a card) once over
        the NULL page, read-only (service warmup): registry hits launch it
        mid-serving."""
        if self._pool is None:
            return 0
        t = self._pool.page_tokens
        with torch.inference_mode():
            ids = torch.zeros((1,), dtype=torch.int32, device=self.device)
            rows = self._layout.gather_row_span(self._d["pages"], ids, t)
            rows[0].cpu()
        return 1

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
        it are skipped, their slots never read.

        Paged: a placement-exact hit in the device prefix-page registry
        gathers the leased pages' rows [0, width) into the fresh admission
        cache (B8 on a card) and starts at the first uncached chunk; the
        hit is chunk-aligned and capped at len(ids) - 1, so the last
        token's chunk always runs and gives the sampling logits.  When the
        registry did not hit, the host prefix cache is asked the same way;
        its rows are uploaded and written by the same writer.  A fault in
        either lookup, or in the host rows' assembly or upload, degrades
        the admission to a cold prefill (``cache_degraded``); the gather
        and the write are device work and fail the request.  An IMPORT
        (``req["handoff"]``) is born complete: the completion boundary
        writes its pages and inserts the slot."""
        ids = req["ids"]
        rid, tid = req["rid"], req["trace_id"]
        warm = req.get("warmup", False)
        s_bucket = self._bucket(len(ids))
        c = self._chunk_width(s_bucket)
        if req.get("handoff") is not None:
            adm = _Admission(req, s_bucket, c, 0)
            adm.next_chunk = adm.n_chunks       # nothing to prefill
            adm.handoff = req["handoff"]
            if rid:
                self.recorder.async_instant("admit", rid, cat="req", bucket=s_bucket,
                                            imported=True, trace_id=tid)
            req["cache_hit_tokens"] = 0
            self._adm = adm
            return
        start_pad = s_bucket - len(ids)
        first_chunk = start_pad // c
        adm = _Admission(req, s_bucket, c, first_chunk)
        row, rmask = left_pad_row(ids, s_bucket, self.pad_id)
        positions = np.maximum(np.cumsum(rmask.astype(np.int64)) - 1, 0)
        adm.row = self._upload(row[None])
        adm.positions = self._upload(positions[None])
        adm.kv_start = self._upload(np.asarray([start_pad], np.int32))
        self._zero_adm_cache()
        self._adm_cache.index = first_chunk * c
        if rid:
            self.recorder.async_instant("admit", rid, cat="req", bucket=s_bucket, trace_id=tid)
        hit_tokens = 0
        cache_faulted = False
        t_lookup = time.perf_counter()
        if self._pool is not None and not warm:
            with self.recorder.span("kv_registry.lookup", track="engine.loop",
                                    prompt=len(ids), rid=rid, trace_id=tid) as sp:
                try:
                    _inject_fault("cache.lookup")
                    lease = self._pool.registry_lookup(s_bucket, start_pad, ids)
                except Exception as e:
                    cache_faulted = True
                    self._cache_degraded(rid, e)
                    lease = None
                if lease is not None:
                    # attached before the gather: every failure path releases it
                    adm.page_lease = lease
                    cached_chunk = (start_pad + min(lease.matched, len(ids) - 1)) // c
                    if cached_chunk > first_chunk:
                        width = cached_chunk * c
                        n_pages = -(-width // self._pool.page_tokens)
                        try:
                            page_ids = self._upload(np.asarray(lease.entries[:n_pages],
                                                               np.int32))
                            self._write_prefix_rows(adm, self._layout.gather_row_span(
                                self._d["pages"], page_ids, width), width)
                        except BaseException:
                            # the request fails (the caller fails it); the
                            # lease must not pin its pages
                            lease.release()
                            adm.page_lease = None
                            raise
                        hit_tokens = width - start_pad
                    else:
                        lease.release()
                        adm.page_lease = None
                sp["hit_tokens"] = hit_tokens
            self._stats["kv_registry_hit_tokens"] += hit_tokens
        if (not hit_tokens and not cache_faulted and self.prefix_cache is not None
                and not warm):
            rows = None
            try:
                with self.recorder.span("prefix_cache.lookup", track="engine.loop",
                                        prompt=len(ids), rid=rid, trace_id=tid) as sp:
                    lease = self.prefix_cache.lookup(ids)
                    if lease is not None:
                        try:
                            adm.skip_capture = lease.tokens >= len(ids)
                            cached_chunk = (start_pad + min(lease.tokens, len(ids) - 1)) // c
                            if cached_chunk > first_chunk:
                                width = cached_chunk * c
                                host = self.prefix_cache.assemble(lease, width, start_pad,
                                                                  width - start_pad)
                                rows = rows_to_device(host, self._adm_cache, self.device)
                        finally:
                            lease.release()
                    sp["hit_tokens"] = 0 if rows is None else width - start_pad
            except Exception as e:
                rows = None
                adm.skip_capture = False
                self._cache_degraded(rid, e)
            if rows is not None:
                self._write_prefix_rows(adm, rows, width)
                hit_tokens = width - start_pad
                self.prefix_cache.record_hit(hit_tokens)
        req["cache_hit_tokens"] = hit_tokens
        if any(s is not None for s in self._host):
            # the lookups, and a hit's gather or upload, ran on the loop
            # thread with rows decoding: that wall is admission stall
            adm.stall_ms += (time.perf_counter() - t_lookup) * 1e3
        adm.capture_lo = adm.next_chunk * c
        self._adm = adm

    def _write_prefix_rows(self, adm: _Admission, rows, width: int) -> None:
        """A prefix hit's rows [0, width) into the admission cache, and the
        admission's start at the first uncached chunk: the one writer for
        registry and host-cache hits alike."""
        write_slot_rows(self._adm_cache, rows, width)
        self._adm_cache.index = width
        adm.next_chunk = width // adm.chunk

    def _cache_degraded(self, rid: int, err: Exception) -> None:
        self._stats["cache_degraded"] += 1
        self.recorder.instant("cache_degraded", track="engine.loop", rid=rid,
                              error=f"{type(err).__name__}: {err}")

    def _zero_adm_cache(self) -> None:
        for layer in self._adm_cache.layers:
            for t in vars(layer).values():
                t.zero_()

    def _run_admission_chunk(self) -> None:
        """One STAGED chunk at a drained boundary (``fused_admission=False``,
        or no decode rows to ride); completes the admission after its last
        chunk."""
        adm = self._adm
        decoding = any(s is not None for s in self._host)
        t0 = self._busy_since = time.perf_counter()
        try:
            with self.recorder.span("prefill_chunk", track="engine.loop", chunk=adm.next_chunk,
                                    of=adm.n_chunks, rid=adm.req["rid"], fused=False,
                                    trace_id=adm.req["trace_id"]):
                self._run_chunk(adm)
        finally:
            self._busy_since = None
        if decoding:
            # a staged chunk with rows decoding IS the stall fusing removes
            adm.stall_ms += (time.perf_counter() - t0) * 1e3
        if adm.next_chunk >= adm.n_chunks:
            self._complete_admission()

    def _complete_admission(self) -> None:
        """The final admission boundary: insert the prefilled row at a free
        slot.  The caller drained the pipeline (the slot comes from the host
        view, which must be fresh)."""
        adm = self._adm
        decoding = any(s is not None for s in self._host)
        t0 = self._busy_since = time.perf_counter()
        try:
            if adm.handoff is not None:
                self._insert_import(adm)
            elif self.prefill_only:
                self._export_admission(adm)
            else:
                self._insert_admission(adm)
        finally:
            self._busy_since = None
        if decoding:
            adm.stall_ms += (time.perf_counter() - t0) * 1e3
        self._hist_stall.observe(adm.stall_ms)
        if adm.fused_any:
            self._stats["admissions_overlapped"] += 1
        self._stats["prefills"] += 1
        self._adm = None

    def _capture(self, adm: _Admission) -> None:
        """Queue the finished prefill's new rows for the host prefix cache
        (best effort: a fault here counts in ``cache_degraded`` and never
        fails the request).  The rows [capture_lo, s_bucket) leave the
        admission cache HERE, before the next admission zeroes it: queued
        copies into pinned host memory behind an event on a card
        (``stage_slot_rows``); the worker waits on the event, trims and
        inserts off the loop thread."""
        req = adm.req
        if self.prefix_cache is None or req.get("warmup") or adm.skip_capture:
            return
        try:
            staged = stage_slot_rows(self._adm_cache, adm.capture_lo, adm.s_bucket)
            self.prefix_cache.insert_async(StagedRows.rows, staged, req["ids"],
                                           adm.s_bucket - len(req["ids"]), adm.capture_lo)
        except Exception:
            self._stats["cache_degraded"] += 1

    def _insert_admission(self, adm: _Admission) -> None:
        req = adm.req
        s_bucket = adm.s_bucket
        self._capture(adm)
        slot = self._host.index(None)
        span = None
        with self.recorder.span("insert", track="engine.loop", slot=slot, rid=req["rid"],
                                trace_id=req["trace_id"]):
            if self._pool is None:
                for dst, src in zip(self._d["cache"].layers, self._adm_cache.layers):
                    for name, t in vars(dst).items():
                        t[slot].copy_(getattr(src, name)[0])
            else:
                try:
                    span = self._insert_pages(slot, s_bucket, req["ids"], req["n_new"],
                                              adm.page_lease, register=not req.get("warmup"))
                finally:
                    if adm.page_lease is not None:
                        adm.page_lease.release()
                        adm.page_lease = None
        self._set_row(slot, req, adm.last_logits[0], req["rid"])
        sl = _Slot(req, remaining=req["n_new"], cursor=s_bucket)
        if span is not None:
            sl.span_end, sl.alloc_upto = span
        self._host[slot] = sl

    def _set_row(self, slot: int, req, last_logits: torch.Tensor, rseed: int) -> None:
        """A fresh decode row at ``slot``: the prompt's last logits, its
        presence row (only the penalty reads it), cursors and knobs."""
        d = self._d
        ids = req["ids"]
        s_bucket = self._bucket(len(ids))
        d["last_logits"][slot].copy_(last_logits)
        d["presence"][slot].zero_()
        if req["repetition_penalty"] != 1.0:
            d["presence"][slot, self._upload(np.asarray(ids, np.int64))] = True
        for key, value in (("cursors", s_bucket), ("positions", len(ids)),
                           ("kv_start", s_bucket - len(ids)), ("remaining", req["n_new"]),
                           ("eos", req["eos_id"]), ("t", req["temperature"]),
                           ("k", req["top_k"]), ("p", req["top_p"]),
                           ("rp", req["repetition_penalty"]), ("rseed", rseed)):
            d[key][slot] = value
        if self.spec_k is not None:
            # the token history seeds the draft: the prompt's real ids
            hist = np.zeros(self.t_ids + 1, np.int64)
            hist[: len(ids)] = ids
            d["ids"][slot].copy_(self._upload(hist))
            d["ids_len"][slot] = len(ids)
        d["active"][slot] = True

    # --------------------------------------------- disaggregated handoff

    def _export_admission(self, adm: _Admission) -> None:
        """Prefill-only completion: feed the host prefix cache, slice the
        finished admission cache's prompt rows from the page holding
        ``start_pad`` to the bucket end, tile them into page payloads, and
        resolve the request's future with the serialized handoff, encoded
        with the last real token's logits.  Faults here fail this request
        only (the ``engine.export`` fault point models a replica dying
        mid-transfer)."""
        req = adm.req
        ids = req["ids"]
        s_bucket = adm.s_bucket
        t = self._export.page_tokens
        start_pad = s_bucket - len(ids)
        # a prefill replica is where the host prefix cache earns its RAM:
        # every request is an admission, and its rows feed the trie
        self._capture(adm)
        lo_page = (start_pad // t) * t
        rid = req["rid"]
        _inject_fault("engine.export")
        with self.recorder.span("handoff_export", track="engine.loop", rid=rid,
                                trace_id=req["trace_id"], prompt=len(ids)) as sp:
            blob, meta = self._encode_export(adm, start_pad, lo_page)
            sp["pages"] = meta["n_pages"]
            sp["bytes"] = len(blob)
        warm = req.get("warmup")
        if not warm:
            self._stats["handoffs_exported"] += 1
            self._stats["kv_pages_exported"] += meta["n_pages"]
            self._stats["handoff_bytes_exported"] += len(blob)
        now = time.perf_counter()
        if not warm:
            # the handoff wall is this request's service time on the
            # prefill replica: the TTFT reservoir reads prefill latency
            ttft_ms = (now - req["t_submit"]) * 1e3
            self._lat_ttft.append(ttft_ms)
            self._lat_ttft_n += 1
            self._hist_ttft.observe(ttft_ms)
        if rid:
            self._cancelled.discard(rid)
            self.recorder.async_end("request", rid, cat="req", exported=True)
        _set_result(req["future"], {
            "handoff": blob, "prefill_tokens": len(ids), "pages": meta["n_pages"],
            "cache_hit_tokens": int(req.get("cache_hit_tokens", 0)),
            "latency_ms": round((now - req["t_submit"]) * 1e3, 2),
            "trace_id": req["trace_id"],
        })

    def _encode_export(self, adm: _Admission, start_pad: int, lo_page: int):
        """The handoff blob of a finished prefill: the admission cache's
        prompt rows from ``lo_page`` to the bucket end as page tiles, with
        the last real token's logits.  Returns (blob, meta)."""
        layout = self._export
        t = layout.page_tokens
        req, s_bucket = adm.req, adm.s_bucket
        ids = req["ids"]
        rid = req["rid"]
        payloads = []
        for spec in layout.kv_specs:
            leaf = getattr(self._adm_cache.layers[spec.layer], spec.field)
            rows = leaf.narrow(spec.slot_axis, lo_page, s_bucket - lo_page)
            payloads.append(rows_to_page_tiles(rows, spec.slot_axis, t).cpu())
        meta = {
            "s_bucket": s_bucket, "start_pad": start_pad, "page_tokens": t,
            "n_pages": (s_bucket - lo_page) // t,
            "ids": [int(x) for x in ids],
            "n_new": int(req["n_new"]),
            # the per-request sampling-stream seed, so that a sampled
            # request decodes the same on any replica built with the same
            # engine seed (greedy never reads it)
            "rseed": rid % (1 << 23),
            "trace_id": req["trace_id"],
            "req": {"temperature": req["temperature"], "top_k": req["top_k"],
                    "top_p": req["top_p"], "eos_id": req["eos_id"],
                    "logprobs": req["logprobs"],
                    "repetition_penalty": req["repetition_penalty"]},
            "leaves": [{"key": spec.keystr} for spec in layout.kv_specs],
        }
        return encode_handoff(meta, adm.last_logits.float().cpu(), payloads), meta

    def _insert_import(self, adm: _Admission) -> None:
        """Insert an IMPORTED prefill at a free slot: allocate the slot's
        pages (prompt span plus one dispatch of decode lookahead, the local
        insert's currency, with its reclaim-then-retry), zero-fill the
        decode-span pages from a zeroed admission cache (a recycled page
        must not leak another stream's bytes into the masked-but-readable
        span), write the payload tiles into the prompt pages
        (``index_copy_``), register them under the placement key, and take
        token 0 from the handoff's logits.  Nothing leaks on any failure
        path: the uncommitted row is released."""
        hd = adm.handoff
        meta = hd["meta"]
        req = adm.req
        pool, layout = self._pool, self._layout
        t = pool.page_tokens
        ids = req["ids"]
        s_bucket = adm.s_bucket
        slot = self._host.index(None)
        start_pad, span_end = self._slot_span(s_bucket, len(ids), req["n_new"])
        alloc_end = self._alloc_end(s_bucket, span_end)
        row, mask = self._build_row(start_pad, span_end, alloc_end, None)
        p0, p_n = start_pad // t, s_bucket // t
        # the prompt pages route to the graveyard here: the payload write
        # below fills them
        wsel = np.where(mask, row, GRAVE_PAGE).astype(np.int32)
        wsel[p0:p_n] = GRAVE_PAGE
        try:
            with self.recorder.span("import", track="engine.loop", slot=slot, rid=req["rid"],
                                    pages=p_n - p0, trace_id=req["trace_id"]):
                self._zero_adm_cache()
                pages = self._d["pages"]
                layout.insert_rows(pages, self._upload(wsel), self._adm_cache)
                dst = self._upload(row[p0:p_n].astype(np.int64))
                for pg, pl in zip(pages, hd["payloads"]):
                    pg.index_copy_(0, dst, pl.to(self.device, non_blocking=self._cuda))
                self._d["table"][slot].copy_(self._upload(row))
        except Exception:
            pool.release_row(row)
            raise
        pool.commit_slot_row(slot, row)
        pool.registry_register(s_bucket, start_pad, ids, row)
        adm.handoff = None      # drop the payload buffers
        self._set_row(slot, req, hd["logits"][0].to(self.device),
                      int(meta.get("rseed", 0)) % (1 << 23))
        sl = _Slot(req, remaining=req["n_new"], cursor=s_bucket)
        sl.span_end, sl.alloc_upto = span_end, -(-alloc_end // t) * t
        self._host[slot] = sl
        self._stats["handoffs_imported"] += 1
        self._stats["kv_pages_imported"] += p_n - p0
        self._stats["handoff_bytes_imported"] += int(hd.get("bytes", 0))

    # ------------------------------------------------------------ paging

    def _build_row(self, start_pad: int, span_end: int, alloc_end: int, lease):
        """``pool.build_slot_row``, evicting LRU registry pins down to the
        PRIVATE shortfall and retrying once when the free list is short
        (shared mappings cost no pages, so reclaiming for the worst case up
        front would evict the registry even where sharing covers the gap).
        Returns (row, write mask)."""
        pool = self._pool
        try:
            row, mask, _ = pool.build_slot_row(start_pad, span_end, shared=lease,
                                               alloc_end=alloc_end)
        except NoFreePages:
            pool.reclaim(pool.private_pages_needed(start_pad, span_end, shared=lease,
                                                   alloc_end=alloc_end))
            row, mask, _ = pool.build_slot_row(start_pad, span_end, shared=lease,
                                               alloc_end=alloc_end)
        return row, mask

    def _insert_pages(self, slot: int, s_bucket: int, ids: Sequence[int], n_new: int,
                      lease=None, register: bool = True):
        """The paged insert: compose the slot's table row (NULL for pad and
        beyond-allocation pages, the registry hit's pages shared
        copy-on-write, private pages for the rest of the prefill span plus
        one dispatch of lookahead), write the admission cache into the
        private pages only (everything else routes to GRAVE), flip the
        slot's device table row, and pin the prompt's prefix pages in the
        registry.  All or nothing: ``NoFreePages`` here (lazy growth of the
        running rows took the pages the gate saw) fails the joiner and
        leaks nothing.  Returns the row's (span end, page-aligned allocated
        end)."""
        pool = self._pool
        start_pad, span_end = self._slot_span(s_bucket, len(ids), n_new)
        alloc_end = self._alloc_end(s_bucket, span_end)
        row, mask = self._build_row(start_pad, span_end, alloc_end, lease)
        try:
            wsel = np.where(mask, row, GRAVE_PAGE).astype(np.int32)
            self._layout.insert_rows(self._d["pages"], self._upload(wsel), self._adm_cache)
            self._d["table"][slot].copy_(self._upload(row))
        except Exception:
            pool.release_row(row)
            raise
        pool.commit_slot_row(slot, row)
        if register:
            # the NEXT same-placement prompt that shares this prefix maps
            # these pages with no prefill of them at all (warmup's dummy
            # prompts stay out)
            pool.registry_register(s_bucket, start_pad, ids, row)
        t = pool.page_tokens
        return span_end, -(-alloc_end // t) * t

    def _slot_span(self, s_bucket: int, n_ids: int, n_new: int) -> Tuple[int, int]:
        """A slot's WRITE span in cache-slot coordinates: from the left-pad
        boundary to the budget plus the scratch slot a retired row's frozen
        cursor still writes (a verify widens it by K).  Pages wholly inside
        the pad prefix (or past the span) map NULL and cost nothing."""
        return s_bucket - n_ids, s_bucket + int(n_new) + (
            self.spec_k + 1 if self.spec_k is not None else 1)

    def _steps_hi(self) -> int:
        """Cache slots one dispatch may advance a row at most (K steps, or
        the K+1 positions of a verify): the lazy allocator's lookahead
        unit."""
        return self.spec_k + 1 if self.spec_k is not None else self.steps_per_dispatch

    def _alloc_end(self, s_bucket: int, span_end: int) -> int:
        """The span the INSERT backs with pages: the prefill plus one
        dispatch of decode lookahead; the rest is allocated lazily."""
        return min(span_end, s_bucket + self._steps_hi() + 1)

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
        need = self._pages_initial(req)
        if need > self._pages_available(need):
            return None
        return self._pending.popleft()

    def _pages_available(self, need: int) -> int:
        """Free pages, counting the registry's reclaimable pins only when
        the free list alone falls short (the reclaimable scan walks the
        whole registry)."""
        free = self._pool.alloc.free_pages
        if need <= free:
            return free
        return free + self._pool.reclaimable_pages()

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
        lookahead = sum(inf.k for inf in self._inflight) + self._steps_hi() + 1
        grew = False
        for i, sl in enumerate(self._host):
            if sl is None or sl.span_end is None:
                continue
            target = min(sl.span_end, sl.cursor + lookahead)
            if target <= sl.alloc_upto:
                continue
            p0, p1 = sl.alloc_upto // t, -(-target // t)
            try:
                try:
                    pool.extend_slot_row(i, p0, p1)
                except NoFreePages:
                    # registry pins are cache, not commitments
                    pool.reclaim(p1 - p0)
                    pool.extend_slot_row(i, p0, p1)
            except NoFreePages:
                self._stats["kv_decode_page_failures"] += 1
                self.recorder.instant("kv_page_exhausted", track="engine.loop", slot=i,
                                      rid=sl.req["rid"])
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
        rows = ns2 * (self.spec_k + 1) if self.spec_k is not None else ns2
        if self._int8_kernel and rows > GEMV_ROWS and not self._fatblock_scale_warned:
            self._fatblock_scale_warned = True
            warnings.warn(f"elastic scale-up to {ns2} slots puts {rows} rows through the int8 "
                          f"kernels, past the fat-block decode boundary (GEMV_ROWS = "
                          f"{GEMV_ROWS}): dispatches at this width leave the decode kernel for "
                          "the tiled path; cap max_slots (or spec_k) to keep the row count "
                          "within budget", stacklevel=2)
        self._busy_since = time.perf_counter()
        try:
            with self.recorder.span("scale_slots", track="engine.loop", frm=ns, to=ns2):
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
            need = self._pages_initial(self._pending[0])
            if need <= self._pages_available(need):
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
        seq = next(self._dispatch_seq)
        # lazy page growth first: this dispatch and those in flight must
        # find every slot they can write backed by a page
        self._lazy_extend_tick()
        k, ns = self.steps_per_dispatch, len(self._host)
        r = self._rows_out(k)
        n = 3 * r * ns
        dev = self._ring_dev[self._ring_i][:n].view(3, r, ns)
        host = self._ring_host[self._ring_i][:n].view(3, r, ns)
        self._ring_i = (self._ring_i + 1) % len(self._ring_dev)
        self._busy_since = time.perf_counter()
        event = None
        rec = self.recorder
        try:
            # the engine.dispatch fault point: raise = a dispatch exception
            # (the loop fails everything and dies cleanly), sleep = a wedged
            # dispatch (the watchdog's clock is already running)
            _inject_fault("engine.dispatch")
            if fused is not None:
                # the dispatch's lifetime span opens before the issue, so
                # that the fused chunk's span nests inside it
                rec.async_begin("dispatch", seq, cat="disp", inflight=len(self._inflight) + 1,
                                fused=True)
            with rec.span("issue", track="engine.loop", seq=seq,
                          **({"fused": True} if fused is not None else {})):
                self._dispatch_steps(k, dev)
                if self._cuda:
                    host.copy_(dev, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record()
                else:
                    host.copy_(dev)
                if fused is not None:
                    with rec.span("prefill_chunk", track="engine.loop", chunk=fused.next_chunk,
                                  of=fused.n_chunks, rid=fused.req["rid"], fused=True, seq=seq,
                                  trace_id=fused.req["trace_id"]):
                        self._run_chunk(fused)
                    fused.fused_any = True
                    self._stats["fused_chunks"] += 1
        finally:
            self._busy_since = None
        pr = self._profile
        if pr is not None and pr["profiler"].active:
            # the capture window's dispatch families
            fam = self._family_name(fused.chunk if fused is not None else None)
            pr["families"][fam] = pr["families"].get(fam, 0) + 1
        # each dispatch carries the slots it may advance a row: the lazy
        # page allocator prices the in-flight window by it
        self._inflight.append(_Inflight(host, event, time.perf_counter(), self._steps_hi(), seq))
        self._dispatches_by_k[k] = self._dispatches_by_k.get(k, 0) + 1
        p = self._pstats
        p["issued"] += 1
        p["inflight_sum"] += len(self._inflight)
        p["peak_inflight"] = max(p["peak_inflight"], len(self._inflight))
        if fused is None:
            # the dispatch's lifetime (issue -> outputs read) as an async
            # span: at depth 2 dispatch N+1's span nests inside N's
            rec.async_begin("dispatch", seq, cat="disp", inflight=len(self._inflight))

    def _process_oldest(self) -> None:
        """Wait for the OLDEST in-flight dispatch's tokens and run the host
        half: stream and record its tokens, retire finished rows.  FIFO
        order keeps step numbering, stream order and retirement identical
        at any pipeline depth."""
        inf = self._inflight.popleft()
        t_block = time.perf_counter()
        self._busy_since = t_block
        try:
            _inject_fault("engine.resolve")  # sleep = a slow readback
            # the resolve span's duration is the blocked wait; the time the
            # pipeline hid (issue -> block) rides as an arg
            with self.recorder.span("resolve", track="engine.loop", seq=inf.seq,
                                    hidden_ms=round((t_block - inf.t_issue) * 1e3, 3)):
                if inf.event is not None:
                    inf.event.synchronize()
                arr = inf.host.numpy().copy()
        finally:
            self._busy_since = None
        t_done = time.perf_counter()
        p = self._pstats
        p["hidden_ms"] += (t_block - inf.t_issue) * 1e3
        p["wait_ms"] += (t_done - t_block) * 1e3
        pr = self._profile
        if pr is not None and pr["profiler"].active:
            # the card finished this dispatch now: where an open capture
            # window's wall ends (not at the later boundary, which may have
            # blocked in the idle queue pump)
            pr["t_last"] = t_done
        self.recorder.async_end("dispatch", inf.seq, cat="disp")
        toks = arr[0].astype(np.int64)
        lps = arr[1]
        valid = arr[2] > 0.5
        self._stats["dispatches"] += 1
        # device forwards: a verify is ONE however many rows it packs
        self._stats["steps"] += 1 if self.spec_k is not None else toks.shape[0]
        self._stats["emitted_tokens"] += int(valid.sum())
        if self.spec_k is not None:
            # a live row emits >= 1 token a verify: rows with any valid
            # token are the verify's live row-forwards
            self._stats["spec_rows"] += int(valid.any(axis=0).sum())
            self._maybe_warn_spec_loss()
        for kk in range(toks.shape[0]):
            self.step_count += 1
            for i, sl in enumerate(self._host):
                if sl is None or not valid[kk, i]:
                    continue
                tok, lp = int(toks[kk, i]), float(lps[kk, i])
                if sl.t_first is None:
                    sl.t_first = t_done
                    if sl.req["rid"]:
                        self.recorder.async_instant("first_token", sl.req["rid"], cat="req")
                sl.emitted.append((tok, lp))
                if sl.req["stream"] is not None:
                    sl.req["stream"].put({"token": tok, "logprob": round(lp, 5),
                                          "step": self.step_count})
                sl.cursor += 1
                sl.remaining -= 1
                if sl.remaining <= 0 or tok == sl.req["eos_id"]:
                    self._finish(i)
                    self._release_slot_pages(i)

    def _maybe_warn_spec_loss(self) -> None:
        """Warn once, and set the sticky ``spec_ineffective``, when measured
        acceptance past 64 row-forwards is at most one token a row a verify:
        every verify then emitted what a plain step would, at K+1 the
        width."""
        if self._spec_warned or self._stats["spec_rows"] < 64:
            return
        acc = self._stats["emitted_tokens"] / self._stats["spec_rows"]
        if acc <= 1.0 + 1e-6:
            self._spec_warned = True
            self._spec_ineffective = True
            warnings.warn(f"speculative decoding (spec_k={self.spec_k}) is a measured net LOSS "
                          f"on this traffic: acceptance {acc:.2f} tokens/row/forward over "
                          f"{self._stats['spec_rows']} row-forwards; every verify forward emits "
                          "no more than a plain decode step while paying the K+1-wide cost; "
                          "drop --engine-spec-k (spec_net_gain in stats() / /healthz tracks "
                          "this live)", stacklevel=2)

    def _drain_inflight(self) -> None:
        """Resolve every in-flight dispatch (the recorded join drain), at
        loop level only: a dispatch failure here is engine-level."""
        if not self._inflight:
            return
        with self.recorder.span("join_drain", track="engine.loop", inflight=len(self._inflight)):
            while self._inflight:
                self._process_oldest()

    def _finish(self, slot_idx: int, error: Optional[Exception] = None) -> None:
        sl = self._host[slot_idx]
        self._host[slot_idx] = None
        if sl is None:
            return
        req = sl.req
        rid = req["rid"]
        self._cancelled.discard(rid)
        if req["future"].done():
            return  # the watchdog failed it and closed its stream
        if req["stream"] is not None:
            req["stream"].put(None)
        if error is not None:
            if rid:
                self.recorder.async_end("request", rid, cat="req", error=True)
            _fail_future(req["future"], error)
            return
        now = time.perf_counter()
        if rid:
            self.recorder.async_end("request", rid, cat="req", tokens=len(sl.emitted))
        if sl.t_first is not None and not req.get("warmup"):
            ttft_ms = (sl.t_first - req["t_submit"]) * 1e3
            self._lat_ttft.append(ttft_ms)
            self._lat_ttft_n += 1
            self._hist_ttft.observe(ttft_ms)
            n = len(sl.emitted)
            if n > 1:
                tok_ms = (now - sl.t_first) * 1e3 / (n - 1)
                self._lat_tok.append(tok_ms)
                self._hist_tok.observe(tok_ms)
        result = {
            "ids": [t for t, _ in sl.emitted],
            "latency_ms": round((now - req["t_submit"]) * 1e3, 2),
            "batched_with": self.slots,
            "trace_id": req["trace_id"],
        }
        if self.prefix_cache is not None:
            # prompt tokens whose prefill the cache skipped (0 on a miss)
            result["cache_hit_tokens"] = int(req.get("cache_hit_tokens", 0))
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
            if self._dist is not None and self._dist.is_coordinator:
                # whatever ended the coordinator's loop, the followers must not
                # wedge in recv: broadcast the stop record (best effort; a dead
                # channel shows them closed)
                try:
                    self._dist.send({"stop": True, "new": [], "ctrl": [], "retired": [],
                                     "k": self.steps_per_dispatch})
                except Exception:
                    pass
            # whatever ended the loop (close, an error, a watchdog verdict),
            # nothing may be left waiting on a future this thread will never
            # resolve; unread in-flight outputs are dropped
            err = self._broken or RuntimeError("decode engine closed")
            self._inflight.clear()
            # an armed or open capture dies with the loop: close the window,
            # fail its future; never a dangling profiler session
            self._finish_profile(error=err)
            for i in range(len(self._host)):
                self._finish(i, error=err)
            self._fail_admission(err)
            self._drain_pending(err)
            self._drain_queue(err)

    def _pump_queue(self, block_s: float = 0.0):
        """Move everything parked in the submit queue into ``_pending``;
        block up to ``block_s`` for the first item when idle.  Returns the
        requests moved and the control items (``warm_on_loop``) met."""
        new: List[Dict[str, Any]] = []
        ctrls: List[Dict[str, Any]] = []
        try:
            item = self._queue.get(timeout=block_s) if block_s else self._queue.get_nowait()
            while True:
                # skip poison pills and futures already failed by submit's
                # close race or the watchdog
                if item is not _POISON and not item["future"].done():
                    if "ctrl" in item:
                        ctrls.append(item)
                    else:
                        self._pending.append(item)
                        new.append(item)
                item = self._queue.get_nowait()
        except queue.Empty:
            pass
        return new, ctrls

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
        cancelled = isinstance(err, RequestCancelled)
        self._stats["cancelled" if cancelled else "deadline_exceeded"] += 1
        self.recorder.instant("cancel" if cancelled else "deadline", track="engine.loop",
                              rid=req["rid"])
        self._cancelled.discard(req["rid"])

    def _boundary_maintenance(self, block_s: float = 0.0, include_adm: bool = False):
        """Pump the submit queue, then retire queued and active requests
        whose deadline passed or whose rid was cancelled (and, with
        ``include_adm``, the admission: a gang retires only here).  An
        active row is deactivated on the device first (stream-ordered
        behind in-flight dispatches), then its slot freed.  Returns the
        requests pumped, the control items and the retirements made, as
        ``(rid, status)`` in order: what a gang's boundary record carries."""
        new, ctrls = self._pump_queue(block_s)
        retired: List[Tuple[int, str]] = []
        if (not self._pending and not self._cancelled and not (include_adm and self._adm)
                and all(s is None or s.req["t_deadline"] is None for s in self._host)):
            return new, ctrls, retired
        now = time.perf_counter()
        kept: Deque[Dict[str, Any]] = deque()
        for req in self._pending:
            err = self._retire_check(req, now)
            if err is None:
                kept.append(req)
            else:
                retired.append((req["rid"], err.status))
                self._count_retire(err, req)
                self._fail_queued(req, err)
        self._pending = kept
        for i, sl in enumerate(self._host):
            if sl is None:
                continue
            err = self._retire_check(sl.req, now)
            if err is None:
                continue
            retired.append((sl.req["rid"], err.status))
            self._retire_row(i, err)
        if include_adm and self._adm is not None:
            err = self._retire_check(self._adm.req, now)
            if err is not None:
                retired.append((self._adm.req["rid"], err.status))
                self._count_retire(err, self._adm.req)
                self._fail_admission(err)
        return new, ctrls, retired

    def _retire_row(self, i: int, err: Exception) -> None:
        """Retire the active row at slot ``i``: deactivated on the device,
        then its slot and pages freed."""
        self._count_retire(err, self._host[i].req)
        self._d["active"][i] = False
        self._d["remaining"][i] = 0
        self._finish(i, error=err)
        self._release_slot_pages(i)

    # ------------------------------------------------- distributed gang

    _WIRE_KEYS = ("ids", "n_new", "temperature", "top_k", "top_p", "eos_id", "logprobs",
                  "repetition_penalty", "rid", "trace_id", "warmup")

    def _wire_out(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """The JSON subset of a request the coordinator broadcasts: all the
        loop's device sequence depends on.  Futures, streams and wall-clock
        fields stay local; deadlines arrive as explicit retirements."""
        return {k: req[k] for k in self._WIRE_KEYS}

    def _wire_in(self, w: Dict[str, Any]) -> Dict[str, Any]:
        """A broadcast request on a follower: a fresh (unread) future, no
        stream, no local deadline; its device work is the point."""
        fut: Future = Future()
        fut.rid = w.get("rid", 0)
        fut.trace_id = w.get("trace_id")
        return {**{k: w[k] for k in self._WIRE_KEYS}, "future": fut, "stream": None,
                "t_submit": time.perf_counter(), "t_deadline": None}

    def warm_on_loop(self) -> Future:
        """A gang's warmup: the warm functions run ON the loop thread at a
        boundary, broadcast as a control record, so that every rank runs
        them at the same point of its dispatch sequence (a warm call on
        another thread would interleave its collectives with the loop's).
        Resolves to the number of warm runs."""
        if self._dist is None:
            raise RuntimeError("warm_on_loop is the distributed warmup path; single-card "
                               "services call the warm_* functions directly")
        if not self.is_coordinator:
            raise RuntimeError("warm_on_loop runs on the coordinator; followers replay the "
                               "broadcast control record")
        fut: Future = Future()
        self._queue.put({"ctrl": "warm", "future": fut})
        if self._stop.is_set() or self._broken is not None:
            # close() may have drained the queue between the checks and the put
            _fail_future(fut, self._broken or RuntimeError("decode engine closed"))
        return fut

    def _run_ctrl(self, kind: str, fut: Optional[Future] = None) -> None:
        if kind != "warm":
            raise RuntimeError(f"unknown ctrl record {kind!r}")
        self._busy_since = time.perf_counter()
        try:
            n = (self.warm_prefix_fns() + self.warm_dispatch_fns() + self.warm_fused_fns()
                 + self.warm_registry_fns())
        except BaseException as e:
            # the waiter sees the real error; the loop's own handling still runs
            if fut is not None:
                _fail_future(fut, e)
            raise
        finally:
            self._busy_since = None
        if fut is not None:
            _set_result(fut, n)

    def _apply_retired(self, retired) -> None:
        """A follower's half of the retirement broadcast: exactly the
        coordinator's retirements in its order; queued requests fail in
        place, active rows deactivate on the device in the same slot order,
        a retired admission ends mid-prefill."""
        for rid, status in retired:
            rid = int(rid)
            err: Exception = (RequestCancelled(f"request {rid} cancelled (broadcast)")
                              if status == RequestCancelled.status
                              else DeadlineExceeded(f"request {rid} exceeded its deadline "
                                                    "(broadcast)"))
            hit = next((req for req in self._pending if req["rid"] == rid), None)
            if hit is not None:
                self._pending.remove(hit)
                self._count_retire(err, hit)
                self._fail_queued(hit, err)
                continue
            adm = self._adm
            if adm is not None and adm.req["rid"] == rid:
                self._count_retire(err, adm.req)
                self._fail_admission(err)
                continue
            for i, sl in enumerate(self._host):
                if sl is not None and sl.req["rid"] == rid:
                    self._retire_row(i, err)
                    break

    def _sync_boundary(self, idle: bool) -> bool:
        """ONE gang boundary.  Coordinator: pump, sweep, pick K, broadcast
        the record, run its control items.  Follower: receive the record and
        replay it (enqueue the requests, perform the retirements, adopt K,
        run the control items).  Both then run the same rest of the loop
        body, whose admissions, chunks, inserts and dispatches are
        deterministic functions of the shared state, so every rank issues
        the same device sequence.  False: the gang is shutting down."""
        dist = self._dist
        if dist.is_coordinator:
            new, ctrls, retired = self._boundary_maintenance(block_s=0.2 if idle else 0.0,
                                                             include_adm=True)
            self._adaptive_tick()
            dist.send({"new": [self._wire_out(r) for r in new],
                       "ctrl": [c["ctrl"] for c in ctrls], "retired": retired,
                       "k": self.steps_per_dispatch})
            for c in ctrls:
                self._run_ctrl(c["ctrl"], c.get("future"))
            return True
        try:
            rec = dist.recv()
        except ChannelClosed:
            return False
        if rec.get("stop"):
            return False
        for w in rec.get("new", ()):
            self._pending.append(self._wire_in(w))
        self._apply_retired(rec.get("retired", ()))
        k2 = int(rec.get("k", self.steps_per_dispatch))
        if k2 != self.steps_per_dispatch:
            self.steps_per_dispatch = k2
            self._stats["dispatch_k_changes"] += 1
        for kind in rec.get("ctrl", ()):
            self._run_ctrl(kind)
        return True

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
            self.recorder.instant("dispatch_k_change", track="engine.loop", k=k2,
                                  queue_depth=depth, active=active)

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
        if self._adm is not None and self._dist is None:
            # a gang retires an admission only at the broadcast boundary: a
            # local clock check here would desequence it
            err = self._retire_check(self._adm.req)
            if err is not None:
                self._count_retire(err, self._adm.req)
                self._fail_admission(err)
        issued = False
        adm = self._adm
        if adm is not None and adm.next_chunk < adm.n_chunks:
            if self.fused_admission and any(s is not None for s in self._host):
                # the engine.fused_prefill fault point: host-side prep before
                # the combined issue fails only the admission, and the rows
                # ride a plain dispatch below
                try:
                    _inject_fault("engine.fused_prefill")
                except Exception as e:
                    self._fail_admission(e)
                else:
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
                if self._dist is not None:
                    # a gang: the boundary's admissions, retirements and K
                    # come through the coordinator's broadcast
                    if not self._sync_boundary(idle):
                        return
                else:
                    self._boundary_maintenance(block_s=0.2 if idle else 0.0)
                    self._adaptive_tick()
                # on-demand device capture: open or close its window here
                self._profile_tick()
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

    # ---------------------------------------------------- device capture

    def _family_name(self, fused_chunk: Optional[int]) -> str:
        """The dispatch family a capture attributes to: the K-step decode or
        the spec verify, with the fused chunk's width as a suffix when an
        admission chunk rode the dispatch."""
        base = (f"spec_verify_k{self.spec_k}" if self.spec_k is not None
                else f"decode_scan_k{self.steps_per_dispatch}")
        return base if fused_chunk is None else f"{base}+prefill_c{fused_chunk}"

    def _sync_device(self) -> None:
        if self._cuda:
            torch.cuda.synchronize(self.device)

    def _profile_tick(self) -> None:
        """Advance the armed or open capture at this boundary.  Open the
        window once there is device work to record (rows, an admission or
        queued requests), after the dispatches in flight resolved and the
        card went idle, so that the window holds exactly the launches made
        inside it; close it after N resolved dispatches (or early once the
        traffic drained, with what ran) behind a synchronize of the card.
        A capture's failure fails its future only; only the shared
        in-flight drains may raise out of here, and those are engine
        failures."""
        pr = self._profile
        if pr is None:
            return
        prof = pr["profiler"]
        if not prof.active:
            if not (self._adm is not None or self._pending
                    or any(s is not None for s in self._host)):
                return  # stay armed until traffic arrives
            self._drain_inflight()
            start_err: Optional[Exception] = None
            with self._prof_lock:
                if self._profile is not pr:
                    return  # cancelled between the read and the start
                try:
                    self._sync_device()
                    pr["launches0"] = launch_counts()
                    prof.step(0)
                except Exception as e:
                    start_err = e
            if start_err is not None:
                self._finish_profile(error=start_err)
                return
            pr["t0"] = time.perf_counter()
            pr["resolved0"] = self._stats["dispatches"]
            self.recorder.instant("profile_start", track="engine.loop", dispatches=pr["n"])
            return
        resolved = self._stats["dispatches"] - pr["resolved0"]
        idle = (not self._inflight and self._adm is None and not self._pending
                and all(s is None for s in self._host))
        if resolved < pr["n"] and not (idle and resolved > 0):
            if idle:
                # the traffic that opened the window retired before any
                # dispatch resolved: close and fail rather than hold the
                # profiler (and every later capture) until new traffic
                self._finish_profile(error=RuntimeError(
                    "capture window closed empty: the traffic that opened it was retired "
                    "before any dispatch resolved"))
            return
        self._drain_inflight()
        pr["resolved"] = self._stats["dispatches"] - pr["resolved0"]
        # t1 before the stop: writing the trace is neither launch cost nor
        # bubble, and must not inflate host_gap_ms
        self._busy_since = time.perf_counter()
        try:
            self._sync_device()
            pr["t1"] = time.perf_counter()
            pr["launches1"] = launch_counts()
            prof.close()
        except Exception as e:
            self._finish_profile(error=e)
            return
        finally:
            self._busy_since = None
        self._finish_profile()

    def _finish_profile(self, error: Optional[Exception] = None) -> None:
        """Complete (or abort) the capture: close its window if still open,
        attribute it on success, remove its directory when the engine made
        it, resolve its future.  Never raises: it runs on every teardown
        path."""
        with self._prof_lock:
            pr, self._profile = self._profile, None
        if pr is None:
            return
        try:
            pr["profiler"].close()  # idempotent; stops an open window
        except Exception as e:
            error = error or e
        if error is None and pr["future"].done():
            # the watchdog failed this waiter while the window was wedged:
            # its wall is stall-inflated, and no one reads it
            error = RuntimeError("capture discarded: its waiter was already failed "
                                 "(watchdog stall verdict stands)")
        attr = None
        if error is None:
            try:
                with self.recorder.span("profile_attribute", track="engine.loop",
                                        dispatches=pr.get("resolved")):
                    attr = self._attribute_capture(pr)
            except Exception as e:
                error = e
        if pr["owns_dir"]:
            shutil.rmtree(pr["dir"], ignore_errors=True)
        if error is not None:
            self.recorder.instant("profile_error", track="engine.loop",
                                  error=f"{type(error).__name__}: {error}")
            _fail_future(pr["future"], error)
            return
        self._last_attr = attr
        self._stats["profile_captures"] += 1
        per = attr.get("device_time_ms_per_dispatch")
        if per is not None:
            self._hist_device.observe(per)
        _set_result(pr["future"], attr)

    def _attribute_capture(self, pr: Dict[str, Any]) -> Dict[str, Any]:
        """Read the capture and split its window into device work and host
        gap, per dispatch family (a split pro rata by dispatch count: exact
        for the usual one-family window).  The window's wall ends at the
        last resolve's readback (``t_last``), not at the closing boundary,
        which may have blocked in the idle queue pump."""
        trace = devprof.load_trace(pr["profiler"].trace_path)
        wall_ms = ((pr.get("t_last") or pr["t1"]) - pr["t0"]) * 1e3
        att = devprof.attribution(trace, wall_ms=wall_ms, top_kernels=20)
        n = int(pr.get("resolved") or 0)
        att["dispatches"] = n
        att["requested_dispatches"] = pr["n"]
        att["launches"] = {k: pr["launches1"][k] - pr["launches0"][k] for k in pr["launches0"]}
        roof_ms = self._roofline_ms()
        att["hbm_gbps"] = self._hbm_gbps
        att["roofline_ms_per_dispatch"] = None if roof_ms is None else round(roof_ms, 4)
        dev, gap = att["device_time_ms"], att["host_gap_ms"]
        if n:
            per = dev / n
            util = round(roof_ms / per, 4) if roof_ms is not None and per > 0 else None
            att["device_time_ms_per_dispatch"] = round(per, 4)
            att["host_gap_ms_per_dispatch"] = round(gap / n, 4)
            att["roofline_utilization"] = util
            total = sum(pr["families"].values()) or 1
            # a family's own utilization only where it is exact (one family
            # in the window); the window's figure above stays measured
            fam_util = util if len(pr["families"]) == 1 else None
            att["families"] = {
                fam: {"dispatches": c, "device_time_ms": round(dev * c / total, 4),
                      "host_gap_ms": round(gap * c / total, 4),
                      "roofline_utilization": fam_util}
                for fam, c in sorted(pr["families"].items())}
        else:
            att["device_time_ms_per_dispatch"] = None
            att["host_gap_ms_per_dispatch"] = None
            att["roofline_utilization"] = None
            att["families"] = {}
        self._merge_device_track(trace, pr)
        return att

    def _merge_device_track(self, trace, pr: Dict[str, Any]) -> None:
        """Fold the capture's device spans into the flight recorder as the
        ``engine.device`` track, so that ``GET /trace`` shows the host's
        issue/resolve spans above the kernels they launched.  The earliest
        device event is anchored at the window's start on the recorder's
        clock (host and card share no epoch)."""
        spans, dropped = devprof.device_spans_us(trace)
        if not spans or pr.get("t0") is None:
            return
        base_us = self.recorder.to_trace_us(pr["t0"])
        for ts, dur, name in spans:
            self.recorder.complete(devprof.short_op(name), base_us + ts, dur,
                                   track="engine.device")
        self.recorder.instant("device_capture", track="engine.device",
                              dispatches=pr.get("resolved"), spans=len(spans), dropped=dropped)

    def _device_summary(self) -> Dict[str, Any]:
        """The device/host split behind ``stats()["device"]`` and the
        roofline gauges: the last capture's measured attribution when one
        exists, else the steady-state ESTIMATE (dispatch wall less the
        pipeline's measured hidden host work), honest only when the
        pipeline saturates; a capture is ground truth."""
        p = dict(self._pstats)
        done = self._stats["dispatches"]
        roof_ms = self._roofline_ms()
        ss = None
        if done:
            wall = (p["hidden_ms"] + p["wait_ms"]) / done
            host = p["hidden_ms"] / done
            dev_est = max(wall - host, 0.0)
            ss = {"dispatch_wall_ms": round(wall, 3), "host_overhead_ms": round(host, 3),
                  "device_time_ms_est": round(dev_est, 3),
                  "roofline_utilization_est": (round(roof_ms / dev_est, 4)
                                               if roof_ms is not None and dev_est > 0 else None)}
        cap = self._last_attr
        per = host_ms = util = None
        if cap is not None:
            per = cap.get("device_time_ms_per_dispatch")
            host_ms = cap.get("host_gap_ms_per_dispatch")
            util = cap.get("roofline_utilization")
            # stats() recurs on every scrape: the capture's summary numbers,
            # not its parse products (the full dict went to its caller)
            cap = {k: v for k, v in cap.items()
                   if k not in ("kernels", "planes", "device_lanes", "device_events")}
        if per is None and ss is not None:
            per = ss["device_time_ms_est"]
            host_ms = ss["host_overhead_ms"]
            util = ss["roofline_utilization_est"]
        return {
            "hbm_gbps": self._hbm_gbps,
            "roofline_bytes_per_dispatch": self._roofline_bytes(),
            "kv_bytes_moved_per_dispatch": self._kv_bytes_moved_per_dispatch(),
            "roofline_ms_per_dispatch": None if roof_ms is None else round(roof_ms, 4),
            "device_time_ms_per_dispatch": per,
            "host_overhead_ms_per_dispatch": host_ms,
            "roofline_utilization": util,
            "source": "capture" if cap is not None else "estimate" if ss is not None else None,
            "captures": self._stats["profile_captures"],
            "steady_state": ss,
            "last_capture": cap,
        }

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
        self.recorder.instant("watchdog_fire", track="engine.watchdog", stuck_s=round(stuck_s, 3))
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
            waiters += [r for r in self._queue.queue if isinstance(r, dict) and "ctrl" not in r]
        for req in waiters:
            if req["stream"] is not None and not req["future"].done():
                req["stream"].put(None)
            _fail_future(req["future"], err)
        # an armed or open capture is a waiter too; its window stays
        # loop-owned (the loop's _finish_profile loses this race)
        pr = self._profile
        if pr is not None:
            _fail_future(pr["future"], err)

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
        self.recorder.instant("watchdog_restart", track="engine.watchdog")
        self._exit_loop.clear()
        self._broken = None
        self._unhealthy_reason = None
        self._thread = threading.Thread(target=self._loop, daemon=True, name="engine-loop")
        self._thread.start()
        return True
