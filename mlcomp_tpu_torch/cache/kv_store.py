"""Host KV-block storage for the prefix cache: the counterpart of
mlcomp_tpu/cache/kv_store.py, in torch.

``prefix_index.py`` decides WHAT is cached; this module knows WHERE the
K/V rows live inside the engine's ``DecodeCache`` and moves them
device <-> host without breaking the engine's per-row cursor/start
contract.  Leaves are walked in ``kvpool/layout.py``'s order, with its
field -> flax-leaf and slot-axis tables (``FIELD_LEAVES``, ``SLOT_AXES``):

- bf16/f32 ``KVCache``: ``k``/``v`` (B, L, Hkv, dh), slot axis 1;
- int8 ``QuantKVCache``: ``kq``/``vq`` (B, Hkv, L, dhp) at slot axis 2
  and the bf16 scales ``ks``/``vs`` (B, Hkv, 1, L) at slot axis 3.

Each leaf is keyed by its flax path (``DecoderLayer_0/attn/cached_key``),
as the JAX cache pytree keys it.

Host blocks are numpy arrays of the leaves' shapes with the slot axis cut
to the token count, as in JAX.  numpy has no bfloat16 here (the port does
without ml_dtypes), so a bf16 leaf's rows are kept as their 2-byte words
(int16) and viewed back as bf16 on the way up: rows round-trip device ->
host -> device bit for bit, with no re-quantisation, so a repeated
prompt's tokens EQUAL its cold prefill's.  (A prefix shared at another
length may sit in another chunk than where its rows were computed: a
chunk at cache index 0 attends its fresh K/V, a later one the int8
cache, as in the JAX package, so those rows need not be bit-equal.)

Why token-indexed blocks transplant across requests at all: a cached row
holds K/V after RoPE, and the serving LEFT-pad contract gives real token
j position j whatever the bucket or pad width, so row j of a prefix is
the same bytes wherever the prefix lands.

The engine's admission cache is ONE static buffer, zeroed and refilled by
the next admission.  A capture therefore never hands the live buffer to
the worker: ``stage_slot_rows`` copies the rows out on the loop thread
(a non-blocking copy into pinned host memory behind a CUDA event on a
card, a clone on the CPU), and the worker only waits on that event.
"""

from __future__ import annotations

import queue
import threading
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mlcomp_tpu_torch.cache.prefix_index import PrefixIndex
from mlcomp_tpu_torch.kvpool.layout import FIELD_LEAVES, SLOT_AXES
from mlcomp_tpu_torch.utils.faults import inject
from mlcomp_tpu_torch.utils.trace import null_tracer


def kv_leaf_items(cache) -> List[Tuple[str, int, torch.Tensor]]:
    """Deterministic (keystr, slot_axis, leaf) list over a ``DecodeCache``
    (``PagedLayout.kv_specs``' order): the one order every capture,
    assemble and write shares.  An unknown field (a new cache layout)
    fails loudly rather than caching garbage."""
    items = []
    for li, layer in enumerate(cache.layers):
        for field, leaf in vars(layer).items():
            name = FIELD_LEAVES.get(field)
            if name is None:
                raise ValueError(f"unknown cache field {field!r}: teach kvpool/layout.py its "
                                 "leaf before prefix-caching this layout")
            items.append((f"DecoderLayer_{li}/attn/{name}", SLOT_AXES[name], leaf))
    return items


def slice_slot_rows(cache, lo: int, hi: int) -> Tuple[torch.Tensor, ...]:
    """Views of slot rows [lo, hi) of every KV leaf, in ``kv_leaf_items``
    order.  Views of the live buffer: copy them before it is reused."""
    return tuple(leaf.narrow(axis, lo, hi - lo) for _, axis, leaf in kv_leaf_items(cache))


def write_slot_rows(cache, rows: Sequence[torch.Tensor], width: int) -> None:
    """Write ``rows`` (``kv_leaf_items`` order, slot width ``width``) into
    slots [0, width) of every KV leaf, in place.  The one writer of a
    prefix hit's rows, whether they came from the device prefix-page
    registry or from host RAM.  Callers fill only the real prefix span;
    the zero filler lands on pad slots (never read) or slots the suffix
    chunks rewrite before any read."""
    items = kv_leaf_items(cache)
    assert len(items) == len(rows), (len(items), len(rows))
    for (_, axis, leaf), row in zip(items, rows):
        leaf.narrow(axis, 0, width).copy_(row)


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy: bf16 as its 2-byte words."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy()
    return t.numpy()


def rows_to_device(rows: Sequence[np.ndarray], cache, device) -> List[torch.Tensor]:
    """Host rows (``kv_leaf_items`` order) as tensors of each leaf's dtype
    on ``device``: bf16 leaves viewed back from their 2-byte words; on a
    card the upload goes through pinned memory without a stream sync."""
    cuda = torch.device(device).type == "cuda"
    out = []
    for (_, _, leaf), a in zip(kv_leaf_items(cache), rows):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if leaf.dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        if t.dtype != leaf.dtype:
            raise ValueError(f"host rows of dtype {t.dtype} for a {leaf.dtype} cache leaf")
        out.append(t.pin_memory().to(device, non_blocking=True) if cuda else t.to(device))
    return out


class StagedRows:
    """Rows taken out of the admission cache on the loop thread: host
    tensors (pinned on a card) filled by copies queued on the loop's
    stream, and the CUDA event behind them.  ``rows()`` (the capture
    worker) waits on the event and returns numpy arrays; it never touches
    the device buffer the rows came from."""

    __slots__ = ("host", "event")

    def __init__(self, host: List[torch.Tensor], event):
        self.host, self.event = host, event

    def rows(self) -> List[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [_host_array(t) for t in self.host]


def stage_slot_rows(cache, lo: int, hi: int) -> StagedRows:
    """Copy slot rows [lo, hi) of every KV leaf out of ``cache`` before
    the caller reuses it.  On a card: one non-blocking copy per leaf into
    pinned host memory, stream-ordered ahead of whatever the loop queues
    next (the next admission's zeroing), and an event recorded behind
    them.  On the CPU: a clone."""
    views = slice_slot_rows(cache, lo, hi)
    if not views or views[0].device.type != "cuda":
        return StagedRows([v.clone() for v in views], None)
    host = []
    for v in views:
        h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        h.copy_(v, non_blocking=True)
        host.append(h)
    event = torch.cuda.Event()
    event.record()
    return StagedRows(host, event)


class KVBlock:
    """Host copy of per-layer K/V rows for ``ntokens`` consecutive prefix
    tokens: ``{keystr: np.ndarray}`` keeping each leaf's full shape except
    the slot axis, which is the token count.  The ONLY methods the prefix
    index calls are ``slice``/``ntokens``/``nbytes``."""

    __slots__ = ("arrays", "axes", "ntokens", "nbytes")

    def __init__(self, arrays: Dict[str, np.ndarray], axes: Dict[str, int], ntokens: int):
        self.arrays = arrays
        self.axes = axes
        self.ntokens = int(ntokens)
        self.nbytes = int(sum(a.nbytes for a in arrays.values()))

    def slice(self, start: int, stop: int) -> "KVBlock":
        """Tokens [start, stop) as a new block, MATERIALIZED (the trie's
        edge splits call this; a view would keep the whole parent buffer
        alive and make eviction accounting a lie)."""
        out = {}
        for k, a in self.arrays.items():
            idx = [slice(None)] * a.ndim
            idx[self.axes[k]] = slice(start, stop)
            out[k] = np.ascontiguousarray(a[tuple(idx)])
        return KVBlock(out, dict(self.axes), stop - start)


def block_from_capture(rows, keys_axes: List[Tuple[str, int]], start: int,
                       n_tokens: int) -> KVBlock:
    """Trim captured host rows to the ``n_tokens`` real-token rows
    beginning at index ``start`` WITHIN the capture, and wrap as a
    KVBlock."""
    arrays, axes = {}, {}
    for (keystr, axis), arr in zip(keys_axes, rows):
        a = np.asarray(arr)
        idx = [slice(None)] * a.ndim
        idx[axis] = slice(start, start + n_tokens)
        arrays[keystr] = np.ascontiguousarray(a[tuple(idx)])
        axes[keystr] = axis
    return KVBlock(arrays, axes, n_tokens)


def assemble_prefix_rows(segments, keys_axes: List[Tuple[str, int]], width: int,
                         start_pad: int, n_tokens: int) -> List[np.ndarray]:
    """Host rows of slot width ``width`` (``write_slot_rows`` order) with
    the lease's first ``n_tokens`` cached tokens placed at slots
    [start_pad, start_pad + n_tokens) and zeros on the pad prefix.
    ``width`` is the engine's chunk-aligned hit boundary, so the upload
    moves only the prefix span, not the bucket."""
    first_block = segments[0][0]
    out = []
    for keystr, axis in keys_axes:
        proto = first_block.arrays[keystr]
        shape = list(proto.shape)
        shape[axis] = width
        buf = np.zeros(shape, proto.dtype)
        at = start_pad
        left = n_tokens
        for block, take in segments:
            if left <= 0:
                break
            take = min(take, left)
            src = block.arrays[keystr]
            sidx = [slice(None)] * src.ndim
            sidx[axis] = slice(0, take)
            didx = [slice(None)] * buf.ndim
            didx[axis] = slice(at, at + take)
            buf[tuple(didx)] = src[tuple(sidx)]
            at += take
            left -= take
        assert left == 0, (n_tokens, "lease shorter than requested span")
        out.append(buf)
    return out


class PrefixKVCache:
    """The engine-facing facade: PrefixIndex + layout glue + counters.

    One instance serves ONE engine (the block layout is the engine's cache
    layout); the engine loop thread calls lookup/insert_async, HTTP
    threads read ``stats()``; the index's lock covers both.

    Captures are ASYNCHRONOUS: the loop thread stages the rows
    (``stage_slot_rows``) and enqueues; a daemon worker waits for the
    copies, trims the rows into a block and inserts it into the trie.
    The queue is BOUNDED: under backlog new captures are dropped
    (``insert_dropped``) rather than pinning unbounded host memory.
    ``flush()`` drains the queue for deterministic tests and benches."""

    def __init__(self, max_bytes: int = 1 << 30):
        # the engine re-points this at its flight recorder so capture
        # spans land in the same trace (on the worker's own track)
        self.tracer = null_tracer()
        self.index = PrefixIndex(max_bytes)
        for key in ("used_hits", "used_hit_tokens", "insert_errors", "insert_dropped"):
            self.index.counters[key] = 0
        self._keys_axes: Optional[List[Tuple[str, int]]] = None
        self._q: "queue.Queue" = queue.Queue(maxsize=8)
        self._warned = False
        self._closed = False
        self._worker = threading.Thread(target=self._drain, daemon=True,
                                        name="prefix-kv-capture")
        self._worker.start()

    # engine admission path -------------------------------------------

    def bind_layout(self, cache) -> None:
        """Record the engine cache's leaf order/axes once; lookups before
        the first capture share it."""
        if self._keys_axes is None:
            self._keys_axes = [(k, ax) for k, ax, _ in kv_leaf_items(cache)]

    def lookup(self, ids):
        """Pinned longest-prefix lease for ``ids`` (or None).  The
        ``cache.lookup`` fault point: an armed raise here must be
        CONTAINED by the engine to a cold prefill, never a failed
        request."""
        inject("cache.lookup")
        return self.index.lookup(ids)

    def assemble(self, lease, width: int, start_pad: int, n_tokens: int) -> List[np.ndarray]:
        assert self._keys_axes is not None, "bind_layout before assemble"
        return assemble_prefix_rows(lease.segments, self._keys_axes, width, start_pad,
                                    n_tokens)

    def insert_async(self, capture_call, cache, ids, start_pad: int, capture_lo: int) -> None:
        """Queue a finished prefill's capture for the worker, which runs
        ``capture_call(cache)`` for the host rows (slot span
        [capture_lo, s_bucket)).  ``cache`` must not be a buffer the
        caller reuses: the engine passes ``StagedRows`` and its ``rows``."""
        if self._closed:
            return
        try:
            self._q.put_nowait((capture_call, cache, list(ids), start_pad, capture_lo))
        except queue.Full:
            with self.index._lock:
                self.index.counters["insert_dropped"] += 1

    def flush(self) -> None:
        """Block until every queued capture has been inserted (or failed)."""
        self._q.join()

    def close(self) -> None:
        """Drop queued captures and stop the worker.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
            self._q.task_done()
        self._q.put(None)  # wakes the worker; it exits on the sentinel

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            capture_call, cache, ids, start_pad, lo = item
            try:
                # the cache.capture fault point: an armed raise lands in
                # the except below (insert_errors; serving goes on uncached)
                inject("cache.capture")
                with self.tracer.span("prefix_cache.capture", tokens=len(ids),
                                      capture_lo=lo) as sp:
                    rows = [np.asarray(r) for r in capture_call(cache)]
                    sp["new_tokens"] = self.insert(ids, rows, start_pad, lo)
            except Exception as e:  # best-effort: never kill serving
                with self.index._lock:
                    self.index.counters["insert_errors"] += 1
                if not self._warned:
                    self._warned = True
                    warnings.warn(f"prefix-cache capture failed ({e!r}); serving continues "
                                  "uncached for affected prompts")
            finally:
                self._q.task_done()

    def insert(self, ids, captured_rows, start_pad: int, capture_lo: int) -> int:
        """Store a finished prefill's captured rows (slot span
        [capture_lo, s_bucket)); the trie dedups, so only rows for tokens
        it does not hold yet are kept.  On a hit the capture starts at the
        hit boundary: the rows below it never left the device, and the
        trie holds those tokens already (it leased them)."""
        assert self._keys_axes is not None, "bind_layout before insert"
        offset = max(0, capture_lo - start_pad)
        n = len(ids) - offset
        if n <= 0:
            return 0
        block = block_from_capture(captured_rows, self._keys_axes,
                                   start_pad + offset - capture_lo, n)
        return self.index.insert(ids, block, offset=offset)

    def record_hit(self, used_tokens: int) -> None:
        """Count a USED hit (tokens whose prefill the engine skipped:
        chunk-aligned, so <= the lease's matched length)."""
        with self.index._lock:
            self.index.counters["used_hits"] += 1
            self.index.counters["used_hit_tokens"] += used_tokens

    def stats(self) -> Dict[str, Any]:
        out = self.index.stats()
        out["capture_queue_depth"] = self._q.qsize()
        return out
