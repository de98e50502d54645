"""Radix (token-trie) prefix index over host-RAM KV blocks: the port's copy
of mlcomp_tpu/cache/prefix_index.py.

The serving traffic this repo targets is dominated by shared prefixes —
system prompts, few-shot templates, retry storms — yet every request
pays full prefill through the engine's chunked-admission path.  This
index is the host half of the prefix KV cache (kv_store.py holds the
layout-aware device glue): it maps token-id sequences to stored KV
blocks so a new request can fetch its longest cached prefix from host
memory and prefill only the uncached suffix.

Design (SGLang-style radix tree, host-only, no JAX imports):

- **Radix edges**: each node's ``tokens`` is a tuple edge label; a new
  sequence diverging mid-edge SPLITS the node (the stored block splits
  with it — blocks expose ``slice``, the only thing the trie asks of
  them, so tests and the cachecheck harness run the trie on fake
  blocks).
- **Longest-prefix lookup** returns a ``Lease``: the matched length,
  the ``(block, take)`` segments along the path, and a pin (per-node
  refcount) that eviction respects.  Leases snapshot the block objects
  at lookup time, so a later split of a pinned node can never corrupt
  an in-flight lease (numpy views keep the backing memory alive).
- **LRU eviction under a byte budget**: only LEAF nodes with refcount
  0 evict (an interior node's suffixes depend on it); eviction cascades
  upward as parents become ref-0 leaves.  Pinned blocks may hold the
  index over budget transiently — ``stats()`` reports it honestly.

Thread-safety: one lock around every public method.  The engine loop
thread does lookup/insert; HTTP threads read stats; the cachecheck
harness interleaves all of it from multiple threads.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from mlcomp_tpu_torch.cache.prefix_key import normalize_ids


def _common_prefix_len(a, b) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


class _Node:
    __slots__ = (
        "tokens", "block", "children", "parent", "refs", "last_used",
    )

    def __init__(self, tokens: Tuple[int, ...], block, parent):
        self.tokens = tokens
        self.block = block            # None only at the root
        self.children: Dict[int, "_Node"] = {}
        self.parent = parent
        self.refs = 0
        self.last_used = 0.0


class Lease:
    """A pinned longest-prefix match.

    ``tokens`` is the matched length; ``segments`` is the ordered list
    of ``(block, take)`` pairs covering exactly ``tokens`` tokens.  Call
    ``release()`` (idempotent) once the rows have been copied out —
    until then the covered nodes cannot be evicted.
    """

    __slots__ = ("tokens", "segments", "_index", "_nodes", "_released")

    def __init__(self, index, nodes, segments, tokens):
        self._index = index
        self._nodes = nodes
        self.segments = segments
        self.tokens = tokens
        self._released = False

    def release(self) -> None:
        index = self._index
        with index._lock:
            if self._released:
                return
            self._released = True
            index._leases -= 1
            for node in self._nodes:
                node.refs -= 1
                if node.refs == 0:
                    index._pinned -= 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


class PrefixIndex:
    """Token-trie prefix index with LRU eviction and ref-count pinning.

    ``max_bytes`` bounds the summed ``nbytes`` of stored blocks; 0 or
    negative disables storage entirely (lookups always miss).
    """

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._root = _Node((), None, None)  # guarded_by: _lock
        self._lock = threading.RLock()
        self._bytes = 0  # guarded_by: _lock
        # node/pinned counts maintained INCREMENTALLY (every mutation
        # funnels through insert/evict/lookup/release under the lock):
        # stats() backs /healthz and the report proxy, and an O(N) walk
        # per monitoring poll would hold the lock the engine loop
        # thread's admissions need
        self._nodes = 0  # guarded_by: _lock
        self._pinned = 0  # guarded_by: _lock
        # unreleased Lease count — the caller-facing leak unit behind
        # the chaoscheck invariant that no engine fault path leaks a
        # pin (distinct leases can share pinned nodes, so pinned_nodes
        # alone under-counts outstanding leases)
        self._leases = 0  # guarded_by: _lock
        # monotonic LRU tick (time.monotonic ties on fast ops)
        self._clock = 0  # guarded_by: _lock
        self.counters = {  # guarded_by: _lock
            "lookups": 0, "hits": 0, "misses": 0, "matched_tokens": 0,
            "inserted_tokens": 0, "evictions": 0, "evicted_tokens": 0,
        }

    # ------------------------------------------------------------- public

    def lookup(self, ids) -> Optional[Lease]:
        """Longest-prefix match of ``ids``; returns a pinned Lease or
        None on a zero-length match.  Touches the path for LRU."""
        # the SHARED coercion (cache/prefix_key.py): the fleet router
        # hashes the same normalized ids for prefix affinity, so a
        # request routed by prefix lands on the replica whose trie
        # walks these exact values
        ids = normalize_ids(ids)
        with self._lock:
            self.counters["lookups"] += 1
            node, nodes, segments, matched = self._root, [], [], 0
            pos = 0
            while pos < len(ids):
                child = node.children.get(ids[pos])
                if child is None:
                    break
                m = _common_prefix_len(child.tokens, ids[pos:])
                if m == 0:
                    break
                nodes.append(child)
                segments.append((child.block, m))
                matched += m
                pos += m
                if m < len(child.tokens):
                    break  # partial edge: the match ends inside it
                node = child
            if matched == 0:
                self.counters["misses"] += 1
                return None
            self.counters["hits"] += 1
            self.counters["matched_tokens"] += matched
            self._clock += 1
            for n in nodes:
                n.refs += 1
                if n.refs == 1:
                    self._pinned += 1
                n.last_used = self._clock
            self._leases += 1
            return Lease(self, nodes, segments, matched)

    def insert(self, ids, block, offset: int = 0) -> int:
        """Store ``block`` (covering tokens [offset, len(ids)) of
        ``ids``) under ``ids``; already-present prefixes are
        deduplicated (only the new suffix's rows are kept).  Returns
        the number of NEW tokens stored (0 when fully present or
        storage is disabled).  A non-zero ``offset`` promises the trie
        already holds tokens [0, offset) — the caller leased them — so
        their rows need not ride along; if they were meanwhile evicted
        the insert declines (returns 0) rather than store a prefix with
        a hole."""
        ids = normalize_ids(ids)
        offset = int(offset)
        if not ids or block is None or self.max_bytes <= 0:
            return 0
        if block.ntokens != len(ids) - offset:
            raise ValueError(
                f"block covers {block.ntokens} tokens, ids[{offset}:] "
                f"has {len(ids) - offset}"
            )
        with self._lock:
            self._clock += 1
            node, pos = self._root, 0
            while pos < len(ids):
                child = node.children.get(ids[pos])
                if child is None:
                    break
                m = _common_prefix_len(child.tokens, ids[pos:])
                if m == len(child.tokens):
                    child.last_used = self._clock
                    node, pos = child, pos + m
                    continue
                # diverges (or ends) mid-edge: split the child at m.
                # The stored arrays split with it (copy=True so evicting
                # one half later really frees its bytes).
                head_blk = child.block.slice(0, m)
                tail_blk = child.block.slice(m, child.block.ntokens)
                self._bytes += head_blk.nbytes + tail_blk.nbytes - (
                    child.block.nbytes
                )
                mid = _Node(child.tokens[:m], head_blk, node)
                mid.last_used = child.last_used
                mid.refs = 0  # leases pinned the ORIGINAL node object
                child.tokens = child.tokens[m:]
                child.block = tail_blk
                child.parent = mid
                mid.children = {child.tokens[0]: child}
                node.children[mid.tokens[0]] = mid
                self._nodes += 1
                node, pos = mid, pos + m
            new = len(ids) - pos
            if new == 0:
                return 0
            if pos < offset:
                # the promised [0, offset) prefix is (partly) gone —
                # evicted since the caller's lease; storing the suffix
                # would create a prefix with a hole
                return 0
            leaf = _Node(
                ids[pos:],
                block.slice(pos - offset, len(ids) - offset),
                node,
            )
            leaf.last_used = self._clock
            node.children[ids[pos]] = leaf
            self._bytes += leaf.block.nbytes
            self._nodes += 1
            self.counters["inserted_tokens"] += new
            self._evict_to_budget()
            return new

    def evict_to_budget(self) -> int:
        """Evict LRU unpinned leaves until within ``max_bytes``; returns
        the number of nodes evicted (also runs inside insert)."""
        with self._lock:
            return self._evict_to_budget()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                **self.counters,
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "nodes": self._nodes,
                "pinned_nodes": self._pinned,
                "outstanding_leases": self._leases,
            }

    def check_invariants(self) -> None:
        """Structural self-check (tests / cachecheck harness): byte and
        node/pinned accounting match a full walk, edges are non-empty
        and keyed by their first token, parent pointers are consistent,
        and every block covers exactly its edge's tokens."""
        with self._lock:
            total, nodes, pinned = 0, 0, 0
            stack = [self._root]
            while stack:
                n = stack.pop()
                if n is not self._root:
                    assert n.tokens, "empty edge label"
                    assert n.block is not None, "interior node lost its block"
                    assert n.block.ntokens == len(n.tokens), (
                        n.block.ntokens, len(n.tokens)
                    )
                    assert n.refs >= 0, "negative refcount"
                    total += n.block.nbytes
                    nodes += 1
                    pinned += 1 if n.refs > 0 else 0
                for first, c in n.children.items():
                    assert c.tokens[0] == first, "child keyed off-label"
                    assert c.parent is n, "broken parent pointer"
                    stack.append(c)
            assert total == self._bytes, (total, self._bytes)
            assert nodes == self._nodes, (nodes, self._nodes)
            assert pinned == self._pinned, (pinned, self._pinned)

    # ------------------------------------------------------------ private

    def _evict_to_budget(self) -> int:  # graftcheck: holds(_lock)
        """ONE tree walk collects the evictable leaves into a heap;
        parents join as their last child goes — O(N + M log N) per
        burst, not a fresh full scan per victim (the lock this runs
        under is the one the engine loop thread needs)."""
        if self._bytes <= self.max_bytes:
            return 0
        import heapq

        heap = []
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if not n.children and n.refs == 0:
                heapq.heappush(heap, (n.last_used, id(n), n))
            stack.extend(n.children.values())
        evicted = 0
        while self._bytes > self.max_bytes and heap:
            _, _, victim = heapq.heappop(heap)
            parent = victim.parent
            del parent.children[victim.tokens[0]]
            self._bytes -= victim.block.nbytes
            self._nodes -= 1
            self.counters["evictions"] += 1
            self.counters["evicted_tokens"] += victim.block.ntokens
            evicted += 1
            if (parent is not self._root and not parent.children
                    and parent.refs == 0):
                heapq.heappush(heap, (parent.last_used, id(parent), parent))
        return evicted

