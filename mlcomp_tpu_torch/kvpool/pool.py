"""PagePool: host accounting for the device-resident paged KV cache, a
copy of mlcomp_tpu/kvpool/pool.py (the port imports nothing of the JAX
package).

The split of responsibilities mirrors the engine's device-carried
state design: the page TENSORS live in the engine's device state,
updated in place, so this object owns everything about them that is
NOT bytes on the device:

- the ``PageAllocator`` (free list + ref counts over physical pages);
- the per-slot page tables' HOST MIRROR (``(max_slots, max_pages)``
  int32; the device copy rides the carry and is rewritten at
  insert/retire/scale boundaries);
- the slot-row POLICY: which table entries are NULL (left-pad and
  beyond-budget spans cost no pages), which map SHARED prefix pages
  (ref-count bump, no copy), which must be privately allocated, and
  which of those are copy-on-write FORKS (a shared page intersecting
  the slot's write span gets a private page instead — the row content
  the insert writes already holds the shared prefix bytes, so the
  "copy" is the insert's own masked page write, never an extra device
  pass);
- the DEVICE PREFIX REGISTRY: the prompt-prefix pages of admitted
  requests stay pinned (ref-count, LRU) under their placement key
  ``(s_bucket, start_pad)``, so a later admission whose prompt shares
  a prefix AT THE SAME PLACEMENT maps the same physical pages into its
  table — no host round-trip, no HBM copy of the persistent K/V.
  Placement-exactness is what makes the bytes transplant: left-padded
  slot layouts give token j page position ``(start_pad + j) // T`` and
  RoPE position j, both functions of the pad — so cross-LENGTH sharing
  stays the host prefix cache's job (``cache/prefix_index.py``
  re-places token-indexed blocks; the registry is the
  retry-storm/shared-system-prompt fast path that skips even the host
  assemble+upload).  Lookups return a LEASE (pages retained) so LRU
  reclaim under admission pressure cannot free a prefix an in-flight
  admission is still gathering from.

Everything here is loop-thread-owned (the engine mutates tables and
the allocator only at dispatch boundaries); ``stats()`` tolerates
torn reads from HTTP threads like the engine's ``_stats``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from mlcomp_tpu_torch.kvpool.allocator import (
    GRAVE_PAGE,
    NULL_PAGE,
    PageAllocator,
    RESERVED_PAGES,
    NoFreePages,
)
from mlcomp_tpu_torch.kvpool.layout import PagedLayout

__all__ = ["PagePool", "PageLease", "NoFreePages"]


class _RegistryEntry:
    __slots__ = ("tokens", "entries", "boundary", "last_used")

    def __init__(self, tokens: Tuple[int, ...], entries: Tuple[int, ...],
                 boundary: int):
        self.tokens = tokens        # real prompt tokens the pages cover
        self.entries = entries      # table-row prefix, incl NULL pads
        self.boundary = boundary    # slot-coordinate prefix end (page-
        # aligned: pages past it would straddle the decode span)
        self.last_used = 0


class PageLease:
    """A registry hit with its pages RETAINED: ``entries`` are the
    source table-row prefix (good for gather + shared mapping),
    ``matched`` the common-prefix token count with the looked-up
    prompt, ``boundary`` the slot-coordinate end of the SHARABLE span
    (``start_pad + matched``, capped at the entry's own page-aligned
    boundary).  ``release()`` (idempotent) once the admission has
    committed its table row (or died) — the retains are what keep LRU
    reclaim from freeing the prefix mid-admission."""

    __slots__ = ("entries", "matched", "boundary", "_pool", "_released")

    def __init__(self, pool: "PagePool", entries: Tuple[int, ...],
                 matched: int, boundary: int):
        self.entries = entries
        self.matched = matched
        self.boundary = boundary
        self._pool = pool
        self._released = False

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        pool = self._pool
        for p in self.entries:
            if p >= RESERVED_PAGES:
                pool._lease_refs[p] -= 1
                if not pool._lease_refs[p]:
                    del pool._lease_refs[p]
                pool.alloc.release(p)
        pool._leases -= 1


class PagePool:
    """Allocator + tables + prefix registry for one paged engine."""

    def __init__(self, layout: PagedLayout, max_slots: int,
                 registry_entries: int = 128):
        self.layout = layout
        self.page_tokens = layout.page_tokens
        self.max_pages = layout.max_pages
        self.max_slots = int(max_slots)
        self.max_registry_entries = int(registry_entries)
        self.alloc = PageAllocator(layout.num_pages, layout.page_tokens)
        # inactive rows map GRAVE everywhere: a retired (or never-used)
        # slot's frozen cursor still receives each dispatch's K/V write
        # — the graveyard absorbs it; NULL must stay all-zero
        self.tables = np.full(
            (self.max_slots, self.max_pages), GRAVE_PAGE, np.int32
        )
        # (s_bucket, start_pad) -> [_RegistryEntry]: placement key first
        # (sharing is placement-exact), then a short best-common-prefix
        # scan inside the bucket
        self._registry: Dict[Tuple[int, int], List[_RegistryEntry]] = (
            {}
        )
        self._clock = 0
        self._leases = 0
        self._lease_refs: Dict[int, int] = {}
        self.counters = {
            "registry_hits": 0, "registry_misses": 0,
            "registry_evictions": 0, "shared_mappings": 0,
        }

    # ------------------------------------------------------------ geometry

    def pages_needed(self, start_pad: int, span_end: int) -> int:
        """Private+shared pages a slot with real tokens in
        ``[start_pad, span_end)`` occupies: pages fully inside the pad
        prefix (and fully beyond the span) map NULL and cost nothing.
        """
        T = self.page_tokens
        return -(-span_end // T) - (start_pad // T)

    # ------------------------------------------------------- slot mapping

    def _plan_slot_row(
        self, start_pad: int, span_end: int,
        shared: Optional[PageLease],
        alloc_end: Optional[int] = None,
    ) -> Tuple[List[Tuple[int, str]], int]:
        """Per-page plan for a slot row: ``(page_index, kind)`` with
        kind ∈ share/fork/alloc, plus the fork count.  ``alloc_end``
        (default ``span_end``) bounds the pages allocated NOW — the
        lazy-decode policy: pages past it stay NULL and are allocated
        by ``extend_slot_row`` as the cursor approaches them."""
        T = self.page_tokens
        if alloc_end is None:
            alloc_end = span_end
        alloc_end = min(int(alloc_end), int(span_end))
        plans: List[Tuple[int, str]] = []
        forks = 0
        for p in range(start_pad // T, -(-alloc_end // T)):
            ent = (
                shared.entries[p] if shared is not None
                and p < len(shared.entries) else None
            )
            if ent is not None and ent != NULL_PAGE and (
                (p + 1) * T <= shared.boundary
            ):
                plans.append((p, "share"))
            elif ent is not None and ent != NULL_PAGE and (
                p * T < shared.boundary
            ):
                # the share boundary lands INSIDE this page: FORK a
                # private copy (the insert's masked write fills it —
                # shared prefix bytes included, the recomputed suffix
                # on top — so the "copy" costs no extra device pass).
                # Entry-covered pages wholly PAST the boundary share
                # nothing and are plain allocs, not forks.
                plans.append((p, "fork"))
                forks += 1
            else:
                # within the span every unshared page holds real
                # tokens (pages fully inside the pad prefix sit below
                # the span and stay NULL in the prefilled row)
                plans.append((p, "alloc"))
        return plans, forks

    def private_pages_needed(
        self, start_pad: int, span_end: int,
        shared: Optional[PageLease] = None,
        alloc_end: Optional[int] = None,
    ) -> int:
        """Pages ``build_slot_row`` would actually ALLOCATE for this
        span (shared mappings cost none) — what a targeted ``reclaim``
        should free, as opposed to ``pages_needed``'s worst case."""
        plans, _ = self._plan_slot_row(
            start_pad, span_end, shared, alloc_end
        )
        return sum(1 for _, kind in plans if kind != "share")

    def build_slot_row(
        self,
        start_pad: int,
        span_end: int,
        shared: Optional[PageLease] = None,
        alloc_end: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Compose a slot's table row for insert.  Returns ``(row,
        write_mask, cow_forks)``: ``row`` is the (max_pages,) int32
        table entries, ``write_mask`` marks the pages the insert
        program must write from the prefilled row (private pages;
        shared and NULL entries keep their bytes), ``cow_forks`` counts
        the COPY-ON-WRITE forks — pages a shared prefix covers but
        whose span crosses the lease's share boundary (the slot writes
        past it), so they get a private allocation the insert fills
        instead of a shared mapping.

        All-or-nothing: on ``NoFreePages`` nothing is retained or
        allocated.  The caller gates admissions on ``pages_needed``
        (plus ``reclaim``), so a raise here means a genuine race or a
        misconfigured pool — it surfaces as an admission failure, never
        a leak."""
        row = np.full((self.max_pages,), NULL_PAGE, np.int32)
        mask = np.zeros((self.max_pages,), bool)
        plans, forks = self._plan_slot_row(
            start_pad, span_end, shared, alloc_end
        )
        n_alloc = sum(1 for _, kind in plans if kind != "share")
        fresh = self.alloc.alloc(n_alloc, cow_fork=forks)  # may raise
        fi = 0
        shared_n = 0
        for p, kind in plans:
            if kind == "share":
                row[p] = shared.entries[p]
                self.alloc.retain(row[p])
                shared_n += 1
            else:
                row[p] = fresh[fi]
                fi += 1
                mask[p] = True
        self.counters["shared_mappings"] += shared_n
        return row, mask, forks

    def commit_slot_row(self, slot: int, row: np.ndarray) -> None:
        self.tables[slot] = row

    def extend_slot_row(self, slot: int, p0: int, p1: int) -> np.ndarray:
        """LAZY decode-page growth: allocate private pages for table
        positions [p0, p1) of a COMMITTED slot row (they must be NULL
        — beyond the row's allocated frontier, inside its span) and
        return the updated row for the device-table write.
        All-or-nothing like every other allocation: ``NoFreePages``
        here is the mid-decode exhaustion the engine maps to a bounded
        request failure."""
        row = self.tables[slot]
        for p in range(p0, p1):
            assert row[p] == NULL_PAGE, (
                f"lazy extend over a mapped page: slot {slot} pos {p} "
                f"-> {row[p]}"
            )
        fresh = self.alloc.alloc(p1 - p0)  # may raise NoFreePages
        row[p0:p1] = fresh
        return row.copy()

    def release_row(self, row: Sequence[int]) -> None:
        """Release an UNCOMMITTED row's references (an admission that
        built its row and then failed before commit)."""
        for p in row:
            if int(p) >= RESERVED_PAGES:
                self.alloc.release(int(p))

    def free_slot(self, slot: int) -> None:
        """Release a retired slot's page references and park the row on
        the graveyard (the device table row must be repointed BEFORE
        any freed page can be re-allocated — the engine sequences the
        clear-row program ahead of the next insert)."""
        for p in self.tables[slot]:
            if p >= RESERVED_PAGES:
                self.alloc.release(int(p))
        self.tables[slot] = GRAVE_PAGE

    def grave_row(self) -> np.ndarray:
        return np.full((self.max_pages,), GRAVE_PAGE, np.int32)

    # ------------------------------------------------------------ registry

    def registry_register(self, s_bucket: int, start_pad: int,
                          ids: Sequence[int], row: np.ndarray) -> bool:
        """Pin a freshly-inserted slot's PROMPT-prefix pages under the
        placement key.  Only pages fully below the decode span are
        registered (``boundary = (s_bucket // T) * T``): their bytes
        are pure prompt K/V, stable for the pool's lifetime — the
        slot's decode writes start at ``s_bucket`` and never touch
        them.  Idempotent on an already-covered prompt (retry storms):
        the existing pin is touched, not duplicated."""
        T = self.page_tokens
        boundary = (s_bucket // T) * T
        n_tokens = boundary - start_pad
        if n_tokens <= 0:
            return False
        n_pages = -(-boundary // T)
        tokens = tuple(int(t) for t in ids[:n_tokens])
        key = (int(s_bucket), int(start_pad))
        self._clock += 1
        bucket = self._registry.setdefault(key, [])
        for ent in bucket:
            if len(ent.tokens) >= n_tokens and (
                ent.tokens[:n_tokens] == tokens
            ):
                ent.last_used = self._clock
                return False
        entries = tuple(int(p) for p in row[:n_pages])
        for p in entries:
            if p >= RESERVED_PAGES:
                self.alloc.retain(p)
        ent = _RegistryEntry(tokens, entries, boundary)
        ent.last_used = self._clock
        bucket.append(ent)
        while self.registry_entries > self.max_registry_entries:
            self._evict_lru()
        return True

    def registry_lookup(self, s_bucket: int, start_pad: int,
                        ids: Sequence[int]) -> Optional[PageLease]:
        """Best common-prefix match at this exact placement, as a
        retained :class:`PageLease` — or None when no entry shares at
        least one full page of prompt prefix.  The lease's pages stay
        pinned until ``release()``, so reclaim cannot free them while
        the admission gathers/maps from them."""
        T = self.page_tokens
        key = (int(s_bucket), int(start_pad))
        toks = [int(t) for t in ids]
        best: Optional[_RegistryEntry] = None
        best_k = 0
        for ent in self._registry.get(key, ()):
            k = 0
            for a, b in zip(ent.tokens, toks):
                if a != b:
                    break
                k += 1
            if k > best_k:
                best, best_k = ent, k
        # a hit must share at least one full page past the pad prefix,
        # else mapping/gathering buys nothing
        if best is None or (start_pad + best_k) // T <= start_pad // T:
            self.counters["registry_misses"] += 1
            return None
        self._clock += 1
        best.last_used = self._clock
        self.counters["registry_hits"] += 1
        boundary = min(start_pad + best_k, best.boundary)
        for p in best.entries:
            if p >= RESERVED_PAGES:
                self.alloc.retain(p)
                self._lease_refs[p] = self._lease_refs.get(p, 0) + 1
        self._leases += 1
        return PageLease(self, best.entries, best_k, boundary)

    def _evict_lru(self) -> None:
        lru_key, lru_i = None, -1
        lru_clock = None
        for key, bucket in self._registry.items():
            for i, ent in enumerate(bucket):
                if lru_clock is None or ent.last_used < lru_clock:
                    lru_key, lru_i, lru_clock = key, i, ent.last_used
        if lru_key is None:
            return
        ent = self._registry[lru_key].pop(lru_i)
        if not self._registry[lru_key]:
            del self._registry[lru_key]
        for p in ent.entries:
            if p >= RESERVED_PAGES:
                self.alloc.release(p)
        self.counters["registry_evictions"] += 1

    def reclaim(self, need_free: int) -> int:
        """Evict LRU registry entries until ``need_free`` pages are
        free (or the registry is empty).  Returns entries evicted.
        Only registry pins are reclaimable — slot-table references are
        live decode state, and leased pages stay pinned by their lease
        refs even after their entry is evicted."""
        evicted = 0
        while self.alloc.free_pages < need_free and self._registry:
            self._evict_lru()
            evicted += 1
        return evicted

    def reclaim_all(self) -> int:
        return self.reclaim(self.alloc.total_pages + 1)

    @property
    def registry_entries(self) -> int:
        return sum(len(b) for b in self._registry.values())

    def reclaimable_pages(self) -> int:
        """Pages that would return to the free list if every registry
        entry dropped: those whose ONLY references are registry pins."""
        seen: Dict[int, int] = {}
        for bucket in self._registry.values():
            for ent in bucket:
                for p in ent.entries:
                    if p >= RESERVED_PAGES:
                        seen[p] = seen.get(p, 0) + 1
        return sum(
            1 for p, n in seen.items()
            if self.alloc.refs(p) == n and p not in self._lease_refs
        )

    # ----------------------------------------------------------- lifecycle

    def reset(self) -> None:
        """Watchdog-restart path: the device carry was rebuilt from
        scratch (fresh zero pages), so every mapping here is stale."""
        self.alloc.reset()
        self.tables[:] = GRAVE_PAGE
        self._registry.clear()
        self._lease_refs.clear()
        self._leases = 0

    def check_invariants(self) -> None:
        self.alloc.check_invariants()
        # every table/registry/lease reference is accounted: per-page
        # refs equal the number of table rows + registry entries +
        # outstanding lease retains mapping it
        refs: Dict[int, int] = {}
        for row in self.tables:
            for p in row:
                if p >= RESERVED_PAGES:
                    refs[int(p)] = refs.get(int(p), 0) + 1
        for bucket in self._registry.values():
            for ent in bucket:
                for p in ent.entries:
                    if p >= RESERVED_PAGES:
                        refs[p] = refs.get(p, 0) + 1
        for p, n in self._lease_refs.items():
            refs[p] = refs.get(p, 0) + n
        for p, n in refs.items():
            assert self.alloc.refs(p) == n, (p, self.alloc.refs(p), n)
        assert len(refs) == self.alloc.used_pages, (
            len(refs), self.alloc.used_pages
        )

    def stats(self) -> Dict[str, Any]:
        return {
            **self.alloc.stats(),
            **self.counters,
            "page_tokens": self.page_tokens,
            "max_pages_per_slot": self.max_pages,
            "page_bytes": self.layout.page_bytes(),
            "pages_reclaimable": self.reclaimable_pages(),
            "registry_entries": self.registry_entries,
            "outstanding_page_leases": self._leases,
        }
