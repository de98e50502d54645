"""Host-side page allocator for the device KV page pool: a copy of
mlcomp_tpu/kvpool/allocator.py (the port imports nothing of the JAX
package).

Pure bookkeeping: the pool's DEVICE tensors live in the engine's
device state (mlcomp_tpu_torch/engine.py owns them), so
the allocator tracks which physical page holds what — a free list plus
per-page reference counts — and nothing else.  Ref counts are what
make copy-on-write prefix sharing safe: a page mapped into N slot
tables (or pinned by the device prefix registry) has ``refs == N`` and
only returns to the free list when the last reference releases.

Two physical pages are RESERVED and never allocated:

- ``NULL_PAGE`` (0): the all-zero page.  Slot-table entries outside a
  slot's allocated span map here — left-pad pages and the tail beyond
  the request's token budget.  Every program that writes through a
  table writes it only with the zeros it gathered from it, so it stays
  zero by construction (the engine's paged dispatch asserts nothing;
  the invariant is structural).
- ``GRAVE_PAGE`` (1): the write sink for INACTIVE slots.  A retired
  row's frozen cursor still receives each dispatch's K/V write (the
  device retires rows by masking emission, not by skipping the
  forward), so a freed slot's table cannot map NULL_PAGE — the garbage
  write would corrupt the shared zero page.  All-graveyard rows park
  those writes in a page no live row ever reads.

The allocator is loop-thread-owned (the engine mutates it only at
dispatch boundaries); ``stats()`` is safe to read from HTTP threads —
torn counters are acceptable for monitoring, same contract as the
engine's ``_stats``.
"""

from __future__ import annotations

from typing import Dict, List

NULL_PAGE = 0
GRAVE_PAGE = 1
RESERVED_PAGES = 2


class NoFreePages(RuntimeError):
    """The pool cannot satisfy an allocation even after the caller
    reclaimed everything reclaimable.  Admission control maps this to
    429 ``no_free_pages``; an allocation larger than the whole pool is
    a configuration error surfaced as a request failure."""

    status = "no_free_pages"


class PageAllocator:
    """Free-list + ref-count allocator over ``num_pages`` physical
    pages of ``page_tokens`` tokens each (reserved pages excluded)."""

    def __init__(self, num_pages: int, page_tokens: int):
        self.num_pages = int(num_pages)
        self.page_tokens = int(page_tokens)
        if self.page_tokens < 1:
            raise ValueError(
                f"page_tokens must be >= 1, got {page_tokens}"
            )
        if self.num_pages <= RESERVED_PAGES:
            raise ValueError(
                f"num_pages must exceed the {RESERVED_PAGES} reserved "
                f"pages, got {num_pages}"
            )
        # LIFO free list: recently-freed pages are re-used first, which
        # keeps the hot working set small whatever the churn pattern
        self._free: List[int] = list(
            range(self.num_pages - 1, RESERVED_PAGES - 1, -1)
        )
        self._refs: Dict[int, int] = {}
        self.counters = {
            "allocs": 0, "frees": 0, "cow_forks": 0, "failed_allocs": 0,
        }
        self._peak_used = 0

    # ------------------------------------------------------------- queries

    @property
    def total_pages(self) -> int:
        """Allocatable pages (reserved pages excluded)."""
        return self.num_pages - RESERVED_PAGES

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.total_pages - len(self._free)

    def refs(self, page: int) -> int:
        return self._refs.get(int(page), 0)

    # ----------------------------------------------------------- lifecycle

    def alloc(self, n: int, cow_fork: int = 0) -> List[int]:
        """Take ``n`` pages off the free list at ref 1.  All-or-nothing:
        a partial grab under pressure would leak unless every caller
        wrote perfect unwind code.  ``cow_fork`` counts how many of the
        ``n`` exist only because a shared page intersected the caller's
        write span (the copy-on-write fork accounting behind
        ``mlcomp_engine_kv_page_cow_forks_total``)."""
        n = int(n)
        if n < 0:
            raise ValueError(f"alloc of {n} pages")
        if n > len(self._free):
            self.counters["failed_allocs"] += 1
            raise NoFreePages(
                f"need {n} pages, {len(self._free)} free "
                f"(total {self.total_pages})"
            )
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        self.counters["allocs"] += n
        self.counters["cow_forks"] += int(cow_fork)
        self._peak_used = max(self._peak_used, self.used_pages)
        return out

    def retain(self, page: int) -> None:
        """Add a reference to a live page (prefix sharing: mapping an
        existing page into another slot table or the registry)."""
        page = int(page)
        if page < RESERVED_PAGES:
            return  # reserved pages are permanently pinned
        refs = self._refs.get(page)
        if not refs:
            raise ValueError(f"retain of unallocated page {page}")
        self._refs[page] = refs + 1

    def release(self, page: int) -> bool:
        """Drop a reference; returns True when the page went back to
        the free list (last reference gone)."""
        page = int(page)
        if page < RESERVED_PAGES:
            return False
        refs = self._refs.get(page)
        if not refs:
            raise ValueError(f"release of unallocated page {page}")
        if refs > 1:
            self._refs[page] = refs - 1
            return False
        del self._refs[page]
        self._free.append(page)
        self.counters["frees"] += 1
        return True

    def reset(self) -> None:
        """Forget every allocation (watchdog restart rebuilds the
        device carry from scratch — stale refs would leak the pool)."""
        self._free = list(
            range(self.num_pages - 1, RESERVED_PAGES - 1, -1)
        )
        self._refs.clear()

    def check_invariants(self) -> None:
        """Structural self-check for tests and the chaos harness."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate page on free list"
        assert not (free & set(self._refs)), "page both free and ref'd"
        for p, r in self._refs.items():
            assert RESERVED_PAGES <= p < self.num_pages, p
            assert r > 0, (p, r)
        assert len(free) + len(self._refs) == self.total_pages, (
            len(free), len(self._refs), self.total_pages
        )

    def stats(self) -> Dict[str, int]:
        return {
            **self.counters,
            "pages_total": self.total_pages,
            "pages_free": len(self._free),
            "pages_used": self.used_pages,
            "pages_shared": sum(1 for r in self._refs.values() if r > 1),
            "peak_pages_used": self._peak_used,
        }
