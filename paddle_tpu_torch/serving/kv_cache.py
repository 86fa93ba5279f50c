"""Host-side paged KV-cache bookkeeping: the page pool and page tables.

The device arrays (the K/V pools) are ordinary persistable scope state
owned by the engine; this module owns the HOST view — which physical
pages are free and each decode slot's logical-block -> physical-page map.

Pages are the allocation quantum.  Under the FIFO scheduler a request
holds ceil((prompt + max_new) / page_size) pages from admission to
eviction, and "no page leaked" reduces to alloc/free pairing (asserted by
the double-free/foreign-free guard).  Pages are never shared: prefix
sharing, with its refcounts, belongs to the preemptive scheduler, which
the port does not have yet (ROADMAP.md Queue A item 2).

Page 0 is the reserved NULL PAGE: never allocated, the target of every
masked write (prompt pad tails, inactive decode slots) and of every
unallocated page-table entry, so garbage traffic can never touch a live
request's pages.

ALL page-table mutation goes through PagedKVCache's API (assign/
release), so the cached int64 feed view can never go stale and
the allocator's accounting stays the single source of truth.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

# Tokens per KV page: the allocator's granularity and the decode kernel's
# unit of work.  ServingEngine(page_size=...) overrides it.
DEFAULT_PAGE_SIZE = 16


def pages_needed(tokens: int, page_size: int) -> int:
    return -(-int(tokens) // int(page_size))


class PageAllocator:
    """Free-list allocator over a fixed pool; page 0 reserved.

    ``alloc`` hands out pages and ``free`` takes them back; freeing a page
    that is not held (a double free, or a foreign page) raises."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (page 0 is the null page), "
                             f"got {num_pages}")
        self.num_pages = int(num_pages)
        # LIFO free list: hot pages get reused first (their pool lines are
        # the ones most recently touched on device)
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._held = set()
        # lifetime counters (stats())
        self.total_allocs = 0
        self.total_frees = 0
        self.peak_held = 0

    def available(self) -> int:
        return len(self._free)

    def held(self) -> int:
        return len(self._held)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages, or None if the pool can't cover them (all-or-nothing:
        a partial grant would deadlock two half-admitted requests)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._held.update(pages)
        self.total_allocs += n
        self.peak_held = max(self.peak_held, len(self._held))
        return pages

    def free(self, pages: List[int]):
        for p in pages:
            if p not in self._held:
                raise ValueError(
                    f"free of page {p} not currently held (double free or "
                    f"foreign page)")
            self._held.remove(p)
            self._free.append(p)
            self.total_frees += 1

    def stats(self) -> dict:
        return {"num_pages": self.num_pages, "free": len(self._free),
                "held": len(self._held),
                "total_allocs": self.total_allocs,
                "total_frees": self.total_frees,
                "peak_held": self.peak_held}


class PagedKVCache:
    """Page tables for a fixed set of decode slots + the allocator.

    page_table[slot] maps logical block j to the physical page holding
    positions [j*ps, (j+1)*ps); entries beyond a request's pages stay 0
    (the null page) so they are always safe to gather/scatter through."""

    def __init__(self, num_slots: int, max_pages_per_seq: int,
                 num_pages: int, page_size: int):
        self.num_slots = int(num_slots)
        self.max_pages_per_seq = int(max_pages_per_seq)
        self.page_size = int(page_size)
        self.allocator = PageAllocator(num_pages)
        self.page_table = np.zeros((self.num_slots, self.max_pages_per_seq),
                                   dtype=np.int32)
        self._pt_i64 = None  # cached feed view, see page_table_i64()

    def assign(self, slot: int, pages: List[int]):
        if len(pages) > self.max_pages_per_seq:
            raise ValueError(f"{len(pages)} pages > max_pages_per_seq="
                             f"{self.max_pages_per_seq}")
        self.page_table[slot, :] = 0
        self.page_table[slot, :len(pages)] = pages
        self._pt_i64 = None

    def release(self, slot: int):
        self.page_table[slot, :] = 0
        self._pt_i64 = None

    def page_table_i64(self):
        """The int64 feed view of the page table, cached between
        mutations: steady-state decode (no admits/evictions for hundreds
        of steps) must not pay a fresh host copy + upload per token."""
        if self._pt_i64 is None:
            self._pt_i64 = self.page_table.astype(np.int64)
        return self._pt_i64
