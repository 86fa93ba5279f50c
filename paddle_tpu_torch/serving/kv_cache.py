"""Host-side paged KV-cache bookkeeping: page pool, page tables, prefix
index — the port of ``paddle_tpu/serving/kv_cache.py``.

The device arrays (the K/V pools) are ordinary persistable scope state
owned by the engine; this module owns the HOST view — which physical
pages are free, how many holders each live page has, each decode slot's
logical-block -> physical-page map, and the hash-keyed index that lets
requests with a common prompt prefix SHARE pages.

Pages are the allocation quantum.  Under the FIFO scheduler a request
holds ceil((prompt + max_new) / page_size) pages from admission to
eviction; under the v2 scheduler pages are allocated as the context
actually grows, shared pages carry a refcount, and "no page leaked"
reduces to retain/free pairing (asserted by the double-free/foreign-free
guards).

Page 0 is the reserved NULL PAGE: never allocated, the target of every
masked write (prompt pad tails, inactive decode slots, idle chunk lanes)
and of every unallocated page-table entry, so garbage traffic can never
touch a live request's pages.

ALL page-table mutation goes through PagedKVCache's API (assign/
map_block/release), so the cached int64 feed view can never go stale and
the allocator's accounting stays the single source of truth.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

# Tokens per KV page: the allocator's granularity and the paged kernels'
# unit of work.  ServingEngine(page_size=...) overrides it.
DEFAULT_PAGE_SIZE = 16


def pages_needed(tokens: int, page_size: int) -> int:
    return -(-int(tokens) // int(page_size))


class PageAllocator:
    """Refcounted free-list allocator over a fixed pool; page 0 reserved.

    ``alloc`` hands out pages at refcount 1; ``retain`` adds a holder
    (prefix sharing: a second request mapping the same physical page, or
    the prefix index itself); ``free`` drops one holder and returns the
    page to the free list only when the last holder lets go.  The FIFO
    scheduler never calls retain, so for it alloc/free simply pair."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (page 0 is the null page), "
                             f"got {num_pages}")
        self.num_pages = int(num_pages)
        # LIFO free list: hot pages get reused first (their pool lines are
        # the ones most recently touched on device)
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._rc: Dict[int, int] = {}
        # lifetime counters (stats())
        self.total_allocs = 0
        self.total_frees = 0
        self.peak_held = 0

    def available(self) -> int:
        return len(self._free)

    def held(self) -> int:
        return len(self._rc)

    def refcount(self, page: int) -> int:
        return self._rc.get(page, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages at refcount 1, or None if the pool can't cover them
        (all-or-nothing: a partial grant would deadlock two half-admitted
        requests)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._rc[p] = 1
        self.total_allocs += n
        self.peak_held = max(self.peak_held, len(self._rc))
        return pages

    def retain(self, pages: List[int]):
        """Add one holder to each page (prefix sharing)."""
        for p in pages:
            if p not in self._rc:
                raise ValueError(f"retain of page {p} not currently held")
            self._rc[p] += 1

    def free(self, pages: List[int]):
        """Drop one holder per page; the last holder returns it to the
        pool.  Freeing a page nobody holds (a double free, or a foreign
        page) raises."""
        for p in pages:
            rc = self._rc.get(p)
            if rc is None:
                raise ValueError(
                    f"free of page {p} not currently held (double free or "
                    f"foreign page)")
            if rc > 1:
                self._rc[p] = rc - 1
            else:
                del self._rc[p]
                self._free.append(p)
                self.total_frees += 1

    def stats(self) -> dict:
        return {"num_pages": self.num_pages, "free": len(self._free),
                "held": len(self._rc), "shared": sum(
                    1 for c in self._rc.values() if c > 1),
                "total_allocs": self.total_allocs,
                "total_frees": self.total_frees,
                "peak_held": self.peak_held}


class _PrefixEntry:
    __slots__ = ("key", "parent", "page", "tokens")

    def __init__(self, key, parent, page, tokens):
        self.key, self.parent = key, parent
        self.page, self.tokens = page, tokens


class PrefixCache:
    """Hash-keyed index of immutable, full prompt blocks -> shared pages.

    Chain-keyed: block j's key folds block j-1's key with block j's
    tokens, so equal keys imply an equal whole prefix (up to Python-hash
    collisions, which lookup() re-checks token-exactly — a false hit is
    impossible, only a missed share).  Entries hold one allocator
    reference each, so an indexed page stays alive after every request
    using it finished; LRU eviction under pool pressure releases that
    reference.

    Pages indexed here are IMMUTABLE by construction: only blocks wholly
    inside a request's *prompt* are ever inserted (decode writes land at
    positions >= prompt length, i.e. in later blocks), and a request that
    must write into a shared block first takes a private copy-on-write
    copy (the engine's page-copy program)."""

    _ROOT = ("prefix-root",)

    def __init__(self, allocator: PageAllocator, page_size: int):
        self.allocator = allocator
        self.page_size = int(page_size)
        self._entries: "OrderedDict[int, _PrefixEntry]" = OrderedDict()
        self._children: Dict[int, List[int]] = {}  # parent key -> child keys
        # stats
        self.lookups = 0
        self.hit_tokens = 0
        self.inserted_blocks = 0
        self.evicted_blocks = 0
        self.cow_hits = 0

    @classmethod
    def _key(cls, parent_key, block_tokens: Tuple[int, ...]) -> int:
        return hash((parent_key, block_tokens))

    def __len__(self):
        return len(self._entries)

    def reclaimable(self) -> int:
        """Pages eviction could actually return to the pool right now:
        indexed pages whose ONLY holder is the index itself."""
        return sum(1 for e in self._entries.values()
                   if self.allocator.refcount(e.page) == 1)

    def lookup(self, tokens: List[int], max_reuse: int, count: bool = True):
        """Longest reusable prefix of `tokens`, capped at `max_reuse`
        positions (callers pass total_prefix_len - 1 so at least one
        position is always left to compute — logits come from the last
        computed position).

        Returns (full_tokens, full_pages, partial):
          full_tokens  — positions covered by whole shared blocks
          full_pages   — their pages, block order (NOT yet retained)
          partial      — (src_page, m) for a copy-on-write reuse of the
                         first divergent block's leading m positions, or
                         None

        ``count=False`` skips the hit-rate counters: an admission that
        may retry counts ONCE via ``count_hit`` when it actually places
        the request, so ``stats()`` means per-admission."""
        ps = self.page_size
        key = self._ROOT
        pages: List[int] = []
        j = 0
        while (j + 1) * ps <= min(len(tokens), max_reuse):
            block = tuple(int(t) for t in tokens[j * ps:(j + 1) * ps])
            k = self._key(key, block)
            e = self._entries.get(k)
            if e is None or e.tokens != block:
                break
            self._entries.move_to_end(k)  # LRU touch
            pages.append(e.page)
            key = k
            j += 1
        # first divergent (or final, reuse-capped) block: the longest
        # token-prefix match among this chain position's children is
        # reusable via copy-on-write — but only when it pays for the
        # device copy (>= half a page)
        partial = None
        min_cow = max(1, ps // 2)
        room = min(len(tokens), max_reuse) - j * ps
        if room >= min_cow:
            mine = [int(t) for t in tokens[j * ps: j * ps + self.page_size]]
            best_m, best_page, best_k = 0, None, None
            for ck in self._children.get(key, ()):
                e = self._entries.get(ck)
                if e is None:
                    continue
                m = 0
                for a, b in zip(e.tokens, mine):
                    if a != b:
                        break
                    m += 1
                if m > best_m:
                    best_m, best_page, best_k = m, e.page, ck
            best_m = min(best_m, room)
            if best_m >= min_cow:
                partial = (best_page, best_m)
                # LRU credit: a COW source serving partial hits is as hot
                # as a whole-block hit
                self._entries.move_to_end(best_k)
        hit = j * ps
        if count:
            self.count_hit(hit, partial)
        return hit, pages, partial

    def count_hit(self, hit: int, partial):
        """Record one admission's lookup result in the hit-rate counters
        (the ``count=False`` half of the per-admission contract)."""
        self.lookups += 1
        if partial is not None:
            self.cow_hits += 1
        self.hit_tokens += hit + (partial[1] if partial else 0)

    def insert(self, tokens: List[int], pages: List[int], n_blocks: int):
        """Index the first `n_blocks` whole blocks of `tokens`, mapping
        block j to pages[j].  Idempotent per key: an already-indexed block
        keeps its existing page (the caller's duplicate page stays
        private to the caller).  Each newly indexed page gains one
        allocator reference."""
        ps = self.page_size
        key = self._ROOT
        for j in range(int(n_blocks)):
            block = tuple(int(t) for t in tokens[j * ps:(j + 1) * ps])
            if len(block) < ps:
                raise ValueError(
                    f"insert of partial block {j} ({len(block)} < {ps} "
                    f"tokens) — only immutable full prompt blocks are "
                    f"indexable")
            k = self._key(key, block)
            e = self._entries.get(k)
            if e is not None and e.tokens != block:
                break  # hash collision: never index under a false chain
            if e is None:
                page = pages[j]
                if page == 0:
                    raise ValueError("null page 0 is never indexable")
                self.allocator.retain([page])
                self._entries[k] = _PrefixEntry(k, key, page, block)
                self._children.setdefault(key, []).append(k)
                self.inserted_blocks += 1
            key = k

    def _evict_entry(self, key: int) -> int:
        """Drop one entry AND its whole descendant subtree (a chain with
        a missing middle block is unreachable to lookup and would leak
        its tail's references).  Returns pages actually returned to the
        pool."""
        freed = 0
        stack = [key]
        while stack:
            k = stack.pop()
            e = self._entries.pop(k, None)
            if e is None:
                continue
            stack.extend(self._children.pop(k, ()))
            sibs = self._children.get(e.parent)
            if sibs and k in sibs:
                sibs.remove(k)
            before = self.allocator.available()
            self.allocator.free([e.page])
            freed += self.allocator.available() - before
            self.evicted_blocks += 1
        return freed

    def evict_pages(self, want: int) -> int:
        """Release least-recently-used CACHE-ONLY entries (refcount 1 —
        the index is the sole holder) until `want` pages came back to
        the free list or no reclaimable entry remains.  Entries whose
        pages a running request (or an in-flight admission's pin) also
        holds are skipped.

        Eviction is LEAF-first: lookup() touches a chain root-to-leaf,
        so in LRU order parents sit before their children — the LRU leaf
        belongs to the least-recently-used chain and frees exactly its
        own page.  Only when every remaining reclaimable page sits above
        a pinned descendant does a subtree fall with its evictable
        ancestor."""
        freed = 0
        progress = True
        while freed < want and progress:
            # evicting a leaf exposes its parent, so re-snapshot until
            # a full pass over the LRU order makes no progress
            progress = False
            for key in list(self._entries):
                if freed >= want:
                    break
                e = self._entries.get(key)
                if e is None or self._children.get(key):
                    continue
                if self.allocator.refcount(e.page) > 1:
                    continue
                freed += self._evict_entry(key)
                progress = True
        # last resort: evictable ancestors whose descendants are pinned
        for key in list(self._entries):
            if freed >= want:
                break
            e = self._entries.get(key)
            if e is None:
                continue  # went down with an earlier subtree
            if self.allocator.refcount(e.page) > 1:
                continue
            freed += self._evict_entry(key)
        return freed

    def clear(self):
        while self._entries:
            self._evict_entry(next(iter(self._entries)))

    def stats(self) -> dict:
        return {"entries": len(self._entries),
                "reclaimable_pages": self.reclaimable(),
                "lookups": self.lookups, "hit_tokens": self.hit_tokens,
                "cow_hits": self.cow_hits,
                "inserted_blocks": self.inserted_blocks,
                "evicted_blocks": self.evicted_blocks}


class PagedKVCache:
    """Page tables for a fixed set of decode slots + the allocator + the
    prefix index.

    page_table[slot] maps logical block j to the physical page holding
    positions [j*ps, (j+1)*ps); entries beyond a request's pages stay 0
    (the null page) so they are always safe to gather/scatter through."""

    def __init__(self, num_slots: int, max_pages_per_seq: int,
                 num_pages: int, page_size: int):
        self.num_slots = int(num_slots)
        self.max_pages_per_seq = int(max_pages_per_seq)
        self.page_size = int(page_size)
        self.allocator = PageAllocator(num_pages)
        self.prefix = PrefixCache(self.allocator, self.page_size)
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

    def map_block(self, slot: int, block: int, page: int):
        """Map ONE logical block (v2 on-demand decode growth)."""
        if not 0 <= block < self.max_pages_per_seq:
            raise ValueError(f"block {block} out of range "
                             f"[0, {self.max_pages_per_seq})")
        self.page_table[slot, block] = page
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
