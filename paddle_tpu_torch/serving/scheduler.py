"""Request-level continuous batching: admission, eviction, preemption —
the port of ``paddle_tpu/serving/scheduler.py``.

Two schedulers share the Request lifecycle and one PagedKVCache:

``ContinuousBatchingScheduler`` — STRICT FIFO with head-blocking:
requests are admitted in arrival order, and if the head of the queue
cannot be placed (no slot, or the pool cannot cover its worst-case pages)
nothing behind it is considered.  Pages are reserved worst-case at
admission (ceil((prompt + max_new)/ps)), so decode never allocates — but
a request that stops early STRANDS its unused reservation;
``page_stats()`` makes that measurable.

``PreemptiveScheduler`` — the v2 scheduler:

  * priority/deadline-aware admission: the waiting set is a heap ordered
    by (priority desc, deadline, arrival); equal priorities and no
    deadlines degrade exactly to arrival order;
  * WATERMARK admission: a request is admitted when the pool can cover
    the pages its context needs *now* (prompt + already-generated tokens,
    minus what the prefix cache already holds) while keeping `watermark`
    pages free for in-flight decode growth.  Decode allocates pages on
    demand (`grow`);
  * PREEMPTION under page pressure: when growth (or a strictly-higher-
    priority admission) cannot be satisfied even after evicting
    reclaimable prefix-cache pages, the lowest-priority / youngest active
    request is evicted and requeued with its generated tokens kept; on
    re-admission the engine re-prefills prompt + generated, so the greedy
    continuation is the uninterrupted one.

The JAX package also counts admissions, preemptions and reclaimed pages
by ladder rung in its metrics registry; the port's observability slice
brings that registry (ROADMAP Queue A).
"""

from __future__ import annotations

import heapq
import itertools
from collections import deque
from typing import Dict, List, Optional

from .kv_cache import PagedKVCache, pages_needed

WAITING, RUNNING, FINISHED = "waiting", "running", "finished"


class Request:
    """One generation request and its lifecycle bookkeeping."""

    _ids = itertools.count()

    def __init__(self, prompt, max_new_tokens: int, rid: Optional[int] = None,
                 arrival: float = 0.0, priority: int = 0,
                 deadline: Optional[float] = None):
        self.rid = next(self._ids) if rid is None else rid
        self.prompt = [int(t) for t in prompt]
        if not self.prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens={max_new_tokens}")
        self.max_new_tokens = int(max_new_tokens)
        self.arrival = arrival
        self.priority = int(priority)   # higher admits (and survives) first
        self.deadline = deadline        # engine-clock stamp; earlier first
        self.state = WAITING
        self.generated: List[int] = []
        self.slot: Optional[int] = None
        self.pages: List[int] = []
        self.ctx_len = 0  # tokens currently materialized in the cache
        # v2 bookkeeping: prefill frontier (tokens of prompt+generated whose
        # K/V must be materialized before decode), preemption + cache stats
        self.prefill_target = 0
        self.preemptions = 0
        self.cached_prefill_tokens = 0
        self.computed_prefill_tokens = 0
        # speculative decoding: drafts offered to / accepted by the verify
        # step for THIS request
        self.spec_drafted = 0
        self.spec_accepted = 0
        # timing (engine clock): admission, first token, completion
        self.admit_t: Optional[float] = None
        self.first_token_t: Optional[float] = None
        self.finish_t: Optional[float] = None


def _used_pages(req: Request, page_size: int) -> int:
    """Pages the request's materialized context actually covers.  A
    request still prefilling counts its whole admission allocation
    (`prefill_target`, 0 on the fifo path): those pages hold work queued
    chunk by chunk, not stranded capacity."""
    return pages_needed(max(req.ctx_len, 1, req.prefill_target), page_size)


class _SchedulerBase:
    """Slot/page release + reservation accounting shared by both
    schedulers, so their eviction paths cannot drift apart."""

    def __init__(self, cache: PagedKVCache, max_prefill_per_step: int = 4):
        self.cache = cache
        # admissions (and so prefills) per engine iteration: bounds how
        # long one iteration's prefill can stall the running decode
        self.max_prefill_per_step = int(max_prefill_per_step)
        self.active: Dict[int, Request] = {}  # slot -> request
        # pop() from the tail keeps low slot ids hot
        self._free_slots = list(range(cache.num_slots - 1, -1, -1))
        # admission witness; bounded so a long-lived service doesn't grow
        # it forever
        self.admission_order: deque = deque(maxlen=4096)

    def _check_feasible(self, req: Request):
        """Submit-time rejection of anything that could NEVER be admitted
        (worst-case pages beyond what the pool can ever grant): under
        head-blocking FIFO an unadmittable head would stall the queue."""
        if req.state != WAITING:
            raise ValueError(f"request {req.rid} is {req.state}")
        need = pages_needed(len(req.prompt) + req.max_new_tokens,
                            self.cache.page_size)
        cap = min(self.cache.max_pages_per_seq,
                  self.cache.allocator.num_pages - 1)
        if need > cap:
            raise ValueError(
                f"request {req.rid}: worst case {need} pages but the pool "
                f"can ever grant {cap} (num_pages="
                f"{self.cache.allocator.num_pages} incl. the null page, "
                f"max_pages_per_seq={self.cache.max_pages_per_seq})")

    def _release(self, req: Request):
        """The one slot/page release sequence (finish and preempt)."""
        self.cache.release(req.slot)
        self.cache.allocator.free(req.pages)
        del self.active[req.slot]
        self._free_slots.append(req.slot)
        req.slot = None
        req.pages = []

    def finish(self, req: Request, now: float = 0.0):
        """Evict a completed request: pages and slot return immediately
        (shared pages just drop this holder)."""
        if req.state != RUNNING:
            raise ValueError(f"request {req.rid} is {req.state}")
        req.state = FINISHED
        req.finish_t = now
        self._release(req)

    def page_stats(self) -> dict:
        """Reservation accounting: worst-case admission holds `reserved`
        pages but the materialized contexts only cover `used` — the
        difference is STRANDED capacity."""
        ps = self.cache.page_size
        reserved = sum(len(r.pages) for r in self.active.values())
        used = sum(_used_pages(r, ps) for r in self.active.values())
        return {"reserved": reserved, "used": used,
                "stranded": reserved - used,
                **self.cache.allocator.stats()}


class ContinuousBatchingScheduler(_SchedulerBase):
    def __init__(self, cache: PagedKVCache, max_prefill_per_step: int = 4):
        super().__init__(cache, max_prefill_per_step)
        self.waiting: deque = deque()

    def submit(self, req: Request):
        """Queue a request (see `_check_feasible`)."""
        self._check_feasible(req)
        self.waiting.append(req)

    def outstanding(self) -> int:
        return len(self.waiting) + len(self.active)

    def admit(self, now: float = 0.0) -> List[Request]:
        """Move queue-head requests into free slots (prefill phase), at
        most max_prefill_per_step of them."""
        out: List[Request] = []
        while (self.waiting and self._free_slots
               and len(out) < self.max_prefill_per_step):
            req = self.waiting[0]
            # submit() proved need <= the pool's lifetime capacity, so a
            # failed alloc here is transient pressure, never a stall
            need = pages_needed(len(req.prompt) + req.max_new_tokens,
                                self.cache.page_size)
            pages = self.cache.allocator.alloc(need)
            if pages is None:
                break  # head-blocking FIFO: never skip past the head
            self.waiting.popleft()
            slot = self._free_slots.pop()
            req.slot, req.pages = slot, pages
            req.state = RUNNING
            req.admit_t = now
            self.cache.assign(slot, pages)
            self.active[slot] = req
            self.admission_order.append(req.rid)
            out.append(req)
        return out


class PreemptiveScheduler(_SchedulerBase):
    """Priority/deadline admission + watermark paging + preemption (v2).

    The scheduler owns placement and page accounting; the ENGINE owns
    what runs each step (chunk lanes, decode feeds) and calls back in:
    ``admit`` -> placed requests (prefix-cache hits resolved, pages for
    the current context allocated, page-table row written), ``grow`` ->
    one more page for a decode crossing a page boundary, ``finish`` /
    ``preempt`` -> release.  Admission order: priority desc, deadline,
    arrival."""

    def __init__(self, cache: PagedKVCache, max_prefill_per_step: int = 4,
                 watermark_pages: int = 1, prefix_caching: bool = True):
        super().__init__(cache, max_prefill_per_step)
        self.watermark_pages = max(0, int(watermark_pages))
        self.prefix_caching = bool(prefix_caching)
        self._heap: list = []  # (-priority, deadline-or-inf, arrival, seq, r)
        self._seq = itertools.count()  # heap tiebreak: submission order
        self.preemptions = 0
        # COW copies the engine must run before the owner's next chunk:
        # (slot, src_page, dst_page) triples, drained by the engine
        self.pending_copies: List[tuple] = []

    def submit(self, req: Request):
        self._check_feasible(req)
        heapq.heappush(self._heap, (-req.priority,
                                    req.deadline if req.deadline is not None
                                    else float("inf"),
                                    req.arrival, next(self._seq), req))

    def outstanding(self) -> int:
        return len(self._heap) + len(self.active)

    def _reclaim(self, need: int) -> bool:
        """Make `need` pages allocatable, cheapest lever first: evict LRU
        prefix-cache entries.  Returns True when alloc(need) can
        succeed."""
        short = need - self.cache.allocator.available()
        if short > 0:
            self.cache.prefix.evict_pages(short)
        return self.cache.allocator.available() >= need

    def _victim(self, exclude: Optional[Request] = None,
                below_priority: Optional[int] = None) -> Optional[Request]:
        """Preemption victim: lowest priority, then YOUNGEST arrival (the
        oldest request of a class is the last to go)."""
        best = None
        for r in self.active.values():
            if r is exclude:
                continue
            if below_priority is not None and r.priority >= below_priority:
                continue
            key = (r.priority, -r.arrival, -r.rid)
            if best is None or key < best[0]:
                best = (key, r)
        return best[1] if best else None

    def preempt(self, req: Request, now: float = 0.0):
        """Evict-and-requeue: pages back to the pool (shared pages just
        drop this holder), generated tokens kept, position in line
        restored by the original arrival stamp."""
        if req.state != RUNNING:
            raise ValueError(f"request {req.rid} is {req.state}")
        # drop any pending COW copy into the victim's row before its pages
        # return to the pool: the copy would otherwise run against a page
        # the allocator may have re-issued
        kept = []
        for slot, src, dst in self.pending_copies:
            if slot == req.slot:
                self.cache.allocator.free([src])  # the admit-time pin
            else:
                kept.append((slot, src, dst))
        self.pending_copies[:] = kept
        self._release(req)
        req.ctx_len = 0
        req.prefill_target = 0
        req.state = WAITING
        req.preemptions += 1
        self.preemptions += 1
        self.submit(req)

    def admit(self, now: float = 0.0) -> List[Request]:
        out: List[Request] = []
        while (self._heap and self._free_slots
               and len(out) < self.max_prefill_per_step):
            req = self._heap[0][4]
            target = len(req.prompt) + len(req.generated)
            hit, shared, partial = (0, [], None)
            if self.prefix_caching:
                # count=False: the watermark-preempt retry below re-runs
                # this lookup; count_hit() on placement keeps stats()
                # per-admission
                hit, shared, partial = self.cache.prefix.lookup(
                    req.prompt, max_reuse=target - 1, count=False)
            # PIN every looked-up page (shared blocks AND the COW source)
            # before any reclaim below: eviction could otherwise free
            # exactly these pages and hand them back via alloc() as this
            # request's PRIVATE pages — two blocks aliasing one page
            pinned = list(shared) + ([partial[0]] if partial else [])
            self.cache.allocator.retain(pinned)
            n_blocks = pages_needed(target, self.cache.page_size)
            need = n_blocks - len(shared)  # private (+ COW dst) pages
            # watermark: keep headroom for the ACTIVE batch's decode
            # growth; a sole admission may dip into it (otherwise a big
            # prompt and a big watermark could deadlock an empty engine)
            headroom = (self.cache.allocator.available()
                        + self.cache.prefix.reclaimable() - need)
            if headroom < self.watermark_pages and (self.active or out):
                # a strictly-higher-priority arrival may preempt its way
                # in instead of waiting out the pressure
                self.cache.allocator.free(pinned)
                victim = self._victim(below_priority=req.priority)
                if victim is None:
                    break
                self.preempt(victim, now=now)
                continue  # re-pin via a fresh lookup next iteration
            if not self._reclaim(need) and partial is not None:
                # the COW-source pin can itself make reclaim
                # unsatisfiable (it occupies a page eviction must skip
                # while not reducing `need`): forgo the COW hit and try
                # again against the shared blocks alone
                self.cache.allocator.free([partial[0]])
                partial = None
                pinned = list(shared)
            if not self._reclaim(need):
                self.cache.allocator.free(pinned)
                break
            pages = self.cache.allocator.alloc(need)
            if pages is None:
                self.cache.allocator.free(pinned)
                break
            heapq.heappop(self._heap)
            # the shared-block pins become the mapping's holders (freed
            # with the row at finish/preempt); the COW source pin is held
            # until the engine has run the copy into the PRIVATE dst page
            slot = self._free_slots.pop()
            row = list(shared) + pages
            req.slot, req.pages = slot, row
            req.state = RUNNING
            req.admit_t = now
            req.ctx_len = hit
            if partial is not None:
                src, m = partial
                self.pending_copies.append((slot, src, pages[0]))
                req.ctx_len = hit + m
            req.prefill_target = target
            req.cached_prefill_tokens += req.ctx_len
            if self.prefix_caching:
                self.cache.prefix.count_hit(hit, partial)
            self.cache.assign(slot, row)
            self.active[slot] = req
            self.admission_order.append(req.rid)
            out.append(req)
        return out

    def grow(self, req: Request, now: float = 0.0) -> bool:
        """One more page for `req` (its context is crossing a page
        boundary).  Under pressure: evict prefix-cache LRU, then preempt
        lowest-priority/youngest OTHER requests, and as the last resort
        preempt `req` itself (requeued, resumed later — never stuck).
        Returns False when `req` was preempted instead of grown."""
        while True:
            if self._reclaim(1):
                (page,) = self.cache.allocator.alloc(1)
                block = len(req.pages)
                req.pages.append(page)
                self.cache.map_block(req.slot, block, page)
                return True
            # victim chosen over ALL active including `req` itself: the
            # youngest of the lowest priority class goes
            victim = self._victim()
            if victim is None or victim is req:
                self.preempt(req, now=now)
                return False
            self.preempt(victim, now=now)

    def page_stats(self) -> dict:
        return {**super().page_stats(), "watermark": self.watermark_pages}
