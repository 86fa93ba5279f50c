"""Request-level continuous batching: admission and eviction.

``ContinuousBatchingScheduler`` is STRICT FIFO with head-blocking:
requests are admitted in arrival order, and if the head of the queue
cannot be placed (no slot, or the pool cannot cover its worst-case pages)
nothing behind it is considered.  Pages are reserved worst-case at
admission (ceil((prompt + max_new)/ps)), so decode never allocates and can
never run out mid-flight — but a request that stops early STRANDS its
unused reservation; ``page_stats()`` makes that measurable.
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Dict, List, Optional

from .kv_cache import PagedKVCache, pages_needed

WAITING, RUNNING, FINISHED = "waiting", "running", "finished"

# admissions (and so whole-prompt prefills) per engine iteration: bounds
# how long one iteration's prefill can stall the running requests' decode
MAX_PREFILL_PER_STEP = 4


class Request:
    """One generation request and its lifecycle bookkeeping."""

    _ids = itertools.count()

    def __init__(self, prompt, max_new_tokens: int, rid: Optional[int] = None,
                 arrival: float = 0.0):
        self.rid = next(self._ids) if rid is None else rid
        self.prompt = [int(t) for t in prompt]
        if not self.prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens={max_new_tokens}")
        self.max_new_tokens = int(max_new_tokens)
        self.arrival = arrival
        self.state = WAITING
        self.generated: List[int] = []
        self.slot: Optional[int] = None
        self.pages: List[int] = []
        self.ctx_len = 0  # tokens currently materialized in the cache
        # timing (time.monotonic): admission, first token, completion
        self.admit_t: Optional[float] = None
        self.first_token_t: Optional[float] = None
        self.finish_t: Optional[float] = None


class ContinuousBatchingScheduler:
    def __init__(self, cache: PagedKVCache):
        self.cache = cache
        self.active: Dict[int, Request] = {}  # slot -> request
        # pop() from the tail keeps low slot ids hot
        self._free_slots = list(range(cache.num_slots - 1, -1, -1))
        # admission witness (admission == arrival under FIFO); bounded so
        # a long-lived service doesn't grow it forever
        self.admission_order: deque = deque(maxlen=4096)
        self.waiting: deque = deque()
        # plain counters (the JAX package mirrors these into its metrics
        # registry)
        self.metrics = {"admissions": 0}

    def submit(self, req: Request):
        """Queue a request.  Anything that could NEVER be admitted (worst
        case beyond what the pool can ever grant) is rejected here: under
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
        self.waiting.append(req)

    def outstanding(self) -> int:
        return len(self.waiting) + len(self.active)

    def admit(self, now: float = 0.0) -> List[Request]:
        """Move queue-head requests into free slots (prefill phase), at
        most MAX_PREFILL_PER_STEP of them."""
        out: List[Request] = []
        while (self.waiting and self._free_slots
               and len(out) < MAX_PREFILL_PER_STEP):
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
            self.metrics["admissions"] += 1
            out.append(req)
        return out

    def finish(self, req: Request, now: float = 0.0):
        """Evict a completed request: pages and slot return immediately."""
        if req.state != RUNNING:
            raise ValueError(f"request {req.rid} is {req.state}")
        req.state = FINISHED
        req.finish_t = now
        self.cache.release(req.slot)
        self.cache.allocator.free(req.pages)
        del self.active[req.slot]
        self._free_slots.append(req.slot)
        req.slot = None
        req.pages = []

    def page_stats(self) -> dict:
        """Reservation accounting: worst-case admission holds `reserved`
        pages but the materialized contexts only cover `used` — the
        difference is STRANDED capacity."""
        ps = self.cache.page_size
        reserved = sum(len(r.pages) for r in self.active.values())
        used = sum(pages_needed(max(r.ctx_len, 1), ps)
                   for r in self.active.values())
        return {"reserved": reserved, "used": used,
                "stranded": reserved - used,
                **self.cache.allocator.stats()}
