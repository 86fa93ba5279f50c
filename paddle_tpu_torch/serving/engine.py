"""ServingEngine: a DecoderLM behind the Executor as a long-lived service.

One engine owns:

  * a fixed set of DECODE SLOTS (max_batch_size) — one decode program of
    static shape [num_slots, ...] runs every step regardless of occupancy
    (inactive slots are masked);
  * a paged KV cache (kv_cache.py) whose pools live in the scope as
    persistable tensors on the executor's device, updated in place;
  * a FIFO scheduler deciding, between steps, which waiting requests take
    freed slots and which finished ones release pages.

The engine iteration (`step()`):
  1. admit: the scheduler moves queue-head requests into free slots; each
     is prefilled (bucket-padded, ragged lengths fine) and its first token
     recorded;
  2. decode: one paged_decode_step over all slots; active slots append
     their token, requests hitting eos/max_new are evicted.

Everything is deterministic greedy argmax, so the engine's output
reproduces the JAX package's engine token for token on the same weights.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from .. import layers
from ..framework import unique_name
from ..framework.core import Program, program_guard, torch_dtype
from ..framework.executor import Executor
from ..framework.place import default_place
from ..framework.scope import global_scope
from .kv_cache import DEFAULT_PAGE_SIZE, PagedKVCache, pages_needed
from .scheduler import (MAX_PREFILL_PER_STEP, ContinuousBatchingScheduler,
                        Request)


def _bucket_of(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class ServingEngine:
    def __init__(self, lm, max_batch_size: int = 8,
                 num_pages: Optional[int] = None,
                 page_size: Optional[int] = None,
                 eos_id: int = -1,
                 place=None, scheduler: str = "fifo"):
        """`lm` is a DecoderLM whose tower is already built (.logits())
        and whose parameters are in the global scope (the startup program
        ran, or `load_params` wrote them).  `num_pages` defaults to enough
        for every slot at max_len simultaneously (+ the null page).
        `place=None` runs on the card (`default_place()`)."""
        if lm._params is None:
            raise RuntimeError("build the model tower with .logits() "
                               "before constructing a ServingEngine")
        if scheduler in ("v2", "spec"):
            raise NotImplementedError(
                f"scheduler={scheduler!r} is not ported yet: ROADMAP.md "
                f"Queue A item 2 (the v2/spec serving slice)")
        if scheduler != "fifo":
            raise ValueError(f"scheduler={scheduler!r}: use 'fifo'")
        self.lm = lm
        self.mode = scheduler
        self.eos_id = int(eos_id)
        self.num_slots = int(max_batch_size)
        self.page_size = int(page_size if page_size is not None
                             else DEFAULT_PAGE_SIZE)
        self.max_pages = pages_needed(lm.max_len, self.page_size)
        self.num_pages = int(num_pages if num_pages is not None
                             else self.num_slots * self.max_pages + 1)
        self._scope = global_scope()

        self.cache = PagedKVCache(self.num_slots, self.max_pages,
                                  self.num_pages, self.page_size)

        self._exe = Executor(place if place is not None else default_place())
        self._pfx = unique_name.generate("serve")
        self._cache_name = f"{self._pfx}.kv"

        # decode program: fixed [num_slots] shape
        self._decode_prog = Program()
        with program_guard(self._decode_prog):
            tok = layers.data(f"{self._pfx}.tok", shape=[1], dtype="int64")
            ctx = layers.data(f"{self._pfx}.ctx", shape=[1], dtype="int64")
            act = layers.data(f"{self._pfx}.act", shape=[1], dtype="int64")
            pt = layers.data(f"{self._pfx}.pt", shape=[self.max_pages],
                             dtype="int64")
            cache_vars = lm.declare_kv_cache(self.num_pages, self.page_size,
                                             name=self._cache_name)
            self._decode_fetch = lm.decode_step(
                cache_vars, tok, ctx, act, pt, self.page_size)

        # the pools: zero-initialized persistable scope state on the
        # executor's device (page 0 = null page)
        dh = lm.dim // lm.n_heads
        pool_shape = (lm.n_layers, self.num_pages, lm.n_heads,
                      self.page_size, dh)
        for s in ("k", "v"):
            self._scope.set(f"{self._cache_name}.{s}", torch.zeros(
                pool_shape, dtype=torch_dtype(lm.dtype),
                device=self._exe.device))

        self._prefill_progs: Dict[int, tuple] = {}  # bucket -> (prog, fetch)
        self.scheduler = ContinuousBatchingScheduler(self.cache)
        self.finished: Dict[int, Request] = {}
        self._steps = 0
        # prefill tokens computed, prefill program runs, decode program
        # runs, the time.monotonic seconds spent in each kind of run, and
        # the peak stranded-reservation gauge.  Each run also sits in a
        # torch.profiler range ("serve.prefill" / "serve.decode") so a
        # profile can attribute device time to its phase.
        self.counters = {"prefill_computed": 0, "prefill_runs": 0,
                         "decode_steps": 0, "prefill_s": 0.0,
                         "decode_s": 0.0, "peak_stranded": 0}

    def submit(self, prompt, max_new_tokens: int,
               arrival: Optional[float] = None) -> int:
        """Queue one request; returns its id (see .finished after run()).
        `arrival` (a time.monotonic timestamp) defaults to now."""
        if len(prompt) + int(max_new_tokens) > self.lm.max_len:
            raise ValueError(
                f"prompt({len(prompt)}) + max_new({max_new_tokens}) "
                f"exceeds model max_len={self.lm.max_len}")
        req = Request(prompt, max_new_tokens,
                      arrival=time.monotonic() if arrival is None
                      else arrival)
        self.scheduler.submit(req)
        return req.rid

    def outstanding(self) -> int:
        return self.scheduler.outstanding()

    def _prefill_program(self, bucket: int):
        entry = self._prefill_progs.get(bucket)
        if entry is not None:
            return entry
        prog = Program()
        with program_guard(prog):
            prompt = layers.data(f"{self._pfx}.prompt{bucket}",
                                 shape=[bucket, 1], dtype="int64")
            plen = layers.data(f"{self._pfx}.plen{bucket}", shape=[1],
                               dtype="int64")
            pt = layers.data(f"{self._pfx}.ppt{bucket}",
                             shape=[self.max_pages], dtype="int64")
            cache_vars = self.lm.declare_kv_cache(
                self.num_pages, self.page_size, name=self._cache_name)
            fetch = self.lm.prefill(prompt, plen, pt, cache_vars,
                                    self.page_size)
        entry = (prog, fetch)
        self._prefill_progs[bucket] = entry
        return entry

    def _prefill(self, reqs: List[Request]):
        """Prefill newly admitted requests, one bucket batch at a time.
        The batch dim is padded to a power of two <= the admission cap, as
        in the JAX engine (there it bounds the compiled shapes); dummy rows
        carry plen=1 and an all-null page table, so their writes land in
        the null page and their token is discarded."""
        by_bucket: Dict[int, List[Request]] = {}
        for r in reqs:
            # cap at max_len: the position table has max_len rows
            b = min(_bucket_of(len(r.prompt)), self.lm.max_len)
            by_bucket.setdefault(b, []).append(r)
        cap = min(MAX_PREFILL_PER_STEP, self.num_slots)
        for bucket, group in sorted(by_bucket.items()):
            prog, fetch = self._prefill_program(bucket)
            G = 1
            while G < len(group):
                G *= 2
            G = min(G, cap)
            toks = np.zeros((G, bucket, 1), np.int64)
            plen = np.ones((G, 1), np.int64)
            pts = np.zeros((G, self.max_pages), np.int64)
            for i, r in enumerate(group):
                toks[i, :len(r.prompt), 0] = r.prompt
                plen[i, 0] = len(r.prompt)
                pts[i] = self.cache.page_table[r.slot]
            t0 = time.monotonic()
            with record_function("serve.prefill"):
                (first,) = self._exe.run(
                    prog,
                    feed={f"{self._pfx}.prompt{bucket}": toks,
                          f"{self._pfx}.plen{bucket}": plen,
                          f"{self._pfx}.ppt{bucket}": pts},
                    fetch_list=[fetch], scope=self._scope)
            now = time.monotonic()
            self.counters["prefill_runs"] += 1
            self.counters["prefill_s"] += now - t0
            for i, r in enumerate(group):
                r.ctx_len = len(r.prompt)
                r.first_token_t = now
                self.counters["prefill_computed"] += len(r.prompt)
                self._record_token(r, int(first[i]), now)

    def _record_token(self, req: Request, token: int, now: float):
        req.generated.append(token)
        done = (len(req.generated) >= req.max_new_tokens
                or (self.eos_id >= 0 and token == self.eos_id))
        if done:
            self.scheduler.finish(req, now=now)
            self.finished[req.rid] = req

    def _decode(self):
        if not self.scheduler.active:
            return
        N = self.num_slots
        tok = np.zeros((N, 1), np.int64)
        ctx = np.zeros((N, 1), np.int64)
        act = np.zeros((N, 1), np.int64)
        for slot, r in self.scheduler.active.items():
            tok[slot, 0] = r.generated[-1]
            ctx[slot, 0] = r.ctx_len
            act[slot, 0] = 1
        t0 = time.monotonic()
        with record_function("serve.decode"):
            (nxt,) = self._exe.run(
                self._decode_prog,
                feed={f"{self._pfx}.tok": tok, f"{self._pfx}.ctx": ctx,
                      f"{self._pfx}.act": act,
                      f"{self._pfx}.pt": self.cache.page_table_i64()},
                fetch_list=[self._decode_fetch], scope=self._scope)
        now = time.monotonic()
        self.counters["decode_steps"] += 1
        self.counters["decode_s"] += now - t0
        # snapshot: finish() mutates scheduler.active during the walk
        for slot, r in list(self.scheduler.active.items()):
            r.ctx_len += 1  # this step wrote r.generated[-1]'s K/V
            self._record_token(r, int(nxt[slot]), now)

    def step(self) -> bool:
        """One engine iteration (admit + whole-prompt prefill, then one
        decode step); returns True while work remains."""
        admitted = self.scheduler.admit(now=time.monotonic())
        if admitted:
            self._prefill(admitted)
        self._decode()
        self._steps += 1
        stats = self.scheduler.page_stats()
        self.counters["peak_stranded"] = max(
            stats["stranded"], self.counters["peak_stranded"])
        return self.scheduler.outstanding() > 0

    def run(self, max_steps: int = 100000) -> Dict[int, Request]:
        """Drive until every submitted request finished (or the step
        budget trips — a scheduler bug, surfaced loudly)."""
        for _ in range(max_steps):
            if not self.step():
                return self.finished
        raise RuntimeError(
            f"serving engine still has {self.scheduler.outstanding()} "
            f"outstanding request(s) after {max_steps} steps")

    def pop_finished(self) -> Dict[int, Request]:
        """Drain completed requests (a long-lived service must, or
        .finished retains every request ever completed)."""
        out = self.finished
        self.finished = {}
        return out

    def stats(self) -> dict:
        """Serving counters + allocator stats in one dict."""
        out = dict(self.counters)
        out["page_stats"] = self.scheduler.page_stats()
        return out
