"""ServingEngine: a DecoderLM behind the Executor as a long-lived service
— the port of ``paddle_tpu/serving/engine.py``.

One engine owns:

  * a fixed set of DECODE SLOTS (max_batch_size) — one decode program of
    static shape [num_slots, ...] runs every step regardless of occupancy
    (inactive slots are masked);
  * a paged KV cache (kv_cache.py) whose pools live in the scope as
    persistable tensors on the executor's device, updated in place;
  * a scheduler deciding, between steps, which waiting requests take
    freed slots and which finished ones release pages.

Three scheduler modes:

``scheduler="fifo"`` — whole-prompt PREFILL programs, one per
prompt-length bucket (next power of two); worst-case page reservation;
strict-FIFO admission.  The engine iteration (`step()`):
  1. admit: the scheduler moves queue-head requests into free slots; each
     is prefilled (bucket-padded, ragged lengths fine) and its first token
     recorded;
  2. decode: one paged_decode_step over all slots; active slots append
     their token, requests hitting eos/max_new are evicted.

``scheduler="v2"`` — prefix caching + chunked prefill + preemption.
Prompts prefill in fixed-size CHUNKS through one MIXED program (a decode
step over all slots + `chunk_lanes` chunk lanes in one run), so long
prompts never stall the running batch's decode.  Admission consults the
prefix-cache index: shared full blocks are mapped (refcounted) instead
of recomputed, a partially matching block is copied on the card
(copy-on-write) before its first divergent token, and decode pages are
allocated on demand — under pressure the scheduler evicts-and-requeues
the lowest-priority request, whose resume (re-prefill of prompt +
generated-so-far) reproduces the uninterrupted greedy output.

``scheduler="spec"`` — v2 plus speculative decoding: the steady-state
decode step becomes a draft→verify→accept round (speculative.py) that
emits only TARGET tokens, so ``spec`` is token-identical to ``v2``.

Everything is deterministic greedy argmax, so the engine reproduces the
JAX package's engine token for token on the same weights.  Each program
run sits in a torch.profiler range (``serve.prefill``, ``serve.decode``,
``serve.mixed``, ``serve.cow_copy``, ``serve.draft``, ``serve.verify``)
so a profile can attribute device time to its phase.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from .. import layers
from ..analysis import memory as amem
from ..framework import unique_name
from ..framework.core import Program, program_guard, torch_dtype
from ..framework.executor import Executor
from ..framework.place import default_place
from ..framework.scope import global_scope
from .kv_cache import DEFAULT_PAGE_SIZE, PagedKVCache, pages_needed
from .scheduler import (RUNNING, ContinuousBatchingScheduler,
                        PreemptiveScheduler, Request)


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
                 max_prefill_per_step: int = 4,
                 place=None, clock=time.monotonic,
                 scheduler: str = "fifo",
                 chunk_size: Optional[int] = None,
                 chunk_lanes: Optional[int] = None,
                 watermark_pages: Optional[int] = None,
                 prefix_caching: bool = True,
                 spec_k: Optional[int] = None,
                 spec_draft_layers: Optional[int] = None,
                 name: Optional[str] = None):
        """`lm` is a DecoderLM whose tower is already built (.logits())
        and whose parameters are in the global scope (the startup program
        ran, or `load_params` wrote them).  `num_pages` defaults to enough
        for every slot at max_len simultaneously (+ the null page).
        `place=None` runs on the card (`default_place()`); `clock` stamps
        arrivals, admissions and tokens.

        v2 knobs: `chunk_size` tokens per prefill chunk (default 32),
        `chunk_lanes` concurrent chunks per mixed step (default
        max_prefill_per_step), `watermark_pages` free pages admission
        keeps for decode growth (default: sized from hbm_report()),
        `prefix_caching=False` disables the shared-page index.  spec
        knobs: `spec_k` draft tokens per round (default 4) and
        `spec_draft_layers` draft depth (default half the layers).
        `name` labels the engine (default: the scheduler mode)."""
        if lm._params is None:
            raise RuntimeError("build the model tower with .logits() "
                               "before constructing a ServingEngine")
        if scheduler not in ("fifo", "v2", "spec"):
            raise ValueError(f"scheduler={scheduler!r}: use 'fifo', 'v2' "
                             "or 'spec'")
        self.lm = lm
        self.mode = scheduler
        # "spec" = the full v2 machinery + speculative steady state
        self._v2like = scheduler in ("v2", "spec")
        self._spec = None  # constructed last (its programs need the pools)
        self.eos_id = int(eos_id)
        self.num_slots = int(max_batch_size)
        self.page_size = int(page_size if page_size is not None
                             else DEFAULT_PAGE_SIZE)
        self.max_pages = pages_needed(lm.max_len, self.page_size)
        self.num_pages = int(num_pages if num_pages is not None
                             else self.num_slots * self.max_pages + 1)
        self._clock = clock
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

        self._mixed_prog = None
        self._copy_prog = None
        if self._v2like:
            self.chunk_size = int(chunk_size if chunk_size is not None
                                  else min(32, lm.max_len))
            self.chunk_lanes = int(chunk_lanes if chunk_lanes is not None
                                   else max(1, min(max_prefill_per_step,
                                                   self.num_slots)))
            self._build_v2_programs()

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
        if self._v2like:
            if watermark_pages is None:
                watermark_pages = self._default_watermark()
            self.scheduler = PreemptiveScheduler(
                self.cache, max_prefill_per_step=max_prefill_per_step,
                watermark_pages=watermark_pages,
                prefix_caching=prefix_caching)
        else:
            self.scheduler = ContinuousBatchingScheduler(
                self.cache, max_prefill_per_step=max_prefill_per_step)
        self.finished: Dict[int, Request] = {}
        self._steps = 0
        self.name = str(name) if name is not None else self.mode
        # the JAX engine's counters: prefill tokens computed vs served from
        # the prefix cache, COW copies, the peak stranded-reservation
        # gauge, step kinds and the speculative tallies.  Beside them, the
        # port's run counts and the time.monotonic seconds spent in each
        # kind of program run.  The fifo path counts its decode steps too,
        # where the JAX engine leaves decode_steps at 0.
        self.counters = {
            "prefill_computed": 0, "prefill_cached": 0,
            "cow_copies": 0, "peak_stranded": 0,
            "mixed_steps": 0, "decode_steps": 0,
            "spec_rounds": 0, "spec_drafted": 0,
            "spec_accepted": 0, "spec_emitted": 0,
            "prefill_runs": 0, "draft_runs": 0,
            "prefill_s": 0.0, "decode_s": 0.0, "mixed_s": 0.0,
            "draft_s": 0.0, "verify_s": 0.0}
        if self.mode == "spec":
            from .speculative import SpeculativeDecoder

            self._spec = SpeculativeDecoder(self, k=spec_k,
                                            draft_layers=spec_draft_layers)

    def _build_v2_programs(self):
        lm, mp = self.lm, self.max_pages
        # ONE mixed prefill+decode program: a decode step over every slot
        # plus `chunk_lanes` prefill chunks per engine step.  Its two ops
        # write the same pools in place, decode first, in desc order.
        self._mixed_prog = Program()
        with program_guard(self._mixed_prog):
            tok = layers.data(f"{self._pfx}.m.tok", shape=[1],
                              dtype="int64")
            ctx = layers.data(f"{self._pfx}.m.ctx", shape=[1],
                              dtype="int64")
            act = layers.data(f"{self._pfx}.m.act", shape=[1],
                              dtype="int64")
            pt = layers.data(f"{self._pfx}.m.pt", shape=[mp],
                             dtype="int64")
            ctok = layers.data(f"{self._pfx}.m.ctok",
                               shape=[self.chunk_size, 1], dtype="int64")
            cctx = layers.data(f"{self._pfx}.m.cctx", shape=[1],
                               dtype="int64")
            cclen = layers.data(f"{self._pfx}.m.cclen", shape=[1],
                                dtype="int64")
            cpt = layers.data(f"{self._pfx}.m.cpt", shape=[mp],
                              dtype="int64")
            cache_vars = lm.declare_kv_cache(self.num_pages, self.page_size,
                                             name=self._cache_name)
            self._mixed_decode_fetch = lm.decode_step(
                cache_vars, tok, ctx, act, pt, self.page_size)
            self._mixed_chunk_fetch = lm.prefill_chunk(
                ctok, cctx, cclen, cpt, cache_vars, self.page_size)

        # COW page-copy program (one copy per run: copies are rare, one
        # per admission at most)
        self._copy_prog = Program()
        with program_guard(self._copy_prog):
            src = layers.data(f"{self._pfx}.cp.src", shape=[1],
                              dtype="int64")
            dst = layers.data(f"{self._pfx}.cp.dst", shape=[1],
                              dtype="int64")
            cache_vars = lm.declare_kv_cache(self.num_pages, self.page_size,
                                             name=self._cache_name)
            self._copy_fetch = lm.page_copy(src, dst, cache_vars)

    def _default_watermark(self) -> int:
        """Admission headroom, sized from the static memory report: the
        worst transient program peak on top of the pools, expressed in
        pages.  Clamped to a quarter of the pool so tiny test pools stay
        admittable."""
        rep = self.hbm_report()
        page_bytes = max(1, rep["kv_pool_bytes"] // self.num_pages)
        transient = max(rep["program_peak_bytes"].values() or [0])
        wm = -(-transient // page_bytes)
        return int(max(1, min(wm, max(1, (self.num_pages - 1) // 4))))

    def submit(self, prompt, max_new_tokens: int,
               arrival: Optional[float] = None, priority: int = 0,
               deadline: Optional[float] = None) -> int:
        """Queue one request; returns its id (see .finished after run()).
        `arrival` (engine-clock timestamp) defaults to now.  `priority`
        orders v2 admission AND preemption survival; `deadline` only
        breaks admission ties between equal priorities.  The FIFO
        scheduler ignores both."""
        if len(prompt) + int(max_new_tokens) > self.lm.max_len:
            raise ValueError(
                f"prompt({len(prompt)}) + max_new({max_new_tokens}) "
                f"exceeds model max_len={self.lm.max_len}")
        req = Request(prompt, max_new_tokens,
                      arrival=self._clock() if arrival is None else arrival,
                      priority=priority, deadline=deadline)
        self.scheduler.submit(req)
        return req.rid

    def outstanding(self) -> int:
        return self.scheduler.outstanding()

    def _run(self, prog, feed, fetch, counter, mark):
        """One program run inside the profiler range `mark`; its wall
        seconds go to counters[counter].  Returns the fetches and the
        engine clock after the run."""
        t0 = time.monotonic()
        with record_function(mark):
            out = self._exe.run(prog, feed=feed, fetch_list=fetch,
                                scope=self._scope)
        self.counters[counter] += time.monotonic() - t0
        return out, self._clock()

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
        cap = min(self.scheduler.max_prefill_per_step, self.num_slots)
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
            (first,), now = self._run(
                prog, {f"{self._pfx}.prompt{bucket}": toks,
                       f"{self._pfx}.plen{bucket}": plen,
                       f"{self._pfx}.ppt{bucket}": pts},
                [fetch], "prefill_s", "serve.prefill")
            self.counters["prefill_runs"] += 1
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
        (nxt,), now = self._run(
            self._decode_prog,
            {f"{self._pfx}.tok": tok, f"{self._pfx}.ctx": ctx,
             f"{self._pfx}.act": act,
             f"{self._pfx}.pt": self.cache.page_table_i64()},
            [self._decode_fetch], "decode_s", "serve.decode")
        self.counters["decode_steps"] += 1
        # snapshot: finish() mutates scheduler.active during the walk
        for slot, r in list(self.scheduler.active.items()):
            r.ctx_len += 1  # this step wrote r.generated[-1]'s K/V
            self._record_token(r, int(nxt[slot]), now)

    # v2: mixed chunked-prefill + decode step, COW copies, preemption

    def _run_copies(self):
        """Drain the scheduler's pending COW copies (one small program run
        each) BEFORE any chunk writes into the destination pages.  The
        scheduler pinned each source page at admission; the pin is
        released here, once the content is duplicated."""
        for slot, src, dst in self.scheduler.pending_copies:
            # the copy's seconds count with the mixed runs it precedes
            self._run(self._copy_prog,
                      {f"{self._pfx}.cp.src": np.array([[src]], np.int64),
                       f"{self._pfx}.cp.dst": np.array([[dst]], np.int64)},
                      [self._copy_fetch], "mixed_s", "serve.cow_copy")
            self.cache.allocator.free([src])
            self.counters["cow_copies"] += 1
        self.scheduler.pending_copies.clear()

    def _index_prompt(self, req: Request):
        """Prefill just completed: publish the request's whole prompt
        blocks (immutable from here on — decode writes land at positions
        >= len(prompt)) into the prefix index for later requests."""
        if not self.scheduler.prefix_caching:
            return
        nb = len(req.prompt) // self.page_size
        if nb:
            self.cache.prefix.insert(req.prompt, req.pages[:nb], nb)

    def _step_v2(self) -> bool:
        now = self._clock()
        self.scheduler.admit(now=now)
        self._run_copies()

        # on-demand decode growth BEFORE feeds are built: a slot about to
        # write position ctx_len needs block ctx_len // ps mapped; under
        # pressure grow() may preempt (possibly the grower itself), so
        # re-check liveness as the walk goes
        for r in sorted(self.scheduler.active.values(),
                        key=lambda r: (-r.priority, r.arrival, r.rid)):
            if r.state != RUNNING or r.ctx_len < r.prefill_target:
                continue
            if r.ctx_len // self.page_size >= len(r.pages):
                self.scheduler.grow(r, now=now)

        lanes = [r for r in self.scheduler.active.values()
                 if r.ctx_len < r.prefill_target]
        lanes.sort(key=lambda r: (-r.priority, r.admit_t, r.rid))
        lanes = lanes[:self.chunk_lanes]
        decoding = [(slot, r) for slot, r in self.scheduler.active.items()
                    if r.ctx_len >= r.prefill_target]

        if not lanes and not decoding:
            self._steps += 1
            return self.scheduler.outstanding() > 0

        if not lanes:
            if self._spec is not None:
                # steady state, spec mode: one draft→verify→accept round
                # emits >= 1 target token per slot (speculative.py)
                self._spec.decode_round(decoding)
                self.counters["spec_rounds"] += 1
            else:
                # steady state: the plain decode program
                self._decode()
            self._steps += 1
            return self.scheduler.outstanding() > 0

        N, K, C = self.num_slots, self.chunk_lanes, self.chunk_size
        tok = np.zeros((N, 1), np.int64)
        ctx = np.zeros((N, 1), np.int64)
        act = np.zeros((N, 1), np.int64)
        for slot, r in decoding:
            tok[slot, 0] = r.generated[-1]
            ctx[slot, 0] = r.ctx_len
            act[slot, 0] = 1
        ctok = np.zeros((K, C, 1), np.int64)
        cctx = np.zeros((K, 1), np.int64)
        cclen = np.zeros((K, 1), np.int64)
        cpt = np.zeros((K, self.max_pages), np.int64)
        chunk_of: List[tuple] = []
        for j, r in enumerate(lanes):
            prefix = r.prompt + r.generated
            cl = min(C, r.prefill_target - r.ctx_len)
            ctok[j, :cl, 0] = prefix[r.ctx_len:r.ctx_len + cl]
            cctx[j, 0] = r.ctx_len
            cclen[j, 0] = cl
            cpt[j] = self.cache.page_table[r.slot]
            chunk_of.append((r, cl))
        (nxt, cnxt), now = self._run(
            self._mixed_prog,
            {f"{self._pfx}.m.tok": tok, f"{self._pfx}.m.ctx": ctx,
             f"{self._pfx}.m.act": act,
             f"{self._pfx}.m.pt": self.cache.page_table_i64(),
             f"{self._pfx}.m.ctok": ctok, f"{self._pfx}.m.cctx": cctx,
             f"{self._pfx}.m.cclen": cclen, f"{self._pfx}.m.cpt": cpt},
            [self._mixed_decode_fetch, self._mixed_chunk_fetch],
            "mixed_s", "serve.mixed")
        self.counters["mixed_steps"] += 1
        for j, (r, cl) in enumerate(chunk_of):
            r.ctx_len += cl
            r.computed_prefill_tokens += cl
            self.counters["prefill_computed"] += cl
            if r.ctx_len >= r.prefill_target:
                # prefill complete: the lane's token is the next greedy
                # token after prompt+generated (the FIRST token for a
                # fresh request, the resume continuation otherwise)
                if r.first_token_t is None:
                    r.first_token_t = now
                self.counters["prefill_cached"] += r.cached_prefill_tokens
                r.cached_prefill_tokens = 0
                self._index_prompt(r)
                self._record_token(r, int(cnxt[j]), now)
        for slot, r in decoding:
            if r.state != RUNNING:
                continue
            r.ctx_len += 1
            self._record_token(r, int(nxt[slot]), now)
        self._steps += 1
        return self.scheduler.outstanding() > 0

    def step(self) -> bool:
        """One engine iteration; returns True while work remains.  FIFO:
        admit + whole-prompt prefill, then one decode step.  v2: admit
        (+ COW copies), then ONE mixed chunked-prefill/decode run (or the
        steady-state decode, or in spec mode a speculative round)."""
        if self._v2like:
            alive = self._step_v2()
        else:
            admitted = self.scheduler.admit(now=self._clock())
            if admitted:
                self._prefill(admitted)
            self._decode()
            self._steps += 1
            alive = self.scheduler.outstanding() > 0
        stats = self.scheduler.page_stats()
        self.counters["peak_stranded"] = max(
            stats["stranded"], self.counters["peak_stranded"])
        return alive

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
        """Serving counters + allocator/prefix/scheduler stats in one
        dict."""
        out = dict(self.counters)
        out["page_stats"] = self.scheduler.page_stats()
        out["prefix"] = self.cache.prefix.stats()
        out["preemptions"] = getattr(self.scheduler, "preemptions", 0)
        return out

    def programs(self) -> Dict[str, Program]:
        """The engine-built programs, for inspection and hbm_report."""
        out = {"decode": self._decode_prog}
        if self._mixed_prog is not None:
            out["mixed"] = self._mixed_prog
        if self._copy_prog is not None:
            out["page_copy"] = self._copy_prog
        if self._spec is not None:
            out.update(self._spec.programs())
        for b, (prog, _) in sorted(self._prefill_progs.items()):
            out[f"prefill_{b}"] = prog
        return out

    def hbm_report(self) -> dict:
        """Static device-memory accounting of the engine
        (analysis/memory.py): the resident K/V pools plus the peak of
        every engine-built program at its batch shape.
        `total_peak_bytes` is the worst program peak ON TOP of the pools
        — the number to compare against the card's memory before sizing
        num_pages/max_batch_size (and the v2 watermark)."""
        dh = self.lm.dim // self.lm.n_heads
        pool_shape = (self.lm.n_layers, self.num_pages, self.lm.n_heads,
                      self.page_size, dh)
        n = 1
        for s in pool_shape:
            n *= s
        kv_pool_bytes = 2 * n * amem.dtype_bytes(self.lm.dtype)  # K and V
        programs = {}
        worst = 0
        for name, prog in self.programs().items():
            est = amem.peak_estimate(prog, batch_size=self.num_slots)
            # pools are persistable vars of every program — already in
            # kv_pool_bytes, so report the non-pool share per program
            share = max(est["total_peak_bytes"] - kv_pool_bytes, 0)
            programs[name] = share
            worst = max(worst, share)
        return {
            "kv_pool_bytes": int(kv_pool_bytes),
            "num_pages": int(self.num_pages),
            "page_size": int(self.page_size),
            "program_peak_bytes": programs,
            "total_peak_bytes": int(kv_pool_bytes + worst),
        }
