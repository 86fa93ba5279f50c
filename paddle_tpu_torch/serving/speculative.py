"""Speculative decoding for the serving engine — the port of
``paddle_tpu/serving/speculative.py``.

SELF-speculation by depth truncation: the DRAFT is the target model's
first ``draft_layers`` blocks plus the shared embedding / position /
final-LN / head (``DecoderLM.truncated``) — no second parameter set, and
because draft layer i IS target layer i, the K/V rows the draft writes at
pool layers ``< draft_layers`` are the values the target itself would
write there.  The draft therefore runs over the TARGET's paged KV pools:
no draft pool, no draft prefill.

One speculative ROUND per engine step, over every decoding slot:

  1. DRAFT — one ``paged_spec_draft`` run proposes K greedy tokens per
     slot (K chained draft decode steps in one op);
  2. VERIFY — one ``paged_prefill_chunk`` run with ``all_tokens=1``
     scores the K+1 rows [last_token, d_1 .. d_K] at context offset
     ctx_len: row c's pick is the TARGET's next token given the context
     through chunk position c;
  3. ACCEPT — the host walk takes target tokens while the draft agreed
     (``d_{c+1} == v_c``) and always emits the first disagreeing target
     token, so every emitted token is a TARGET token and the output is
     token-identical to autoregressive v2.  Rejected positions' K/V sit
     past ctx_len, invisible to masked attention and rewritten before
     they can become visible.

The JAX package resolves the speculation depth K and the draft depth
through its autotune knob layer; the port uses that layer's defaults
(K = 4, half the layers) until the autotune slice brings the knobs
(ROADMAP Queue A).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import layers
from ..framework.core import Program, program_guard
from .scheduler import RUNNING

DEFAULT_SPEC_K = 4


def build_draft_lm(lm, n_layers: Optional[int] = None):
    """The one draft mint: the truncated parameter-sharing view of `lm`,
    `n_layers` deep (default: the knob layer's ``spec_draft_layers``,
    whose own default is half of `lm`'s layers, at least 1)."""
    if n_layers is None:
        from ..autotune import knobs

        n_layers = knobs.spec_draft_layers(max(1, lm.n_layers // 2))
    n_layers = max(1, min(int(n_layers), lm.n_layers))
    return lm.truncated(n_layers)


class SpeculativeDecoder:
    """Draft + verify + accept over one ServingEngine's decode slots.

    Owns the two extra programs (both of static [num_slots] shape like
    the engine's decode program) and the accept walk; the engine calls
    :meth:`decode_round` wherever plain v2 would run its steady-state
    decode step.  Page growth for the speculative window goes through the
    scheduler's normal ``grow`` ladder, so a request preempted mid-round
    simply drops out of it and resumes later token-exactly."""

    def __init__(self, engine, k: Optional[int] = None,
                 draft_layers: Optional[int] = None):
        if k is None:
            from ..autotune import knobs

            k = knobs.speculation_k(DEFAULT_SPEC_K)
        self.k = max(1, int(k))
        self.engine = engine
        self.draft = build_draft_lm(engine.lm, draft_layers)

        pfx, mp = engine._pfx, engine.max_pages
        self._draft_prog = Program()
        with program_guard(self._draft_prog):
            tok = layers.data(f"{pfx}.sd.tok", shape=[1], dtype="int64")
            ctx = layers.data(f"{pfx}.sd.ctx", shape=[1], dtype="int64")
            slen = layers.data(f"{pfx}.sd.slen", shape=[1], dtype="int64")
            pt = layers.data(f"{pfx}.sd.pt", shape=[mp], dtype="int64")
            # TARGET-shaped pools: the draft touches only layers < its
            # depth, so the two towers share one physical cache
            cache_vars = engine.lm.declare_kv_cache(
                engine.num_pages, engine.page_size,
                name=engine._cache_name)
            self._draft_fetch = self.draft.spec_draft(
                cache_vars, tok, ctx, slen, pt, engine.page_size, self.k)

        self._verify_prog = Program()
        with program_guard(self._verify_prog):
            C = self.k + 1
            vtok = layers.data(f"{pfx}.vf.tok", shape=[C, 1],
                               dtype="int64")
            vctx = layers.data(f"{pfx}.vf.ctx", shape=[1], dtype="int64")
            vclen = layers.data(f"{pfx}.vf.clen", shape=[1],
                                dtype="int64")
            vpt = layers.data(f"{pfx}.vf.pt", shape=[mp], dtype="int64")
            cache_vars = engine.lm.declare_kv_cache(
                engine.num_pages, engine.page_size,
                name=engine._cache_name)
            _, self._verify_fetch = engine.lm.prefill_chunk(
                vtok, vctx, vclen, vpt, cache_vars, engine.page_size,
                all_tokens=True)

    def programs(self) -> Dict[str, Program]:
        return {"spec_draft": self._draft_prog,
                "spec_verify": self._verify_prog}

    def _window(self, r) -> int:
        """Per-request speculation depth this round: never draft past the
        request's max_new budget (the bonus token means K drafts can emit
        K+1) nor past the pages actually mapped."""
        remaining = r.max_new_tokens - len(r.generated)
        ke = min(self.k, remaining - 1)
        ke = min(ke, len(r.pages) * self.engine.page_size - r.ctx_len - 1)
        return max(0, ke)

    def decode_round(self, decoding: List[Tuple[int, object]]) -> None:
        """One draft→verify→accept round over `decoding` (slot, request)
        pairs.  Emits >= 1 target token per live request."""
        eng = self.engine
        N, K = eng.num_slots, self.k

        # grow pages to cover each slot's speculative window (positions
        # ctx .. ctx+ke); grow() may preempt — the victim (possibly the
        # grower) just drops out of this round
        now = eng._clock()
        for slot, r in decoding:
            if r.state != RUNNING:
                continue
            ke = self._window(r)
            while (r.ctx_len + ke) // eng.page_size >= len(r.pages):
                if not eng.scheduler.grow(r, now=now):
                    break
        live = [(slot, r) for slot, r in decoding if r.state == RUNNING]
        if not live:
            return
        window = {slot: self._window(r) for slot, r in live}

        drafted = None
        if any(window.values()):
            tok = np.zeros((N, 1), np.int64)
            ctx = np.zeros((N, 1), np.int64)
            slen = np.zeros((N, 1), np.int64)
            for slot, r in live:
                tok[slot, 0] = r.generated[-1]
                ctx[slot, 0] = r.ctx_len
                slen[slot, 0] = window[slot]
            (drafted,), _ = eng._run(
                self._draft_prog,
                {f"{eng._pfx}.sd.tok": tok, f"{eng._pfx}.sd.ctx": ctx,
                 f"{eng._pfx}.sd.slen": slen,
                 f"{eng._pfx}.sd.pt": eng.cache.page_table_i64()},
                [self._draft_fetch], "draft_s", "serve.draft")
            eng.counters["draft_runs"] += 1

        vtok = np.zeros((N, K + 1, 1), np.int64)
        vctx = np.zeros((N, 1), np.int64)
        vclen = np.zeros((N, 1), np.int64)
        for slot, r in live:
            ke = window[slot]
            vtok[slot, 0, 0] = r.generated[-1]
            if ke:
                vtok[slot, 1:1 + ke, 0] = drafted[slot, :ke]
            vctx[slot, 0] = r.ctx_len
            vclen[slot, 0] = ke + 1
        (vtoks,), now = eng._run(
            self._verify_prog,
            {f"{eng._pfx}.vf.tok": vtok, f"{eng._pfx}.vf.ctx": vctx,
             f"{eng._pfx}.vf.clen": vclen,
             f"{eng._pfx}.vf.pt": eng.cache.page_table_i64()},
            [self._verify_fetch], "verify_s", "serve.verify")

        tot_drafted = tot_accepted = tot_emitted = 0
        for slot, r in live:
            ke = window[slot]
            v = vtoks[slot]
            i = 0
            while i < ke and int(drafted[slot, i]) == int(v[i]):
                i += 1
            tot_drafted += ke
            tot_accepted += i
            r.spec_drafted += ke
            r.spec_accepted += i
            # emit v[0..i]: i accepted drafts' target tokens plus the
            # correction (or bonus) token — all TARGET tokens
            for c in range(i + 1):
                r.ctx_len += 1
                tot_emitted += 1
                eng._record_token(r, int(v[c]), now)
                if r.state != RUNNING:
                    break  # eos / max_new finished the request
        eng.counters["spec_drafted"] += tot_drafted
        eng.counters["spec_accepted"] += tot_accepted
        eng.counters["spec_emitted"] += tot_emitted
