"""The port's v2 and speculative serving slice against the JAX package on
the CPU.

The same small decoder LM is built in both packages and the JAX startup's
parameters are carried across with ``DecoderLM.load_params``.  The chunk,
draft and page-copy ops, the prefix cache and the preemptive scheduler,
and whole v2 and spec engines must then agree with JAX: greedy tokens
exactly, pools to f32 reduction-order tolerance outside the null page
(which takes the duplicate writes of pad rows, in any order), scheduler
decisions and counters exactly, and the static memory report to the
byte."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.serving import PagedKVCache as JCache
from paddle_tpu.serving import PreemptiveScheduler as JSched
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import build_draft_lm as j_build_draft_lm
from paddle_tpu_torch.models import gpt_bench
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.serving import PagedKVCache as TCache
from paddle_tpu_torch.serving import PreemptiveScheduler as TSched
from paddle_tpu_torch.serving import Request as TRequest
from paddle_tpu_torch.serving import ServingEngine as TEngine
from paddle_tpu_torch.serving import build_draft_lm as t_build_draft_lm
from paddle_tpu_torch.serving import pages_needed

V, D, L, NH, ML = 50, 32, 2, 2, 64
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    yield


def _build_pair(seed=11, damp=None):
    """(jax_lm, torch_lm): the same tower in both packages, the port's
    parameters overwritten with the JAX startup's values.  `damp` scales
    the attention-out and MLP-down weights of layers >= 1 in both (the
    spec engines' realistic accept regime)."""
    jlm = jtransformer.DecoderLM(V, D, L, NH, max_len=ML, dtype="float32")
    jlm.logits(jfluid.layers.data("tokens", shape=[ML, 1], dtype="int64"))
    jfluid.default_main_program().random_seed = seed
    jfluid.Executor(jfluid.CPUPlace()).run(jfluid.default_startup_program())

    tlm = ttransformer.DecoderLM(V, D, L, NH, max_len=ML, dtype="float32")
    tlm.logits(tfluid.layers.data("tokens", shape=[ML, 1], dtype="int64"))
    tfluid.Executor(tfluid.CPUPlace()).run(tfluid.default_startup_program())

    jscope = jfluid.global_scope()
    tscope = tfluid.global_scope()
    tlm.load_params([jscope.find_np(p.name) for p in jlm._params], tscope)
    if damp is not None:
        gpt_bench.damp_tail_layers(tlm, tscope, draft_layers=1, scale=damp)
        for jp, tp in zip(jlm._params, tlm._params):
            jscope.set(jp.name, tscope.find_np(tp.name))
    return jlm, tlm


def _garbage_pools(scope, name, shape, seed=9):
    """Stale values everywhere: only what the ops write or read may
    matter."""
    init = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    scope.set(f"{name}.k", init)
    scope.set(f"{name}.v", -init)


def _pools_agree(jscope, tscope, name):
    for s in ("k", "v"):
        np.testing.assert_allclose(tscope.find_np(f"{name}.{s}")[:, 1:],
                                   jscope.find_np(f"{name}.{s}")[:, 1:],
                                   atol=1e-5, rtol=1e-5)


# -- the three new ops -------------------------------------------------------


@pytest.mark.parametrize("all_tokens", [False, True])
def test_prefill_chunk_op_matches_jax(all_tokens):
    """One chunk program over four lanes: a chunk from position 0, one
    that starts mid-page after a prefix hit and crosses a page, an idle
    lane, and a short chunk deep in the context.  Tokens equal exactly;
    pools within 1e-5 outside the null page."""
    jlm, tlm = _build_pair()
    ps, num_pages, C = 8, 16, 8
    maxp = pages_needed(ML, ps)
    ctx = np.array([[0], [11], [0], [29]], np.int64)
    clen = np.array([[8], [7], [0], [3]], np.int64)
    pts = np.zeros((4, maxp), np.int64)
    pts[0, :1] = [1]
    pts[1, :3] = [2, 3, 4]
    pts[3, :4] = [5, 6, 7, 8]
    toks = np.random.RandomState(5).randint(1, V, (4, C, 1)).astype(np.int64)
    toks[2] = 0
    pool_shape = (L, num_pages, NH, ps, D // NH)
    out = {}
    for name, fluid, lm in (("jax", jfluid, jlm), ("torch", tfluid, tlm)):
        prog = fluid.Program()
        with fluid.program_guard(prog):
            tk = fluid.layers.data("ctok", shape=[C, 1], dtype="int64")
            cx = fluid.layers.data("cctx", shape=[1], dtype="int64")
            cn = fluid.layers.data("cclen", shape=[1], dtype="int64")
            pt = fluid.layers.data("cpt", shape=[maxp], dtype="int64")
            cache = lm.declare_kv_cache(num_pages, ps, name="kv")
            fetch = lm.prefill_chunk(tk, cx, cn, pt, cache, ps,
                                     all_tokens=all_tokens)
        fetch = list(fetch) if all_tokens else [fetch]
        scope = fluid.global_scope()
        _garbage_pools(scope, "kv", pool_shape)
        got = fluid.Executor(fluid.CPUPlace()).run(
            prog, feed={"ctok": toks, "cctx": ctx, "cclen": clen, "cpt": pts},
            fetch_list=fetch)
        out[name] = ([np.asarray(g) for g in got], scope)
    (jt, jscope), (tt, tscope) = out["jax"], out["torch"]
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(b, a)
        assert b.dtype == np.int64
    assert tt[0][2] == 0  # the idle lane emits 0
    if all_tokens:
        assert (tt[1][3, 3:] == 0).all() and (tt[1][2] == 0).all()
    _pools_agree(jscope, tscope, "kv")


def test_spec_draft_op_matches_jax():
    """Three chained draft steps of the depth-1 draft over the target's
    pools, with per-slot draft lengths 3, 0 (idle), 1 and 2."""
    jlm, tlm = _build_pair()
    ps, num_pages, k = 8, 12, 3
    maxp = pages_needed(ML, ps)
    tok = np.array([[4], [9], [17], [33]], np.int64)
    ctx = np.array([[5], [0], [15], [22]], np.int64)
    slen = np.array([[3], [0], [1], [2]], np.int64)
    pts = np.zeros((4, maxp), np.int64)
    pts[0, :1] = [1]
    pts[2, :2] = [2, 3]
    pts[3, :3] = [4, 5, 6]
    pool_shape = (L, num_pages, NH, ps, D // NH)
    out = {}
    for name, fluid, lm, mint in (("jax", jfluid, jlm, j_build_draft_lm),
                                  ("torch", tfluid, tlm, t_build_draft_lm)):
        draft = mint(lm, 1)
        prog = fluid.Program()
        with fluid.program_guard(prog):
            t = fluid.layers.data("tok", shape=[1], dtype="int64")
            c = fluid.layers.data("ctx", shape=[1], dtype="int64")
            s = fluid.layers.data("slen", shape=[1], dtype="int64")
            pt = fluid.layers.data("pt", shape=[maxp], dtype="int64")
            cache = lm.declare_kv_cache(num_pages, ps, name="kv")
            fetch = draft.spec_draft(cache, t, c, s, pt, ps, k)
        scope = fluid.global_scope()
        _garbage_pools(scope, "kv", pool_shape)
        (d,) = fluid.Executor(fluid.CPUPlace()).run(
            prog, feed={"tok": tok, "ctx": ctx, "slen": slen, "pt": pts},
            fetch_list=[fetch])
        out[name] = (np.asarray(d), scope)
    (jd, jscope), (td, tscope) = out["jax"], out["torch"]
    np.testing.assert_array_equal(td, jd)
    assert td.shape == (4, k) and (td[1] == 0).all()
    _pools_agree(jscope, tscope, "kv")
    # the draft never touches the layers past its depth
    np.testing.assert_array_equal(
        tscope.find_np("kv.k")[1],
        np.random.RandomState(9).randn(*pool_shape).astype(np.float32)[1])


def test_page_copy_op_matches_jax():
    jlm, tlm = _build_pair()
    pool_shape = (L, 6, NH, 8, D // NH)
    out = {}
    for name, fluid, lm in (("jax", jfluid, jlm), ("torch", tfluid, tlm)):
        prog = fluid.Program()
        with fluid.program_guard(prog):
            src = fluid.layers.data("src", shape=[1], dtype="int64")
            dst = fluid.layers.data("dst", shape=[1], dtype="int64")
            cache = lm.declare_kv_cache(6, 8, name="kv")
            fetch = lm.page_copy(src, dst, cache)
        scope = fluid.global_scope()
        _garbage_pools(scope, "kv", pool_shape)
        (w,) = fluid.Executor(fluid.CPUPlace()).run(
            prog, feed={"src": np.array([[2], [0]]),
                        "dst": np.array([[5], [0]])}, fetch_list=[fetch])
        out[name] = (np.asarray(w), {s: scope.find_np(f"kv.{s}")
                                     for s in ("k", "v")})
    np.testing.assert_array_equal(out["torch"][0], out["jax"][0])
    for s in ("k", "v"):
        np.testing.assert_array_equal(out["torch"][1][s], out["jax"][1][s])
        np.testing.assert_array_equal(out["torch"][1][s][:, 5],
                                      out["torch"][1][s][:, 2])


def test_truncated_slices_the_ports_params():
    _, tlm = _build_pair()
    d = t_build_draft_lm(tlm)  # default depth: half the layers
    assert d.n_layers == 1 and len(d._params) == 2 + 12 + 3
    assert d._params[:14] == tlm._params[:14]
    assert d._params[-3:] == tlm._params[-3:]
    assert t_build_draft_lm(tlm, 9).n_layers == L  # clamped to the depth
    with pytest.raises(ValueError, match="draft depth"):
        tlm.truncated(0)


# -- the prefix cache and the preemptive scheduler ---------------------------


def _sched_trace(Cache, Sched, Req):
    """A scripted trace over one package's cache + scheduler, stepped the
    way the engine steps them: admissions with priorities and a deadline,
    prefix inserts and hits (whole blocks and a copy-on-write), decode
    growth until preemption, finishes, then eviction.  Returns what every
    step decided."""
    cache = Cache(num_slots=3, max_pages_per_seq=6, num_pages=10,
                  page_size=4)
    s = Sched(cache, max_prefill_per_step=2, watermark_pages=1)
    A = list(range(1, 11))  # 2 full blocks + 2 tokens
    reqs = [Req(A, 12, rid=0, arrival=0.0),
            Req(A[:6] + [40, 41, 42], 6, rid=1, arrival=1.0),
            Req([7] * 9, 10, rid=2, arrival=2.0, priority=2),
            Req(A + [30], 8, rid=3, arrival=3.0, deadline=1.0)]
    log = []

    def snap(tag):
        log.append((tag, [(r.rid, r.state, r.slot, tuple(r.pages),
                           r.ctx_len, r.prefill_target,
                           r.cached_prefill_tokens, r.preemptions,
                           len(r.generated)) for r in reqs],
                    list(s.pending_copies), s.preemptions,
                    cache.page_table.tolist(), cache.allocator.stats(),
                    cache.prefix.stats(), s.page_stats()))

    s.submit(reqs[0])
    for step in range(40):
        if step == 2:
            for r in reqs[1:]:
                s.submit(r)
        s.admit(now=float(step))
        for _, src, _ in s.pending_copies:  # the engine runs the copies
            cache.allocator.free([src])
        s.pending_copies.clear()
        for r in sorted(s.active.values(),
                        key=lambda r: (-r.priority, r.arrival, r.rid)):
            if r.state == "running" and r.ctx_len >= r.prefill_target \
                    and r.ctx_len // 4 >= len(r.pages):
                s.grow(r, now=float(step))
        for r in list(s.active.values()):
            if r.ctx_len < r.prefill_target:  # one whole-prompt "chunk"
                r.ctx_len = r.prefill_target
                nb = len(r.prompt) // 4
                if nb:
                    cache.prefix.insert(r.prompt, r.pages[:nb], nb)
            else:
                r.ctx_len += 1
            r.generated.append(step)
            if len(r.generated) >= r.max_new_tokens:
                s.finish(r, now=float(step))
        snap(f"step {step}")
        if not s.outstanding():
            break
    cache.prefix.evict_pages(3)
    snap("evicted")
    cache.prefix.clear()
    snap("cleared")
    return log


def test_prefix_cache_and_scheduler_trace_matches_jax():
    jlog = _sched_trace(JCache, JSched, JRequest)
    tlog = _sched_trace(TCache, TSched, TRequest)
    assert len(tlog) == len(jlog)
    for j, t in zip(jlog, tlog):
        assert t == j, j[0]
    # the trace really walked the paths it is for
    assert tlog[-1][6]["cow_hits"] > 0, "no copy-on-write hit"
    assert tlog[-1][3] > 0, "nothing was preempted"
    assert tlog[-1][5]["free"] == 9, "pages leaked"


# -- whole engines -----------------------------------------------------------


def _serve(Engine, lm, place, prompts, max_new, priorities=None, **kw):
    eng = Engine(lm, place=place, **kw)
    pri = priorities or [0] * len(prompts)
    rids = [eng.submit(p, max_new, arrival=float(i), priority=pr)
            for i, (p, pr) in enumerate(zip(prompts, pri))]
    fin = eng.run()
    assert sorted(fin) == sorted(rids)
    order = [rids.index(r) for r in eng.scheduler.admission_order]
    return eng, [fin[r].generated for r in rids], order


def _engine_pair(jlm, tlm, prompts, max_new, priorities=None, **kw):
    out = {}
    for name, Engine, lm, place in (
            ("jax", JEngine, jlm, jfluid.CPUPlace()),
            ("torch", TEngine, tlm, tfluid.CPUPlace())):
        out[name] = _serve(Engine, lm, place, prompts, max_new, priorities,
                           **kw)
    return out["jax"], out["torch"]


_STATS = ("prefill_computed", "prefill_cached", "cow_copies", "preemptions",
          "mixed_steps", "decode_steps", "spec_rounds", "spec_drafted",
          "spec_accepted", "spec_emitted", "peak_stranded", "prefix",
          "page_stats")


def _stats_agree(jeng, teng):
    js, ts = jeng.stats(), teng.stats()
    for k in _STATS:
        assert ts[k] == js[k], k


def _prefix_prompts(n, seed=1):
    """A small prefix-heavy set: a shared 20-token system prompt (2.5
    pages of 8), then one of three suffixes, repeated.  The system
    prompt's tail half-page is shared inside a block whose suffix part
    differs: the copy-on-write path."""
    rng = np.random.RandomState(seed)
    system = rng.randint(1, V, size=20).tolist()
    suffixes = [rng.randint(1, V, size=k).tolist() for k in (3, 9, 6)]
    return [system + suffixes[i % 3] for i in range(n)]


def test_v2_engine_matches_jax_on_prefix_heavy_traffic():
    jlm, tlm = _build_pair()
    prompts = _prefix_prompts(7)
    (je, jt, jo), (te, tt, to) = _engine_pair(
        jlm, tlm, prompts, 5, scheduler="v2", max_batch_size=3,
        page_size=8, chunk_size=8, chunk_lanes=2)
    assert tt == jt and to == jo
    _stats_agree(je, te)
    st = te.stats()
    assert st["prefill_cached"] > 0 and st["cow_copies"] > 0
    assert st["mixed_steps"] > 0 and st["decode_steps"] > 0
    assert te.scheduler.watermark_pages == je.scheduler.watermark_pages
    te.cache.prefix.clear()
    assert te.cache.allocator.available() == te.num_pages - 1


def test_v2_engine_matches_jax_with_tight_pool_and_priorities():
    """A low-priority request, then a burst of higher-priority ones into a
    pool too small for all: preemption at admission and at growth, and
    the resumed requests reproduce the JAX engine's tokens."""
    jlm, tlm = _build_pair(seed=5)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, V, size=n).tolist() for n in (14, 6, 9, 5, 11)]
    (je, jt, jo), (te, tt, to) = _engine_pair(
        jlm, tlm, prompts, 10, priorities=[0, 2, 2, 1, 2],
        scheduler="v2", max_batch_size=3, page_size=4, num_pages=13,
        chunk_size=4, chunk_lanes=2, watermark_pages=1)
    assert tt == jt and to == jo
    _stats_agree(je, te)
    assert te.stats()["preemptions"] > 0
    # the same requests in a roomy pool: preemption changed no token
    _, roomy, _ = _serve(TEngine, tlm, tfluid.CPUPlace(), prompts, 10,
                         [0, 2, 2, 1, 2], scheduler="v2", max_batch_size=3,
                         page_size=4, chunk_size=4, chunk_lanes=2)
    assert roomy == tt


def test_spec_engine_matches_jax_and_v2():
    """spec with k 3 and a depth-1 draft on damped weights: the JAX spec
    engine's tokens and speculative counters, and the v2 engine's
    tokens."""
    jlm, tlm = _build_pair(damp=0.01)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, V, size=p).tolist()
               for p in (13, 6, 9, 16, 2, 11)]
    kw = dict(max_batch_size=2, page_size=8, num_pages=14, chunk_size=6,
              spec_k=3, spec_draft_layers=1)
    (je, jt, _), (te, tt, _) = _engine_pair(jlm, tlm, prompts, 9,
                                            scheduler="spec", **kw)
    assert tt == jt
    _stats_agree(je, te)
    st = te.stats()
    assert st["spec_rounds"] > 0 and st["spec_accepted"] > 0
    assert st["draft_runs"] > 0
    _, v2, _ = _serve(TEngine, tlm, tfluid.CPUPlace(), prompts, 9,
                      scheduler="v2", **kw)
    assert v2 == tt


@pytest.mark.parametrize("mode", ["fifo", "v2", "spec"])
def test_hbm_report_matches_jax(mode):
    jlm, tlm = _build_pair()
    kw = dict(scheduler=mode, max_batch_size=3, page_size=8,
              spec_k=2, spec_draft_layers=1)
    je = JEngine(jlm, place=jfluid.CPUPlace(), **kw)
    te = TEngine(tlm, place=tfluid.CPUPlace(), **kw)
    if mode == "fifo":  # bring a prefill program into the report
        for e in (je, te):
            e.submit([1, 2, 3], 2)
            e.run()
    assert te.hbm_report() == je.hbm_report()
    if mode != "fifo":
        assert te.scheduler.watermark_pages == je.scheduler.watermark_pages


# -- the smoke's request sets and weights ------------------------------------


def test_prefix_prompts_are_serve_benchs():
    spec = importlib.util.spec_from_file_location(
        "serve_bench", os.path.join(_REPO, "tools", "serve_bench.py"))
    sb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sb)
    want = [p for _, p, _ in sb.synth_prefix_requests(
        16, 4.0, 8, 950, 32, gpt_bench.VOCAB, seed=0)]
    got = gpt_bench.prefix_prompts(16, seed=0)
    assert got == want
    assert all(len(p) <= 950 and p[:570] == got[0][:570] for p in got)
    assert len({tuple(p) for p in got}) < len(got)  # whole prompts repeat


def test_damp_tail_layers_scales_the_branch_outputs():
    _, tlm = _build_pair()
    scope = tfluid.global_scope()
    before = {p.name: scope.find(p.name).clone() for p in tlm._params}
    gpt_bench.damp_tail_layers(tlm, scope, draft_layers=1, scale=0.5)
    damped = {tlm._params[2 + 12 + off].name for off in (5, 10)}
    for p in tlm._params:
        want = before[p.name] * (0.5 if p.name in damped else 1.0)
        assert torch.equal(scope.find(p.name), want), p.name
