"""The port's fifo serving slice against the JAX package on the CPU.

The same small decoder LM is built in both packages; each runs its own
startup program, then the JAX parameters are carried across with
``DecoderLM.load_params`` (the two frameworks' random draws differ, so
no test compares draws).  The one-op ``paged_prefill`` and
``paged_decode_step`` programs, and whole fifo engines, must then agree:
greedy tokens exactly, pools to f32 reduction-order tolerance."""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu_torch.framework.initializer import (
    ConstantInitializer, NormalInitializer, UniformInitializer)
from paddle_tpu_torch.models import gpt_bench
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.serving import PageAllocator, pages_needed
from paddle_tpu_torch.serving import ServingEngine as TEngine

V, D, L, NH, ML = 50, 32, 2, 2, 48


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    yield


def _build_pair(seed=11):
    """(jax_lm, torch_lm): the same tower in both packages, the port's
    parameters overwritten with the JAX startup's values."""
    jlm = jtransformer.DecoderLM(V, D, L, NH, max_len=ML, dtype="float32")
    jlm.logits(jfluid.layers.data("tokens", shape=[ML, 1], dtype="int64"))
    jfluid.default_main_program().random_seed = seed
    jfluid.Executor(jfluid.CPUPlace()).run(jfluid.default_startup_program())

    tlm = ttransformer.DecoderLM(V, D, L, NH, max_len=ML, dtype="float32")
    tlm.logits(tfluid.layers.data("tokens", shape=[ML, 1], dtype="int64"))
    tfluid.default_main_program().random_seed = seed
    tfluid.Executor(tfluid.CPUPlace()).run(tfluid.default_startup_program())

    jscope = jfluid.global_scope()
    tlm.load_params([jscope.find_np(p.name) for p in jlm._params],
                    tfluid.global_scope())
    return jlm, tlm


def _programs(fluid, lm, bucket, num_pages, ps):
    """One-op prefill and decode programs sharing one pool pair."""
    maxp = pages_needed(ML, ps)
    pre = fluid.Program()
    with fluid.program_guard(pre):
        prompt = fluid.layers.data("prompt", shape=[bucket, 1], dtype="int64")
        plen = fluid.layers.data("plen", shape=[1], dtype="int64")
        pt = fluid.layers.data("ppt", shape=[maxp], dtype="int64")
        cache = lm.declare_kv_cache(num_pages, ps, name="kv")
        first = lm.prefill(prompt, plen, pt, cache, ps)
    dec = fluid.Program()
    with fluid.program_guard(dec):
        tok = fluid.layers.data("tok", shape=[1], dtype="int64")
        ctx = fluid.layers.data("ctx", shape=[1], dtype="int64")
        act = fluid.layers.data("act", shape=[1], dtype="int64")
        pt = fluid.layers.data("pt", shape=[maxp], dtype="int64")
        cache = lm.declare_kv_cache(num_pages, ps, name="kv")
        nxt = lm.decode_step(cache, tok, ctx, act, pt, ps)
    return pre, first, dec, nxt


def test_paged_ops_match_jax():
    """paged_prefill then two paged_decode_step runs, identical feeds in
    both packages: NextToken equal, pools equal to 1e-5 outside the null
    page (where duplicate pad-tail writes may land in any order)."""
    jlm, tlm = _build_pair()
    ps, num_pages, bucket = 8, 20, 32
    maxp = pages_needed(ML, ps)
    rng = np.random.RandomState(4)
    lens = [13, 6, 20, 1]
    toks = np.zeros((len(lens), bucket, 1), np.int64)
    for i, n in enumerate(lens):
        toks[i, :n, 0] = rng.randint(1, V, size=n)
    plen = np.array(lens, np.int64)[:, None]
    pts = np.zeros((len(lens), maxp), np.int64)
    pages = iter(range(1, num_pages))
    for i, n in enumerate(lens):
        for j in range(pages_needed(n + 4, ps)):
            pts[i, j] = next(pages)
    pool_shape = (L, num_pages, NH, ps, D // NH)

    runs = {}
    for name, fluid, lm in (("jax", jfluid, jlm), ("torch", tfluid, tlm)):
        pre, first, dec, nxt = _programs(fluid, lm, bucket, num_pages, ps)
        scope = fluid.global_scope()
        # stale garbage in the pools: only the written slots may matter
        init = np.random.RandomState(9).randn(*pool_shape).astype(np.float32)
        scope.set("kv.k", init)
        scope.set("kv.v", -init)
        exe = fluid.Executor(fluid.CPUPlace())
        (tok0,) = exe.run(pre, feed={"prompt": toks, "plen": plen,
                                     "ppt": pts}, fetch_list=[first])
        toks_out = [np.asarray(tok0)]
        ctx = plen.copy()
        act = np.array([[1], [1], [1], [0]], np.int64)
        cur = np.asarray(tok0).reshape(-1, 1)
        for _ in range(2):
            (t,) = exe.run(dec, feed={"tok": cur, "ctx": ctx, "act": act,
                                      "pt": pts}, fetch_list=[nxt])
            toks_out.append(np.asarray(t))
            cur = np.asarray(t).reshape(-1, 1)
            ctx = ctx + act
        runs[name] = (toks_out, scope.find_np("kv.k"), scope.find_np("kv.v"))

    (jt, jk, jv), (tt, tk, tv) = runs["jax"], runs["torch"]
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(b, a)
        assert b.dtype == np.int64
    np.testing.assert_allclose(tk[:, 1:], jk[:, 1:], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tv[:, 1:], jv[:, 1:], atol=1e-5, rtol=1e-5)


def test_pool_tensor_is_updated_in_place():
    """The executor writes a pool back to the scope by reference: the
    tensor object the scope held before a run is the one it holds after,
    with the prompt's K written into it."""
    _, tlm = _build_pair()
    ps, num_pages = 8, 8
    pre, first, _, _ = _programs(tfluid, tlm, 8, num_pages, ps)
    scope = tfluid.global_scope()
    for s in ("k", "v"):
        scope.set(f"kv.{s}", torch.zeros(L, num_pages, NH, ps, D // NH))
    before = scope.find("kv.k")
    pts = np.zeros((1, pages_needed(ML, ps)), np.int64)
    pts[0, 0] = 3
    tfluid.Executor(tfluid.CPUPlace()).run(
        pre, feed={"prompt": np.arange(1, 9).reshape(1, 8, 1),
                   "plen": np.array([[8]]), "ppt": pts}, fetch_list=[first])
    assert scope.find("kv.k") is before
    assert before[:, 3].abs().sum() > 0
    assert before[:, 1:3].abs().sum() == 0
    # return_numpy=False hands back the fetched tensor itself
    (tok,) = tfluid.Executor(tfluid.CPUPlace()).run(
        pre, feed={"prompt": np.arange(1, 9).reshape(1, 8, 1),
                   "plen": np.array([[8]]), "ppt": pts},
        fetch_list=[first], return_numpy=False)
    assert isinstance(tok, torch.Tensor) and tok.dtype == torch.int64


# eos 28 ends one request at its prefill token and another in decode
@pytest.mark.parametrize("eos_id,max_new", [(-1, 4), (28, 6)])
def test_engine_tokens_match_jax_engine(eos_id, max_new):
    """The ragged page-reuse scenario of the JAX package's engine test (2
    slots, page 8, 7 pages, six ragged prompts) plus a 20-token prompt
    so that bucket 32 runs: the port's fifo engine must emit exactly the
    JAX engine's tokens, admit in the same order and end leak-free, with
    and without an end-of-sequence token."""
    jlm, tlm = _build_pair()
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, V, size=p).tolist()
               for p in (13, 6, 9, 16, 2, 11, 20)]
    out = {}
    for name, Engine, lm, place in (
            ("jax", JEngine, jlm, jfluid.CPUPlace()),
            ("torch", TEngine, tlm, tfluid.CPUPlace())):
        eng = Engine(lm, max_batch_size=2, page_size=8, num_pages=7,
                     eos_id=eos_id, place=place)
        rids = [eng.submit(p, max_new) for p in prompts]
        fin = eng.run()
        assert sorted(fin) == sorted(rids)
        assert eng.cache.allocator.available() == 7 - 1, "page leak"
        order = [rids.index(r) for r in eng.scheduler.admission_order]
        out[name] = ([fin[r].generated for r in rids], order)
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == list(range(len(prompts)))
    lens = sorted({len(g) for g in out["torch"][0]})
    assert lens == ([max_new] if eos_id < 0 else [1, 2, max_new])


def test_engine_runs_every_prefill_bucket_it_needs():
    _, tlm = _build_pair()
    eng = TEngine(tlm, max_batch_size=2, page_size=8, num_pages=7,
                  place=tfluid.CPUPlace())
    for n in (3, 20):
        eng.submit(list(range(1, n + 1)), 2)
    done = eng.run()
    assert sorted(eng._prefill_progs) == [8, 32]
    st = eng.stats()
    assert st["prefill_computed"] == 23
    assert st["page_stats"]["held"] == 0
    # a long-lived service drains what finished
    assert eng.pop_finished() is done and len(done) == 2
    assert eng.finished == {}


def test_engine_refuses_unported_schedulers():
    _, tlm = _build_pair()
    for mode in ("v2", "spec"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TEngine(tlm, scheduler=mode, place=tfluid.CPUPlace())
    # the fifo engine has no priorities or deadlines to honour
    eng = TEngine(tlm, max_batch_size=2, page_size=8, num_pages=7,
                  place=tfluid.CPUPlace())
    for kw in ({"priority": 1}, {"deadline": 5.0}):
        with pytest.raises(TypeError):
            eng.submit([1, 2, 3], 2, **kw)


def test_page_allocator_guards_and_counts():
    alloc = PageAllocator(5)
    assert alloc.alloc(5) is None  # all-or-nothing; page 0 is never given
    pages = alloc.alloc(3)
    assert 0 not in pages and alloc.available() == 1 and alloc.held() == 3
    alloc.free(pages[:1])
    with pytest.raises(ValueError, match="double free"):
        alloc.free(pages[:1])
    with pytest.raises(ValueError, match="foreign"):
        alloc.free([0])
    alloc.free(pages[1:])
    assert alloc.stats() == {"num_pages": 5, "free": 4, "held": 0,
                             "total_allocs": 3, "total_frees": 3,
                             "peak_held": 3}


def test_gpt_bench_prompts_reach_the_long_buckets():
    """The smoke's request set: deterministic, in range, and long enough
    that the 256, 512 and 1024 prefill buckets run."""
    ps = gpt_bench.prompts(16, seed=0)
    assert ps == gpt_bench.prompts(16, seed=0)
    lens = [len(p) for p in ps]
    assert len(ps) == 16 and min(lens) >= 5 and max(lens) <= 960
    assert sum(n > 128 for n in lens) >= 4
    assert all(1 <= t < gpt_bench.VOCAB for p in ps for t in p)


def test_startup_initializers_follow_the_desc():
    """uniform_random stays in [min, max]; gaussian_random has the asked
    mean and std (5% at 1e5 samples); fill_constant fills; every value has
    the desc's shape and dtype; the same seed replays the same draws."""
    specs = {
        "u": ([400, 250], "float32", UniformInitializer(-0.5, 0.3)),
        "g": ([100000], "float32", NormalInitializer(0.7, 2.0)),
        "c": ([3, 5], "bfloat16", ConstantInitializer(1.5)),
        "i": ([4], "int64", ConstantInitializer(7)),
    }

    def run(seed):
        tfluid.reset()
        for name, (shape, dtype, init) in specs.items():
            tfluid.layers.create_parameter(shape, dtype, name=name,
                                           default_initializer=init)
        startup = tfluid.default_startup_program()
        startup.random_seed = seed
        scope = tfluid.Scope()
        tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
        return startup, scope

    startup, scope = run(seed=3)
    for name, (shape, dtype, _) in specs.items():
        t = scope.find(name)
        assert tuple(t.shape) == tuple(shape)
        assert t.dtype == tfluid.framework.core.torch_dtype(dtype)
        assert startup.global_block().var(name).dtype == dtype
    u = scope.find("u")
    assert u.min() >= -0.5 and u.max() <= 0.3
    assert abs(u.mean().item() - (-0.1)) < 0.01
    g = scope.find("g").double()
    assert abs(g.mean().item() - 0.7) < 0.05 * 0.7
    assert abs(g.std().item() - 2.0) < 0.05 * 2.0
    assert (scope.find("c").float() == 1.5).all()
    assert scope.find("i").tolist() == [7] * 4
    # replay: same seed, same draws; another seed, other draws
    _, again = run(seed=3)
    _, other = run(seed=4)
    assert torch.equal(again.find("g"), scope.find("g"))
    assert not torch.equal(other.find("g"), scope.find("g"))
    # two random ops of one program draw independent streams
    assert not torch.equal(scope.find("u").flatten()[:1000],
                           scope.find("g")[:1000])


def test_executor_reports_uninitialized_state():
    _, tlm = _build_pair()
    pre, first, _, _ = _programs(tfluid, tlm, 8, 8, 8)
    with pytest.raises(RuntimeError, match="used before initialization"):
        tfluid.Executor(tfluid.CPUPlace()).run(
            pre, feed={"prompt": np.ones((1, 8, 1), np.int64),
                       "plen": np.array([[8]]),
                       "ppt": np.zeros((1, 6), np.int64)},
            fetch_list=[first], scope=tfluid.Scope())


def test_load_params_checks_count_and_shape():
    jlm, tlm = _build_pair()
    scope = tfluid.global_scope()
    arrays = [scope.find_np(p.name) for p in tlm._params]
    with pytest.raises(ValueError, match="arrays for"):
        tlm.load_params(arrays[:-1], scope)
    arrays[0] = arrays[0][:, :-1]
    with pytest.raises(ValueError, match="shape"):
        tlm.load_params(arrays, scope)
