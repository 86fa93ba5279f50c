"""Tunable workloads: what ``tune`` can point the harness at — the port of
``paddle_tpu/autotune/workloads.py`` over the port's models and its
hand-written kernels.

  * :class:`ProgramWorkload` — a ProgramDesc train/infer step built into
    a PRIVATE program pair (``program_guard`` + ``unique_name.guard`` so
    repeated builds are name-deterministic — the program digest must be
    stable — and the process's default programs are never touched).  The
    ``remat`` axis applies the desc-level blanket rematerialization pass
    to the built program, which is exactly what the executor's winner
    pickup (integration.py) re-applies later.
  * kernel workloads — ``bn_conv`` (the fused BatchNorm 3x3 forward:
    ``v1`` = K13, ``v2`` = K14 with its O blocks, ``reference`` = the
    unfused composition) and ``paged_decode`` (K2 over page sizes).  Each
    trial checks its kernel against the plain version BEFORE it is timed
    (a fast wrong kernel must never win) and reports the launches it
    made.
  * serve and loop workloads — ``spec_decode`` (the speculative serve
    loop over K and draft depth) and ``step_loop`` (steps per dispatch).

  * ``mesh_layout`` — multi-slice layouts of the Momentum-MLP step over
    eight mesh positions, ranked by their priced communication
    (``analysis/sharding.comm_report``) and timed on the layout's
    ``ParallelExecutor``.

Every workload runs on its `place`: the card by default
(``default_place()``), the CPU when the caller asks.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np

from . import space as _space


def _place(place):
    from ..framework.place import default_place

    return place if place is not None else default_place()


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Built:
    """One candidate's built program + synthetic feed."""

    __slots__ = ("main", "startup", "feed", "fetch", "batch_size")

    def __init__(self, main, startup, feed, fetch, batch_size):
        self.main = main
        self.startup = startup
        self.feed = feed
        self.fetch = fetch
        self.batch_size = batch_size


class _ProgramRunner:
    """Measurement runner: the feed is staged to the device ONCE, the
    state lives in a private scope, and ``barrier`` waits for the card."""

    def __init__(self, built: Built, place, scope=None, run_startup=True):
        import torch

        from ..framework.executor import Executor
        from ..framework.scope import Scope

        self.built = built
        self.scope = scope if scope is not None else Scope()
        self.exe = Executor(place)
        if run_startup:
            self.exe.run(built.startup, scope=self.scope,
                         steps_per_dispatch=1)
        self.feed = {}
        for k, v in built.feed.items():
            self.feed.update(self.exe._feed_tensor(
                built.main.global_block(), k,
                v if isinstance(v, torch.Tensor) else np.asarray(v)))

    def step(self):
        self.exe.run(self.built.main, feed=self.feed,
                     fetch_list=self.built.fetch, scope=self.scope,
                     return_numpy=False)

    def barrier(self):
        _sync(self.exe.device)

    def close(self):
        self.exe.close()


class ProgramWorkload:
    """A named ProgramDesc workload.  `builder()` runs inside fresh
    program/name guards and returns (feed, fetch_list, batch_size)."""

    kind = "program"

    def __init__(self, name: str, builder: Callable,
                 space_builder: Callable[[], _space.SearchSpace],
                 kernel_sites: Tuple = (), place=None):
        self.name = name
        self._builder = builder
        self._space_builder = space_builder
        self._kernel_sites = tuple(kernel_sites)
        self.place = place
        self._default_built: Optional[Built] = None

    # -- space / identity ----------------------------------------------
    def space(self) -> _space.SearchSpace:
        return self._space_builder()

    def build(self, candidate: Optional[_space.Candidate]) -> Built:
        from ..framework import unique_name
        from ..framework.core import Program, program_guard

        main, startup = Program(), Program()
        with unique_name.guard(), program_guard(main, startup):
            feed, fetch, bs = self._builder()
        built = Built(main, startup, feed, fetch, bs)
        if candidate is not None and candidate.get("remat"):
            from ..memory_optimization_transpiler import memory_optimize

            memory_optimize(main, level=1, batch_size=bs)
        return built

    def _default(self) -> Built:
        if self._default_built is None:
            self._default_built = self.build(None)
        return self._default_built

    def site(self) -> dict:
        """The store site: program digest of the DEFAULT build + the
        feed signature (integration.py computes the identical site from
        a live Executor.run)."""
        from .integration import program_site

        b = self._default()
        return program_site(b.main, b.feed)

    def kernel_sites(self) -> Tuple:
        return self._kernel_sites

    # -- prior hooks -----------------------------------------------------
    def desc_key(self, candidate):
        """The candidate axes that change the built ProgramDesc — the
        prior's per-desc analysis cache key: remat only."""
        return bool(candidate.get("remat"))

    def program_for(self, candidate) -> Tuple[object, int]:
        b = self.build(candidate)
        return b.main, b.batch_size

    def byte_delta(self, candidate, spec) -> float:
        return 0.0

    def feasible(self, candidate, spec) -> Tuple[bool, str]:
        return True, ""

    # -- measurement -----------------------------------------------------
    def build_runner(self, candidate) -> _ProgramRunner:
        return _ProgramRunner(self.build(candidate), _place(self.place))


# ---------------------------------------------------------------------------
# named program builders


def _build_gpt_small():
    """Small decoder-LM train step (the gpt-small workload), float32."""
    from ..models import transformer

    T, V, dim, heads, layers = 256, 512, 64, 2, 2
    bs = 2
    loss = transformer.build_lm_train_program(
        seq_len=T, vocab_size=V, dim=dim, n_layers=layers,
        n_heads=heads, dtype="float32", learning_rate=1e-3)
    rng = np.random.RandomState(7)
    toks = rng.randint(0, V, (bs, T, 1)).astype(np.int64)
    feed = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    return feed, [loss], bs


def _build_lstm():
    """The bench lstm shape scaled down: 2xLSTM+fc classification."""
    import paddle_tpu_torch as fluid
    from ..models import image_models

    bs, hidden, seq = 8, 128, 32
    words = fluid.layers.sequence_data(name="words", shape=[1],
                                       dtype="int64", max_len=seq)
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    emb = fluid.layers.sequence_embedding(words, size=[1000, hidden],
                                          dtype="float32")
    logits = image_models.stacked_lstm_net(emb, hidden_dim=hidden,
                                           stacked_num=2, class_dim=2)
    loss = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, label))
    fluid.optimizer.Adam(learning_rate=0.002).minimize(loss)
    rng = np.random.RandomState(11)
    feed = {"words": rng.randint(0, 1000, (bs, seq, 1)).astype(np.int64),
            "words@LENGTH": np.full((bs,), seq, dtype=np.int32),
            "label": rng.randint(0, 2, (bs, 1)).astype(np.int64)}
    return feed, [loss], bs


# depth -> width such that the fc-chain weight count 64*w + (d-1)*w^2
# stays ~65536 across candidates: ~equal FLOPs/bytes, 1x-vs-16x op count
_MLP_WIDTHS = {16: 64, 4: 136, 1: 1024}


def _build_mlp(depth: int):
    """Inference MLP chain: in(64) -> depth x fc(width) -> fc(8), with
    the total matmul work held ~constant (see _MLP_WIDTHS).  The deep
    build wins the RAW roofline yet measures slower wherever per-op
    dispatch overhead is real — what the calibration store's overhead
    term exists to price."""
    import paddle_tpu_torch as fluid

    width = _MLP_WIDTHS[int(depth)]
    bs, in_dim = 8, 64
    x = fluid.layers.data(name="x", shape=[in_dim], dtype="float32")
    h = x
    for _ in range(int(depth)):
        h = fluid.layers.fc(h, size=width, act="relu")
    out = fluid.layers.fc(h, size=8, act=None)
    rng = np.random.RandomState(13)
    feed = {"x": rng.randn(bs, in_dim).astype(np.float32)}
    return feed, [out], bs


class MlpDepthWorkload(ProgramWorkload):
    """The op-count A/B: same task, ~same FLOPs, 1x/4x/16x the op
    count — rankable only by the calibrated prior's per-op overhead
    term."""

    def __init__(self, place=None):
        super().__init__("mlp_depth", None, _space.mlp_depth_space,
                         place=place)

    def desc_key(self, candidate):
        return int(candidate.get("mlp.depth", 16))

    def build(self, candidate) -> Built:
        from ..framework import unique_name
        from ..framework.core import Program, program_guard

        depth = int(candidate.get("mlp.depth", 16)) if candidate else 16
        main, startup = Program(), Program()
        with unique_name.guard(), program_guard(main, startup):
            feed, fetch, bs = _build_mlp(depth)
        return Built(main, startup, feed, fetch, bs)


# ---------------------------------------------------------------------------
# kernel workloads


def _dtype_bytes(dtype: str) -> int:
    return {"float32": 4, "bfloat16": 2, "float16": 2}[dtype]


class _KernelRunner:
    """One step() = one call of `fn` on fixed device arguments;
    ``report`` gives the kernel launches the trial's steps made."""

    def __init__(self, fn, args, device, counters):
        self._fn = fn
        self._args = args
        self._device = device
        self._counters = counters  # name -> wrapper with .launches
        self._start = {n: w.launches for n, w in counters.items()}

    def step(self):
        self._fn(*self._args)

    def barrier(self):
        _sync(self._device)

    def report(self) -> dict:
        return {"launches": {n: w.launches - self._start[n]
                             for n, w in self._counters.items()}}

    def close(self):
        pass


def _close_enough(got, ref, dtype: str, what: str):
    """The trial's parity gate: f32 to 2e-3 (abs and rel, as the JAX
    workloads hold their kernels), bf16 to 2% of the reference's largest
    magnitude (one bf16 rounding of the fused operand is 2^-8 relative;
    the product sums K·9 of them)."""
    import torch

    g, r = got.float(), ref.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: non-finite output")
    if dtype == "float32":
        torch.testing.assert_close(g, r, atol=2e-3, rtol=2e-3)
        return
    err = float((g - r).abs().max())
    scale = float(r.abs().max()) or 1.0
    if err > 2e-2 * scale:
        raise AssertionError(f"{what}: max |kernel - plain| {err} > "
                             f"2e-2 x {scale}")


class BnConvWorkload:
    """The fused BatchNorm(+act) -> 3x3 convolution forward over its
    variants — ``v1`` (K13), ``v2`` (K14, with its O-block axis) and
    ``reference`` (the unfused composition) — on one fixed training
    shape.  A trial runs the ``bn_act_conv3x3`` op's own emitter, so the
    variant and O block resolve through the knobs exactly as in a
    training step; each trial is checked against the plain version
    before it is timed."""

    kind = "kernel"
    name = "bn_conv"

    def __init__(self, N=2, H=8, W=8, K=128, O=256, dtype="float32",
                 place=None):
        self.shape = (N, H, W, K, O)
        self.dtype = dtype
        self.place = place

    def space(self) -> _space.SearchSpace:
        return _space.bn_conv_space(O=self.shape[4])

    def site(self) -> dict:
        N, H, W, K, O = self.shape
        return {"workload": self.name,
                "x": [N, H, W, K], "w": [3, 3, K, O],
                "dtype": self.dtype}

    def kernel_sites(self) -> Tuple:
        return (("bn_conv", {}, {"variant": "bn_conv.variant",
                                 "block_o": "bn_conv.block_o"}),)

    def program_for(self, candidate):
        return None  # kernel workload: priced analytically

    def analytic_cost(self, candidate, spec) -> dict:
        """Static FLOPs/bytes per variant: v1 gives each image's block
        its own weight read, v2 one weight pass, and the reference the
        materialized normalized activation (written and read back) — the
        fusion the kernels exist to delete.  Equal-byte candidates tie
        and the measurement decides."""
        N, H, W, K, O = self.shape
        b = _dtype_bytes(self.dtype)
        x_bytes = N * H * W * K * b
        w_bytes = 9 * K * O * b
        o_bytes = N * H * W * O * b
        flops = 2 * N * H * W * O * K * 9 + 6 * N * H * W * K
        variant = candidate.get("bn_conv.variant", "v1")
        if variant == "v1":
            bytes_ = x_bytes + N * w_bytes + o_bytes
        elif variant == "v2":
            bytes_ = x_bytes + w_bytes + o_bytes
        else:  # reference: the normalized map goes to memory and back
            bytes_ = 3 * x_bytes + w_bytes + o_bytes
        return {"flops": flops, "bytes": bytes_, "dtype": self.dtype}

    def feasible(self, candidate, spec):
        """K13 and K14 take any channel counts and any O block; a block
        that does not divide O is never offered (``bn_conv_space``)."""
        bo = int(candidate.get("bn_conv.block_o", 0) or 0)
        if bo and self.shape[4] % bo:
            return False, (f"block_o={bo} does not divide O="
                           f"{self.shape[4]}")
        return True, ""

    def _args(self, device):
        import torch

        from ..framework.core import torch_dtype

        N, H, W, K, O = self.shape
        rng = np.random.RandomState(3)
        dt = torch_dtype(self.dtype)

        def t(a, d=dt):
            return torch.as_tensor(a).to(device=device, dtype=d)

        x = t(rng.randn(N, H, W, K).astype(np.float32))
        w = t(rng.randn(O, K, 3, 3).astype(np.float32) * 0.05)
        f32 = torch.float32
        g = t(rng.rand(K).astype(np.float32) + 0.5, f32)
        be = t(rng.randn(K).astype(np.float32), f32)
        mu = t(rng.randn(K).astype(np.float32) * 0.1, f32)
        var = t(rng.rand(K).astype(np.float32) + 0.5, f32)
        return x, g, be, mu, var, w

    def build_runner(self, candidate) -> _KernelRunner:
        import torch

        from ..ops.cuda_kernels import bn_conv as bc
        from ..ops.registry import EmitContext, get_op_info

        device = _place(self.place).device
        x, g, be, mu, var, w = self._args(device)
        emit = get_op_info("bn_act_conv3x3").emit
        ctx = EmitContext(device, is_test=False)
        ins = {"X": [x], "Scale": [g], "Bias": [be], "SavedMean": [mu],
               "SavedVariance": [var], "Filter": [w]}
        attrs = {"act": "relu", "epsilon": 1e-5, "strides": [1, 1]}

        def fn():
            with torch.no_grad():
                return emit(ctx, ins, attrs)["Output"][0]

        # the variant and O block come from the ACTIVE TRIAL OVERRIDE,
        # through the op's own knob reads: this A/B proves the routing
        got = fn()
        ref = bc.bn_conv3x3_fwd_ref(x, g, be, mu, var, bc.w_hwio(w))
        _close_enough(got, ref, self.dtype,
                      f"bn_conv {candidate.describe()}")
        return _KernelRunner(fn, (), device,
                             {"bn_conv3x3_fwd": bc.bn_conv3x3_fwd,
                              "bn_conv3x3_fwd_v2": bc.bn_conv3x3_fwd_v2})


class PagedDecodeWorkload:
    """K2, the paged-attention decode kernel, over KV page sizes (the
    page is both the kernel's unit of work and the allocator's
    granularity).  The candidate page size reshapes the pools, so each
    trial builds its own arguments; parity against the plain version
    gates every trial.  The winner lands under the
    ("paged_attention", {}) site that ``knobs.paged_page_size`` — and
    through it ``ServingEngine``'s default — resolves."""

    kind = "kernel"
    name = "paged_decode"

    def __init__(self, N=4, nh=2, dh=16, max_ctx=128, dtype="float32",
                 place=None):
        self.N, self.nh, self.dh, self.max_ctx = N, nh, dh, max_ctx
        self.dtype = dtype
        self.place = place

    def space(self) -> _space.SearchSpace:
        return _space.paged_space(max_ctx=self.max_ctx)

    def site(self) -> dict:
        return {"workload": self.name, "n": self.N, "heads": self.nh,
                "head_dim": self.dh, "max_ctx": self.max_ctx,
                "dtype": self.dtype}

    def kernel_sites(self) -> Tuple:
        return (("paged_attention", {},
                 {"page_size": "paged_attention.page_size"}),)

    def program_for(self, candidate):
        return None

    def analytic_cost(self, candidate, spec) -> dict:
        """Bytes walked per decode step: q + out + every mapped page of
        K and V — page size moves the walk's geometry, not its byte
        volume, so candidates tie in the prior and the measurement
        decides."""
        b = _dtype_bytes(self.dtype)
        q = self.N * self.nh * self.dh * b
        kv = 2 * self.N * self.max_ctx * self.nh * self.dh * b
        flops = 4 * self.N * self.nh * self.max_ctx * self.dh
        return {"flops": flops, "bytes": q + kv + q, "dtype": self.dtype}

    def feasible(self, candidate, spec):
        """K2's own limits (``csrc/paged_attention.cu``): head dim at
        most 128, and a warp's ring of 3 staged K and V page tiles (rows
        of 16-byte chunks, padded to 8 chunks) plus its reduction scratch
        within the block's 232448 bytes of shared memory at one warp."""
        ps = int(candidate.get("paged_attention.page_size", 16))
        if not 1 <= self.dh <= 128:
            return False, f"head dim {self.dh} outside K2's [1, 128]"
        if ps > self.max_ctx:
            return False, f"page size {ps} > max_ctx {self.max_ctx}"
        item = _dtype_bytes(self.dtype)
        ch = -(-self.dh * item // 16)
        tile = ps * ((ch + 7) & ~7) * 16
        red = (2 + 4 * 4 * (16 // item)) * 4  # the widest split's scratch
        smem = 3 * 2 * tile + red
        if smem > 232448:
            return False, (f"page size {ps}: one warp's staged tiles need "
                           f"{smem} B of shared memory > 232448")
        return True, ""

    def build_runner(self, candidate) -> _KernelRunner:
        import torch

        from ..framework.core import torch_dtype
        from ..ops.cuda_kernels import paged_attention as pa
        from ..serving.kv_cache import pages_needed

        device = _place(self.place).device
        dt = torch_dtype(self.dtype)
        ps = int(candidate.get("paged_attention.page_size", 16))
        N, nh, dh, ctx = self.N, self.nh, self.dh, self.max_ctx
        maxp = pages_needed(ctx, ps)
        rng = np.random.RandomState(5)
        num_pages = 1 + N * maxp  # page 0 = the reserved null page

        def t(a, d=dt):
            return torch.as_tensor(a).to(device=device, dtype=d)

        q = t(rng.randn(N, nh, dh).astype(np.float32))
        k_pages = t(rng.randn(num_pages, nh, ps, dh).astype(np.float32))
        v_pages = t(rng.randn(num_pages, nh, ps, dh).astype(np.float32))
        pt = t((1 + np.arange(N * maxp)).reshape(N, maxp), torch.int32)
        cl = t(rng.randint(ps, ctx + 1, (N,)), torch.int32)
        args = (q, k_pages, v_pages, pt, cl)
        got = pa.paged_attention(*args)
        ref = pa.paged_attention_ref(*args)
        _close_enough(got, ref, self.dtype, f"paged_decode page {ps}")
        return _KernelRunner(pa.paged_attention, args, device,
                             {"paged_attention": pa.paged_attention})


# ---------------------------------------------------------------------------
# serve and loop workloads


class _ServeRunner:
    """Serve-loop measurement runner: one step() = submit a FIXED
    request set and drive the engine to drain.  Candidates change how
    many program runs that takes, not how much work is requested."""

    def __init__(self, engine, prompts, max_new):
        self.engine = engine
        self.prompts = prompts
        self.max_new = int(max_new)

    def step(self):
        for p in self.prompts:
            self.engine.submit(p, self.max_new)
        self.engine.run()
        self.engine.pop_finished()

    def barrier(self):
        pass  # generated tokens are host ints: the drain IS the barrier

    def close(self):
        self.engine._exe.close()
        self.engine = None


class SpecDecodeWorkload:
    """Speculative-decoding serve loop over (K, draft depth), resolved
    through ``knobs.speculation_k`` / ``spec_draft_layers`` so the
    trial-override path the engine uses is what the A/B proves.  The
    analytic prior prices one drained serve of the fixed request set
    under a geometric accept model whose per-token probability rises
    with draft depth."""

    kind = "kernel"
    name = "spec_decode"

    def __init__(self, vocab=50, dim=32, layers=4, heads=2, max_len=64,
                 max_new=12, n_requests=6, accept_prob=0.6, place=None):
        self.vocab, self.dim, self.layers = vocab, dim, layers
        self.heads, self.max_len, self.max_new = heads, max_len, max_new
        self.n_requests = n_requests
        self.accept_prob = accept_prob
        self.place = place

    def space(self) -> _space.SearchSpace:
        return _space.spec_decode_space(n_layers=self.layers,
                                        max_new=self.max_new)

    def site(self) -> dict:
        return {"workload": self.name, "vocab": self.vocab,
                "dim": self.dim, "layers": self.layers,
                "heads": self.heads, "max_len": self.max_len,
                "max_new": self.max_new, "dtype": "float32"}

    def kernel_sites(self) -> Tuple:
        return (("spec_decode", {},
                 {"speculation_k": "spec_decode.speculation_k",
                  "draft_layers": "spec_decode.draft_layers"}),)

    def program_for(self, candidate):
        return None  # serve loop: priced analytically

    def _accept_prob(self, draft_layers: int) -> float:
        """Per-drafted-token accept probability: linear in draft depth
        from `accept_prob` at one layer to 1.0 at full depth."""
        L = self.layers
        if L <= 1:
            return 1.0
        frac = (L - draft_layers) / float(L - 1)
        return 1.0 - (1.0 - self.accept_prob) * frac

    def analytic_cost(self, candidate, spec) -> dict:
        k = int(candidate.get("spec_decode.speculation_k", 4))
        nd = int(candidate.get("spec_decode.draft_layers",
                               max(1, self.layers // 2)))
        D, L, V = self.dim, self.layers, self.vocab
        p = min(self._accept_prob(nd), 0.999)
        # expected tokens emitted per round: the accepted prefix + the
        # verify row's own token (geometric, truncated at K)
        emitted = (1.0 - p ** (k + 1)) / (1.0 - p)
        rounds = self.n_requests * self.max_new / emitted
        f_layer = 24.0 * D * D + 4.0 * (self.max_len / 2.0) * D
        f_head = 2.0 * D * V
        token_passes = k * nd + (k + 1) * L  # draft + verify per round
        flops = rounds * (token_passes * f_layer + (k + 1) * f_head)
        wb_layer = 12.0 * D * D * 4
        kv_row = 2.0 * (self.max_len / 2.0) * D * 4
        bytes_ = rounds * (token_passes * (wb_layer + kv_row)
                           + (k + 1) * D * V * 4)
        return {"flops": flops, "bytes": bytes_, "dtype": "float32"}

    def feasible(self, candidate, spec):
        k = int(candidate.get("spec_decode.speculation_k", 4))
        nd = int(candidate.get("spec_decode.draft_layers", 1))
        if not 1 <= k < self.max_new:
            return False, (f"speculation_k={k} outside [1, "
                           f"{self.max_new}) for max_new={self.max_new}")
        if not 1 <= nd < self.layers:
            return False, (f"draft_layers={nd} must be in [1, "
                           f"{self.layers}) — equal depth is the target")
        return True, ""

    def build_runner(self, candidate) -> _ServeRunner:
        import paddle_tpu_torch as fluid
        from ..framework import unique_name
        from ..framework.core import Program, program_guard
        from ..models import transformer
        from ..serving import ServingEngine

        place = _place(self.place)
        main, startup = Program(), Program()
        with unique_name.guard(), program_guard(main, startup):
            lm = transformer.DecoderLM(self.vocab, self.dim, self.layers,
                                       self.heads, max_len=self.max_len,
                                       dtype="float32")
            tokens = fluid.layers.data("tokens",
                                       shape=[self.max_len, 1],
                                       dtype="int64")
            lm.logits(tokens)
            main.random_seed = 11
            exe = fluid.Executor(place)
            exe.run(startup, steps_per_dispatch=1)
            # K and draft depth resolve through the knobs under the
            # active trial override — the production resolution path
            eng = ServingEngine(lm, max_batch_size=3, page_size=16,
                                scheduler="spec", name="tune_spec",
                                place=place)
        rng = np.random.RandomState(0)
        prompts = [rng.randint(1, self.vocab, size=n).tolist()
                   for n in (13, 6, 9, 16, 2, 11)][:self.n_requests]
        return _ServeRunner(eng, prompts, self.max_new)


class _StepLoopRunner:
    """One step() = `dispatches` Executor.run calls totalling the same
    number of training steps for every candidate.  run() is called
    WITHOUT the steps_per_dispatch kwarg: the knob resolves it through
    the ACTIVE TRIAL OVERRIDE, and a K mismatch fails loudly in
    step_loop.check_stacked."""

    def __init__(self, exe, program, scope, feed, loss_name, dispatches):
        self._exe, self._program = exe, program
        self._scope, self._feed = scope, feed
        self._loss, self._dispatches = loss_name, int(dispatches)

    def step(self):
        for _ in range(self._dispatches):
            self._exe.run(self._program, feed=self._feed,
                          fetch_list=[self._loss], scope=self._scope,
                          return_numpy=False)

    def barrier(self):
        _sync(self._exe.device)

    def close(self):
        self._exe.close()


class StepLoopWorkload:
    """K steps a dispatch (framework/step_loop.py) over the Momentum
    MLP: every candidate runs the SAME `total_steps` training steps, K=1
    as `total_steps` dispatches, K=8 as `total_steps/8`.  The analytic
    prior prices ``(T/K) * overhead_s`` on top of the (tied) roofline.
    The winner persists under the ("step_loop", {}) site that
    ``knobs.steps_per_dispatch(store=True)`` resolves — never the
    executor's own default path (store=False there)."""

    kind = "loop"
    name = "step_loop"

    def __init__(self, batch_size: int = 4, total_steps: int = 8,
                 place=None):
        self.batch_size = int(batch_size)
        self.total_steps = int(total_steps)
        self.place = place
        self._built = None
        self._reports: Dict[str, dict] = {}

    def site(self) -> dict:
        return {"workload": self.name, "model": "mlp_momentum",
                "batch_size": self.batch_size,
                "total_steps": self.total_steps}

    def space(self) -> _space.SearchSpace:
        return _space.step_loop_space(
            ks=[k for k in (1, 2, 4, 8) if k <= self.total_steps])

    def kernel_sites(self) -> Tuple:
        return (("step_loop", {},
                 {"steps_per_dispatch": "step_loop.steps_per_dispatch"}),)

    def program_for(self, candidate):
        return None  # priced analytically; overhead_s differentiates

    def _program(self):
        if self._built is None:
            import paddle_tpu_torch as fluid
            from ..framework import unique_name
            from ..framework.core import Program, program_guard

            main, startup = Program(), Program()
            with unique_name.guard(), program_guard(main, startup):
                x = fluid.layers.data(name="x", shape=[16])
                y = fluid.layers.data(name="y", shape=[1])
                h = fluid.layers.fc(x, size=32, act="relu")
                pred = fluid.layers.fc(h, size=1)
                loss = fluid.layers.mean(
                    fluid.layers.square_error_cost(pred, y))
                fluid.optimizer.Momentum(
                    learning_rate=0.01, momentum=0.9).minimize(loss)
            self._built = (main, startup, loss.name, ["x", "y"])
        return self._built

    def analytic_cost(self, candidate, spec) -> dict:
        from ..analysis import cost as _c

        k = int(candidate.get("step_loop.steps_per_dispatch", 1))
        chip = spec["chip"]
        rep = self._reports.get(chip)
        if rep is None:
            rep = _c.program_cost(self._program()[0],
                                  batch_size=self.batch_size, chip=chip)
            self._reports[chip] = rep
        T = self.total_steps
        overhead = _c.DEFAULT_DISPATCH_OVERHEAD_S.get(chip, 8e-5)
        return {"flops": T * rep["total_flops"],
                "bytes": T * rep["hbm_bytes"],
                "overhead_s": (T // max(k, 1)) * overhead}

    def feasible(self, candidate, spec):
        k = int(candidate.get("step_loop.steps_per_dispatch", 1))
        if k < 1:
            return False, f"steps_per_dispatch={k} must be >= 1"
        if self.total_steps % k:
            return False, (f"total_steps={self.total_steps} not "
                           f"divisible by steps_per_dispatch={k} — "
                           f"candidates would run unequal work")
        return True, ""

    def build_runner(self, candidate) -> _StepLoopRunner:
        from ..analysis.equivalence import build_feeds
        from ..framework.executor import Executor
        from ..framework.scope import Scope

        k = int(candidate.get("step_loop.steps_per_dispatch", 1))
        main, startup, loss_name, feed_names = self._program()
        exe = Executor(_place(self.place))
        scope = Scope()
        # the trial pins steps_per_dispatch: the startup runs once
        exe.run(startup, scope=scope, steps_per_dispatch=1)
        feeds = [build_feeds(main, feed_names, self.batch_size, seed=i)
                 for i in range(k)]
        # K=1 is the identity path: plain per-step feeds, no K dim
        feed = (feeds[0] if k == 1 else
                {n: np.stack([f[n] for f in feeds])
                 for n in feed_names})
        return _StepLoopRunner(exe, main, scope, feed, loss_name,
                               self.total_steps // k)


# ---------------------------------------------------------------------------
# saved-model workloads (`tune <dir>`)


class SavedModelWorkload(ProgramWorkload):
    """Generic workload over a saved model: the remat axis (the kernel
    knobs resolve per site from whatever the program runs).  Feeds are
    the equivalence oracle's deterministic synthetic feeds; state comes
    from the saved persistables when present and is otherwise seeded by
    name — the idiom the `metrics`/`trace` CLI runs use."""

    def __init__(self, path: str, batch_size: int = 2, place=None):
        import os

        from ..analysis import equivalence as eqv
        from ..cli import _load_program_any

        name = os.path.basename(os.path.normpath(path)) or "model"
        super().__init__(name, builder=None,
                         space_builder=_space.remat_space, place=place)
        self.path = path
        self.batch_size = batch_size
        program, feed_names, fetch_names = _load_program_any(path)
        block = program.global_block()
        if not fetch_names:  # None OR an empty manifest list
            fetch_names = eqv.sink_outputs(block)
        if not feed_names:
            feed_names = [v.name for v in block.vars.values()
                          if v.is_data]
        self._program_json = program.to_json()
        self._fetch = list(fetch_names)
        self._feeds = eqv.build_feeds(program, feed_names,
                                      batch_size=batch_size)

    def build(self, candidate) -> Built:
        from ..framework.core import Program

        main = Program.from_json(self._program_json)
        built = Built(main, Program(), dict(self._feeds),
                      list(self._fetch), self.batch_size)
        if candidate is not None and candidate.get("remat"):
            from ..memory_optimization_transpiler import memory_optimize

            memory_optimize(main, level=1, batch_size=self.batch_size)
        return built

    def build_runner(self, candidate) -> _ProgramRunner:
        from ..cli import _load_scope_for, seed_missing_state
        from ..framework.scope import Scope

        built = self.build(candidate)
        scope = _load_scope_for(self.path) or Scope()
        seed_missing_state(built.main, built.feed, scope)
        return _ProgramRunner(built, _place(self.place), scope=scope,
                              run_startup=False)


def saved_model_workload(path: str, batch_size: int = 2,
                         place=None) -> SavedModelWorkload:
    return SavedModelWorkload(path, batch_size, place=place)


class _MeshRunner:
    """One training step of the layout's ParallelExecutor on its
    positions — the measured half when a real (non-mock) measurer drives
    the mesh_layout axis; ``barrier`` waits for the card."""

    def __init__(self, exe, program, startup, feeds, loss_name):
        from ..framework.scope import Scope

        self._exe = exe
        self._program = program
        self._feeds = feeds
        self._loss = loss_name
        self._last = None
        self._scope = Scope()
        exe.run(startup, scope=self._scope)

    def step(self):
        self._last = self._exe.run(
            self._program, feed=dict(self._feeds),
            fetch_list=[self._loss], scope=self._scope, rng_step=0,
            return_numpy=False)

    def barrier(self):
        _sync(self._exe.device)

    def close(self):
        pass


class MeshLayoutWorkload:
    """Multi-slice mesh layouts (slice count x per-slice ICI topology,
    fixed 8-device fleet) for the Momentum-MLP step with weight-update
    sharding active.  Every layout runs the same math — compute and
    HBM traffic tie by construction — so the DIFFERENTIATOR is pure
    communication: ``comm_cost`` prices each layout's collectives per
    link class (a hybrid all-reduce decomposes into per-slice ICI
    reduce-scatter -> DCN all-reduce -> ICI all-gather) and the prior
    folds the wire time through `cost.roofline_with_comm`, ranking
    ICI-heavy layouts (1x8) above DCN-heavy ones (4x2) exactly when
    the analyzer says the DCN link dominates the step."""

    kind = "mesh"
    name = "mesh_layout"
    LAYOUTS = ("1x8", "2x4", "4x2")

    def __init__(self, batch_size: int = 64, place=None):
        from ..parallel import modes as pmodes

        self.batch_size = int(batch_size)
        self.place = place
        self._built = None
        # eight positions: the card's (repeated) unless `place` is the CPU
        self.devices = pmodes.ensure_virtual_devices(8, place)

    def site(self) -> dict:
        return {"workload": self.name, "devices": 8,
                "model": "mlp_momentum_zero",
                "batch_size": self.batch_size}

    def space(self) -> _space.SearchSpace:
        return _space.SearchSpace([
            _space.Choice("mesh_layout.layout", list(self.LAYOUTS))])

    def kernel_sites(self) -> Tuple:
        return ()

    def program_for(self, candidate):
        return None  # priced analytically; comm_cost differentiates

    def _program(self):
        if self._built is None:
            from ..parallel import modes as pmodes

            from ..framework.core import default_startup_program

            mode, program, loss_name = pmodes.build_mode("dp")
            self._built = (program, loss_name, default_startup_program())
        return self._built

    @staticmethod
    def _parse(layout: str) -> Tuple[int, int]:
        slices, per_slice = (int(p) for p in str(layout).split("x"))
        return slices, per_slice

    def _mesh_for(self, layout):
        from ..parallel.mesh import make_hybrid_mesh, make_mesh

        slices, per_slice = self._parse(layout)
        if slices == 1:
            return make_mesh({"dp": per_slice}, devices=self.devices)
        return make_hybrid_mesh({"dp": per_slice}, {"dcn_dp": slices},
                                devices=self.devices)

    def analytic_cost(self, candidate, spec) -> dict:
        from ..analysis import cost as _c

        program = self._program()[0]
        report = _c.program_cost(program, batch_size=self.batch_size,
                                 chip=spec["chip"])
        return {"flops": report["total_flops"],
                "bytes": report["hbm_bytes"],
                "devices": 8}

    def comm_cost(self, candidate, spec) -> dict:
        """The layout's priced collective footprint: plan the program
        on the candidate mesh (weight-update sharding on), propagate,
        and price per link class."""
        from ..analysis.sharding import comm_report, propagate
        from ..parallel.parallel_executor import ParallelExecutor

        layout = candidate.get("mesh_layout.layout", self.LAYOUTS[0])
        mesh = self._mesh_for(layout)
        program = self._program()[0]
        exe = ParallelExecutor(mesh=mesh, zero_dp_states=True)
        plan = exe.static_plan(program)
        ana = propagate(program, mesh=mesh, plan=plan,
                        batch_size=self.batch_size)
        return comm_report(ana, chip=spec["chip"])

    def feasible(self, candidate, spec):
        slices, per_slice = self._parse(
            candidate.get("mesh_layout.layout", self.LAYOUTS[0]))
        if slices * per_slice != 8:
            return False, (f"layout {slices}x{per_slice} does not use "
                           f"the fixed 8-device fleet")
        if self.batch_size % (slices * per_slice):
            return False, (f"batch {self.batch_size} not divisible by "
                           f"{slices * per_slice} devices")
        return True, ""

    def build_runner(self, candidate) -> _MeshRunner:
        from ..analysis.equivalence import build_feeds
        from ..parallel.parallel_executor import ParallelExecutor

        layout = candidate.get("mesh_layout.layout", self.LAYOUTS[0])
        mesh = self._mesh_for(layout)
        program, loss_name, startup = self._program()
        exe = ParallelExecutor(mesh=mesh, zero_dp_states=True)
        block = program.global_block()
        feed_names = sorted(n for n, v in block.vars.items()
                            if v.is_data)
        feeds = build_feeds(program, feed_names, self.batch_size)
        return _MeshRunner(exe, program, startup, feeds, loss_name)


# ---------------------------------------------------------------------------
# registry

WORKLOADS: Dict[str, Callable[..., object]] = {
    "gpt_small": lambda place=None: ProgramWorkload(
        "gpt_small", _build_gpt_small, _space.remat_space, place=place),
    "bn_conv": lambda place=None: BnConvWorkload(place=place),
    "paged_decode": lambda place=None: PagedDecodeWorkload(place=place),
    "spec_decode": lambda place=None: SpecDecodeWorkload(place=place),
    "lstm": lambda place=None: ProgramWorkload(
        "lstm", _build_lstm, _space.remat_space, place=place),
    "mlp_depth": lambda place=None: MlpDepthWorkload(place=place),
    "mesh_layout": lambda place=None: MeshLayoutWorkload(place=place),
    "step_loop": lambda place=None: StepLoopWorkload(place=place),
}


def get_workload(name: str, place=None):
    """Named workload, or a saved-model workload when `name` is a
    path; `place` is where its trials run (None: the card)."""
    import os

    if name in WORKLOADS:
        return WORKLOADS[name](place=place)
    if os.path.exists(name):
        return saved_model_workload(name, place=place)
    raise KeyError(
        f"unknown workload {name!r}: use one of {sorted(WORKLOADS)} or "
        f"a saved-model path")
