"""Drive paddle_tpu_torch on one CUDA card and check it end to end.

Usage (from the repository root, on a machine with an NVIDIA H100 and
nvcc):

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught; any error exits
non-zero and no result line is printed):

1. the card: name, power limit, TF32 off for float32 matmuls;
2. build: the hand-written CUDA kernels are compiled from
   ``paddle_tpu_torch/ops/cuda_kernels/csrc`` with nvcc for sm_90a;
3. kernels K1 and K2: each against its plain PyTorch version on the card,
   in float32 and bfloat16, at the serving path's shapes, timed beside
   the plain version, the bound of the card and (flash only) PyTorch's
   scaled_dot_product_attention as a yardstick the port never calls;
   each flash row names its design (f32 ``mma_3xtf32``, bf16 ``mma``,
   both on the tensor cores) with its ratio to that call and its share of
   the bound; the f32 bound counts three TF32 products at the tensor
   cores' TF32 rate, and the phase's log rows (not the ``kernels`` line)
   give the CUDA cores' bound of one f32 product beside it.  K2 (design
   ``split_kv_cuda_cores``) runs the 8 ragged slots of a decode step, all
   8 at ctx 1024 and one alone at 1024, each timed warm (``kernel_ms``:
   100 calls on one pool, whose pages stay in the 50 MB L2) and cold
   (``kernel_cold_ms``: each call on the next of 8 or more pool copies,
   one per layer as a serve's ``kpool[i]``, at least 100 MB a round);
4. fifo serve: the full-width GPT bench model (vocab 32000, dim 512, 8
   layers, 8 heads, max_len 1024, float32, random weights from a seed)
   behind the fifo ServingEngine (8 slots, page 16) answers 16 requests,
   once to warm up and once measured; every request must finish, no page
   may leak, and the kernels' launch counts must equal 8 layers x the
   prefill runs and decode steps the engine ran;
5. the same weights and requests through an explicit-CPU engine, which
   takes the kernels' plain versions: tokens must agree, except at most
   one request that may part at a near tie (CPU top-2 logits within
   1e-3) — the rule every comparison below uses;
6. kernel K3 (the multi-query page walk) against its plain version at the
   mixed step's shape (4 chunk lanes of 32 rows) and the speculative
   verify's (8 slots of 5 rows), float32 and bfloat16, ragged, with an
   idle lane, a mid-page start, a chunk across a page, a lane near 1024
   and every unseen pool slot poisoned; design ``split_kv_mma`` (bf16) or
   ``split_kv_mma_3xtf32`` (f32, bounded as K1's f32 body), timed warm
   and cold as K2;
7. v2 serve (8 slots, page 16, chunk 32, 4 lanes, the default
   watermark): the 16 requests (tokens as the fifo card run's), the 16
   prefix-heavy requests of ``gpt_bench.prefix_prompts`` (prefix hits and
   copy-on-write must happen; tokens as an explicit-CPU v2 engine's), and
   a low-priority request overtaken by a high-priority burst in a pool
   tight enough to preempt (tokens as a roomy pool's); launch counts
   K3 = 8 x mixed steps, K2 = 8 x (mixed + decode steps), K1 = 0;
8. spec serve (k 4, a 1-layer draft) on weights whose layers 1-7 are
   damped as serve_bench's spec rows damp them: tokens as v2's on the
   same weights, drafts accepted, K3 = 8 x (mixed steps + spec rounds),
   K2 = 8 x (mixed + decode steps) + 1 layer x k x draft runs;
9. (the serving summary rows, printed with phase 18);
10. kernels K4-K6 (flash forward with logsumexp, dQ, dK/dV) against their
    plain versions, float32 and bfloat16, at the training bench shape
    [8, 8, 1024, 64] causal, a ragged [2, 4, 1000, 64] causal and
    non-causal, a D = 128 case [2, 4, 512, 128], one short ragged tile
    with a padded head dim [1, 1, 37, 40], B*H = 1024 [64, 16, 128, 64]
    and a head dim that is no whole number of 16-byte chunks in either
    dtype [1, 2, 77, 38] (staged element by element); out and lse
    absolutely, dq, dk and dv relative to each tensor's max |value|; at
    the bench shape each is timed beside its plain version, the card's
    bound and PyTorch's scaled_dot_product_attention (forward for K4, its
    backward, which yields dq, dk and dv together, for K5 and K6), and
    each row names its design (bf16 K4-K6 ``mma``; f32 K4-K6
    ``mma_3xtf32``, bounded as K1 in 3) with its ratio to that call and
    its share of the bound;
11. training parity, float32: ``build_lm_train_program`` at full width
    and depth (vocab 32000, dim 512, 8 layers, 8 heads, Adam 3e-4), batch
    2 x 256, three steps on the card and three on an explicit CPU
    executor from the same numpy state: losses within 1e-4 relative, the
    step-1 grads of the embedding, the first WQ and the head within 1e-3
    of their max |g|, and per step K4 = 16, K5 = 8, K6 = 8, K1 = 0;
12. bf16 training at the bench shape (``build_lm_train_program``
    defaults, batch 8 x 1024 from ``RandomState(0)`` as ``bench.py`` makes
    it): 2 warm-up steps, then 10 measured; every loss finite, the last
    below the first; step ms, tokens/s, peak memory and launch counts
    (K4 = 16, K5 = 8, K6 = 8, K1 = 0 per step);
13. kernels K7-K10 (the LSTM and GRU time loops, forward and BPTT)
    against their plain versions, float32 and bfloat16: the LSTM at its
    bench shape (B 64, T 96, H 512) and the GRU at the NMT encoder's (B 64,
    T 64, H 512), each with full and with ragged lengths, and at three
    awkward shapes (B 5, T 7, H 96; one row; a row of length 0), both
    also at B 160, T 6, H 512 (more batch groups than the persistent grid
    runs at once), the LSTM at B 4, T 5, H 528 and H 1152 and the GRU at
    B 4, T 5 and the two widths past 512 at which ``gru.smem_bytes``
    first exceeds the card's shared memory a block for some body and for
    every body (``gru.steps_widths``: widths whose W slice does not fit);
    states absolutely, gradients relative to each tensor's max |value|;
    each row logs the body that ran and its device launches, both read
    from the launches the kernel library counted in the parity call,
    kernel by kernel, where it launched them (``lstm.device_launches``,
    ``gru.device_launches``), and fails unless that is the body the
    module's ``route`` chose before the launch (``persistent``: K7 one
    launch, K8 two, K9 one, K10 three; ``steps``: T, 2T + 1, 2T and 4T +
    2); both bodies of each kernel must run; with full lengths each is
    timed beside its plain version and the card's bound (no single
    PyTorch call computes the same function, so no library time);
14. LSTM parity, float32: the stacked-LSTM classifier of
    ``rnn_bench.lstm_train_program`` at full width (vocab 30000, hidden
    512, two layers, the second reversed), batch 16 x 32 with ragged
    lengths, three Adam steps on the card and three on an explicit CPU
    executor from the same state: losses within 1e-4 relative, step-1
    grads of both recurrent weights and the embedding within 1e-3 of
    their max |g|, and per step K7 = 4, K8 = 2 (each LSTM op runs its
    forward again inside its grad op);
15. LSTM bench, bfloat16, batch 64 x 96 as ``bench.py`` makes it: 2 warm-up
    steps, 10 measured (the lowest measured loss below the first step's:
    the classifier memorises its one batch, and at loss 0 a bf16 Adam step
    can spike, so the last step need not be the lowest), then 3 steps on a
    feed with ragged lengths, then the same forward program without grad
    ops (test mode) on that feed: K7 = 2, K8 = 0;
16. NMT parity, float32: ``rnn_bench.nmt_train_program`` (the attention-NMT
    training program at the book's widths: dictionaries 30000, embedding,
    hidden and attention 512), batch 8 x 16 + 16 ragged, card against CPU
    as in 14; per step K9 = 4, K10 = 2;
17. NMT bench, float32, batch 64 x 64 + 64 ragged: 2 + 10 steps, the loss
    falls (judged as in 15);
18. kernels K11-K15 (the fused BatchNorm -> 1x1 convolution forward and
    backward; the fused BatchNorm -> 3x3 convolution forward, its O-blocked
    variant and backward) against their plain versions, float32 and
    bfloat16: every distinct (op, shape, stride, residual) of ResNet-50's
    fused bench program at batch 128 and 224 x 224 (read from its desc),
    ResNet-18's stride-2 and residual 3x3 shapes, and an odd-H stride-2
    3x3; outputs and gradients relative to each tensor's max |value|, the
    f32 kernels against the plain version in float64 (inputs clear of the
    ReLU's kink), the bf16 ones against it in bf16, with each bf16
    output's distance to the float64 function logged beside the plain
    version's (the forwards' too); each row names its body (every bf16
    kernel ``mma``, every f32 one ``mma_3xtf32``, bounded at three TF32
    products per f32 product with the CUDA cores' bound beside it) and
    K14's whether it has K13's bits;
    K13 and K14 timed at
    every 3x3 shape, K11, K12 and K15 in both dtypes at every ResNet-50
    shape, and one row (``bn_f32_resnet50_step``) sums launches x kernel
    ms of f32 K11, K12 and K15 over the fused ops of ResNet-50's step; at
    stage 2's 1x1 with a residual and its 3x3 each kernel is timed beside
    its plain version (the unfused ATen, cuDNN and torch.matmul
    composition) and the card's bound; then the ``top_k`` op that feeds
    ResNet's accuracy, on rows full of ties (all zeros; 128 x 1000
    integers in [0, 4)), float32 and bfloat16: its indices on the card
    equal a stable descending sort's (the lowest index first among equal
    values, as ``jax.lax.top_k``) and the CPU's;
19. ResNet-50 and ResNet-18 parity, float32: the fused NHWC programs of
    ``resnet_bench`` at full width (class_dim 1000), batch 4, Momentum
    0.001, against an explicit CPU executor from the same state.
    ResNet-18 at 64 x 64, three free steps on each: losses within 1e-4
    relative, step-1 grads of the stem filter, a fused 3x3 filter, a BN
    scale and the fc weight within 1e-3 of their max |g|, every running
    mean and variance within 1e-3 after three steps.  ResNet-50 at 128 x
    128, where float32 itself holds its gradients only to about 2%
    (RESNET_PARITY's comment): the card takes each of three steps from the
    CPU's state before it, each loss within 1e-4, the fc grad within 1e-3,
    the running statistics after step 1 within 1e-3, and the stem, fused
    3x3 and BN-scale grads, and all grads together, no further from a
    float64 CPU step's than twice the CPU's f32 ones; again with
    PADDLE_TPU_BNCONV_VARIANT=v2: K13 0, K14 32, each loss within 1e-4 of
    the CPU's and the step-1 loss within 1e-6 of v1's.  Per step K11 68,
    K12 34, K13 32, K15 16 (ResNet-50) and K11 6, K12 3, K13 30, K15 15
    (ResNet-18);
20. ResNet-50 bench, bfloat16, batch 128, 224 x 224 (``bench.py``'s
    configuration): 2 warm-up and 10 measured steps fused (the lowest
    measured loss below the first; step ms, images/s, peak memory, the
    launches of 19 every step), the same fused program again under
    PADDLE_TPU_BNCONV_VARIANT=v2 (K13 0, K14 32 a step), then the program
    built unfused for 2 + 10 steps (no port kernel runs) and the three
    images/s side by side;
21. K steps a dispatch (``Executor.run(steps_per_dispatch=K)``, one
    replay of a captured CUDA graph, ``framework/step_loop.py``), GPT
    training at the bench width, K = 4, in f32 at batch 2 x 256 and in
    bf16 at 8 x 1024: from one state, SPREAD_RUNS runs of 4 eager steps
    (the largest distance between two is the eager spread, printed, of the
    losses and of each persistable tensor; where they part, the ops whose
    outputs part first, from a checksum of every op's outputs in two more
    runs), then from that state the first dispatch (eager), the second
    (capture, then replay) and a third (replay) against the first eager
    run: losses within SPREAD_FACTOR of the losses' spread and each tensor
    within SPREAD_FACTOR of its own, so bitwise where the eager runs agree
    to the bit; launches at capture K x 16 K4, K x 8
    K5 and K6, none at a replay; then (bf16) 12 eager and 12 replayed
    steps, each ending in the loss fetch: step ms, tok/s, peak memory
    (eager; a replay allocates nothing), the memory reserved, and the
    graphs' shared pool;
22. on that GPT, each held as 21 to the spread of eager runs from its
    own start: ``fetch_every="last"`` (a second key, its own capture),
    with the graphs' shared pool and the card's reserved memory at one
    key and at two, and a replay after an eager ``run()`` replaced the
    scope's state; one executor dispatching a small MLP against two
    scopes in turn, each equal to the bit to its own eager steps; a small
    program holding ``uniform_random`` warns naming it, runs its K steps
    eagerly and equals K runs;
23. ``DeviceFeeder(steps=4)`` (pinned memory, its own stream) drives two
    GPT dispatches, held to the spread of eager runs of the same 8 steps
    against two numpy-fed ones from the same state;
24. fused ResNet-50 at the bench shape, K = 2, as 21: launches at
    capture 2 x (K11 68, K12 34, K13 32, K15 16), 12 eager and 12
    replayed steps; then whether one cooperative launch (K7's persistent
    body) captures into a graph (one call in a process of its own; a
    record, not a check);
25. summary.

The second-to-last line is the ``{"kernels": [...], "serve": [...],
"train": [...], "step_loop": [...]}`` summary (all 15 kernels) and the
last line is ``{"ok": true, "device": {...}}``.  Without CUDA the script
exits 2 and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

import paddle_tpu_torch as fluid
from paddle_tpu_torch.framework import executor as texecutor
from paddle_tpu_torch.models import gpt_bench, resnet_bench, rnn_bench
from paddle_tpu_torch.models.gpt_bench import (DIM, HEADS, LAYERS, MAX_LEN,
                                               VOCAB)
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.ops.cuda_kernels import _common
from paddle_tpu_torch.ops.cuda_kernels import bn_conv as bnc
from paddle_tpu_torch.ops.cuda_kernels import bn_matmul as bnmm
from paddle_tpu_torch.ops.cuda_kernels import flash_attention as fa
from paddle_tpu_torch.ops.cuda_kernels import gru as gru_k
from paddle_tpu_torch.ops.cuda_kernels import lstm as lstm_k
from paddle_tpu_torch.ops.cuda_kernels import paged_attention as pa
from paddle_tpu_torch.ops.registry import EmitContext, get_op_info
from paddle_tpu_torch.ops.transformer_ops import _lm_fns
from paddle_tpu_torch.serving import ServingEngine, pages_needed

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12,   # CUDA cores: the kernels' FMA loops
              torch.bfloat16: 989e12}
# the dense TF32 rate of the tensor cores, which the f32 flash kernels
# (K1, f32 K4-K6), f32 K3 and the f32 fused BatchNorm backwards and 3x3
# forwards (K12, K13, K14, K15) run on in 3xTF32: three TF32 products per
# f32 product
PEAK_TF32 = 495e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = (torch.float32, torch.bfloat16)

# the serving model is gpt_bench's: bench.py's GPT config at _gpt_heads(512)
SLOTS, PAGE, N_REQ, MAX_NEW = 8, 16, 16, 32
NUM_PAGES = SLOTS * pages_needed(MAX_LEN, PAGE) + 1
CHUNK, LANES = 32, 4
SPEC_K, DRAFT_LAYERS = 4, 1
SEED = 0
KERNELS = {"flash_attention": fa.flash_attention,
           "paged_attention": pa.paged_attention,
           "paged_attention_mq": pa.paged_attention_mq,
           "flash_attention_fwd": fa.flash_attention_fwd,
           "flash_attention_dq": fa.flash_attention_dq,
           "flash_attention_dkv": fa.flash_attention_dkv,
           "lstm_forward": lstm_k.lstm_forward,
           "lstm_backward": lstm_k.lstm_backward,
           "gru_forward": gru_k.gru_forward,
           "gru_backward": gru_k.gru_backward,
           "bn_matmul_fwd": bnmm.bn_matmul_fwd,
           "bn_matmul_bwd": bnmm.bn_matmul_bwd,
           "bn_conv3x3_fwd": bnc.bn_conv3x3_fwd,
           "bn_conv3x3_fwd_v2": bnc.bn_conv3x3_fwd_v2,
           "bn_conv3x3_bwd": bnc.bn_conv3x3_bwd}
# the training bench (bench.py bench_gpt_train): batch 8 x 1024, bf16
TRAIN_BS, TRAIN_SEQ = 8, 1024


_T0 = time.monotonic()


def log(tag, obj):
    """One result line; `at_s` is the seconds since the script started."""
    print(f"{tag} {json.dumps({**obj, 'at_s': time.monotonic() - _T0})}",
          flush=True)


def time_ms(fn, iters=20, ahead=True):
    """Mean device time of one call, from CUDA events around `iters` calls
    after a warm-up.  The calls are queued behind a device spin
    (``torch.cuda._sleep``) that lasts longer than the host takes to
    enqueue them, so the events time the kernels back to back and not the
    host's launch rate (for a kernel shorter than its Python wrapper the
    two differ).  The spin doubles until the host stays ahead of it, and
    `iters` halves, because CUDA's launch queue is finite: a host
    that fills it waits for the spin to end.  A call of hundreds of
    launches should pass an `iters` that keeps the whole below about 500.
    With ``ahead=False`` nothing is queued ahead: the events span `iters`
    calls as the host issues them, which for a Python loop of small
    kernels (the recurrent plain versions) is the host's rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if not ahead:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.monotonic()
    fn()
    torch.cuda.synchronize()
    spin_s = 2 * iters * (time.monotonic() - t0) + 0.01
    for _ in range(5):
        torch.cuda._sleep(int(spin_s * 2e9))  # cycles, at up to 2 GHz
        start.record()
        t0 = time.monotonic()
        for _ in range(iters):
            fn()
        host_s = time.monotonic() - t0
        end.record()
        end.synchronize()
        if host_s < spin_s / 2:
            return start.elapsed_time(end) / iters
        spin_s *= 2
        iters = max(2, iters // 2)
    raise AssertionError(f"time_ms: the host could not enqueue {iters} "
                         f"calls ahead of the device")


def bound(nbytes, flops, dtype, peak=None):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the body of each flash kernel by dtype: all run on the tensor cores
# (mma.sync), bf16 in m16n8k16, f32 in 3xTF32
DESIGN = {torch.bfloat16: {"flash_attention": "mma",
                           "flash_attention_fwd": "mma",
                           "flash_attention_dq": "mma",
                           "flash_attention_dkv": "mma"},
          torch.float32: {"flash_attention": "mma_3xtf32",
                          "flash_attention_fwd": "mma_3xtf32",
                          "flash_attention_dq": "mma_3xtf32",
                          "flash_attention_dkv": "mma_3xtf32"}}
# K11-K15: every body runs on the tensor cores (mma.sync), bf16 in
# m16n8k16, f32 in 3xTF32: K11, K12, K15 and bf16 K13 on csrc/bn_mma.cuh's
# 64 x 64 tiles, K14 and f32 K13 on csrc/bn_conv.cu's bnc_fwd_wide
BN_KERNELS = ("bn_matmul_fwd", "bn_matmul_bwd", "bn_conv3x3_fwd",
              "bn_conv3x3_fwd_v2", "bn_conv3x3_bwd")
DESIGN[torch.bfloat16].update(dict.fromkeys(BN_KERNELS, "mma"))
DESIGN[torch.float32].update(dict.fromkeys(BN_KERNELS, "mma_3xtf32"))
# K2 and K3 split a slot's page walk across blocks and stage pages by
# cp.async into rings (csrc/paged_split.cuh); K2 scores on the CUDA cores
# in both dtypes, K3 on the tensor cores (f32 in 3xTF32)
for _dt in DTYPES:
    DESIGN[_dt]["paged_attention"] = "split_kv_cuda_cores"
DESIGN[torch.bfloat16]["paged_attention_mq"] = "split_kv_mma"
DESIGN[torch.float32]["paged_attention_mq"] = "split_kv_mma_3xtf32"


def flash_bound(name, nbytes, flops, dtype):
    """(bound_ms, bound_by, extra fields) of an attention kernel, by its
    body: a 3xTF32 body does three TF32 products per f32 product at the
    tensor cores' TF32 rate, and its log row keeps the CUDA cores' bound of
    the one f32 product beside it; every other body is bounded at its
    dtype's rate."""
    if not DESIGN[dtype][name].endswith("mma_3xtf32"):
        return (*bound(nbytes, flops, dtype), {})
    b_ms, b_by = bound(nbytes, 3 * flops, dtype, peak=PEAK_TF32)
    return b_ms, b_by, {"bound_cuda_cores_ms": bound(nbytes, flops, dtype)[0]}


def ratios(row):
    """The kernel's time over the library call's and the bound's share."""
    row["vs_library"] = row["kernel_ms"] / row["library_ms"]
    row["bound_share"] = row["bound_ms"] / row["kernel_ms"]


def max_err(a, b):
    return (a.double() - b.double()).abs().max().item()


# -- 1. the card --------------------------------------------------------------

def card():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("card", {"name": name, "nvidia_smi": smi,
                 "count": torch.cuda.device_count(),
                 "torch": torch.__version__, "cuda": torch.version.cuda,
                 "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                 "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32})
    return name, smi


# -- 2. build -----------------------------------------------------------------

def build():
    t0 = time.monotonic()
    so = _common.build()
    _common.load()
    secs = time.monotonic() - t0
    with open(so[:-3] + ".log") as f:
        ptxas = [ln.strip() for ln in f
                 if any(w in ln for w in ("Function properties", "registers",
                                          "spill", "== "))]
    log("build", {"seconds": secs, "library": so, "ptxas": ptxas})


# -- 3. kernels ---------------------------------------------------------------

def flash_phase(dev):
    """K1 at B in {1, 4}, H 8, D 64, T in {40, 128, 1024}, causal."""
    H, D = HEADS, DIM // HEADS
    rows, summary = [], None
    for dtype in DTYPES:
        for B in (1, 4):
            for T in (40, 128, 1024):
                g = torch.Generator(device=dev).manual_seed(SEED + T + B)
                q, k, v = (torch.randn(B, H, T, D, generator=g, device=dev)
                           .to(dtype) for _ in range(3))
                out = fa.flash_attention(q, k, v, causal=True)
                torch.cuda.synchronize()
                ref = fa.flash_attention_ref(q, k, v, causal=True)
                err = max_err(out, ref)
                itemsize = q.element_size()
                nbytes = 4 * B * H * T * D * itemsize
                flops = 2 * D * T * (T + 1) * B * H  # causal QK^T and PV
                b_ms, b_by, extra = flash_bound("flash_attention", nbytes,
                                                flops, dtype)
                row = {
                    "dtype": str(dtype).split(".")[1], "B": B, "H": H,
                    "T": T, "D": D,
                    "design": DESIGN[dtype]["flash_attention"], **extra,
                    "max_abs_err": err,
                    "kernel_ms": time_ms(
                        lambda: fa.flash_attention(q, k, v, causal=True)),
                    "plain_ms": time_ms(
                        lambda: fa.flash_attention_ref(q, k, v,
                                                       causal=True)),
                    "library_ms": time_ms(
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, is_causal=True)),
                    "bound_ms": b_ms, "bound_by": b_by}
                ratios(row)
                rows.append(row)
                log("flash_attention", row)
                if err > TOL[dtype]:
                    raise AssertionError(
                        f"flash_attention disagrees with its plain version:"
                        f" {row} (tolerance {TOL[dtype]})")
                if dtype == torch.float32 and B == 4 and T == 1024:
                    summary = row
    return rows, summary


def _poison_unseen(kp, vp, pt, cl, ps):
    """Set every pool slot no slot's context can see to 1e9."""
    keep = torch.zeros(kp.shape[0], ps, dtype=torch.bool)
    for n in range(pt.shape[0]):
        L = int(cl[n])
        for j in range(pages_needed(L, ps)):
            keep[int(pt[n, j]), :min(ps, L - j * ps)] = True
    mask = ~keep.to(kp.device)[:, None, :, None]
    return kp.masked_fill(mask, 1e9), vp.masked_fill(mask, 1e9)


# K2's timed cases: the engine's decode step (ragged, 1 to 1024), all 8
# slots at 1024, and one slot alone at 1024 (the case split-KV is for)
PAGED_CASES = {"decode": [1, 17, 1024, 300, 64, 999, 5, 512],
               "full_1024": [1024] * SLOTS,
               "one_1024": [1024]}
# a cold reading rotates each call over distinct pools, one per layer as
# the serve's kpool[i], at least this many and enough to touch COLD_BYTES
# a round: twice the H100's 50 MB L2
COLD_POOLS, COLD_BYTES = LAYERS, 100e6


def page_table(rng, lens, maxp):
    """Distinct random pages of the 513-page pool for each slot's first
    ceil(len / PAGE) entries, null past them (an all-null row for 0)."""
    pt = np.zeros((len(lens), maxp), np.int32)
    perm = iter(rng.permutation(np.arange(1, NUM_PAGES)))
    for n, L in enumerate(lens):
        for j in range(pages_needed(L, PAGE)):
            pt[n, j] = next(perm)
    return torch.from_numpy(pt)


def cold_pools(kp, vp, nbytes):
    """Copies of the pools for a cold reading: COLD_POOLS or more, enough
    that a round through them touches COLD_BYTES of K/V."""
    n = max(COLD_POOLS, -(-int(COLD_BYTES) // int(nbytes)))
    return [(kp.clone(), vp.clone()) for _ in range(n)]


def warm_cold_ms(call, kp, vp, kv_bytes):
    """(warm ms, cold ms, pools) of `call(kp, vp)`: warm, 100 calls on one
    pool (its pages stay in L2); cold, each call on the next of several
    pool copies (``cold_pools``), as a serve's layers each read their own
    pool while the weights pass through L2 between them."""
    warm = time_ms(lambda: call(kp, vp), iters=100)
    pools = cold_pools(kp, vp, kv_bytes)
    n = len(pools)
    cold = time_ms(lambda: [call(k, v) for k, v in pools],
                   iters=max(2, 200 // n)) / n
    del pools
    torch.cuda.empty_cache()
    return warm, cold, n


def paged_case(dev, dtype, ctx, seed=SEED + 1):
    """K2's inputs at the engine's decode shape for ctx_lens `ctx`: q, the
    513-page pools with every slot no context sees poisoned, the table and
    the lengths on the card, and the K/V bytes the call needs."""
    nh, dh = HEADS, DIM // HEADS
    maxp = pages_needed(MAX_LEN, PAGE)
    pt_t = page_table(np.random.RandomState(SEED), ctx, maxp)
    cl_t = torch.tensor(ctx, dtype=torch.int32)
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(len(ctx), nh, dh, generator=g, device=dev).to(dtype)
    kp, vp = (torch.randn(NUM_PAGES, nh, PAGE, dh, generator=g,
                          device=dev).to(dtype) for _ in range(2))
    kp, vp = _poison_unseen(kp, vp, pt_t, cl_t, PAGE)
    kv = sum(ctx) * nh * dh * 2 * q.element_size()
    return q, kp, vp, pt_t.to(dev), cl_t.to(dev), kv


def paged_phase(dev):
    """K2 at the engine's decode shape: nh 8, dh 64, ps 16, maxp 64, the
    engine's 513-page pool, unused slots poisoned; ragged ctx_lens with 1,
    partial pages and 1024 (the 8 slots of a decode step), all 8 slots at
    1024, and one slot alone at 1024; each timed warm and cold."""
    nh, dh = HEADS, DIM // HEADS
    maxp = pages_needed(MAX_LEN, PAGE)
    rows, summary = [], None
    for case, ctx in PAGED_CASES.items():
        N = len(ctx)
        for dtype in DTYPES:
            q, kp, vp, pt_d, cl_d, kv = paged_case(dev, dtype, ctx)
            out = pa.paged_attention(q, kp, vp, pt_d, cl_d)
            torch.cuda.synchronize()
            ref = pa.paged_attention_ref(q, kp, vp, pt_d, cl_d)
            err = max_err(out, ref)
            if not torch.isfinite(out.float()).all():
                raise AssertionError("paged_attention read a poisoned slot")
            itemsize = q.element_size()
            table = sum(pages_needed(L, PAGE) for L in ctx) * 4 + N * 4
            nbytes = kv + 2 * q.numel() * itemsize + table
            flops = 4 * sum(ctx) * nh * dh
            b_ms, b_by = bound(nbytes, flops, dtype)
            warm, cold, n_pools = warm_cold_ms(
                lambda k, v: pa.paged_attention(q, k, v, pt_d, cl_d), kp,
                vp, kv)
            row = {"case": case, "dtype": str(dtype).split(".")[1], "N": N,
                   "nh": nh, "dh": dh, "ps": PAGE, "maxp": maxp,
                   "pool_pages": NUM_PAGES, "ctx_lens": ctx,
                   "design": DESIGN[dtype]["paged_attention"],
                   "max_abs_err": err, "kernel_ms": warm,
                   "kernel_cold_ms": cold, "cold_pools": n_pools,
                   "plain_ms": time_ms(
                       lambda: pa.paged_attention_ref(q, kp, vp, pt_d,
                                                      cl_d)),
                   "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                   "bound_share": b_ms / warm,
                   "bound_share_cold": b_ms / cold}
            rows.append(row)
            log("paged_attention", row)
            if err > TOL[dtype]:
                raise AssertionError(
                    f"paged_attention disagrees with its plain version: "
                    f"{row} (tolerance {TOL[dtype]})")
            if dtype == torch.float32 and case == "decode":
                summary = row
            del q, kp, vp, out, ref
    return rows, summary


# -- 4. serve -----------------------------------------------------------------

def serve(lm, prompts, place, scheduler="fifo", priorities=None,
          first_alone=False, **kw):
    """Serve `prompts` on a fresh engine over the global scope's
    parameters.  With `first_alone`, request 0 is submitted and stepped
    once before the others arrive.  Checks that every request finished
    with max_new tokens and that no page leaked (the prefix index let go
    first); returns (tokens per request, requests, engine, wall
    seconds)."""
    eng = ServingEngine(lm, max_batch_size=SLOTS, page_size=PAGE,
                        place=place, scheduler=scheduler, **kw)
    pri = priorities or [0] * len(prompts)
    t0 = time.monotonic()
    rids = [eng.submit(prompts[0], MAX_NEW, arrival=t0, priority=pri[0])]
    if first_alone:
        eng.step()
    rids += [eng.submit(p, MAX_NEW, arrival=t0, priority=pr)
             for p, pr in zip(prompts[1:], pri[1:])]
    fin = eng.run()
    wall = time.monotonic() - t0
    if sorted(fin) != sorted(rids):
        raise AssertionError("not every request finished")
    if any(len(fin[r].generated) != MAX_NEW for r in rids):
        raise AssertionError("a request finished short of max_new")
    eng.cache.prefix.clear()
    if eng.cache.allocator.available() != eng.num_pages - 1:
        raise AssertionError(f"page leak: {eng.stats()['page_stats']}")
    return [fin[r].generated for r in rids], [fin[r] for r in rids], eng, wall


def counted(fn):
    """Run `fn` with every kernel's launch count set to 0 just before;
    returns (its result, the counts just after)."""
    for k in KERNELS.values():
        k.launches = 0
    out = fn()
    return out, {name: k.launches for name, k in KERNELS.items()}


def check_launches(path, launches, want):
    """`want` names the kernels the path runs; every other kernel must
    stay at 0."""
    want = {k: want.get(k, 0) for k in KERNELS}
    if launches != want:
        raise AssertionError(f"{path}: kernel launches {launches} != what "
                             f"the engine's counts imply {want}")
    used = [k for k, v in want.items() if v]
    if not used:
        raise AssertionError(f"{path}: no kernel launched")


def serve_row(scheduler, prompts, tokens, reqs, eng, wall, launches):
    """One serve's numbers: TTFT over the requests (all submitted at t0),
    prefill tokens per second of the runs that carry prefill (fifo:
    prefill runs; v2/spec: mixed runs, which also decode), decoded tokens
    per second of the runs that emit them, steps and launches."""
    st = eng.stats()
    ttft = sorted(r.first_token_t - r.arrival for r in reqs)
    decoded = sum(len(t) - 1 for t in tokens)
    if scheduler == "fifo":
        pre_s, dec_s = st["prefill_s"], st["decode_s"]
    else:
        pre_s = st["mixed_s"]
        dec_s = st["mixed_s"] + st["decode_s"] + st["draft_s"] \
            + st["verify_s"]
    return {"scheduler": scheduler, "requests": len(prompts),
            "prompt_tokens": sum(len(p) for p in prompts),
            "max_new": MAX_NEW, "wall_s": wall,
            "ttft_p50_ms": float(np.median(ttft)) * 1e3,
            "ttft_max_ms": ttft[-1] * 1e3,
            "prefill_tok_s": st["prefill_computed"] / pre_s,
            "decode_tok_s": decoded / dec_s,
            "output_tok_s": sum(len(t) for t in tokens) / wall,
            "steps": eng._steps,
            **{k: st[k] for k in (
                "prefill_runs", "decode_steps", "mixed_steps",
                "spec_rounds", "draft_runs", "prefill_computed",
                "prefill_cached", "cow_copies", "preemptions",
                "spec_drafted", "spec_accepted", "spec_emitted",
                "prefill_s", "decode_s", "mixed_s", "draft_s",
                "verify_s")},
            "launches": launches,
            "launches_per_request": {k: v / len(prompts)
                                     for k, v in launches.items()},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def serve_phase(dev, card_name, smi):
    t0 = time.monotonic()
    lm = gpt_bench.build(fluid.CUDAPlace(0), seed=SEED)
    torch.cuda.synchronize()
    startup_s = time.monotonic() - t0
    scope = fluid.global_scope()
    n_params = sum(scope.find(p.name).numel() for p in lm._params)
    if any(scope.find(p.name).device != dev for p in lm._params):
        raise AssertionError("startup left a parameter off the card")

    prompts = gpt_bench.prompts(N_REQ, seed=SEED)
    serve(lm, prompts, fluid.CUDAPlace(0))  # warm-up
    (tokens, reqs, eng, wall), launches = counted(
        lambda: serve(lm, prompts, fluid.CUDAPlace(0)))
    st = eng.stats()
    check_launches("fifo", launches, {
        "flash_attention": LAYERS * st["prefill_runs"],
        "paged_attention": LAYERS * st["decode_steps"],
        "paged_attention_mq": 0})
    buckets = sorted(eng._prefill_progs)
    if not {256, 512, 1024} <= set(buckets):
        raise AssertionError(f"prefill buckets {buckets} miss 256/512/1024")
    row = serve_row("fifo", prompts, tokens, reqs, eng, wall, launches)
    log("serve", {"card": card_name, "nvidia_smi": smi, "params": n_params,
                  "startup_s": startup_s,
                  "prompt_lens": [len(p) for p in prompts],
                  "prefill_buckets": buckets, **row})
    arrays = [scope.find_np(p.name) for p in lm._params]
    return lm, prompts, tokens, arrays, row


# -- 5. the same weights on the CPU -------------------------------------------

def cpu_scope(lm, arrays):
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        lm.load_params(arrays, scope)
    return scope


def cpu_top2_gap(lm, scope, seq):
    """Gap between the CPU model's two largest next-token logits after
    `seq`, from a full-prefix forward through the port's layer code and
    the plain attention."""
    with fluid.program_guard(fluid.Program()):
        slots = lm._decode_inputs(
            fluid.layers.data("gap.tok", shape=[1], dtype="int64"))
    ins = {s: [scope.find(n) for n in names]
           for s, names in slots.items() if s != "Tokens"}
    fns = _lm_fns(ins, HEADS, 1e-5)
    tok = torch.tensor([seq], dtype=torch.int64)
    scale = 1.0 / fns.dh ** 0.5
    with torch.no_grad():
        x = ins["Emb"][0][tok] + fns.pos[:len(seq)]
        for i in range(fns.L):
            x = fns.block(i, x, lambda i, q, k, v: fa.flash_attention_ref(
                q, k, v, causal=True, scale=scale))
        top = fns.head_logits(x)[0].topk(2).values
    return (top[0] - top[1]).item()


def agree(tag, lm, gap_scope, prompts, want, got, **extra):
    """Hold `got` to `want`: identical, except at most one request that
    parts where the CPU model's top-2 logits are within 1e-3."""
    parted = []
    for i, (a, b) in enumerate(zip(want, got)):
        if a == b:
            continue
        j = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        gap = cpu_top2_gap(lm, gap_scope, prompts[i] + a[:j])
        parted.append({"request": i, "position": j, "want": a[j],
                       "got": b[j], "cpu_top2_gap": gap})
    res = {"identical": len(want) - len(parted), "of": len(want),
           "parted": parted, **extra}
    log(tag, res)
    if len(parted) > 1 or any(p["cpu_top2_gap"] > 1e-3 for p in parted):
        raise AssertionError(f"{tag}: tokens disagree: {parted}")
    return res


def cpu_phase(lm, prompts, gpu_tokens, scope):
    t0 = time.monotonic()
    with fluid.scope_guard(scope):
        cpu_tokens, _, _, _ = serve(lm, prompts, fluid.CPUPlace())
    agree("cpu_agreement", lm, scope, prompts, cpu_tokens, gpu_tokens,
          cpu_s=time.monotonic() - t0)


# -- 6. kernel K3 -------------------------------------------------------------

def mq_phase(dev):
    """K3 at the mixed step's shape (N 4 chunk lanes, C 32) and the spec
    verify's (N 8, C 5): nh 8, dh 64, ps 16, maxp 64, the 513-page pool.
    Each lane is (q_start, valid rows); ctx_lens = max(q_start + rows, 1),
    as the chunk op passes them."""
    nh, dh = HEADS, DIM // HEADS
    maxp = pages_needed(MAX_LEN, PAGE)
    shapes = {
        # rows past the chunk at the end of a system prompt, a mid-page
        # start whose chunk crosses a page, an idle lane, a lane near 1024
        "mixed": (32, [(576, 20), (200, 32), (0, 0), (990, 32)]),
        # verify rows k+1 = 5 (fewer where the window shrank), a chunk
        # crossing a page, a lane near 1024, an idle lane
        "verify": (5, [(1, 5), (14, 5), (1019, 5), (300, 3), (64, 5),
                       (999, 1), (5, 2), (0, 0)]),
    }
    rng = np.random.RandomState(SEED + 2)
    rows, summary = [], {}
    for shape, (C, lanes) in shapes.items():
        N = len(lanes)
        q0 = [s for s, _ in lanes]
        ctx = [max(s + n, 1) for s, n in lanes]
        # an idle lane keeps its all-null table row
        pt_t = page_table(rng, [L if n else 0 for L, (_, n) in
                                zip(ctx, lanes)], maxp)
        cl_t = torch.tensor(ctx, dtype=torch.int32)
        for dtype in DTYPES:
            g = torch.Generator(device=dev).manual_seed(SEED + 3)
            q = torch.randn(N, nh, C, dh, generator=g, device=dev).to(dtype)
            kp, vp = (torch.randn(NUM_PAGES, nh, PAGE, dh, generator=g,
                                  device=dev).to(dtype) for _ in range(2))
            kp, vp = _poison_unseen(kp, vp, pt_t, cl_t, PAGE)
            pt_d, cl_d = pt_t.to(dev), cl_t.to(dev)
            q0_d = torch.tensor(q0, dtype=torch.int32, device=dev)
            args = (q, kp, vp, pt_d, cl_d, q0_d)
            out = pa.paged_attention_mq(*args)
            torch.cuda.synchronize()
            ref = pa.paged_attention_mq_ref(*args)
            err = max_err(out, ref)
            if not torch.isfinite(out.float()).all():
                raise AssertionError("paged_attention_mq read a poisoned "
                                     "slot or left a row unnormalized")
            itemsize = q.element_size()
            # keys some row needs: below min(ctx, q_start + C); each
            # (row, key) pair visible to the row is 4*dh FLOPs per head
            needed = [min(L, s + C) for L, s in zip(ctx, q0)]
            kv = sum(needed) * nh * dh * 2 * itemsize
            table = sum(pages_needed(k, PAGE) for k in needed) * 4 + N * 8
            nbytes = kv + 2 * q.numel() * itemsize + table
            pairs = sum(min(s + c + 1, L) for L, s in zip(ctx, q0)
                        for c in range(C))
            flops = 4 * dh * nh * pairs
            b_ms, b_by, extra = flash_bound("paged_attention_mq", nbytes,
                                            flops, dtype)
            warm, cold, n_pools = warm_cold_ms(
                lambda k, v: pa.paged_attention_mq(q, k, v, *args[3:]), kp,
                vp, kv)
            row = {"shape": shape, "dtype": str(dtype).split(".")[1],
                   "N": N, "nh": nh, "C": C, "dh": dh, "ps": PAGE,
                   "maxp": maxp, "pool_pages": NUM_PAGES,
                   "q_starts": q0, "ctx_lens": ctx,
                   "design": DESIGN[dtype]["paged_attention_mq"], **extra,
                   "max_abs_err": err, "kernel_ms": warm,
                   "kernel_cold_ms": cold, "cold_pools": n_pools,
                   "plain_ms": time_ms(
                       lambda: pa.paged_attention_mq_ref(*args)),
                   "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                   "bound_share": b_ms / warm,
                   "bound_share_cold": b_ms / cold}
            rows.append(row)
            log("paged_attention_mq", row)
            if err > TOL[dtype]:
                raise AssertionError(
                    f"paged_attention_mq disagrees with its plain version: "
                    f"{row} (tolerance {TOL[dtype]})")
            if dtype == torch.float32:
                summary[shape] = row
    return rows, summary


# -- 7. v2 serve --------------------------------------------------------------

V2 = dict(scheduler="v2", chunk_size=CHUNK, chunk_lanes=LANES)


def v2_want(st):
    return {"flash_attention": 0,
            "paged_attention": LAYERS * (st["mixed_steps"]
                                         + st["decode_steps"]),
            "paged_attention_mq": LAYERS * st["mixed_steps"]}


def v2_phase(lm, prompts, fifo_tokens, scope_cpu):
    card = fluid.CUDAPlace(0)
    serve(lm, prompts, card, **V2)  # warm-up
    (tokens, reqs, eng, wall), launches = counted(
        lambda: serve(lm, prompts, card, **V2))
    check_launches("v2", launches, v2_want(eng.stats()))
    row = serve_row("v2", prompts, tokens, reqs, eng, wall, launches)
    row["watermark_pages"] = eng.scheduler.watermark_pages
    log("serve_v2", row)
    agree("v2_vs_fifo", lm, scope_cpu, prompts, fifo_tokens, tokens)

    # prefix-heavy traffic: hits and copy-on-write, against the CPU
    pprompts = gpt_bench.prefix_prompts(N_REQ, seed=SEED)
    (ptok, preqs, peng, pwall), plaunch = counted(
        lambda: serve(lm, pprompts, card, **V2))
    pst = peng.stats()
    check_launches("v2_prefix", plaunch, v2_want(pst))
    if not (pst["prefill_cached"] > 0 and pst["cow_copies"] > 0):
        raise AssertionError(f"prefix set: no prefix hit or no COW copy: "
                             f"{pst}")
    prow = serve_row("v2", pprompts, ptok, preqs, peng, pwall, plaunch)
    log("serve_v2_prefix", prow)
    t0 = time.monotonic()
    with fluid.scope_guard(scope_cpu):
        cpu_tok, _, ceng, _ = serve(lm, pprompts, fluid.CPUPlace(), **V2)
    agree("v2_prefix_vs_cpu", lm, scope_cpu, pprompts, cpu_tok, ptok,
          cpu_s=time.monotonic() - t0,
          cpu_prefill_cached=ceng.stats()["prefill_cached"])

    # preemption: a low-priority request, then a high-priority burst into
    # a pool of 64 pages; the same arrivals in the roomy pool
    burst = [prompts[0][:300]] + [p[:200] for p in prompts[1:8]]
    pri = [0] + [1] * 7
    (ttok, _, teng, _), tlaunch = counted(lambda: serve(
        lm, burst, card, priorities=pri, first_alone=True, num_pages=64,
        **V2))
    check_launches("v2_tight", tlaunch, v2_want(teng.stats()))
    if teng.stats()["preemptions"] < 1:
        raise AssertionError("the tight pool preempted nothing")
    rtok, _, _, _ = serve(lm, burst, card, priorities=pri, first_alone=True,
                          **V2)
    agree("v2_preempt_vs_roomy", lm, scope_cpu, burst, rtok, ttok,
          preemptions=teng.stats()["preemptions"],
          watermark_pages=teng.scheduler.watermark_pages)
    return row, prow, launches


# -- 8. spec serve ------------------------------------------------------------

def spec_phase(lm, prompts):
    card = fluid.CUDAPlace(0)
    scope = fluid.global_scope()
    gpt_bench.damp_tail_layers(lm, scope, DRAFT_LAYERS, scale=0.01)
    damped_cpu = cpu_scope(lm, [scope.find_np(p.name) for p in lm._params])
    v2_tok, _, _, _ = serve(lm, prompts, card, **V2)
    spec = dict(V2, scheduler="spec", spec_k=SPEC_K,
                spec_draft_layers=DRAFT_LAYERS)
    serve(lm, prompts, card, **spec)  # warm-up
    (tokens, reqs, eng, wall), launches = counted(
        lambda: serve(lm, prompts, card, **spec))
    st = eng.stats()
    check_launches("spec", launches, {
        "flash_attention": 0,
        "paged_attention": LAYERS * (st["mixed_steps"] + st["decode_steps"])
        + DRAFT_LAYERS * SPEC_K * st["draft_runs"],
        "paged_attention_mq": LAYERS * (st["mixed_steps"]
                                        + st["spec_rounds"])})
    if st["spec_accepted"] < 1:
        raise AssertionError(f"spec accepted no draft: {st}")
    row = serve_row("spec", prompts, tokens, reqs, eng, wall, launches)
    row["accept_rate_damped_random_model"] = (st["spec_accepted"]
                                              / max(st["spec_drafted"], 1))
    log("serve_spec", row)
    agree("spec_vs_v2_damped", lm, damped_cpu, prompts, v2_tok, tokens)
    return row, launches


# -- 10. kernels K4-K6 --------------------------------------------------------

TRAIN_SHAPES = [  # (B, H, T, D, causal, timed)
    (TRAIN_BS, HEADS, TRAIN_SEQ, DIM // HEADS, True, True),
    (2, 4, 1000, 64, True, False),
    (2, 4, 1000, 64, False, False),
    (2, 4, 512, 128, True, False),
    (1, 1, 37, 40, True, False),     # one short ragged tile, D padded to 64
    (64, 16, 128, 64, True, False),  # B*H = 1024 blocks along grid.y
    (1, 2, 77, 38, True, False),     # d % 4 != 0: staged element by element
]


def rel_err(got, ref):
    ref = ref.double()
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()


def train_kernel_phase(dev):
    """K4 (out, lse), K5 (dq) and K6 (dk, dv) against their plain
    versions; the plain backward takes the plain forward's out and lse,
    so each kernel sees the same inputs as its plain version."""
    rows = {"flash_attention_fwd": [], "flash_attention_dq": [],
            "flash_attention_dkv": []}
    summary = {}
    for dtype in DTYPES:
        for B, H, T, D, causal, timed in TRAIN_SHAPES:
            g = torch.Generator(device=dev).manual_seed(SEED + T + D)
            q, k, v, do = (torch.randn(B, H, T, D, generator=g, device=dev)
                           .to(dtype) for _ in range(4))
            out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
            torch.cuda.synchronize()
            r_out, r_lse = fa.flash_attention_fwd_ref(q, k, v, causal=causal)
            delta = (r_out.float() * do.float()).sum(-1).reshape(B * H, T)
            bwd = (q, k, v, do, r_lse, delta)
            dq = fa.flash_attention_dq(*bwd, causal=causal)
            dk, dv = fa.flash_attention_dkv(*bwd, causal=causal)
            torch.cuda.synchronize()
            r_dq = fa.flash_attention_dq_ref(*bwd, causal=causal)
            r_dk, r_dv = fa.flash_attention_dkv_ref(*bwd, causal=causal)
            shape = {"dtype": str(dtype).split(".")[1], "B": B, "H": H,
                     "T": T, "D": D, "causal": causal}
            itemsize = q.element_size()
            tensor_bytes = B * H * T * D * itemsize
            row_bytes = B * H * T * 4
            pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
            checks = {
                "flash_attention_fwd": (
                    {"max_abs_err": max_err(out, r_out),
                     "lse_max_abs_err": max_err(lse, r_lse)},
                    4 * tensor_bytes + row_bytes, 4 * D * pairs),
                "flash_attention_dq": (
                    {"max_abs_err": max_err(dq, r_dq),
                     "max_rel_err": rel_err(dq, r_dq)},
                    5 * tensor_bytes + 2 * row_bytes, 6 * D * pairs),
                "flash_attention_dkv": (
                    {"max_abs_err": max(max_err(dk, r_dk),
                                        max_err(dv, r_dv)),
                     "max_rel_err": max(rel_err(dk, r_dk),
                                        rel_err(dv, r_dv))},
                    6 * tensor_bytes + 2 * row_bytes, 8 * D * pairs),
            }
            for name, (errs, nbytes, flops) in checks.items():
                b_ms, b_by, extra = flash_bound(name, nbytes, flops, dtype)
                rows[name].append({**shape, "design": DESIGN[dtype][name],
                                   **extra, **errs, "bound_ms": b_ms,
                                   "bound_by": b_by})
            if timed:
                timed_rows(q, k, v, do, bwd, causal, rows)
                for name in rows:
                    ratios(rows[name][-1])
            for name in rows:
                log(name, rows[name][-1])
            fwd = rows["flash_attention_fwd"][-1]
            worst = max(rows["flash_attention_dq"][-1]["max_rel_err"],
                        rows["flash_attention_dkv"][-1]["max_rel_err"])
            if (fwd["max_abs_err"] > TOL[dtype]
                    or fwd["lse_max_abs_err"] > 1e-4 or worst > TOL[dtype]):
                raise AssertionError(
                    f"a training kernel disagrees with its plain version at "
                    f"{shape}: out/lse {fwd}, grads {worst} (tolerance "
                    f"{TOL[dtype]}: out absolute, grads relative to max "
                    f"|g|; lse 1e-4)")
            if timed and dtype == torch.bfloat16:
                summary = {n: rows[n][-1] for n in rows}
    return rows, summary


def timed_rows(q, k, v, do, bwd, causal, rows):
    """Kernel, plain and library times at the bench shape, added to the
    last row of each kernel."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        lib_out, leaves, do, retain_graph=True), iters=10)
    times = {
        "flash_attention_fwd": (
            lambda: fa.flash_attention_fwd(q, k, v, causal=causal),
            lambda: fa.flash_attention_fwd_ref(q, k, v, causal=causal),
            time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal))),
        "flash_attention_dq": (
            lambda: fa.flash_attention_dq(*bwd, causal=causal),
            lambda: fa.flash_attention_dq_ref(*bwd, causal=causal),
            lib_bwd),
        "flash_attention_dkv": (
            lambda: fa.flash_attention_dkv(*bwd, causal=causal),
            lambda: fa.flash_attention_dkv_ref(*bwd, causal=causal),
            lib_bwd),
    }
    for name, (kern, plain, lib) in times.items():
        rows[name][-1].update({"kernel_ms": time_ms(kern),
                               "plain_ms": time_ms(plain, iters=5),
                               "library_ms": lib})


# -- 11. training parity, f32 --------------------------------------------------

PARITY_BS, PARITY_SEQ = 2, 256
TRAIN_KERNELS = ("flash_attention", "flash_attention_fwd",
                 "flash_attention_dq", "flash_attention_dkv")


def train_program(seq, dtype):
    """The full-width GPT training program (bench.py's config at dim 512:
    8 heads) in fresh default programs and scope; returns (loss, main,
    startup)."""
    fluid.reset()
    loss = transformer.build_lm_train_program(
        seq_len=seq, vocab_size=VOCAB, dim=DIM, n_layers=LAYERS,
        n_heads=HEADS, dtype=dtype, learning_rate=3e-4)
    startup = fluid.default_startup_program()
    startup.random_seed = SEED
    return loss, fluid.default_main_program(), startup


def train_batch(bs, seq, seed=0):
    """bench.py's batch: tokens from RandomState(seed) (bench.py: 0),
    targets shifted."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, VOCAB, (bs, seq, 1)).astype(np.int64)
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}


def per_step_want():
    return {"flash_attention_fwd": 2 * LAYERS, "flash_attention_dq": LAYERS,
            "flash_attention_dkv": LAYERS}


def run_steps(exe, main, loss, feed, n, fetch=(), scope=None):
    """`n` training steps; per step (loss, the fetched grads (step 1
    only), the kernels' launches in that step, host seconds to the fetched
    loss).  The counts are read as differences: nothing is reset here."""
    out = []
    for step in range(n):
        names = list(fetch) if step == 0 else []
        before = {k: f.launches for k, f in KERNELS.items()}
        t0 = time.monotonic()
        vals = exe.run(main, feed=feed, fetch_list=[loss] + names,
                       scope=scope)
        secs = time.monotonic() - t0
        out.append((float(vals[0][0]), dict(zip(names, vals[1:])),
                    {k: f.launches - before[k] for k, f in KERNELS.items()},
                    secs))
    return out


def parity_run(tag, main, startup, loss, feed, grads, want, shape,
               state_names=(), state_step=3, loss_tol=(1e-4,) * 3,
               grad_tol=None):
    """Three steps of `main` on the card and three on an explicit CPU
    executor from the same numpy state (the card's startup values): each
    step's loss within `loss_tol` relative (1e-4), the step-1 `grads`
    within `grad_tol` of their max |g| (1e-3 each unless the dict says
    otherwise), the persistable `state_names` after step `state_step`
    within 1e-3 of their max |value|, and in every step exactly the
    launches `want`."""
    grad_tol = {n: (grad_tol or {}).get(n, 1e-3) for n in grads}
    card = fluid.Executor(fluid.CUDAPlace(0))
    card.run(startup)
    scope = fluid.global_scope()
    state = {n: scope.find_np(n) for n, v in main.global_block().vars.items()
             if v.persistable}

    def steps(exe, sc):
        first = run_steps(exe, main, loss, feed, state_step, grads, scope=sc)
        snap = {n: (sc or fluid.global_scope()).find_np(n)
                for n in state_names}
        return first + run_steps(exe, main, loss, feed, 3 - state_step,
                                 scope=sc), snap

    gpu, gpu_state = steps(card, None)
    for _, _, launches, _ in gpu:
        check_launches(tag, launches, want)
    t0 = time.monotonic()
    cpu_scope = fluid.Scope()
    fluid.load_persistables(main, state, cpu_scope)
    cpu, cpu_state = steps(fluid.Executor(fluid.CPUPlace()), cpu_scope)
    cpu_s = time.monotonic() - t0
    loss_rel = [abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(gpu, cpu)]
    grad_rel = {n: float(np.abs(gpu[0][1][n] - cpu[0][1][n]).max()
                         / np.abs(cpu[0][1][n]).max()) for n in grads}
    state_rel = {n: float(np.abs(gpu_state[n] - cpu_state[n]).max()
                          / max(np.abs(cpu_state[n]).max(), 1e-12))
                 for n in state_names}
    res = {**shape, "dtype": "float32",
           "gpu_losses": [r[0] for r in gpu],
           "cpu_losses": [r[0] for r in cpu], "loss_rel_err": loss_rel,
           "loss_tol": list(loss_tol),
           "grad_rel_err_step1": grad_rel, "grad_tol": grad_tol,
           "state_rel_err_max": max(state_rel.values(), default=0.0),
           "state_after_step": state_step,
           "launches_per_step": gpu[-1][2],
           "gpu_step_s": [r[3] for r in gpu], "cpu_s": cpu_s}
    log(tag, res)
    if (any(e > t for e, t in zip(loss_rel, loss_tol))
            or any(grad_rel[n] > grad_tol[n] for n in grads)
            or res["state_rel_err_max"] > 1e-3):
        worst = sorted(state_rel.items(), key=lambda kv: -kv[1])[:3]
        raise AssertionError(f"{tag}: card and CPU training disagree: {res} "
                             f"worst state {worst} (state 1e-3 of max "
                             f"|value|)")
    return res


def train_parity_phase():
    loss, main, startup = train_program(PARITY_SEQ, "float32")
    params = [p.name for p in main.global_block().all_parameters()]
    # the embedding, the first layer's WQ, the head
    grads = [n + "@GRAD" for n in (params[0], params[4], params[-1])]
    return parity_run("train_parity", main, startup, loss,
                      train_batch(PARITY_BS, PARITY_SEQ), grads,
                      per_step_want(), {"bs": PARITY_BS, "seq": PARITY_SEQ})


# -- 12. bf16 training at the bench shape -------------------------------------

def train_bench_phase(card_name, smi):
    t0 = time.monotonic()
    loss, main, startup = train_program(TRAIN_SEQ, "bfloat16")
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup)
    torch.cuda.synchronize()
    startup_s = time.monotonic() - t0
    feed = train_batch(TRAIN_BS, TRAIN_SEQ)
    warm = run_steps(exe, main, loss, feed, 2)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    steps, launches = counted(lambda: run_steps(exe, main, loss, feed, 10))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    want = {k: 10 * v for k, v in per_step_want().items()}
    check_launches("train_bf16", launches, want)
    losses = [r[0] for r in warm + steps]
    step_ms = wall / len(steps) * 1e3
    res = {"card": card_name, "nvidia_smi": smi, "bs": TRAIN_BS,
           "seq": TRAIN_SEQ, "dtype": "bfloat16", "lr": 3e-4,
           "params": sum(int(np.prod(p.shape)) for p in
                         main.global_block().all_parameters()),
           "startup_s": startup_s, "losses": losses,
           "step_ms": step_ms,
           "step_ms_each": [r[3] * 1e3 for r in steps],
           "tok_s": TRAIN_BS * TRAIN_SEQ / (step_ms / 1e3),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches,
           "launches_per_step": {k: v / len(steps)
                                 for k, v in launches.items()}}
    log("train_bench", res)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"bf16 training: losses {losses} are not "
                             f"finite or did not fall")
    return res


# -- 13. kernels K7-K10 -------------------------------------------------------

# (B, T, H, lengths or "full"/"ragged", timed)
RNN_AWKWARD = [(5, 7, 96, "ragged", False), (1, 9, 96, [6], False),
               (3, 5, 20, [5, 0, 3], False)]
LSTM_SHAPES = [
    (rnn_bench.LSTM_BS, rnn_bench.LSTM_SEQ, rnn_bench.LSTM_HIDDEN, "full",
     True),
    (rnn_bench.LSTM_BS, rnn_bench.LSTM_SEQ, rnn_bench.LSTM_HIDDEN, "ragged",
     False),
    *RNN_AWKWARD,
    # 10 batch groups x 32 column slices, more blocks than an H100 holds at
    # once: the persistent grid runs the groups a few at a time
    (160, 6, 512, "ragged", False),
    # widths whose W slice does not fit in a block's shared memory on an
    # H100 (lstm.route): H 528 the f32 backward (the f32 forward and bf16
    # fit), H 1152 both directions in both dtypes take the step route
    (4, 5, 528, "ragged", False),
    (4, 5, 1152, "ragged", False),
]
GRU_SHAPES = [(rnn_bench.NMT_BS, rnn_bench.NMT_SEQ, rnn_bench.NMT_DIM, ln, tm)
              for _, _, _, ln, tm in LSTM_SHAPES[:2]] + RNN_AWKWARD + [
    # 10 batch groups x 32 column slices, more blocks than an H100 holds at
    # once: the persistent grid runs the groups a few at a time
    (160, 6, 512, "ragged", False)]
# and at run time the widths whose W slice does not fit in a block's shared
# memory on the card (gru.steps_widths)
NO_LIBRARY = ("null: no single PyTorch call computes it (cuDNN's LSTM takes "
              "the input product in and no per-step mask; PyTorch's GRU "
              "applies the reset gate after the candidate product)")


# each recurrent cell's kernels as its module's ``KERNELS`` names them, by
# direction: each route's time-loop kernels, and the backward's dW kernels,
# launched after either loop (the LSTM's bf16 persistent route has its own)
RNN_KERNELS = {
    "lstm": {False: ({"persistent": ("lstm_fwd_persistent",),
                      "steps": ("lstm_fwd_step",)}, ()),
             True: ({"persistent": ("lstm_bwd_persistent",),
                     "steps": ("lstm_bwd_gates", "lstm_bwd_dh")},
                    ("lstm_dw_mma", "rnn_dw_kernel"))},
    "gru": {False: ({"persistent": ("gru_fwd_persistent",),
                     "steps": ("gru_gates", "gru_fwd_cand")}, ()),
            True: ({"persistent": ("gru_bwd_persistent",),
                    "steps": ("gru_gates", "gru_bwd_cand", "gru_bwd_drh",
                              "gru_bwd_dh")},
                   ("rnn_dw_kernel",))}}


def rnn_launches(kind, route, T):
    """(forward, backward) device launches of one call: K7 1 or T, K8 the
    loop and dW, 2 or 2T + 1; K9 1 or 2T, K10 the loop and dW's two, 3 or
    4T + 2."""
    if kind == "lstm":
        return (1, 2) if route == "persistent" else (T, 2 * T + 1)
    return (1, 3) if route == "persistent" else (2 * T, 4 * T + 2)


def kernels_launched(mod, dev, fn):
    """(fn's result, {kernel name: launches}) of one call of `fn`: the
    device launches of the cell's kernels that the kernel library counted
    during the call, where it launched each (``mod.device_launches``,
    `mod` the ``lstm`` or ``gru`` kernel module)."""
    before = mod.device_launches(dev)
    out = fn()
    after = mod.device_launches(dev)
    return out, {k: n - before[k] for k, n in after.items() if n > before[k]}


def rnn_body(kind, counts, backward):
    """(route, device launches) of one call of the `kind` ("lstm" or
    "gru") kernel of that direction, read from `counts`, {kernel name:
    launches} of the kernels it launched (``kernels_launched``; a name may
    be the profiler's, which holds the kernel's own): the route whose loop
    kernels ran, and the launches of those and of the dW kernels.  Raises
    unless exactly one route's loop kernels ran."""
    loops, dw = RNN_KERNELS[kind][backward]

    def launched(names):
        return sum(c for name, c in counts.items()
                   if any(k in name for k in names))

    n = {body: launched(names) for body, names in loops.items()}
    ran = [body for body, c in n.items() if c]
    if len(ran) != 1:
        raise AssertionError(f"a {kind} {'backward' if backward else 'forward'}"
                             f" call ran the loop kernels of "
                             f"{ran or 'no route'}: {counts}")
    return ran[0], n[ran[0]] + launched(dw)


def rnn_case(dev, dtype, gates, B, T, H, lengths):
    g = torch.Generator(device=dev).manual_seed(SEED + B + T + H)
    rng = np.random.RandomState(SEED + B + T)
    if lengths == "full":
        lengths = [T] * B
    elif lengths == "ragged":
        lengths = rng.randint(1, T + 1, (B,)).tolist()

    def f(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev)
                * scale).to(dtype)

    return {"x": f(B, T, gates * H, scale=0.3), "h0": f(B, H, scale=0.2),
            "c0": f(B, H, scale=0.2), "w": f(H, gates * H, scale=0.05),
            "lengths": torch.tensor(lengths, dtype=torch.int32, device=dev),
            "dhs": f(B, T, H), "dcs": f(B, T, H), "steps": sum(lengths)}


def rnn_bound(gates, a, B, T, H, backward, dtype):
    """The card's bound for one call: each input read once and each output
    written once, and 2*gates*H^2 flops per valid (row, step) forward,
    three times that backward (recompute, dg W^T, dW).  It ignores that
    the T steps depend on each other."""
    size = a["x"].element_size()
    n_states = 2 if gates == 4 else 1  # (h, c) or h
    big, seq, st = B * T * gates * H, B * T * H, B * H
    if backward:
        # x, saved states, their cotangents, dx; w, dw; h0/c0 and dh0/dc0
        elems = 2 * big + 2 * n_states * seq + 2 * gates * H * H \
            + 2 * n_states * st
    else:
        # x, the states out; w; h0/c0 and hT/cT
        elems = big + n_states * seq + gates * H * H + 2 * n_states * st
    flops = 2 * gates * H * H * a["steps"] * (3 if backward else 1)
    return bound(elems * size + B * 4, flops, dtype)


def recurrent_kernel_phase(dev):
    """K7/K8 (LSTM) and K9/K10 (GRU) against their plain versions; the
    plain backward takes the plain forward's saved states, so each kernel
    sees the same inputs as its plain version."""
    rows = {k: [] for k in ("lstm_forward", "lstm_backward", "gru_forward",
                            "gru_backward")}
    gru_shapes = GRU_SHAPES + [(4, 5, H, "ragged", False)
                               for H in gru_k.steps_widths(dev)]
    for kind, gates, shapes in (("lstm", 4, LSTM_SHAPES),
                                ("gru", 3, gru_shapes)):
        mod = lstm_k if kind == "lstm" else gru_k
        fwd, bwd = (getattr(mod, f"{kind}_{d}") for d in ("forward",
                                                          "backward"))
        fwd_ref, bwd_ref = (getattr(mod, f"{kind}_{d}_ref")
                            for d in ("forward", "backward"))
        for dtype in DTYPES:
            for B, T, H, lengths, timed in shapes:
                a = rnn_case(dev, dtype, gates, B, T, H, lengths)
                if kind == "lstm":
                    ins = (a["x"], a["h0"], a["c0"], a["w"], a["lengths"])
                    cts = (a["dhs"], a["dcs"])
                else:
                    ins = (a["x"], a["h0"], a["w"], a["lengths"])
                    cts = (a["dhs"],)
                got, k_f = kernels_launched(mod, dev, lambda: fwd(*ins))
                ref = fwd_ref(*ins)
                saved = ref[:len(cts)]  # (hs, cs) or (hs,)
                grads, k_b = kernels_launched(
                    mod, dev, lambda: bwd(*ins, *saved, *cts))
                ref_g = bwd_ref(*ins, *saved, *cts)
                shape = {"dtype": str(dtype).split(".")[1], "B": B, "T": T,
                         "H": H, "valid_steps": a["steps"],
                         "lengths": lengths if isinstance(lengths, str)
                         else "given"}
                f_row = {**shape, "max_abs_err": max(
                    max_err(g, r) for g, r in zip(got, ref))}
                b_row = {**shape,
                         "max_abs_err": max(max_err(g, r)
                                            for g, r in zip(grads, ref_g)),
                         "max_rel_err": max(rel_err(g, r)
                                            for g, r in zip(grads, ref_g))}
                for row, back in ((f_row, False), (b_row, True)):
                    row["bound_ms"], row["bound_by"] = rnn_bound(
                        gates, a, B, T, H, back, dtype)
                    row["bound_ignores"] = "the dependence between steps"
                    row["library_ms"] = None
                # the route and device launches the library counted; the
                # route must be the one the module's route names before the
                # launch, with its launches (rnn_launches)
                for row, back, counts in ((f_row, False, k_f),
                                          (b_row, True, k_b)):
                    body, n = rnn_body(kind, counts, back)
                    want = mod.route(a["x"], backward=back)
                    want_n = rnn_launches(kind, want, T)[back]
                    row.update({"route": body, "device_launches": n})
                    if (body, n) != (want, want_n):
                        raise AssertionError(
                            f"{kind} {'backward' if back else 'forward'}"
                            f" at {shape}: ran {body} in {n} launches, "
                            f"{kind}.route chose {want} ({want_n})")
                n_f, n_b = f_row["device_launches"], b_row["device_launches"]
                if timed:
                    # the plain versions are Python loops of about a dozen
                    # small kernels a step, timed at the rate the host
                    # issues them
                    f_row.update({
                        "kernel_ms": time_ms(lambda: fwd(*ins),
                                             iters=max(2, 400 // n_f)),
                        "plain_ms": time_ms(lambda: fwd_ref(*ins), iters=3,
                                            ahead=False),
                        "plain_ms_includes": "the host's launch rate"})
                    b_row.update({
                        "kernel_ms": time_ms(
                            lambda: bwd(*ins, *saved, *cts),
                            iters=max(2, 400 // n_b)),
                        "plain_ms": time_ms(
                            lambda: bwd_ref(*ins, *saved, *cts), iters=3,
                            ahead=False),
                        "plain_ms_includes": "the host's launch rate"})
                rows[f"{kind}_forward"].append(f_row)
                rows[f"{kind}_backward"].append(b_row)
                log(f"{kind}_forward", f_row)
                log(f"{kind}_backward", b_row)
                if (f_row["max_abs_err"] > TOL[dtype]
                        or b_row["max_rel_err"] > TOL[dtype]):
                    raise AssertionError(
                        f"a {kind} kernel disagrees with its plain version "
                        f"at {shape}: forward {f_row['max_abs_err']}, "
                        f"gradients {b_row['max_rel_err']} (tolerance "
                        f"{TOL[dtype]}: states absolute, gradients relative "
                        f"to max |g|)")
    # both bodies of each kernel, as the library counted their launches,
    # are held to the plain versions
    for name, taken in rows.items():
        taken = {r["route"] for r in taken}
        if taken != {"persistent", "steps"}:
            raise AssertionError(f"{name}: its shapes took the routes "
                                 f"{sorted(taken)}, not both")
    return rows


def timed_row(rows, dtype):
    """The row of this dtype timed beside its plain version."""
    name = str(dtype).split(".")[1]
    return next(r for r in rows if "plain_ms" in r and r["dtype"] == name)


# -- 14-17. the recurrent training paths --------------------------------------

LSTM_PARITY_BS, LSTM_PARITY_SEQ = 16, 32
NMT_PARITY_BS, NMT_PARITY_SEQ = 8, 16
LSTM_WANT = {"lstm_forward": 2 * rnn_bench.LSTM_LAYERS,
             "lstm_backward": rnn_bench.LSTM_LAYERS}
# the encoder's two directions
NMT_WANT = {"gru_forward": 4, "gru_backward": 2}


def rnn_program(which, seq, dtype="float32", train=True):
    """One of the two recurrent programs at full width in fresh default
    programs and scope; returns (loss, main, startup)."""
    fluid.reset()
    if which == "lstm":
        loss = rnn_bench.lstm_train_program(seq_len=seq, dtype=dtype,
                                            train=train)
    else:
        loss = rnn_bench.nmt_train_program(seq_len=seq)
    startup = fluid.default_startup_program()
    startup.random_seed = SEED
    return loss, fluid.default_main_program(), startup


def lstm_parity_phase():
    loss, main, startup = rnn_program("lstm", LSTM_PARITY_SEQ)
    grads = [n + "@GRAD" for n in ("embedding_0.w_0", "dynamic_lstm_0.w_0",
                                   "dynamic_lstm_1.w_0")]
    feed = rnn_bench.lstm_feed(LSTM_PARITY_BS, LSTM_PARITY_SEQ, ragged=True)
    return parity_run("lstm_parity", main, startup, loss, feed, grads,
                      LSTM_WANT, {"bs": LSTM_PARITY_BS,
                                  "seq": LSTM_PARITY_SEQ})


def nmt_parity_phase():
    loss, main, startup = rnn_program("nmt", NMT_PARITY_SEQ)
    grads = [n + "@GRAD" for n in ("s2s.src_emb", "s2s.enc_gru_f.w",
                                   "s2s.enc_gru_b.w", "s2s.dec_w_h")]
    feed = rnn_bench.nmt_feed(NMT_PARITY_BS, NMT_PARITY_SEQ)
    return parity_run("nmt_parity", main, startup, loss, feed, grads,
                      NMT_WANT, {"bs": NMT_PARITY_BS, "seq": NMT_PARITY_SEQ})


def rnn_bench_run(tag, which, dtype, feed, want, card_name, smi, lr):
    """2 warm-up steps and 10 measured ones of a recurrent program at full
    width: losses finite and falling (the lowest measured one below the
    first step's), step ms, sequences and tokens per
    second (tokens = the feed's valid source steps), peak memory, and the
    launches `want` in every step."""
    bs, seq = feed[next(iter(feed))].shape[:2]
    t0 = time.monotonic()
    loss, main, startup = rnn_program(which, seq, dtype)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup)
    torch.cuda.synchronize()
    startup_s = time.monotonic() - t0
    warm = run_steps(exe, main, loss, feed, 2)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    steps, launches = counted(lambda: run_steps(exe, main, loss, feed, 10))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    check_launches(tag, launches, {k: 10 * v for k, v in want.items()})
    for _, _, per_step, _ in steps:
        check_launches(tag, per_step, want)
    losses = [r[0] for r in warm + steps]
    step_ms = wall / len(steps) * 1e3
    tokens = int(sum(int(v.sum()) for k, v in feed.items()
                     if k in ("words@LENGTH", "src@LENGTH", "tgt@LENGTH")))
    res = {"card": card_name, "nvidia_smi": smi, "bs": bs, "seq": seq,
           "dtype": dtype, "lr": lr, "tokens_per_step": tokens,
           "params": sum(int(np.prod(p.shape)) for p in
                         main.global_block().all_parameters()),
           "ops": len(main.global_block().ops),
           "startup_s": startup_s, "losses": losses, "step_ms": step_ms,
           "step_ms_each": [r[3] * 1e3 for r in steps],
           "seq_s": bs / (step_ms / 1e3),
           "tok_s": tokens / (step_ms / 1e3),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches,
           "launches_per_step": {k: v / len(steps)
                                 for k, v in launches.items()}}
    log(tag, res)
    if not all(np.isfinite(losses)) or not min(losses[2:]) < losses[0]:
        raise AssertionError(f"{tag}: losses {losses} are not finite or did "
                             f"not fall")
    return res, exe, main, loss


def lstm_bench_phase(card_name, smi):
    feed = rnn_bench.lstm_feed()
    res, exe, main, loss = rnn_bench_run(
        "lstm_bench", "lstm", "bfloat16", feed, LSTM_WANT, card_name, smi,
        rnn_bench.LSTM_LR)
    # the mask at full width: ragged lengths, the same program
    ragged = rnn_bench.lstm_feed(ragged=True, seed=1)
    steps = run_steps(exe, main, loss, ragged, 3)
    for _, _, per_step, _ in steps:
        check_launches("lstm_bench_ragged", per_step, LSTM_WANT)
    res["ragged_losses"] = [r[0] for r in steps]
    if not all(np.isfinite(res["ragged_losses"])):
        raise AssertionError(f"lstm_bench: ragged losses "
                             f"{res['ragged_losses']} are not finite")
    # the forward program alone runs in test mode: K7 only
    loss_t, main_t, startup_t = rnn_program("lstm", rnn_bench.LSTM_SEQ,
                                            "bfloat16", train=False)
    exe_t = fluid.Executor(fluid.CUDAPlace(0))
    exe_t.run(startup_t)
    (val,), launches = counted(lambda: exe_t.run(main_t, feed=ragged,
                                                 fetch_list=[loss_t]))
    check_launches("lstm_infer", launches,
                   {"lstm_forward": rnn_bench.LSTM_LAYERS})
    infer = {"bs": rnn_bench.LSTM_BS, "seq": rnn_bench.LSTM_SEQ,
             "dtype": "bfloat16", "loss": float(val[0]),
             "launches": launches}
    log("lstm_infer", infer)
    if not np.isfinite(infer["loss"]):
        raise AssertionError(f"lstm_infer: loss {infer['loss']}")
    return res, infer


def nmt_bench_phase(card_name, smi):
    res, _, _, _ = rnn_bench_run(
        "nmt_bench", "nmt", "float32", rnn_bench.nmt_feed(), NMT_WANT,
        card_name, smi, rnn_bench.NMT_LR)
    return res


# -- 18. kernels K11-K15 ------------------------------------------------------

BN_TIMED_1X1 = ("1x1", 128, 28, 28, 512, 128, 1, True)   # stage 2's conv1
BN_TIMED_3X3 = ("3x3", 128, 28, 28, 128, 128, 1, False)  # stage 2's conv2
BN_EXTRA = [("3x3", 8, 7, 7, 64, 96, 2, True)]  # odd H and W at stride 2
BN_NO_LIBRARY = ("null: no single PyTorch call computes the fused function "
                 "(BatchNorm apply, residual and ReLU inside the "
                 "convolution's operand); the plain version is that "
                 "composition of ATen, cuDNN and torch.matmul calls")


def fused_shape_counts(depth, bs, image):
    """{(kind, N, H, W, K, O, stride, residual): fused ops of that shape}
    of the NHWC training program at this depth, batch and image size,
    read from its desc (built, not run); H and W are X's, before a 1x1's
    stride."""
    fluid.reset()
    resnet_bench.train_program(depth=depth, image=image)
    block = fluid.default_main_program().global_block()
    out = {}
    for op in block.ops:
        if op.type not in ("bn_act_conv1x1", "bn_act_conv3x3"):
            continue
        _, h, w, k = block.var(op.inputs["X"][0]).shape
        o = block.var(op.inputs["Filter"][0]).shape[0]
        key = ("1x1" if op.type == "bn_act_conv1x1" else "3x3", bs, h, w,
               k, o, op.attrs["strides"][0],
               bool(op.inputs.get("Residual")))
        out[key] = out.get(key, 0) + 1
    fluid.reset()
    return out


def fused_shapes(depth, bs, image):
    """Every distinct fused shape of the program (``fused_shape_counts``),
    sorted."""
    return sorted(fused_shape_counts(depth, bs, image))


# launches a ResNet step makes per fused op of a shape (RESNET_WANT): the
# forward twice (the op, then its generic_grad's re-run), the backward once
BN_STEP_LAUNCHES = {"bn_matmul_fwd": 2, "bn_matmul_bwd": 1,
                    "bn_conv3x3_bwd": 1}


def bn_step_sum(rows, counts, dtype):
    """Sum over the fused ops of a ResNet step of launches x kernel ms (and
    x bound ms) of K11, K12 and K15 in `dtype`, from the rows timed at
    each shape; the launches must add up to RESNET_WANT[50]."""
    dt = str(dtype).split(".")[1]
    out = {"dtype": dt}
    for name, per_op in BN_STEP_LAUNCHES.items():
        launches = ms = bound_ms = 0.0
        for row in rows[name]:
            key = (row["kind"], row["N"], row["H"], row["W"], row["K"],
                   row["O"], row["stride"], row["residual"])
            if row["dtype"] != dt or key not in counts:
                continue
            n = per_op * counts[key]
            launches += n
            ms += n * row["kernel_ms"]
            bound_ms += n * row["bound_ms"]
        if launches != RESNET_WANT[50][name]:
            raise AssertionError(
                f"{name}: {launches} launches over ResNet-50's fused shapes, "
                f"not the {RESNET_WANT[50][name]} of a step")
        out[name] = {"launches": int(launches), "kernel_ms": ms,
                     "bound_ms": bound_ms}
    out["kernel_ms"] = sum(out[n]["kernel_ms"] for n in BN_STEP_LAUNCHES)
    return out


def bn_case(dev, dtype, kind, N, H, W, K, O, stride, has_r):
    """Inputs of one fused op on the card, as the kernels see them: for a
    1x1, x and r already read at the stride ([M, K]) and w [K, O]; for a
    3x3, NHWC x and r and w HWIO, the weights scaled to 0.5/sqrt(fan
    in)."""
    g = torch.Generator(device=dev).manual_seed(SEED + H + K + O + stride)

    def rnd(*shape, scale=1.0, shift=0.0, dt=dtype):
        return (torch.randn(*shape, generator=g, device=dev) * scale
                + shift).to(dt)

    if kind == "1x1":
        Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
        xs, ws, dos = (N * Ho * Wo, K), (K, O), (N * Ho * Wo, O)
        fan = K
    else:
        Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
        xs, ws, dos = (N, H, W, K), (3, 3, K, O), (N, Ho, Wo, O)
        fan = 9 * K
    return {"x": rnd(*xs, scale=1.5, shift=0.3),
            "r": rnd(*xs) if has_r else None,
            "gamma": (torch.rand(K, generator=g, device=dev) + 0.5),
            "beta": rnd(K, scale=0.3, dt=torch.float32),
            "mean": rnd(K, scale=0.1, shift=0.3, dt=torch.float32),
            "var": torch.rand(K, generator=g, device=dev) + 2.0,
            "w": rnd(*ws, scale=0.5 / fan ** 0.5), "do": rnd(*dos),
            "rows_out": dos[0] if kind == "1x1" else N * Ho * Wo}


BN_KINK = 1e-3  # the least |ReLU input| of an f32 case


def bn_clear_of_kinks(a):
    """Moves each element of x whose ReLU input (x - mean) * gamma *
    rsqrt(var + eps) + beta [+ r] lies within BN_KINK of 0 out to 2
    BN_KINK on its side, so that f32 and f64 take the same mask: an f32
    kernel held to a float64 plain version would otherwise see an element
    that flips move a gradient element by its whole value.  (The bf16
    cases, the on-card tests and the training phases keep such elements:
    there the plain version rounds as the kernel does.)"""
    gi = a["gamma"].double() * torch.rsqrt(a["var"].double() + 1e-5)
    pre = (a["x"].double() - a["mean"].double()) * gi + a["beta"].double()
    if a["r"] is not None:
        pre = pre + a["r"].double()
    step = torch.where(pre >= 0, 2 * BN_KINK, -2 * BN_KINK) / gi
    a["x"] = torch.where(pre.abs() < BN_KINK, a["x"].double() + step,
                         a["x"].double()).to(a["x"].dtype)
    return a


def bn_bound(kind, a, O, backward, dtype, design="cuda_cores"):
    """Each input read once, each output written once (the statistics
    too), and 2 flops per multiply-add of the products: forward M_out K O
    (times 9 taps for a 3x3), backward twice that (dA and dW); the
    prologue's few flops an element are left out.  The products at the
    dtype's rate, or for a 3xTF32 body (``design``) three TF32 products
    per f32 product at the tensor cores' TF32 rate, as ``flash_bound``."""
    size = a["x"].element_size()
    xe, we = a["x"].numel(), a["w"].numel()
    oe = a["do"].numel()
    n_r = 0 if a["r"] is None else 1
    K = a["gamma"].numel()
    if backward:
        elems = (2 + 2 * n_r) * xe + 2 * we + oe  # x, r, dx, dr; w, dw; dO
        stats = 4 * K * 4 + 6 * K * 4
    else:
        elems = (1 + n_r) * xe + we + oe
        stats = 4 * K * 4
    taps = 9 if kind == "3x3" else 1
    flops = 2 * a["rows_out"] * K * O * taps * (2 if backward else 1)
    if design.endswith("mma_3xtf32"):
        return bound(elems * size + stats, 3 * flops, dtype, peak=PEAK_TF32)
    return bound(elems * size + stats, flops, dtype)


def bn_calls(kind, a, stride, v2=False):
    """(forward, plain forward, backward, plain backward) of one case as
    zero-argument callables."""
    args = tuple(a[k] for k in ("x", "gamma", "beta", "mean", "var", "w"))
    if kind == "1x1":
        return (lambda: bnmm.bn_matmul_fwd(*args, a["r"]),
                lambda: bnmm.bn_matmul_fwd_ref(*args, a["r"]),
                lambda: bnmm.bn_matmul_bwd(*args, a["do"], a["r"]),
                lambda: bnmm.bn_matmul_bwd_ref(*args, a["do"], a["r"]))
    fwd = bnc.bn_conv3x3_fwd_v2 if v2 else bnc.bn_conv3x3_fwd
    return (lambda: fwd(*args, a["r"], stride=stride),
            lambda: bnc.bn_conv3x3_fwd_ref(*args, a["r"], stride=stride),
            lambda: bnc.bn_conv3x3_bwd(*args, a["do"], a["r"],
                                       stride=stride),
            lambda: bnc.bn_conv3x3_bwd_ref(*args, a["do"], a["r"],
                                           stride=stride))


def bn_double(a):
    """The case's inputs in float64: what the f32 kernels are held to."""
    return {k: v.double() if isinstance(v, torch.Tensor) else v
            for k, v in a.items()}


BN_OUTPUTS = {False: ("out",),
              True: ("dx", "dgamma", "dbeta", "dmean", "dvar", "dw", "dr")}


def bn_f64_errs(names, got, plain, want):
    """{output: {"kernel": d, "plain": d}}: each bf16 output's and its
    plain version's distance to the function in float64 from the same
    inputs (max |error| over max |value|)."""
    return {n: {"kernel": rel_err(g, w), "plain": rel_err(p, w)}
            for n, g, p, w in zip(names, got, plain, want)}


def bn_kernel_phase(dev):
    """K11-K15 against their plain versions, float32 and bfloat16, at
    every distinct fused shape of ResNet-50's bench program (batch 128,
    224 x 224), the stride-2 and residual 3x3 shapes of ResNet-18, and an
    odd-H stride-2 3x3; outputs and gradients relative to each tensor's
    max |value|, by TOL.  The f32 kernels are held to the plain version in
    float64 (so neither cuDNN's algorithm choice nor its summation order
    moves the reading; inputs clear of the ReLU's kink,
    ``bn_clear_of_kinks``), the bf16 ones to the plain version in bf16,
    and each bf16 output's distance to the float64 function from the same
    inputs is logged beside the plain version's (``f64_err``).  K13 and K14
    are timed at every 3x3 shape, K11, K12 and K15 in both dtypes at every
    ResNet-50 shape, and the f32 ones summed over ResNet-50's step
    (``bn_step_sum``); at stage 2's 1x1 with a residual and stage 2's 3x3
    each kernel is timed beside its plain version (in its own dtype) and
    the bound.  Each row names its kernel's body by dtype (``DESIGN``)."""
    r50 = fused_shape_counts(50, resnet_bench.BS, resnet_bench.IMAGE)
    shapes = sorted(r50)
    shapes += [s for s in fused_shapes(18, resnet_bench.BS,
                                       resnet_bench.IMAGE)
               if s[0] == "3x3" and (s[6] == 2 or s[7]) and s not in shapes]
    shapes += BN_EXTRA
    names = {"1x1": ("bn_matmul_fwd", "bn_matmul_bwd"),
             "3x3": ("bn_conv3x3_fwd", "bn_conv3x3_bwd")}
    rows = {k: [] for k in BN_KERNELS}
    for dtype in DTYPES:
        for shape in shapes:
            kind, N, H, W, K, O, stride, has_r = shape
            a = bn_case(dev, dtype, *shape)
            if dtype == torch.float32:
                a = bn_clear_of_kinks(a)
            fwd, _, bwd, _ = bn_calls(kind, a, stride)
            out = fwd()
            grads = bwd()
            torch.cuda.synchronize()
            ref_calls = bn_calls(kind, bn_double(a) if dtype == torch.float32
                                 else a, stride)
            ref = ref_calls[1]()
            ref_g = ref_calls[3]()
            f64 = {}
            if dtype == torch.bfloat16:
                x64 = bn_calls(kind, bn_double(a), stride)
                f64 = {False: bn_f64_errs(BN_OUTPUTS[False], [out], [ref],
                                          [x64[1]()]),
                       True: bn_f64_errs(BN_OUTPUTS[True], grads, ref_g,
                                         x64[3]())}
                del x64
            desc = {"dtype": str(dtype).split(".")[1], "kind": kind, "N": N,
                    "H": H, "W": W, "K": K, "O": O, "stride": stride,
                    "residual": has_r,
                    "plain_dtype": str(ref.dtype).split(".")[1]}
            checks = [(names[kind][0], fwd, [out], [ref], False)]
            if kind == "3x3":
                v2 = bn_calls(kind, a, stride, v2=True)[0]
                out2 = v2()
                torch.cuda.synchronize()
                checks.append(("bn_conv3x3_fwd_v2", v2, [out2], [ref],
                               False))
            checks.append((names[kind][1], bwd, grads, ref_g, True))
            timed = (shape == BN_TIMED_1X1 or shape == BN_TIMED_3X3)
            for name, kern, got, want, back in checks:
                design = DESIGN[dtype][name]
                b_ms, b_by = bn_bound(kind, a, O, back, dtype, design)
                row = {**desc, "design": design,
                       "max_rel_err": max(rel_err(g, r)
                                          for g, r in zip(got, want)),
                       "max_abs_err": max(max_err(g, r)
                                          for g, r in zip(got, want)),
                       "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": None}
                if design.endswith("mma_3xtf32"):
                    row["bound_cuda_cores_ms"] = bn_bound(kind, a, O, back,
                                                          dtype)[0]
                if name == "bn_conv3x3_fwd_v2":
                    row["block_o"] = bnc._v2_block_o(O)
                    row["equals_v1"] = torch.equal(out2, out)
                elif f64:
                    row["f64_err"] = f64[back]
                if timed or (kind == "3x3" and not back) or shape in r50:
                    row["kernel_ms"] = time_ms(kern, iters=10)
                if timed:
                    row["plain_ms"] = time_ms(
                        bn_calls(kind, a, stride)[3 if back else 1], iters=5)
                rows[name].append(row)
                log(name, row)
                if row["max_rel_err"] > TOL[dtype]:
                    raise AssertionError(
                        f"{name} disagrees with its plain version at "
                        f"{desc}: {row} (tolerance {TOL[dtype]} of each "
                        f"tensor's max |value|)")
            del a, out, grads, ref, ref_g
    log("bn_f32_resnet50_step", bn_step_sum(rows, r50, torch.float32))
    return rows


def top_k_phase(dev):
    """The top_k op on ties, on the card and on the CPU, against a stable
    descending sort of the same rows."""
    info = get_op_info("top_k")
    rng = np.random.RandomState(SEED)
    cases = [(np.zeros((1, 10), np.float32), 3),
             (rng.randint(0, 4, (128, 1000)).astype(np.float32), 5)]
    rows = []
    for x, k in cases:
        want = np.argsort(-x, axis=1, kind="stable")[:, :k]
        for dtype in DTYPES:
            for d in (dev, torch.device("cpu")):
                xt = torch.from_numpy(x).to(device=d, dtype=dtype)
                got = info.emit(EmitContext(d, is_test=True), {"X": [xt]},
                                {"k": k})["Indices"][0].cpu().numpy()
                if not np.array_equal(got, want):
                    raise AssertionError(
                        f"top_k on {d} ({dtype}) breaks ties otherwise than "
                        f"a stable sort: {got[:2]} against {want[:2]}")
            rows.append({"shape": list(x.shape), "k": k,
                         "dtype": str(dtype).split(".")[1],
                         "indices_equal": True})
    log("top_k_ties", {"cases": rows})
    return rows


def v1_v2_times(rows):
    """K13 against K14 at every 3x3 shape the phase timed: each kernel's
    ms and K14's share of K13's time."""
    v2 = {tuple(r[k] for k in ("dtype", "N", "H", "W", "K", "O", "stride",
                               "residual")): r
          for r in rows["bn_conv3x3_fwd_v2"]}
    out = []
    for r in rows["bn_conv3x3_fwd"]:
        key = tuple(r[k] for k in ("dtype", "N", "H", "W", "K", "O",
                                   "stride", "residual"))
        if "kernel_ms" in r and "kernel_ms" in v2.get(key, {}):
            out.append({"shape": dict(zip(
                ("dtype", "N", "H", "W", "K", "O", "stride", "residual"),
                key)), "v1_ms": r["kernel_ms"],
                "v2_ms": v2[key]["kernel_ms"],
                "v2_over_v1": v2[key]["kernel_ms"] / r["kernel_ms"]})
    log("bn_conv3x3_v1_vs_v2", {"shapes": out})
    return out


# -- 19-20. ResNet training ---------------------------------------------------

# (image, batch) of the f32 parity runs.  ResNet-50's f32 training is
# ill-conditioned at these sizes: from one state its step-1 gradients lie
# about 2% (in norm over all parameters; up to 27% of max |g| for the last
# stage's filters) from a float64 run of the same step, on the CPU and on
# the card alike, at 128 x 128 and at 224 x 224, and the next steps
# inherit that spread (tools/resnet_conditioning.py --card).  ResNet-18
# at 64 x 64 stays within 2e-5.
RESNET_PARITY = {50: (128, 4), 18: (64, 4)}
RESNET_PARITY_LR = 0.001
# per step: each fused op once in the forward and once inside its
# generic_grad's re-run of the forward, its backward once
RESNET_WANT = {
    50: {"bn_matmul_fwd": 68, "bn_matmul_bwd": 34, "bn_conv3x3_fwd": 32,
         "bn_conv3x3_bwd": 16},
    18: {"bn_matmul_fwd": 6, "bn_matmul_bwd": 3, "bn_conv3x3_fwd": 30,
         "bn_conv3x3_bwd": 15}}
# ResNet-50 under PADDLE_TPU_BNCONV_VARIANT=v2: K14 in K13's place
RESNET_V2_WANT = dict(RESNET_WANT[50], bn_conv3x3_fwd=0,
                      bn_conv3x3_fwd_v2=32)


def resnet_program(depth, image, dtype, lr, fuse=True):
    """The NHWC training program of ``resnet_bench`` at this depth, image
    size and dtype (class_dim 1000) in fresh default programs and scope;
    returns (loss, main, startup)."""
    fluid.reset()
    loss, _ = resnet_bench.train_program(depth=depth, image=image,
                                         dtype=dtype, learning_rate=lr,
                                         fuse_bn=fuse)
    startup = fluid.default_startup_program()
    startup.random_seed = SEED
    return loss, fluid.default_main_program(), startup


def resnet_watched(block):
    """The stem filter's, the first fused 3x3's filter and BN scale's and
    the fc weight's gradient names."""
    conv3 = next(op for op in block.ops if op.type == "bn_act_conv3x3")
    return [n + "@GRAD" for n in (
        "conv2d_0.w_0", conv3.inputs["Filter"][0], conv3.inputs["Scale"][0],
        next(p.name for p in block.all_parameters()
             if p.name.startswith("fc") and ".w_" in p.name))]


def snapshot(block, scope=None):
    return {n: (scope or fluid.global_scope()).find_np(n)
            for n, v in block.vars.items() if v.persistable}


def forced_steps(exe, main, loss, feed, states, grads, scope=None):
    """One step from each numpy state of `states` (loaded by name before
    it), the step-1 `grads` fetched; returns run_steps' rows."""
    rows = []
    for i, state in enumerate(states):
        fluid.load_persistables(main, state, scope)
        rows += run_steps(exe, main, loss, feed, 1, grads if i == 0 else (),
                          scope=scope)
    return rows


def resnet50_parity_phase():
    """ResNet-50 in f32 at 128 x 128, batch 4, held where f32 itself holds
    (RESNET_PARITY's comment).  The CPU takes three f32 steps from the
    card's startup state; the card takes each step from the CPU's state
    before it (so every step starts equal, the velocities of steps 2 and 3
    included), with v1 (K13) and again with v2 (K14); the CPU takes one
    float64 step from the same start.  Held: each step's loss within 1e-4
    relative of the CPU's, and v2's step-1 loss within 1e-6 of v1's (the
    same function and rounding; later steps differ in cuDNN's and max
    pooling's atomics); the fc weight's step-1 gradient within 1e-3 of
    its max |g|, and the running statistics after step 1 within 1e-3; the
    stem, first fused 3x3 and BN-scale gradients, each, and all gradients
    together (in norm), no further from the float64 ones than twice the
    CPU's f32 ones are.  Launches per step are RESNET_WANT[50] (v2: K14 in
    place of K13).  The free-running card trajectory's losses are logged
    beside the CPU's and float64's, not held."""
    image, bs = RESNET_PARITY[50]
    loss, main, startup = resnet_program(50, image, "float32",
                                         RESNET_PARITY_LR)
    block = main.global_block()
    watched = resnet_watched(block)
    names = sorted(p.name + "@GRAD" for p in block.all_parameters())
    stats = [op.inputs[s][0] for op in block.ops if op.type == "batch_norm"
             for s in ("Mean", "Variance")]
    feed = resnet_bench.feed(bs, image)
    card = fluid.Executor(fluid.CUDAPlace(0))
    card.run(startup)
    states = [snapshot(block)]
    t0 = time.monotonic()
    cpu_scope = fluid.Scope()
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    cpu = forced_steps(cpu_exe, main, loss, feed, states[:1], names,
                       cpu_scope)
    for _ in range(2):
        states.append(snapshot(block, cpu_scope))
        cpu += run_steps(cpu_exe, main, loss, feed, 1, scope=cpu_scope)
    cpu_s = time.monotonic() - t0
    cpu_stats = {n: states[1][n] for n in stats}
    free, _ = counted(lambda: run_steps(card, main, loss, feed, 3))
    gpu, launches = counted(lambda: forced_steps(card, main, loss, feed,
                                                 states[:1], names))
    gpu_stats = {n: fluid.global_scope().find_np(n) for n in stats}
    gpu += forced_steps(card, main, loss, feed, states[1:], ())
    for _, _, per_step, _ in gpu:
        check_launches("resnet50_parity", per_step, RESNET_WANT[50])
    os.environ["PADDLE_TPU_BNCONV_VARIANT"] = "v2"
    try:
        v2, v2_launches = counted(lambda: forced_steps(card, main, loss,
                                                       feed, states, ()))
    finally:
        del os.environ["PADDLE_TPU_BNCONV_VARIANT"]
    for _, _, per_step, _ in v2:
        check_launches("resnet50_parity_v2", per_step, RESNET_V2_WANT)
    del card
    t0 = time.monotonic()
    loss64, main64, _ = resnet_program(50, image, "float64",
                                       RESNET_PARITY_LR)
    block64 = main64.global_block()
    scope64 = fluid.Scope()
    fluid.load_persistables(main64, {
        n: a.astype(block64.vars[n].dtype) for n, a in states[0].items()},
        scope64)
    feed64 = dict(feed, image=feed["image"].astype(np.float64))
    f64 = run_steps(fluid.Executor(fluid.CPUPlace()), main64, loss64,
                    feed64, 1, names, scope=scope64)
    f64_s = time.monotonic() - t0
    g32, gc, g64 = gpu[0][1], cpu[0][1], f64[0][1]

    def max_rel(a, b):
        return float(np.abs(np.asarray(a, np.float64) - b).max()
                     / np.abs(b).max())

    def norm_rel(a):
        num = sum(float(((np.asarray(a[n], np.float64) - g64[n]) ** 2).sum())
                  for n in names)
        return (num / sum(float((g64[n] ** 2).sum()) for n in names)) ** 0.5

    loss_rel = [abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(gpu, cpu)]
    v2_rel = [abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(v2, gpu)]
    fc = watched[3]
    witness = {n: {"card": max_rel(g32[n], g64[n]),
                   "cpu": max_rel(gc[n], g64[n])} for n in watched[:3]}
    witness["all_norm"] = {"card": norm_rel(g32), "cpu": norm_rel(gc)}
    res = {"depth": 50, "bs": bs, "image": image, "dtype": "float32",
           "gpu_losses": [r[0] for r in gpu],
           "cpu_losses": [r[0] for r in cpu], "loss_rel_err": loss_rel,
           "loss_tol": [1e-4] * 3, "steps": "each from the CPU's state",
           "grad_rel_err_step1": {fc: max_rel(g32[fc], gc[fc])},
           "grad_tol": {fc: 1e-3},
           "grad_vs_f64_step1": witness, "grad_vs_f64_tol": "2 x the CPU's",
           "state_rel_err_max": max(max_rel(gpu_stats[n], cpu_stats[n])
                                    for n in stats),
           "state_after_step": 1,
           "free_running_losses": {"card": [r[0] for r in free],
                                   "cpu": [r[0] for r in cpu],
                                   "f64_step1": f64[0][0]},
           "launches_per_step": gpu[-1][2],
           "gpu_step_s": [r[3] for r in gpu], "cpu_s": cpu_s,
           "f64_s": f64_s}
    log("resnet50_parity", res)
    v2res = {"losses": [r[0] for r in v2], "v1_losses": res["gpu_losses"],
             "loss_rel_err_vs_v1": v2_rel, "loss_tol_step1": 1e-6,
             "loss_rel_err_vs_cpu": [abs(a[0] - b[0]) / abs(b[0])
                                     for a, b in zip(v2, cpu)],
             "launches_per_step": v2[-1][2], "launches": v2_launches}
    log("resnet50_parity_v2", v2res)
    bad = [f"step {i + 1} loss {e}" for i, e in enumerate(loss_rel)
           if e > 1e-4]
    bad += [f"v2 step {i + 1} loss vs the CPU {e}" for i, e in
            enumerate(v2res["loss_rel_err_vs_cpu"]) if e > 1e-4]
    bad += [f"v2 step-1 loss vs v1 {v2_rel[0]}"] if v2_rel[0] > 1e-6 else []
    bad += [f"{fc} {res['grad_rel_err_step1'][fc]}"] \
        if res["grad_rel_err_step1"][fc] > 1e-3 else []
    bad += [f"statistics {res['state_rel_err_max']}"] \
        if res["state_rel_err_max"] > 1e-3 else []
    bad += [f"{n} vs float64 {w}" for n, w in witness.items()
            if w["card"] > 2 * w["cpu"]]
    if bad:
        raise AssertionError(f"resnet50 card and CPU training disagree: "
                             f"{bad}: {res}")
    fluid.reset()
    return res, v2res


def resnet18_parity_phase():
    """Three f32 steps of ResNet-18 at 64 x 64 on the card against three
    on the CPU (``parity_run``), the running statistics after step 3."""
    image, bs = RESNET_PARITY[18]
    loss, main, startup = resnet_program(18, image, "float32",
                                         RESNET_PARITY_LR)
    block = main.global_block()
    stats = [op.inputs[s][0] for op in block.ops if op.type == "batch_norm"
             for s in ("Mean", "Variance")]
    return parity_run("resnet18_parity", main, startup, loss,
                      resnet_bench.feed(bs, image), resnet_watched(block),
                      RESNET_WANT[18], {"depth": 18, "bs": bs,
                                        "image": image}, stats)


def resnet_bench_run(tag, fuse, card_name, smi, want=RESNET_WANT[50]):
    """2 warm-up steps and 10 measured ones of ResNet-50's bench program
    (bf16, batch 128, 224 x 224): losses finite and the lowest measured
    below the first, step ms, images per second, peak memory and, fused,
    exactly `want` launches a step (unfused: none)."""
    t0 = time.monotonic()
    loss, main, startup = resnet_program(resnet_bench.DEPTH,
                                         resnet_bench.IMAGE,
                                         resnet_bench.DTYPE, resnet_bench.LR,
                                         fuse)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup)
    torch.cuda.synchronize()
    startup_s = time.monotonic() - t0
    feed = resnet_bench.feed()
    warm = run_steps(exe, main, loss, feed, 2)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    steps, launches = counted(lambda: run_steps(exe, main, loss, feed, 10))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    want = want if fuse else {}
    for _, _, per_step, _ in steps:
        if fuse:
            check_launches(tag, per_step, want)
        elif any(per_step.values()):
            raise AssertionError(f"{tag}: the unfused program launched "
                                 f"{per_step}")
    losses = [r[0] for r in warm + steps]
    step_ms = wall / len(steps) * 1e3
    block = main.global_block()
    res = {"card": card_name, "nvidia_smi": smi, "fused": fuse,
           "depth": resnet_bench.DEPTH, "bs": resnet_bench.BS,
           "image": resnet_bench.IMAGE, "dtype": resnet_bench.DTYPE,
           "lr": resnet_bench.LR, "ops": len(block.ops),
           "ops_run_per_step": sum(texecutor.live_ops(block, [loss.name])),
           "params": sum(int(np.prod(p.shape))
                         for p in block.all_parameters()),
           "startup_s": startup_s, "losses": losses, "step_ms": step_ms,
           "step_ms_each": [r[3] * 1e3 for r in steps],
           "img_s": resnet_bench.BS / (step_ms / 1e3),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches,
           "launches_per_step": {k: v / len(steps)
                                 for k, v in launches.items()}}
    log(tag, res)
    if not all(np.isfinite(losses)) or not min(losses[2:]) < losses[0]:
        raise AssertionError(f"{tag}: losses {losses} are not finite or did "
                             f"not fall")
    del exe
    fluid.reset()
    torch.cuda.empty_cache()
    return res


def resnet_bench_phase(card_name, smi):
    fused = resnet_bench_run("resnet50_bench_fused", True, card_name, smi)
    os.environ["PADDLE_TPU_BNCONV_VARIANT"] = "v2"
    try:
        v2 = resnet_bench_run("resnet50_bench_fused_v2", True, card_name,
                              smi, RESNET_V2_WANT)
    finally:
        del os.environ["PADDLE_TPU_BNCONV_VARIANT"]
    unfused = resnet_bench_run("resnet50_bench_unfused", False, card_name,
                               smi)
    cmp = {"fused_img_s": fused["img_s"], "fused_v2_img_s": v2["img_s"],
           "unfused_img_s": unfused["img_s"],
           "fused_over_unfused": fused["img_s"] / unfused["img_s"],
           "fused_v2_over_fused": v2["img_s"] / fused["img_s"],
           "card": card_name, "nvidia_smi": smi}
    log("resnet50_fused_vs_unfused", cmp)
    return fused, v2, unfused


# -- 21-24. K steps a dispatch: the captured step loop -------------------------

# GPT training at the bench shape takes 4 steps a dispatch, ResNet-50 2
STEP_LOOP_K = {"gpt": 4, "resnet50": 2}
# timed steps of each route
STEP_LOOP_TIMED = 12
# eager runs from one state: the eager spread is the largest distance
# between any two of them
SPREAD_RUNS = 6
# where eager runs from one state part (an op whose sums depend on the
# order atomics land in), a graph's losses and each state tensor are held
# to this multiple of their spread: the graph-to-eager distance is a draw
# from the same spread
SPREAD_FACTOR = 2.0


def persistables(main):
    return [n for n, v in main.global_block().vars.items() if v.persistable]


def snap(names):
    """The scope's values of `names`, cloned on the card."""
    scope = fluid.global_scope()
    return {n: scope.find(n).detach().clone() for n in names}


def restore(state):
    """Replace the scope's entries by copies of `state` (new tensors, as
    an eager run() or Scope.set leaves them)."""
    for n, t in state.items():
        fluid.global_scope().set(n, t.clone())


def distance(losses_a, state_a, losses_b, state_b):
    """Whether two runs agree to the bit, and how far apart they are: the
    losses' largest relative distance (`loss_rel`), and each state
    tensor's that differs, as the norm of the difference relative to the
    tensor's norm (`tensors`; the largest is `state_rel`, in `worst`).
    The norm sums every element's part, where a largest element
    difference is one rounding flip (bf16 parameters, Adam's second
    moments) and jumps by whole units in the last place; that largest,
    relative to the tensor's max |value|, is `state_max_rel`.  `flips`
    holds each differing tensor's one flip of its largest element in the
    same measure: its dtype's eps times its max |value|, over its norm."""
    la, lb = np.asarray(losses_a, np.float64), np.asarray(losses_b,
                                                          np.float64)
    loss_rel = float(np.max(np.abs(la - lb) / np.abs(lb)))
    tensors, flips, peak = {}, {}, 0.0
    for n, b in state_b.items():
        a = state_a[n]
        if not torch.equal(a, b):
            eps = torch.finfo(b.dtype).eps
            diff, b = a.double() - b.double(), b.double()
            norm, top = b.norm().clamp_min(1e-30), b.abs().max()
            tensors[n] = (diff.norm() / norm).item()
            flips[n] = (eps * top / norm).item()
            peak = max(peak, (diff.abs().max()
                              / top.clamp_min(1e-30)).item())
    worst = max(tensors, key=tensors.get, default=None)
    return {"bitwise": loss_rel == 0.0 and not tensors, "loss_rel": loss_rel,
            "state_rel": tensors.get(worst, 0.0), "worst": worst,
            "state_max_rel": peak, "tensors": tensors, "flips": flips}


def eager_runs(exe, main, loss, blocks, k, start):
    """SPREAD_RUNS runs from `start`, each k eager steps per stacked block
    of `blocks`: (losses, state) each."""
    names = list(start)
    runs = []
    for _ in range(SPREAD_RUNS):
        restore(start)
        losses = []
        for stacked in blocks:
            losses += eager_steps(exe, main, loss, stacked, k)
        runs.append((losses, snap(names)))
    return runs


def spread_of(runs):
    """The eager spread of runs from one state: the largest distance
    between any two of them, of the losses and of each state tensor."""
    pairs = [distance(*a, *b) for i, a in enumerate(runs)
             for b in runs[i + 1:]]
    tensors = {}
    for pair in pairs:
        for n, d in pair["tensors"].items():
            tensors[n] = max(tensors.get(n, 0.0), d)
    worst = max(tensors, key=tensors.get, default=None)
    return {"runs": len(runs), "bitwise": all(p["bitwise"] for p in pairs),
            "loss_rel": max(p["loss_rel"] for p in pairs),
            "state_rel": tensors.get(worst, 0.0), "worst": worst,
            "state_max_rel": max(p["state_max_rel"] for p in pairs),
            "tensors": tensors}


def brief(d):
    """A ``distance`` or ``spread_of`` without its per-tensor tables."""
    return {k: v for k, v in d.items() if k not in ("tensors", "flips")}


def hold(tag, what, got, spread):
    """`got` (a ``distance``) within the eager `spread` (``spread_of``):
    to the bit where every eager run agrees to the bit; else its losses
    within SPREAD_FACTOR of the losses' spread, and each state tensor
    within SPREAD_FACTOR of that tensor's spread or within one rounding
    flip of its largest element (``distance``'s `flips`), whichever is
    more: a tensor whose elements part by rare flips (a bf16 bias) has a
    spread of whichever few elements flipped, and every run that is not
    bitwise may flip its largest.  Returns `got` in brief, with the
    largest share of its bound that the losses and a tensor take."""
    over, share = [], {"loss": 0.0, "state": 0.0}
    floor = (lambda n: 0.0) if spread["bitwise"] else got["flips"].get
    for part, n, d, lim in (
            [("loss", "losses", got["loss_rel"],
              SPREAD_FACTOR * spread["loss_rel"])]
            + [("state", n, d, max(SPREAD_FACTOR
                                   * spread["tensors"].get(n, 0.0),
                                   floor(n)))
               for n, d in got["tensors"].items()]):
        if d > lim:
            over.append((n, d, lim))
        if d > 0:
            share[part] = max(share[part],
                              d / lim if lim > 0 else float("inf"))
    if over:
        raise AssertionError(
            f"{tag}: {what} is not within {SPREAD_FACTOR} x the spread of "
            f"{spread['runs']} eager runs; (name, distance, bound): "
            f"{over[:8]}, {len(over)} in all; {brief(got)}")
    return {**brief(got), "share_of_bound": share}


def bits_sum(t):
    """An exact checksum of a tensor's bits: its elements read as integers
    of their width, summed plainly and weighted by position (1 + index mod
    1021), in int64; the weights catch two changes that cancel in the
    plain sum (+1 and -1 ulp, as atomics' rounding leaves them)."""
    t = t.detach().contiguous().view(-1)
    as_int = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
              8: torch.int64}[t.element_size()]
    v = t.view(as_int).to(torch.int64)
    w = torch.arange(v.numel(), device=v.device) % 1021 + 1
    return torch.stack([v.sum(), (v * w).sum()])


def parting_ops(exe, main, loss, stacked, k, state, show=5):
    """Where two eager runs of k steps from `state` part: both run with a
    checksum of every op's outputs, compared op by op in walk order; the
    first `show` ops whose outputs differ (step, op index, type, and the
    forward type a ``generic_grad`` re-runs) and how many differ."""
    runs = []
    patched = texecutor.Executor.__dict__["_run_op"]
    inner = patched.__func__

    def checked(op, env, ctx):
        inner(op, env, ctx)
        sums = [bits_sum(env[n]) for n in op.output_names()
                if n and env.get(n) is not None]
        runs[-1].append((exe._walking[0], op.type,
                         op.attrs.get("__fwd_type__"),
                         torch.stack(sums) if sums else None))

    texecutor.Executor._run_op = staticmethod(checked)
    try:
        for _ in range(2):
            restore(state)
            runs.append([])
            eager_steps(exe, main, loss, stacked, k)
    finally:
        texecutor.Executor._run_op = patched
    per_step = len(runs[0]) // k
    parted = [{"step": j // per_step, "op_index": a[0], "op": a[1],
               "fwd": a[2]}
              for j, (a, b) in enumerate(zip(*runs))
              if a[3] is not None and not torch.equal(a[3], b[3])]
    return {"ops_walked": len(runs[0]), "ops_parted": len(parted),
            "first": parted[:show]}


def eager_steps(exe, main, loss, stacked, k):
    """`k` run() calls, one slice of the stacked feed each; the losses."""
    return [float(exe.run(main, feed={n: v[i] for n, v in stacked.items()},
                          fetch_list=[loss])[0][0]) for i in range(k)]


def dispatch(exe, main, loss, stacked, k, fetch_every="all"):
    out = exe.run(main, feed=stacked, fetch_list=[loss],
                  steps_per_dispatch=k, fetch_every=fetch_every)[0]
    return [float(v) for v in np.asarray(out).reshape(-1)]


def loop_parity(tag, exe, main, loss, stacked, k, want):
    """From one state: SPREAD_RUNS eager runs of k steps (their spread;
    where two part, the ops that part first), then, each from that state
    and held to the spread against the first eager run, the first
    dispatch (eager, the warm-up), the second (capture, then replay;
    launches at capture k x `want`) and a third (a replay alone, after the
    scope's entries were replaced; no launch)."""
    names = persistables(main)
    s0 = snap(names)
    runs = eager_runs(exe, main, loss, [stacked], k, s0)
    spread = spread_of(runs)
    if not spread["bitwise"]:
        spread["parting"] = parting_ops(exe, main, loss, stacked, k, s0)
    la, sa = runs[0]
    restore(s0)
    lc = dispatch(exe, main, loss, stacked, k)
    first = hold(tag, "the first (eager) dispatch",
                 distance(lc, snap(names), la, sa), spread)
    restore(s0)
    ld, launches = counted(lambda: dispatch(exe, main, loss, stacked, k))
    check_launches(tag + " capture", launches,
                   {n: k * v for n, v in want.items()})
    replay = hold(tag, "the replay", distance(ld, snap(names), la, sa),
                  spread)
    restore(s0)
    le, again = counted(lambda: dispatch(exe, main, loss, stacked, k))
    if any(again.values()):
        raise AssertionError(f"{tag}: a replay made Python launches {again}")
    replay2 = hold(tag, "the second replay",
                   distance(le, snap(names), la, sa), spread)
    return {"k": k, "eager_losses": la, "dispatch1_losses": lc,
            "replay_losses": ld, "replay2_losses": le,
            "eager_spread": brief(spread), "dispatch1_vs_eager": first,
            "replay_vs_eager": replay, "replay2_vs_eager": replay2,
            "spread_factor": SPREAD_FACTOR,
            "launches_at_capture": launches}


def loop_timing(exe, main, loss, stacked, k, per_step_items):
    """STEP_LOOP_TIMED eager steps, then as many replayed ones, each ending
    in the loss fetch; ms a step, items/s, peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    for _ in range(STEP_LOOP_TIMED // k):
        eager_steps(exe, main, loss, stacked, k)
    eager_s = time.monotonic() - t0
    peak_eager = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    for _ in range(STEP_LOOP_TIMED // k):
        dispatch(exe, main, loss, stacked, k)
    replay_s = time.monotonic() - t0
    eager_ms = eager_s / STEP_LOOP_TIMED * 1e3
    replay_ms = replay_s / STEP_LOOP_TIMED * 1e3
    return {"steps_timed": STEP_LOOP_TIMED, "eager_step_ms": eager_ms,
            "replay_step_ms": replay_ms, "replay_speedup": eager_ms / replay_ms,
            "eager_items_s": per_step_items / (eager_ms / 1e3),
            "replay_items_s": per_step_items / (replay_ms / 1e3),
            "peak_mem_gb_eager": peak_eager / 1e9,
            # a replay allocates nothing: its memory is the graph's pool,
            # reserved since the capture
            "peak_mem_gb_replay": torch.cuda.max_memory_allocated() / 1e9,
            "reserved_gb": torch.cuda.memory_reserved() / 1e9,
            "pool_gb": graph_pool_gb(exe)}


def gpt_stacked(bs, seq, k):
    batches = [train_batch(bs, seq, seed=i) for i in range(k)]
    return {n: np.stack([b[n] for b in batches]) for n in batches[0]}


def step_loop_gpt_phase(card_name, smi):
    """21. GPT training at the bench width and shape (bf16, batch 8 x
    1024), 4 steps a dispatch: parity of the first dispatch and of a
    replay with eager steps from the same state, launches at capture,
    eager against replayed step ms; then the f32 parity shape (batch 2 x
    256) the same way, which puts the 3xTF32 flash bodies in a graph."""
    k = STEP_LOOP_K["gpt"]
    rows = {}
    for dtype, (bs, seq) in (("float32", (PARITY_BS, PARITY_SEQ)),
                             ("bfloat16", (TRAIN_BS, TRAIN_SEQ))):
        loss, main, startup = train_program(seq, dtype)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup)
        stacked = gpt_stacked(bs, seq, k)
        row = {"dtype": dtype, "bs": bs, "seq": seq,
               **loop_parity(f"step_loop_gpt_{dtype}", exe, main, loss,
                             stacked, k, per_step_want())}
        if dtype == "bfloat16":
            row.update(loop_timing(exe, main, loss, stacked, k, bs * seq))
            row["tok_s_eager"] = row.pop("eager_items_s")
            row["tok_s_replay"] = row.pop("replay_items_s")
            ctx = {"exe": exe, "main": main, "loss": loss,
                   "stacked": stacked, "k": k}
        else:
            exe.close()
        rows[dtype] = row
    res = {"card": card_name, "nvidia_smi": smi, **rows["bfloat16"],
           "f32_parity": rows["float32"]}
    log("step_loop_gpt", res)
    return res, ctx


def graph_pool_gb(exe):
    """GB of the card's memory in the pool `exe`'s graphs share."""
    pool = exe._graph_pool
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool or ())
               ) / 1e9 if pool is not None else 0.0


def two_scopes_check(k):
    """A small MLP, f32, on one executor, dispatched against two scopes in
    turn (for each: an eager dispatch, a capture, two replays): each equals
    k eager steps of its own from its own state, to the bit, and the two
    loops share no state buffer."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[64])
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=256, act="relu")
        cost = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            fluid.layers.fc(input=h, size=10), y))
        fluid.optimizer.Momentum(learning_rate=0.01,
                                 momentum=0.9).minimize(cost)
    startup.random_seed = SEED
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scopes = [fluid.Scope(), fluid.Scope()]
    exe.run(startup, scope=scopes[0])
    names = persistables(main)
    for n in names:
        t = scopes[0].find(n)
        scopes[1].set(n, t * 0.5 if t.is_floating_point() else t.clone())
    rng = np.random.RandomState(SEED)
    for d in range(4):
        for j, scope in enumerate(scopes):
            feed = {"x": rng.randn(k, 32, 64).astype(np.float32),
                    "y": rng.randint(0, 10, (k, 32, 1)).astype(np.int64)}
            twin = fluid.Scope()
            for n in names:
                twin.set(n, scope.find(n).clone())
            ref = fluid.Executor(fluid.CUDAPlace(0))
            want = np.stack([ref.run(main, feed={n: v[i] for n, v in
                                                 feed.items()},
                                     fetch_list=[cost], scope=twin)[0]
                             for i in range(k)])
            got = exe.run(main, feed=feed, fetch_list=[cost], scope=scope,
                          steps_per_dispatch=k)[0]
            if not (np.array_equal(got, want) and all(
                    torch.equal(scope.find(n), twin.find(n))
                    for n in names)):
                raise AssertionError(
                    f"step_loop_two_scopes: scope {j}, dispatch {d} differs "
                    f"from its own eager steps")
    loops = [entry.loop for entry in exe._loops.values()]
    ptrs = [{t.untyped_storage().data_ptr() for t in loop.state.values()}
            for loop in loops if loop is not None]
    if len(ptrs) != 2 or ptrs[0] & ptrs[1]:
        raise AssertionError(f"step_loop_two_scopes: {len(ptrs)} loops, or "
                             f"their state buffers overlap")
    exe.close()
    return {"scopes": 2, "dispatches_each": 4, "bitwise": True}


def step_loop_last_and_unsafe_phase(ctx):
    """22. On the GPT, each from a state of its own and held to the spread
    of SPREAD_RUNS eager runs from it: ``fetch_every="last"`` (a second
    key, its own capture) against the eager runs, with the memory the
    graphs' shared pool and the card hold while both keys are live; a
    replay right after an eager run() replaced the scope's state against
    the eager continuation.  Then two scopes in turn on one executor
    (``two_scopes_check``), and a small program with ``uniform_random``,
    which must warn, run its K steps eagerly and equal them."""
    exe, main, loss, stacked, k = (ctx[n] for n in ("exe", "main", "loss",
                                                    "stacked", "k"))
    names = persistables(main)
    pool_one_key = graph_pool_gb(exe)
    reserved_one_key = torch.cuda.memory_reserved() / 1e9
    s0 = snap(names)
    runs = eager_runs(exe, main, loss, [stacked], k, s0)
    spread = spread_of(runs)
    restore(s0)
    dispatch(exe, main, loss, stacked, k, "last")  # eager: the warm-up
    restore(s0)
    last = dispatch(exe, main, loss, stacked, k, "last")  # capture, replay
    last_vs_eager = hold("step_loop_last", "fetch_every='last'",
                         distance(last, snap(names), runs[0][0][-1:],
                                  runs[0][1]), spread)
    memory = {"keys_live": 2, "pool_gb_one_key": pool_one_key,
              "pool_gb_two_keys": graph_pool_gb(exe),
              "reserved_gb_one_key": reserved_one_key,
              "reserved_gb_two_keys": torch.cuda.memory_reserved() / 1e9}

    exe.run(main, feed={n: v[0] for n, v in stacked.items()},
            fetch_list=[loss])  # replaces the scope's entries
    s1 = snap(names)
    replay = dispatch(exe, main, loss, stacked, k)
    s_replay = snap(names)
    runs1 = eager_runs(exe, main, loss, [stacked], k, s1)
    adopt = hold("step_loop_adopt", "a replay after an eager run()",
                 distance(replay, s_replay, *runs1[0]), spread_of(runs1))
    two_scopes = two_scopes_check(k)

    prog = fluid.Program()  # beside the GPT's programs and scope
    with fluid.program_guard(prog, fluid.Program()):
        fluid.layers.data(name="x", shape=[3])
    block = prog.global_block()
    for n in ("noise", "out"):
        block.create_var(name=n, shape=(2, 3), dtype="float32")
    block.append_op("uniform_random", outputs={"Out": ["noise"]},
                    attrs={"shape": [2, 3], "dtype": "float32"})
    block.append_op("elementwise_add", inputs={"X": ["x"], "Y": ["noise"]},
                    outputs={"Out": ["out"]}, attrs={"axis": -1})
    x = np.random.RandomState(SEED).randn(k, 2, 3).astype(np.float32)
    noisy = fluid.Executor(fluid.CUDAPlace(0))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fused = noisy.run(prog, feed={"x": x}, fetch_list=["out"],
                          scope=fluid.Scope(), rng_step=3,
                          steps_per_dispatch=k)[0]
    said = [str(w.message) for w in caught]
    if not any("loop-unsafe" in m and "'uniform_random'" in m for m in said):
        raise AssertionError(f"step_loop_unsafe: no warning naming "
                             f"uniform_random: {said}")
    seq = np.stack([fluid.Executor(fluid.CUDAPlace(0)).run(
        prog, feed={"x": x[i]}, fetch_list=["out"], scope=fluid.Scope(),
        rng_step=3 + i)[0] for i in range(k)])
    if not np.array_equal(fused, seq) or any(
            entry.loop is not None for entry in noisy._loops.values()):
        raise AssertionError("step_loop_unsafe: the eager K steps differ "
                             "from K runs, or a loop was captured")
    res = {"last_vs_eager": last_vs_eager, "last_spread": brief(spread),
           "memory": memory, "adopt_vs_eager": adopt,
           "adopt_spread": brief(spread_of(runs1)), "two_scopes": two_scopes,
           "unsafe_warning": said[0], "unsafe_equal": True}
    log("step_loop_last_and_unsafe", res)
    return res


def step_loop_feeder_phase(ctx):
    """23. ``DeviceFeeder(steps=4)`` drives two GPT dispatches from pinned
    memory on its own stream; from one state, the losses and state equal
    two numpy-fed dispatches', held to the spread of SPREAD_RUNS eager runs
    of the same 8 steps from that state."""
    exe, main, loss, k = (ctx[n] for n in ("exe", "main", "loss", "k"))
    names = persistables(main)
    feeder = fluid.DataFeeder(feed_list=["tokens", "targets"],
                              place=fluid.CUDAPlace(0), program=main)
    blocks = [gpt_stacked(TRAIN_BS, TRAIN_SEQ, k) for _ in range(2)]
    blocks[1] = {n: np.roll(v, 1, axis=0) for n, v in blocks[1].items()}

    def reader():
        for blk in blocks:
            for i in range(k):
                yield list(zip(blk["tokens"][i], blk["targets"][i]))

    s0 = snap(names)
    spread = spread_of(eager_runs(exe, main, loss, blocks, k, s0))
    restore(s0)
    fed = []
    for blk in fluid.DeviceFeeder(feeder, reader, steps=k):
        if blk["tokens"].device != feeder.place.device:
            raise AssertionError("DeviceFeeder: a block off the card")
        fed += dispatch(exe, main, loss, blk, k)
    s_fed = snap(names)
    restore(s0)
    ref = []
    for blk in blocks:
        ref += dispatch(exe, main, loss, blk, k)
    got = hold("step_loop_feeder", "the DeviceFeeder dispatches",
               distance(fed, s_fed, ref, snap(names)), spread)
    res = {"dispatches": len(blocks), "k": k, "feeder_losses": fed,
           "numpy_losses": ref, "feeder_vs_numpy": got,
           "spread_8_steps": brief(spread)}
    log("step_loop_feeder", res)
    return res


def step_loop_resnet50_phase(card_name, smi):
    """24. Fused ResNet-50 at the bench shape (bf16, batch 128, 224 x 224,
    Momentum(0.1, 0.9)), 2 steps a dispatch: parity as 21, launches of
    K11-K15 at capture, eager against replayed step ms."""
    k = STEP_LOOP_K["resnet50"]
    loss, main, startup = resnet_program(resnet_bench.DEPTH,
                                         resnet_bench.IMAGE,
                                         resnet_bench.DTYPE, resnet_bench.LR)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup)
    feeds = [resnet_bench.feed(seed=i) for i in range(k)]
    stacked = {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}
    res = {"card": card_name, "nvidia_smi": smi, "fused": True,
           "bs": resnet_bench.BS, "image": resnet_bench.IMAGE,
           "dtype": resnet_bench.DTYPE,
           **loop_parity("step_loop_resnet50", exe, main, loss, stacked, k,
                         RESNET_WANT[50]),
           **loop_timing(exe, main, loss, stacked, k, resnet_bench.BS)}
    res["img_s_eager"] = res.pop("eager_items_s")
    res["img_s_replay"] = res.pop("replay_items_s")
    log("step_loop_resnet50", res)
    exe.close()
    del exe
    fluid.reset()
    torch.cuda.empty_cache()
    return res


COOPERATIVE_PROBE = r"""
import json, torch
from paddle_tpu_torch.ops.cuda_kernels import lstm
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(0)
B, T, H = 64, 8, 512
def f(*shape, s):
    return (torch.randn(*shape, generator=g, device=dev) * s).bfloat16()
x, h0, c0, w = f(B, T, 4 * H, s=0.3), f(B, H, s=0.2), f(B, H, s=0.2), \
    f(H, 4 * H, s=0.05)
lengths = torch.full((B,), T, dtype=torch.int32, device=dev)
want = lstm.lstm_forward(x, h0, c0, w, lengths)
torch.cuda.synchronize()
res = {"kernel": "lstm_forward", "route": lstm.route(x), "B": B, "T": T,
       "H": H, "dtype": "bfloat16", "torch": torch.__version__,
       "cuda": torch.version.cuda}
graph = torch.cuda.CUDAGraph()
try:
    with torch.cuda.graph(graph):
        got = lstm.lstm_forward(x, h0, c0, w, lengths)
    graph.replay()
    torch.cuda.synchronize()
    res.update(captures=True,
               equal=all(torch.equal(a, b) for a, b in zip(got, want)))
except Exception as e:
    res.update(captures=False, error=f"{type(e).__name__}: {e}"[:600])
print(json.dumps(res))
"""


def cooperative_capture_probe():
    """Whether one cooperative launch (K7's persistent body,
    ``cudaLaunchCooperativeKernel``) captures into a CUDA graph on this
    toolkit: one call, in a process of its own so that a broken capture
    cannot touch this one.  A record for the next slice, not a check."""
    out = subprocess.run([sys.executable, "-c", COOPERATIVE_PROBE],
                         capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = out.stdout.strip().splitlines()
    res = json.loads(lines[-1]) if out.returncode == 0 and lines else {
        "captures": None, "returncode": out.returncode,
        "stderr": out.stderr[-600:]}
    log("step_loop_cooperative_probe", res)
    return res


# -- 25. summary --------------------------------------------------------------

def summary_row(name, source, replaces, row, by_dtype, launches, by_path):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "launches_by_path": by_path,
            "max_abs_err": row["max_abs_err"],
            "max_abs_err_by_dtype": by_dtype,
            "ms": row["kernel_ms"], "kernel_ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": {k: row[k] for k in row
                      if k in ("shape", "dtype", "B", "H", "T", "D", "N",
                               "nh", "C", "dh", "ps", "maxp",
                               "pool_pages", "causal", "lengths")}}


def errs_by_dtype(rows, key="max_abs_err"):
    out = {}
    for r in rows:
        out[r["dtype"]] = max(out.get(r["dtype"], 0.0), r[key])
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the "
              "card only", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name, smi = card()
    build()
    fl_rows, fl_sum = flash_phase(dev)
    pg_rows, pg_sum = paged_phase(dev)
    lm, prompts, tokens, arrays, fifo_row = serve_phase(dev, name, smi)
    scope_cpu = cpu_scope(lm, arrays)
    cpu_phase(lm, prompts, tokens, scope_cpu)
    mq_rows, mq_sum = mq_phase(dev)
    v2_row, v2p_row, v2_launch = v2_phase(lm, prompts, tokens, scope_cpu)
    spec_row, spec_launch = spec_phase(lm, prompts)
    tr_rows, tr_sum = train_kernel_phase(dev)
    parity = train_parity_phase()
    bench = train_bench_phase(name, smi)
    rnn_rows = recurrent_kernel_phase(dev)
    lstm_parity = lstm_parity_phase()
    lstm_bench, lstm_infer = lstm_bench_phase(name, smi)
    nmt_parity = nmt_parity_phase()
    nmt_bench = nmt_bench_phase(name, smi)
    bn_rows = bn_kernel_phase(dev)
    top_k_phase(dev)
    v1_v2 = v1_v2_times(bn_rows)
    r50_parity, r50_v2 = resnet50_parity_phase()
    r18_parity = resnet18_parity_phase()
    r50_fused, r50_fused_v2, r50_unfused = resnet_bench_phase(name, smi)
    sl_gpt, sl_ctx = step_loop_gpt_phase(name, smi)
    sl_last = step_loop_last_and_unsafe_phase(sl_ctx)
    sl_feeder = step_loop_feeder_phase(sl_ctx)
    sl_ctx["exe"].close()
    sl_ctx.clear()
    fluid.reset()
    torch.cuda.empty_cache()
    sl_r50 = step_loop_resnet50_phase(name, smi)
    coop = cooperative_capture_probe()
    by_path = {"fifo": fifo_row["launches"], "v2": v2_launch,
               "v2_prefix": v2p_row["launches"], "spec": spec_launch,
               "train_f32_per_step": parity["launches_per_step"],
               "train_bf16_10_steps": bench["launches"],
               "lstm_f32_per_step": lstm_parity["launches_per_step"],
               "lstm_bf16_10_steps": lstm_bench["launches"],
               "lstm_infer": lstm_infer["launches"],
               "nmt_f32_per_step": nmt_parity["launches_per_step"],
               "nmt_f32_10_steps": nmt_bench["launches"],
               "resnet50_f32_per_step": r50_parity["launches_per_step"],
               "resnet50_v2_f32_3_steps": r50_v2["launches"],
               "resnet18_f32_per_step": r18_parity["launches_per_step"],
               "resnet50_bf16_10_steps": r50_fused["launches"],
               "resnet50_v2_bf16_10_steps": r50_fused_v2["launches"],
               "resnet50_unfused_bf16_10_steps": r50_unfused["launches"]}
    csrc = "paddle_tpu_torch/ops/cuda_kernels/csrc/"
    pallas = "paddle_tpu/ops/pallas_kernels/"

    def paths(kernel):
        return {p: c[kernel] for p, c in by_path.items()}

    kernels = [
        {**summary_row("flash_attention", csrc + "flash_attention.cu",
                       pallas + "flash_attention.py:213", fl_sum,
                       errs_by_dtype(fl_rows),
                       fifo_row["launches"]["flash_attention"],
                       paths("flash_attention")),
         **{k: fl_sum[k] for k in ("design", "vs_library", "bound_share")}},
        summary_row("paged_attention", csrc + "paged_attention.cu",
                    pallas + "paged_attention.py:177", pg_sum,
                    errs_by_dtype(pg_rows),
                    fifo_row["launches"]["paged_attention"],
                    paths("paged_attention")),
        summary_row("paged_attention_mq", csrc + "paged_attention_mq.cu",
                    pallas + "paged_attention.py:284", mq_sum["mixed"],
                    errs_by_dtype(mq_rows),
                    v2_launch["paged_attention_mq"],
                    paths("paged_attention_mq")),
    ]
    # K2 and K3: every case and dtype, warm and cold, beside the bound
    for row, timed in ((kernels[1], pg_rows), (kernels[2], mq_rows)):
        row["design"] = {r["dtype"]: r["design"] for r in timed}
        row["cases"] = [{k: r[k] for k in (
            "case", "shape", "dtype", "kernel_ms", "kernel_cold_ms",
            "cold_pools", "plain_ms", "bound_ms", "bound_by",
            "bound_share", "bound_share_cold", "max_abs_err") if k in r}
            for r in timed]
    for kname, replaces, err_key in (
            ("flash_attention_fwd", "flash_attention.py:342", "max_abs_err"),
            ("flash_attention_dq", "flash_attention.py:235", "max_rel_err"),
            ("flash_attention_dkv", "flash_attention.py:286",
             "max_rel_err")):
        src = "flash_attention.cu" if kname == "flash_attention_fwd" \
            else "flash_attention_bwd.cu"
        row = summary_row(kname, csrc + src, pallas + replaces,
                          tr_sum[kname], errs_by_dtype(tr_rows[kname],
                                                       err_key),
                          bench["launches"][kname], paths(kname))
        row["max_err_by_dtype_is"] = err_key
        row.update({k: tr_sum[kname][k]
                    for k in ("design", "vs_library", "bound_share")})
        row["f32_bench_shape"] = {
            k: v for k, v in tr_rows[kname][0].items() if k in (
                "design", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "vs_library", "bound_share", "max_abs_err")}
        kernels.append(row)
    # K7-K10: the row of the dtype the main path runs (the LSTM bench in
    # bf16, the NMT bench in f32), the other dtype's numbers beside it
    for kname, replaces, main_dt, other_dt, run in (
            ("lstm_forward", "lstm.py:72", torch.bfloat16, torch.float32,
             lstm_bench),
            ("lstm_backward", "lstm.py:236", torch.bfloat16, torch.float32,
             lstm_bench),
            ("gru_forward", "gru.py:60", torch.float32, torch.bfloat16,
             nmt_bench),
            ("gru_backward", "gru.py:159", torch.float32, torch.bfloat16,
             nmt_bench)):
        err_key = "max_rel_err" if kname.endswith("backward") \
            else "max_abs_err"
        main_row = timed_row(rnn_rows[kname], main_dt)
        # the source is that of the body the timed row ran
        cell = kname.split("_")[0]
        steps_src = f"{cell}.cu"
        src = f"{cell}_persistent.cuh" if main_row["route"] == "persistent" \
            else steps_src
        row = summary_row(kname, csrc + src, pallas + replaces, main_row,
                          errs_by_dtype(rnn_rows[kname], err_key),
                          run["launches"][kname], paths(kname))
        row["max_err_by_dtype_is"] = err_key
        row["library_ms_is"] = NO_LIBRARY
        row["bound_ignores"] = "the dependence between the T steps"
        # "route" stays "cuda": the contract's word for the language; the
        # body and its device launches are the library's count
        row.update({"body": main_row["route"],
                    "device_launches": main_row["device_launches"],
                    "steps_route_source": csrc + steps_src})
        other = timed_row(rnn_rows[kname], other_dt)
        row["other_dtype_bench_shape"] = {
            k: other[k] for k in ("dtype", "kernel_ms", "plain_ms",
                                  "bound_ms", "bound_by", "max_abs_err")}
        kernels.append(row)
    # K11-K15: the bf16 row (the bench's dtype) at the timed shape, the
    # f32 row beside it; K14's launches are the v2 bench run's
    for kname, src, replaces in (
            ("bn_matmul_fwd", "bn_matmul.cu", "bn_matmul.py:161"),
            ("bn_matmul_bwd", "bn_matmul.cu", "bn_matmul.py:195"),
            ("bn_conv3x3_fwd", "bn_conv.cu", "bn_conv.py:352"),
            ("bn_conv3x3_fwd_v2", "bn_conv.cu", "bn_conv.py:181"),
            ("bn_conv3x3_bwd", "bn_conv.cu", "bn_conv.py:386")):
        err_key = "max_rel_err"
        run = r50_fused_v2 if kname == "bn_conv3x3_fwd_v2" else r50_fused
        main_row = timed_row(bn_rows[kname], torch.bfloat16)
        row = summary_row(kname, csrc + src, pallas + replaces, main_row,
                          errs_by_dtype(bn_rows[kname], err_key),
                          run["launches"][kname], paths(kname))
        row["max_err_by_dtype_is"] = err_key
        row["library_ms_is"] = BN_NO_LIBRARY
        row["design"] = main_row["design"]
        row["shape"] = {k: main_row[k] for k in (
            "dtype", "kind", "N", "H", "W", "K", "O", "stride", "residual")}
        other = timed_row(bn_rows[kname], torch.float32)
        row["other_dtype_bench_shape"] = {
            k: other[k] for k in ("dtype", "design", "kernel_ms", "plain_ms",
                                  "bound_ms", "bound_by",
                                  "bound_cuda_cores_ms", "max_abs_err")
            if k in other}
        if kname == "bn_conv3x3_fwd_v2":
            row["v1_vs_v2_by_shape"] = v1_v2
        kernels.append(row)
    kernels[2]["verify_shape"] = {
        k: mq_sum["verify"][k] for k in ("kernel_ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "max_abs_err")}
    serve_rows = [{k: r[k] for k in (
        "scheduler", "requests", "ttft_p50_ms", "prefill_tok_s",
        "decode_tok_s", "output_tok_s", "steps", "mixed_steps",
        "decode_steps", "spec_rounds", "launches")}
        for r in (fifo_row, v2_row, spec_row)]
    train_rows = [
        {"run": "parity_f32", **{k: parity[k] for k in (
            "bs", "seq", "gpu_losses", "cpu_losses", "loss_rel_err",
            "grad_rel_err_step1", "launches_per_step")}},
        {"run": "bench_bf16", **{k: bench[k] for k in (
            "bs", "seq", "losses", "step_ms", "tok_s", "peak_mem_gb",
            "launches_per_step")}}]
    parity_keys = ("bs", "seq", "gpu_losses", "cpu_losses", "loss_rel_err",
                   "grad_rel_err_step1", "launches_per_step")
    bench_keys = ("bs", "seq", "dtype", "losses", "step_ms", "seq_s",
                  "tok_s", "peak_mem_gb", "launches_per_step")
    train_rows += [
        {"run": "lstm_parity_f32", **{k: lstm_parity[k]
                                      for k in parity_keys}},
        {"run": "lstm_bench_bf16", **{k: lstm_bench[k] for k in bench_keys},
         "ragged_losses": lstm_bench["ragged_losses"]},
        {"run": "lstm_infer_bf16", **lstm_infer},
        {"run": "nmt_parity_f32", **{k: nmt_parity[k] for k in parity_keys}},
        {"run": "nmt_bench_f32", **{k: nmt_bench[k] for k in bench_keys}},
        {"run": "resnet50_parity_f32",
         **{k: r50_parity[k] for k in parity_keys if k != "seq"},
         "image": r50_parity["image"],
         "state_rel_err_max": r50_parity["state_rel_err_max"],
         "v2_loss_rel_err_vs_v1": r50_v2["loss_rel_err_vs_v1"],
         "v2_launches_per_step": r50_v2["launches_per_step"]},
        {"run": "resnet18_parity_f32",
         **{k: r18_parity[k] for k in parity_keys if k != "seq"},
         "image": r18_parity["image"],
         "state_rel_err_max": r18_parity["state_rel_err_max"]}]
    resnet_keys = ("fused", "bs", "image", "dtype", "losses", "step_ms",
                   "img_s", "peak_mem_gb", "launches_per_step")
    train_rows += [{"run": run, **{k: r[k] for k in resnet_keys}}
                   for run, r in (("resnet50_bench_bf16", r50_fused),
                                  ("resnet50_bench_bf16_v2", r50_fused_v2),
                                  ("resnet50_bench_bf16_unfused",
                                   r50_unfused))]
    loop_keys = ("k", "replay_vs_eager", "eager_spread",
                 "launches_at_capture", "eager_step_ms", "replay_step_ms",
                 "replay_speedup", "peak_mem_gb_eager", "peak_mem_gb_replay",
                 "reserved_gb", "pool_gb")
    step_loop_rows = [
        {"phase": "step_loop_gpt", "dtype": "bfloat16", "bs": TRAIN_BS,
         "seq": TRAIN_SEQ, **{k: sl_gpt[k] for k in loop_keys},
         "tok_s_eager": sl_gpt["tok_s_eager"],
         "tok_s_replay": sl_gpt["tok_s_replay"],
         "f32_parity": {k: sl_gpt["f32_parity"][k] for k in (
             "bs", "seq", "replay_vs_eager", "eager_spread",
             "launches_at_capture")}},
        {"phase": "step_loop_resnet50", "dtype": resnet_bench.DTYPE,
         "bs": resnet_bench.BS, **{k: sl_r50[k] for k in loop_keys},
         "img_s_eager": sl_r50["img_s_eager"],
         "img_s_replay": sl_r50["img_s_replay"]},
        {"phase": "step_loop_last_and_unsafe", **sl_last},
        {"phase": "step_loop_feeder", **{k: sl_feeder[k] for k in (
            "dispatches", "k", "feeder_vs_numpy", "spread_8_steps")}},
        {"phase": "step_loop_cooperative_probe", **coop}]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels, "serve": serve_rows,
                      "train": train_rows, "step_loop": step_loop_rows}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
