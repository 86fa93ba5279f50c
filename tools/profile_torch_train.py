"""Where the port's training step goes, on one CUDA card.

Usage (repository root, on a machine with a CUDA card and nvcc):

    python3 tools/profile_torch_train.py \
        [--model gpt|lstm|seq2seq|resnet50|resnet50_unfused] [--steps 2] \
        [--trace train.json]

Builds one training program at its bench shape: ``gpt`` (the default) the
GPT training bench (``build_lm_train_program`` defaults: vocab 32000, dim
512, 8 layers, 8 heads, bf16, Adam 3e-4) at batch 8 x 1024 with
``bench.py``'s batch; ``lstm`` the stacked-LSTM classifier of
``models/rnn_bench.py`` (bf16, batch 64 x 96); ``seq2seq`` the
attention-NMT program there (f32, batch 64 x 64 + 64, ragged);
``resnet50`` the fused ResNet-50 bench of ``models/resnet_bench.py`` (bf16,
batch 128, 224 x 224, Momentum) and ``resnet50_unfused`` the same program
built without the BatchNorm -> conv fusion.  It runs 2
warm-up steps and times 5 unprofiled ones, then profiles ``--steps`` steps
under ``torch.profiler`` and prints one JSON line: the step's wall ms
(unprofiled and profiled), the device busy share of the profiled steps
(kernel intervals merged, over their host wall time, which the profiler
and the phase synchronizations inflate), device ms per step by kernel
group (the hand-written kernels K4-K15, GEMM, cuDNN convolutions, other
kernels, copies) and
by phase of the step (the forward ops, the backward ops — each
``generic_grad`` re-runs its forward op, so the forward phase's device
time is also the cost of that recompute — and the optimizer updates), each
phase's range ms per step (host work, or its kernels where they take
longer), and the kernels' launches per step.  The phases are profiler
ranges this tool puts around the executor's op walk.  The fused 3x3
forward is K13 unless ``PADDLE_TPU_BNCONV_VARIANT=v2`` (K14) is set, which
the line records.  The prep pass that K13, K14 and K15 each launch
(``bnc_pad_prep``) counts in the group of the kernel that called it: the
next ``bnc_`` kernel on the stream, which reads what it wrote.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import paddle_tpu_torch as fluid  # noqa: E402
from paddle_tpu_torch.autotune import knobs  # noqa: E402
from paddle_tpu_torch.framework.executor import Executor  # noqa: E402
from paddle_tpu_torch.models import (  # noqa: E402
    resnet_bench, rnn_bench, transformer)
from paddle_tpu_torch.ops.cuda_kernels import _common  # noqa: E402
from paddle_tpu_torch.ops.cuda_kernels import bn_conv as bnc  # noqa: E402
from paddle_tpu_torch.ops.cuda_kernels import bn_matmul as bnmm  # noqa: E402
from paddle_tpu_torch.ops.cuda_kernels import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.ops.cuda_kernels import gru as gru_k  # noqa: E402
from paddle_tpu_torch.ops.cuda_kernels import lstm as lstm_k  # noqa: E402
from tools.profile_torch_serve import _busy_us  # noqa: E402

BS, SEQ, VOCAB, SEED = 8, 1024, 32000, 0
PHASES = ("train.forward", "train.backward", "train.optimizer")
COUNTERS = {"K1": fa.flash_attention, "K4": fa.flash_attention_fwd,
            "K5": fa.flash_attention_dq, "K6": fa.flash_attention_dkv,
            "K7": lstm_k.lstm_forward, "K8": lstm_k.lstm_backward,
            "K9": gru_k.gru_forward, "K10": gru_k.gru_backward,
            "K11": bnmm.bn_matmul_fwd, "K12": bnmm.bn_matmul_bwd,
            "K13": bnc.bn_conv3x3_fwd, "K14": bnc.bn_conv3x3_fwd_v2,
            "K15": bnc.bn_conv3x3_bwd}


def _gpt():
    loss = transformer.build_lm_train_program(seq_len=SEQ)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, VOCAB, (BS, SEQ, 1)).astype(np.int64)
    return loss, {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}, \
        BS * SEQ


def _lstm():
    feed = rnn_bench.lstm_feed()
    return rnn_bench.lstm_train_program(), feed, \
        int(feed["words@LENGTH"].sum())


def _seq2seq():
    feed = rnn_bench.nmt_feed()
    return rnn_bench.nmt_train_program(), feed, \
        int(feed["src@LENGTH"].sum() + feed["tgt@LENGTH"].sum())


def _resnet(fuse):
    def build():
        loss, _ = resnet_bench.train_program(fuse_bn=fuse)
        return loss, resnet_bench.feed(), resnet_bench.BS
    return build


# model -> (function making (loss, feed, tokens or images per step),
# batch, length or image size, dtype)
MODELS = {"gpt": (_gpt, BS, SEQ, "bfloat16"),
          "lstm": (_lstm, rnn_bench.LSTM_BS, rnn_bench.LSTM_SEQ, "bfloat16"),
          "seq2seq": (_seq2seq, rnn_bench.NMT_BS, rnn_bench.NMT_SEQ,
                      "float32"),
          "resnet50": (_resnet(True), resnet_bench.BS, resnet_bench.IMAGE,
                       resnet_bench.DTYPE),
          "resnet50_unfused": (_resnet(False), resnet_bench.BS,
                               resnet_bench.IMAGE, resnet_bench.DTYPE)}


PREP = "the prep pass"


def _group(name: str, model: str) -> str:
    n = name.lower()
    # the forward's two bodies, flash_fwd_mma_kernel (bf16) and
    # flash_fwd_tf32_kernel (f32): the LSE instance is K4 (demangled
    # "..., true>", mangled "Lb1E"); K1, without LSE, must not run in
    # training
    if "flash_fwd_mma_kernel" in n or "flash_fwd_tf32_kernel" in n:
        lse = ", true>" in n or "lb1e" in n
        return "K4 flash_attention_fwd" if lse else "K1"
    # dQ and dK/dV: the bf16 bodies (mma) and the f32 ones (tf32)
    if "flash_dq_mma_kernel" in n or "flash_dq_tf32_kernel" in n:
        return "K5 flash_attention_dq"
    if "flash_dkv_mma_kernel" in n or "flash_dkv_tf32_kernel" in n:
        return "K6 flash_attention_dkv"
    # the LSTM's persistent bodies (one launch a call) and step bodies
    if "lstm_fwd_persistent" in n or "lstm_fwd_step" in n:
        return "K7 lstm_forward"
    if "lstm_bwd_persistent" in n:
        return "K8 lstm_backward (loop)"
    if "lstm_dw_mma" in n:
        return "K8 lstm_backward (dW)"
    if "lstm_bwd_" in n:
        return "K8 lstm_backward (steps)"
    # the GRU's persistent bodies (one launch a call) and step bodies,
    # whose gates kernel both directions launch
    if "gru_fwd_persistent" in n or "gru_fwd_cand" in n:
        return "K9 gru_forward"
    if "gru_bwd_persistent" in n:
        return "K10 gru_backward (loop)"
    if "gru_gates" in n:
        return "K9 and K10 (the step route's gates kernel)"
    if "gru_bwd_" in n:
        return "K10 gru_backward (steps)"
    if "bnc_pad_prep" in n:
        return PREP
    if "bnmm_fwd" in n:
        return "K11 bn_matmul_fwd"
    if "bnmm_bwd" in n:
        return "K12 bn_matmul_bwd"
    # the wide tap product: K14 in both dtypes, and f32 K13
    if "bnc_fwd_wide" in n and knobs.bnconv_variant() == "v2":
        return "K14 bn_conv3x3_fwd_v2"
    if "bnc_fwd" in n:
        return "K13 bn_conv3x3_fwd"
    if "bnc_bwd" in n:
        return "K15 bn_conv3x3_bwd"
    if "sum_splits" in n or "sum_tiles" in n:
        return "K12 and K15 (split and tile sums)"
    if model.startswith("resnet") and any(w in n for w in (
            "conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit")):
        return "cuDNN conv"
    if "rnn_dw_kernel" in n:
        # the weight-gradient product after the time loop
        return "K8 lstm_backward (dW)" if model == "lstm" \
            else "K10 gru_backward (dW)"
    if "memcpy" in n or "memset" in n:
        return "copies"
    if ("gemm" in n or "sm90_" in n or "cutlass" in n or "xmma" in n
            or "nvjet" in n):
        return "gemm"
    return "other kernels"


def _phase(op) -> str:
    if op.type.startswith("adam") or op.type == "momentum":
        return "train.optimizer"
    if op.type in ("generic_grad", "sum", "assign") or any(
            n.endswith("@GRAD") for n in op.output_names()):
        return "train.backward"
    return "train.forward"


class PhaseRanges:
    """One profiler range over each run of consecutive ops of one phase.
    The device is synchronized where the phase changes (three times a
    step), so every kernel runs inside the host range of the phase that
    launched it."""

    def __init__(self):
        self.phase, self.rf = None, None

    def enter(self, phase):
        if phase != self.phase:
            self.close()
            self.phase, self.rf = phase, record_function(phase)
            self.rf.__enter__()

    def close(self):
        if self.rf is not None:
            torch.cuda.synchronize()
            self.rf.__exit__(None, None, None)
        self.phase, self.rf = None, None

    def wrap(self, run_op):
        def run(op, env, ctx):
            self.enter(_phase(op))
            return run_op(op, env, ctx)
        return staticmethod(run)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=sorted(MODELS), default="gpt")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _common.load()
    build, bs, seq, dtype = MODELS[args.model]
    loss, feed, tokens = build()
    fluid.default_startup_program().random_seed = SEED
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(fluid.default_startup_program())

    ranges = PhaseRanges()

    def step():
        lv = exe.run(feed=feed, fetch_list=[loss])[0][0]
        ranges.close()
        return float(lv)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(5):
        step()
    wall_ms = (time.monotonic() - t0) / 5 * 1e3

    Executor._run_op = ranges.wrap(Executor._run_op)
    for f in COUNTERS.values():
        f.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall_prof_ms = (time.monotonic() - t0) / args.steps * 1e3
    launches = {k: f.launches / args.steps for k, f in COUNTERS.items()}

    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events
                   if e.name in PHASES and e.device_type == DeviceType.CPU)
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                      and e.name not in PHASES),
                     key=lambda e: e.time_range.start)
    groups, by_phase, names, intervals = {}, {}, {}, []
    for i, e in enumerate(kernels):
        ms = e.time_range.elapsed_us() / 1e3 / args.steps
        t = e.time_range.start
        intervals.append((t, e.time_range.end))
        phase = next((p for s, f, p in spans if s <= t <= f), "other")
        g = _group(e.name, args.model)
        if g == PREP:  # the group of its caller
            caller = next((k for k in kernels[i + 1:] if "bnc_" in k.name
                           and _group(k.name, args.model) != PREP), None)
            if caller is not None:
                g = _group(caller.name, args.model)
        groups[g] = groups.get(g, 0.0) + ms
        by_phase.setdefault(phase, {})
        by_phase[phase][g] = by_phase[phase].get(g, 0.0) + ms
        m, c = names.get(e.name, (0.0, 0))
        names[e.name] = (m + ms, c + 1)
    host_ms = {}
    for s0, f0, p in spans:
        host_ms[p] = host_ms.get(p, 0.0) + (f0 - s0) / 1e3 / args.steps
    window = max(f for _, f, _ in spans) - min(s for s, _, _ in spans)
    busy = _busy_us(intervals) / window if window else 0.0
    out = {"card": smi, "model": args.model,
           "bnconv_variant": knobs.bnconv_variant(),
           "bs": bs, "seq": seq,
           "dtype": dtype,
           ("images_per_step" if args.model.startswith("resnet")
            else "tokens_per_step"): tokens,
           "ops": len(fluid.default_main_program().global_block().ops),
           "step_ms_unprofiled": wall_ms,
           "step_ms_profiled": wall_prof_ms,
           ("img_s_unprofiled" if args.model.startswith("resnet")
            else "tok_s_unprofiled"): tokens / (wall_ms / 1e3),
           "device_busy_share_profiled": busy,
           "device_ms_per_step_by_group": dict(sorted(groups.items())),
           # a phase's range ends after a synchronize: its host ms is the
           # longer of its host work and its kernels
           "range_ms_per_step_by_phase": dict(sorted(host_ms.items())),
           "device_ms_per_step_by_phase": {
               p: {"total": sum(g.values()), **dict(sorted(g.items()))}
               for p, g in sorted(by_phase.items())},
           "launches_per_step": launches,
           "top_kernels": [
               {"name": n[:120], "ms_per_step": ms,
                "count_per_step": c / args.steps}
               for n, (ms, c) in sorted(names.items(),
                                        key=lambda kv: -kv[1][0])[:15]],
           "kernels_per_step": len(intervals) / args.steps}
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
