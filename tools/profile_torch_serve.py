"""Where the port's serving time goes, on one CUDA card.

Usage (repository root, on a machine with a CUDA card and nvcc):

    python3 tools/profile_torch_serve.py [--scheduler fifo|v2|spec]
                                         [--trace serve_trace.json]

Builds the full-width GPT bench model and the 16 requests that
``chip_smoke.py`` serves (``paddle_tpu_torch.models.gpt_bench``), serves
them once to warm up with the chosen scheduler (v2 and spec: chunk 32, 4
lanes; spec: k 4, a 1-layer draft, on weights whose later layers are
damped as ``chip_smoke.py`` damps them), then serves them again under
``torch.profiler`` and prints one JSON line: the engine's counters and
seconds per kind of run, the device time of each kernel group (the
port's three kernels, GEMMs, everything else, host-device copies) per
phase, and the device busy share of the profiled window (kernel
intervals merged, over the window's host wall time, which the profiler
itself inflates).  The phases are the engine's own profiler ranges
(``serve.prefill``, ``serve.decode``, ``serve.mixed_step``,
``serve.cow_copy``, ``serve.draft``, ``serve.verify``).  The chrome
trace goes to ``--trace`` when given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import paddle_tpu_torch as fluid  # noqa: E402
from paddle_tpu_torch.models import gpt_bench  # noqa: E402
from paddle_tpu_torch.ops.cuda_kernels import _common  # noqa: E402
from paddle_tpu_torch.serving import ServingEngine  # noqa: E402

SLOTS, PAGE, N_REQ, MAX_NEW, SEED = 8, 16, 16, 32, 0
MARKS = ("serve.prefill", "serve.decode", "serve.mixed_step", "serve.cow_copy",
         "serve.draft", "serve.verify")
ENGINE_KW = {"fifo": {},
             "v2": {"scheduler": "v2", "chunk_size": 32, "chunk_lanes": 4},
             "spec": {"scheduler": "spec", "chunk_size": 32,
                      "chunk_lanes": 4, "spec_k": 4, "spec_draft_layers": 1}}


def _group(name: str) -> str:
    n = name.lower()
    # the forward's bodies: flash_fwd_tf32_kernel (f32, the serve's
    # dtype) and flash_fwd_mma_kernel (bf16)
    if "flash_fwd_tf32_kernel" in n or "flash_fwd_mma_kernel" in n:
        return "flash_attention (K1)"
    # the split walks and their combines: paged_attn_mq_split_kernel,
    # paged_attn_mq_combine_kernel (K3); paged_attn_split_kernel,
    # paged_attn_combine_kernel (K2)
    if "paged_attn_mq" in n:
        return "paged_attention_mq (K3)"
    if "paged_attn" in n:
        return "paged_attention (K2)"
    if "memcpy" in n or "memset" in n:
        return "copies"
    if "gemm" in n or "sm90_" in n or "cutlass" in n or "xmma" in n:
        return "gemm"
    return "other kernels"


def _busy_us(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _serve(lm, prompts, kw):
    """Serve `prompts` on a fresh engine on the card; returns the engine
    and the wall seconds."""
    eng = ServingEngine(lm, max_batch_size=SLOTS, page_size=PAGE,
                        place=fluid.CUDAPlace(0), **kw)
    t0 = time.monotonic()
    for p in prompts:
        eng.submit(p, MAX_NEW, arrival=t0)
    eng.run()
    return eng, time.monotonic() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scheduler", choices=sorted(ENGINE_KW),
                    default="fifo")
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)
    kw = ENGINE_KW[args.scheduler]
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _common.load()
    lm = gpt_bench.build(fluid.CUDAPlace(0), seed=SEED)
    if args.scheduler == "spec":
        gpt_bench.damp_tail_layers(lm, fluid.global_scope(), 1, scale=0.01)
    prompts = gpt_bench.prompts(N_REQ, seed=SEED)
    _serve(lm, prompts, kw)  # warm-up
    eng_plain, wall_plain = _serve(lm, prompts, kw)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        _serve(lm, prompts, kw)
        torch.cuda.synchronize()
        wall_prof = time.monotonic() - t0

    events = prof.events()
    phases = [(e.name, e.time_range.start, e.time_range.end) for e in events
              if e.name in MARKS and e.device_type == DeviceType.CPU]
    groups, names, intervals, by_phase = {}, {}, [], {}
    for e in events:
        # the profiler mirrors each host mark as a device-side annotation
        # spanning the phase: not a kernel
        if e.device_type != DeviceType.CUDA or e.name in MARKS:
            continue
        us = e.time_range.elapsed_us()
        intervals.append((e.time_range.start, e.time_range.end))
        # each phase ends by fetching its tokens to the host, which waits
        # for its kernels: a kernel that starts inside a phase's host
        # interval belongs to that phase
        t = e.time_range.start
        phase = next((p for p, s, f in phases if s <= t <= f), "other")
        by_phase.setdefault(phase, []).append(
            (e.time_range.start, e.time_range.end))
        key = f"{phase}/{_group(e.name)}"
        groups[key] = groups.get(key, 0.0) + us / 1e3
        ms, n = names.get((phase, e.name), (0.0, 0))
        names[(phase, e.name)] = (ms + us / 1e3, n + 1)
    window_us = max(f for _, _, f in phases) - min(s for _, s, _ in phases)
    busy = _busy_us(intervals) / window_us if window_us else 0.0
    busy_by_phase = {
        m: _busy_us(by_phase.get(m, [])) / sum(
            f - s for p, s, f in phases if p == m)
        for m in MARKS if any(p == m for p, _, _ in phases)}
    st = eng_plain.stats()
    out = {"card": smi, "scheduler": args.scheduler,
           "wall_s_unprofiled": wall_plain,
           **{k: st[k] for k in (
               "prefill_s", "decode_s", "mixed_s", "draft_s", "verify_s",
               "prefill_runs", "decode_steps", "mixed_steps", "spec_rounds",
               "draft_runs", "prefill_computed", "spec_drafted",
               "spec_accepted")},
           "wall_s_profiled": wall_prof,
           "device_ms_by_phase_and_group": dict(sorted(groups.items())),
           "device_busy_share_profiled": busy,
           "device_busy_share_by_phase_profiled": busy_by_phase,
           "top_kernels": [
               {"phase": p, "name": n[:120], "ms": ms, "count": c}
               for (p, n), (ms, c) in sorted(
                   names.items(), key=lambda kv: -kv[1][0])[:15]],
           "kernel_launches_profiled": len(intervals)}
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
