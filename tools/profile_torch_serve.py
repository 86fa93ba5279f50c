"""Where the port's fifo serving time goes, on one CUDA card.

Usage (repository root, on a machine with a CUDA card and nvcc):

    python3 tools/profile_torch_serve.py [--trace serve_trace.json]

Builds the full-width GPT bench model and the 16 requests that
``chip_smoke.py`` serves (``paddle_tpu_torch.models.gpt_bench``), serves
them once to warm up, then serves them again under ``torch.profiler`` and
prints one JSON line: the engine's prefill and decode seconds, the device
time of each kernel group (the port's two kernels, GEMMs, everything
else, host-device copies) per phase, and the device busy share of the
profiled window (kernel intervals merged, over the window's host wall
time, which the profiler itself inflates).  The phases are the engine's
own profiler ranges, ``serve.prefill`` and ``serve.decode``.  The chrome
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


def _group(name: str) -> str:
    n = name.lower()
    if "flash_fwd_kernel" in n:
        return "flash_attention (K1)"
    if "paged_attn_kernel" in n:
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


def _serve(lm, prompts):
    """Serve `prompts` on a fresh fifo engine on the card; returns the
    engine and the wall seconds."""
    eng = ServingEngine(lm, max_batch_size=SLOTS, page_size=PAGE,
                        place=fluid.CUDAPlace(0))
    t0 = time.monotonic()
    for p in prompts:
        eng.submit(p, MAX_NEW, arrival=t0)
    eng.run()
    return eng, time.monotonic() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)
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
    prompts = gpt_bench.prompts(N_REQ, seed=SEED)
    _serve(lm, prompts)  # warm-up
    eng_plain, wall_plain = _serve(lm, prompts)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        _serve(lm, prompts)
        torch.cuda.synchronize()
        wall_prof = time.monotonic() - t0

    events = prof.events()
    marks = ("serve.prefill", "serve.decode")
    phases = [(e.name, e.time_range.start, e.time_range.end) for e in events
              if e.name in marks and e.device_type == DeviceType.CPU]
    groups, names, intervals, by_phase = {}, {}, [], {}
    for e in events:
        # the profiler mirrors each host mark as a device-side annotation
        # spanning the phase: not a kernel
        if e.device_type != DeviceType.CUDA or e.name in marks:
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
        for m in marks if any(p == m for p, _, _ in phases)}
    st = eng_plain.stats()
    out = {"card": smi, "wall_s_unprofiled": wall_plain,
           "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
           "prefill_runs": st["prefill_runs"],
           "decode_steps": st["decode_steps"],
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
