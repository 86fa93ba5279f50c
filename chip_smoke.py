"""Drive paddle_tpu_torch on one CUDA card and check it end to end.

Usage (from the repository root, on a machine with an NVIDIA H100 and
nvcc):

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught; any error exits
non-zero and no result line is printed):

1. the card: name, power limit, TF32 off for float32 matmuls;
2. build: the hand-written CUDA kernels are compiled from
   ``paddle_tpu_torch/ops/cuda_kernels/csrc`` with nvcc for sm_90a;
3. kernels: each kernel against its plain PyTorch version on the card,
   in float32 and bfloat16, at the serving path's shapes, timed beside
   the plain version, the bound of the card and (flash only) PyTorch's
   scaled_dot_product_attention as a yardstick the port never calls;
4. serve: the full-width GPT bench model (vocab 32000, dim 512, 8 layers,
   8 heads, max_len 1024, float32, random weights from a seed) behind the
   fifo ServingEngine (8 slots, page 16) answers 16 requests; every
   request must finish, no page may leak, and the kernels' launch counts
   must equal 8 layers x the prefill runs and decode steps the engine ran;
5. the same weights and requests through an explicit-CPU engine, which
   takes the kernels' plain versions: tokens must agree, except at most
   one request that may part at a near tie (CPU top-2 logits within
   1e-3).

The second-to-last line is the ``{"kernels": [...]}`` summary and the last
line is ``{"ok": true, "device": {...}}``.  Without CUDA the script
exits 2 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

import paddle_tpu_torch as fluid
from paddle_tpu_torch.models import gpt_bench
from paddle_tpu_torch.models.gpt_bench import DIM, HEADS, LAYERS, MAX_LEN
from paddle_tpu_torch.ops.cuda_kernels import _common
from paddle_tpu_torch.ops.cuda_kernels import flash_attention as fa
from paddle_tpu_torch.ops.cuda_kernels import paged_attention as pa
from paddle_tpu_torch.ops.transformer_ops import _lm_fns
from paddle_tpu_torch.serving import ServingEngine, pages_needed

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12,   # CUDA cores: the kernels' FMA loops
              torch.bfloat16: 989e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = (torch.float32, torch.bfloat16)

# the serving model is gpt_bench's: bench.py's GPT config at _gpt_heads(512)
SLOTS, PAGE, N_REQ, MAX_NEW = 8, 16, 16, 32
NUM_PAGES = SLOTS * pages_needed(MAX_LEN, PAGE) + 1
SEED = 0


def log(tag, obj):
    print(f"{tag} {json.dumps(obj)}", flush=True)


def time_ms(fn, iters=20):
    """Mean device time of one call, from CUDA events over `iters` calls
    after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


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
                b_ms, b_by = bound(nbytes, flops, dtype)
                row = {
                    "dtype": str(dtype).split(".")[1], "B": B, "H": H,
                    "T": T, "D": D, "max_abs_err": err,
                    "kernel_ms": time_ms(
                        lambda: fa.flash_attention(q, k, v, causal=True)),
                    "plain_ms": time_ms(
                        lambda: fa.flash_attention_ref(q, k, v,
                                                       causal=True)),
                    "library_ms": time_ms(
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, is_causal=True)),
                    "bound_ms": b_ms, "bound_by": b_by}
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


def paged_phase(dev):
    """K2 at the engine's decode shape: N 8, nh 8, dh 64, ps 16, maxp 64,
    the engine's 513-page pool, ragged ctx_lens with 1, partial pages and
    1024; unused slots poisoned."""
    N, nh, dh = SLOTS, HEADS, DIM // HEADS
    maxp = pages_needed(MAX_LEN, PAGE)
    ctx = [1, 17, 1024, 300, 64, 999, 5, 512]
    rng = np.random.RandomState(SEED)
    pt = np.zeros((N, maxp), np.int32)
    perm = iter(rng.permutation(np.arange(1, NUM_PAGES)))
    for n, L in enumerate(ctx):
        for j in range(pages_needed(L, PAGE)):
            pt[n, j] = next(perm)
    pt_t = torch.from_numpy(pt)
    cl_t = torch.tensor(ctx, dtype=torch.int32)
    rows, summary = [], None
    for dtype in DTYPES:
        g = torch.Generator(device=dev).manual_seed(SEED + 1)
        q = torch.randn(N, nh, dh, generator=g, device=dev).to(dtype)
        kp, vp = (torch.randn(NUM_PAGES, nh, PAGE, dh, generator=g,
                              device=dev).to(dtype) for _ in range(2))
        kp, vp = _poison_unseen(kp, vp, pt_t, cl_t, PAGE)
        pt_d, cl_d = pt_t.to(dev), cl_t.to(dev)
        out = pa.paged_attention(q, kp, vp, pt_d, cl_d)
        torch.cuda.synchronize()
        ref = pa.paged_attention_ref(q, kp, vp, pt_d, cl_d)
        err = max_err(out, ref)
        if not torch.isfinite(out.float()).all():
            raise AssertionError("paged_attention read a poisoned slot")
        itemsize = q.element_size()
        kv = sum(ctx) * nh * dh * 2 * itemsize
        table = sum(pages_needed(L, PAGE) for L in ctx) * 4 + N * 4
        nbytes = kv + 2 * q.numel() * itemsize + table
        flops = 4 * sum(ctx) * nh * dh
        b_ms, b_by = bound(nbytes, flops, dtype)
        row = {"dtype": str(dtype).split(".")[1], "N": N, "nh": nh,
               "dh": dh, "ps": PAGE, "maxp": maxp, "pool_pages": NUM_PAGES,
               "ctx_lens": ctx, "max_abs_err": err,
               "kernel_ms": time_ms(
                   lambda: pa.paged_attention(q, kp, vp, pt_d, cl_d),
                   iters=100),
               "plain_ms": time_ms(
                   lambda: pa.paged_attention_ref(q, kp, vp, pt_d, cl_d)),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        log("paged_attention", row)
        if err > TOL[dtype]:
            raise AssertionError(
                f"paged_attention disagrees with its plain version: {row} "
                f"(tolerance {TOL[dtype]})")
        if dtype == torch.float32:
            summary = row
    return rows, summary


# -- 4. serve -----------------------------------------------------------------

def serve(lm, prompts, place):
    """Serve `prompts` on a fresh fifo engine over the global scope's
    parameters; returns (tokens per request, requests, engine, wall
    seconds)."""
    eng = ServingEngine(lm, max_batch_size=SLOTS, page_size=PAGE,
                        place=place)
    t0 = time.monotonic()
    rids = [eng.submit(p, MAX_NEW, arrival=t0) for p in prompts]
    fin = eng.run()
    wall = time.monotonic() - t0
    if sorted(fin) != sorted(rids):
        raise AssertionError("not every request finished")
    if any(len(fin[r].generated) != MAX_NEW for r in rids):
        raise AssertionError("a request finished short of max_new")
    if eng.cache.allocator.available() != eng.num_pages - 1:
        raise AssertionError(f"page leak: {eng.stats()['page_stats']}")
    return [fin[r].generated for r in rids], [fin[r] for r in rids], eng, wall


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
    fa.flash_attention.launches = 0
    pa.paged_attention.launches = 0
    tokens, reqs, eng, wall = serve(lm, prompts, fluid.CUDAPlace(0))
    launches = {"flash_attention": fa.flash_attention.launches,
                "paged_attention": pa.paged_attention.launches}
    st = eng.stats()
    want = {"flash_attention": LAYERS * st["prefill_runs"],
            "paged_attention": LAYERS * st["decode_steps"]}
    if launches != want or min(launches.values()) == 0:
        raise AssertionError(f"kernel launches {launches} != 8 layers x "
                             f"engine runs {want}")
    buckets = sorted(eng._prefill_progs)
    if not {256, 512, 1024} <= set(buckets):
        raise AssertionError(f"prefill buckets {buckets} miss 256/512/1024")
    ttft = sorted(r.first_token_t - r.arrival for r in reqs)
    decoded = sum(len(t) - 1 for t in tokens)
    res = {"card": card_name, "nvidia_smi": smi, "requests": N_REQ,
           "params": n_params, "startup_s": startup_s,
           "prompt_lens": [len(p) for p in prompts], "max_new": MAX_NEW,
           "prefill_buckets": buckets, "wall_s": wall,
           "ttft_p50_ms": float(np.median(ttft)) * 1e3,
           "ttft_max_ms": ttft[-1] * 1e3,
           "prefill_tok_s": st["prefill_computed"] / st["prefill_s"],
           "decode_tok_s": decoded / st["decode_s"],
           "prefill_runs": st["prefill_runs"],
           "decode_steps": st["decode_steps"],
           "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
           "launches": launches,
           "launches_per_request": {k: v / N_REQ
                                    for k, v in launches.items()},
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log("serve", res)
    arrays = [scope.find_np(p.name) for p in lm._params]
    return lm, prompts, tokens, arrays, launches


# -- 5. the same weights on the CPU -------------------------------------------

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


def cpu_phase(lm, prompts, gpu_tokens, arrays):
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        lm.load_params(arrays, scope)
        t0 = time.monotonic()
        cpu_tokens, _, _, _ = serve(lm, prompts, fluid.CPUPlace())
        cpu_s = time.monotonic() - t0
    parted = []
    for i, (g, c) in enumerate(zip(gpu_tokens, cpu_tokens)):
        if g == c:
            continue
        j = next(j for j, (a, b) in enumerate(zip(g, c)) if a != b)
        gap = cpu_top2_gap(lm, scope, prompts[i] + c[:j])
        parted.append({"request": i, "position": j, "gpu": g[j],
                       "cpu": c[j], "cpu_top2_gap": gap})
    res = {"cpu_s": cpu_s, "identical": N_REQ - len(parted),
           "parted": parted}
    log("cpu_agreement", res)
    if len(parted) > 1 or any(p["cpu_top2_gap"] > 1e-3 for p in parted):
        raise AssertionError(f"card and CPU tokens disagree: {parted}")


# -- summary ------------------------------------------------------------------

def summary_row(name, source, replaces, row, by_dtype, launches):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"],
            "max_abs_err_by_dtype": by_dtype,
            "ms": row["kernel_ms"], "kernel_ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": {k: row[k] for k in row
                      if k in ("dtype", "B", "H", "T", "D", "N", "nh", "dh",
                               "ps", "maxp", "pool_pages")}}


def errs_by_dtype(rows):
    out = {}
    for r in rows:
        out[r["dtype"]] = max(out.get(r["dtype"], 0.0), r["max_abs_err"])
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
    lm, prompts, tokens, arrays, launches = serve_phase(dev, name, smi)
    cpu_phase(lm, prompts, tokens, arrays)
    kernels = [
        summary_row("flash_attention", "paddle_tpu_torch/ops/cuda_kernels/"
                    "csrc/flash_attention.cu",
                    "paddle_tpu/ops/pallas_kernels/flash_attention.py:213",
                    fl_sum, errs_by_dtype(fl_rows),
                    launches["flash_attention"]),
        summary_row("paged_attention", "paddle_tpu_torch/ops/cuda_kernels/"
                    "csrc/paged_attention.cu",
                    "paddle_tpu/ops/pallas_kernels/paged_attention.py:177",
                    pg_sum, errs_by_dtype(pg_rows),
                    launches["paged_attention"]),
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
