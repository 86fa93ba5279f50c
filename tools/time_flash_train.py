"""Time the flash attention kernels K1 and K4-K6 on one CUDA card.

Usage (repository root, on a machine with a CUDA card and nvcc):

    python3 tools/time_flash_train.py [--root DIR] [--dtype bfloat16|float32]
        [--shape 8,8,1024,64] [--k1-shape 4,8,1024,64] [--non-causal]

At the GPT training bench shape ([B, H, T, D] = [8, 8, 1024, 64], causal,
bf16 unless ``--dtype float32``) it builds the kernels, runs K4 (flash
forward with logsumexp), K5 (dQ) and K6 (dK, dV) once against their plain
versions on the same inputs (out and lse absolutely, the gradients
relative to each tensor's max |value|) and against the functions in
float64 (the forward's out; the backward's P, dP and dS in float64, dS
rounded to the input dtype where the reference rounds it): the plain
version sums each output in one sequential chain, as a straightforward
kernel does, so two kernels that differ only in summation order are told
apart by their distance to float64, not by their distance to the plain
version.  K1 (the serving forward, no logsumexp) runs at the serving
prefill shape (``--k1-shape``, [4, 8, 1024, 64]) against its plain version
and float64.  Then it times each (CUDA events, ``chip_smoke.time_ms``)
beside PyTorch's scaled_dot_product_attention forward and backward, and
prints one JSON line with the card's name and power limit.  ``--root``
imports the package and ``chip_smoke`` of another checkout instead of this
one (a parent commit unpacked with ``git archive``), so two designs are
compared on one card in one call: run parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def bwd_float64(q, k, v, do, lse, delta, causal, scale):
    """(dq, dk, dv) of the flash backward in float64 from the saved lse and
    delta; dS is rounded to Q's dtype before dS K and dS^T Q."""
    import torch

    B, H, T, _ = q.shape
    qd, kd, vd, dod = (t.double() for t in (q, k, v, do))
    s = qd @ kd.transpose(-1, -2) * scale
    if causal:
        keep = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - lse.double().reshape(B, H, T, 1))
    dp = dod @ vd.transpose(-1, -2)
    ds = (p * (dp - delta.double().reshape(B, H, T, 1)) * scale)
    ds = ds.to(q.dtype).double()
    return ds @ kd, ds.transpose(-1, -2) @ qd, p.transpose(-1, -2) @ dod


def fwd_float64(q, k, v, causal, scale):
    """The attention forward in float64: softmax(Q K^T scale) V."""
    import torch

    T = q.shape[2]
    s = q.double() @ k.double().transpose(-1, -2) * scale
    if causal:
        keep = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return torch.softmax(s, dim=-1) @ v.double()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--shape", default="8,8,1024,64")
    ap.add_argument("--k1-shape", default="4,8,1024,64")
    ap.add_argument("--non-causal", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from paddle_tpu_torch.ops.cuda_kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("time_flash_train: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dtype = getattr(torch, args.dtype)
    B, H, T, D = (int(x) for x in args.shape.split(","))
    causal = not args.non_causal
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = (torch.randn(B, H, T, D, generator=g, device=dev)
                   .to(dtype) for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    r_out, r_lse = fa.flash_attention_fwd_ref(q, k, v, causal=causal)
    delta = (r_out.float() * do.float()).sum(-1).reshape(B * H, T)
    bwd = (q, k, v, do, r_lse, delta)
    dq = fa.flash_attention_dq(*bwd, causal=causal)
    dk, dv = fa.flash_attention_dkv(*bwd, causal=causal)
    r_dk, r_dv = fa.flash_attention_dkv_ref(*bwd, causal=causal)
    r_dq = fa.flash_attention_dq_ref(*bwd, causal=causal)
    x_dq, x_dk, x_dv = bwd_float64(*bwd, causal, 1.0 / D ** 0.5)
    x_out = fwd_float64(q, k, v, causal, 1.0 / D ** 0.5)
    k1_shape = tuple(int(x) for x in args.k1_shape.split(","))
    q1, k1, v1 = (torch.randn(*k1_shape, generator=g, device=dev).to(dtype)
                  for _ in range(3))
    out1 = fa.flash_attention(q1, k1, v1, causal=causal)
    r_out1 = fa.flash_attention_ref(q1, k1, v1, causal=causal)
    x_out1 = fwd_float64(q1, k1, v1, causal, 1.0 / k1_shape[3] ** 0.5)
    torch.cuda.synchronize()
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    row = {
        "root": os.path.abspath(args.root),
        "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(),
        "dtype": args.dtype, "B": B, "H": H, "T": T, "D": D,
        "causal": causal, "k1_shape": list(k1_shape),
        "k1_max_abs_err": cs.max_err(out1, r_out1),
        "fwd_out_max_abs_err": cs.max_err(out, r_out),
        "fwd_lse_max_abs_err": cs.max_err(lse, r_lse),
        "dq_max_rel_err": cs.rel_err(dq, r_dq),
        "dk_max_rel_err": cs.rel_err(dk, r_dk),
        "dv_max_rel_err": cs.rel_err(dv, r_dv),
        "f64": {name: {"kernel": cs.rel_err(got, x),
                       "plain": cs.rel_err(plain, x)}
                for name, got, plain, x in (("k1_out", out1, r_out1, x_out1),
                                            ("out", out, r_out, x_out),
                                            ("dq", dq, r_dq, x_dq),
                                            ("dk", dk, r_dk, x_dk),
                                            ("dv", dv, r_dv, x_dv))},
        "k1_ms": cs.time_ms(
            lambda: fa.flash_attention(q1, k1, v1, causal=causal), 50),
        "sdpa_k1_ms": cs.time_ms(lambda: F.scaled_dot_product_attention(
            q1, k1, v1, is_causal=causal), 50),
        "fwd_ms": cs.time_ms(
            lambda: fa.flash_attention_fwd(q, k, v, causal=causal), 50),
        "dq_ms": cs.time_ms(lambda: fa.flash_attention_dq(
            *bwd, causal=causal), 50),
        "dkv_ms": cs.time_ms(lambda: fa.flash_attention_dkv(
            *bwd, causal=causal), 50),
        "sdpa_fwd_ms": cs.time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), 50),
        "sdpa_bwd_ms": cs.time_ms(lambda: torch.autograd.grad(
            lib_out, leaves, do, retain_graph=True), 20),
    }
    row["k1_vs_sdpa"] = row["k1_ms"] / row["sdpa_k1_ms"]
    row["fwd_vs_sdpa"] = row["fwd_ms"] / row["sdpa_fwd_ms"]
    row["dq_vs_sdpa_bwd"] = row["dq_ms"] / row["sdpa_bwd_ms"]
    row["dkv_vs_sdpa_bwd"] = row["dkv_ms"] / row["sdpa_bwd_ms"]
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
