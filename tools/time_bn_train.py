"""Time the fused BatchNorm -> convolution kernels K11-K15 on one CUDA card.

Usage (repository root, on a machine with a CUDA card and nvcc):

    python3 tools/time_bn_train.py [--root DIR] [--dtype bfloat16|float32]

At every fused shape of ResNet-50's bench program (``chip_smoke.fused_shapes``:
batch 128, 224 x 224, read from the program's desc) it builds the kernels,
runs the forward (K11 for a 1x1, K13 and K14 for a 3x3) and the backward
(K12, K15) once on the same inputs as ``chip_smoke.bn_case`` makes them,
and holds each output against the plain version in float64 from the same
inputs: the distance (max |error| over max |value|, each tensor) of the
kernel and of the plain version in the kernel's dtype.  Two kernels that
differ only in the order of their sums are told apart there, not by their
distance to the plain version.  Then it times each kernel (CUDA events,
``chip_smoke.time_ms``) beside its bound (``chip_smoke.bn_bound``: each
input read once and each output written once at 3.35 TB/s, or the
products at the dtype's peak rate, whichever is longer) and prints one
JSON line with the card's name and power limit.  ``--root`` imports the
package and ``chip_smoke`` of another checkout instead of this one (a
parent commit unpacked with ``git archive``), so two designs are compared
on one card in one call: run parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

FWD_OUT = ("out",)
BWD_OUT = ("dx", "dgamma", "dbeta", "dmean", "dvar", "dw", "dr")


def f64_dist(cs, got, plain, want, names):
    """{name: {"kernel": d, "plain": d}} against float64, per output."""
    return {n: {"kernel": cs.rel_err(g, w), "plain": cs.rel_err(p, w)}
            for n, g, p, w in zip(names, got, plain, want)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.models import resnet_bench

    if not torch.cuda.is_available():
        print("time_bn_train: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dtype = getattr(torch, args.dtype)
    rows = []
    for shape in cs.fused_shapes(50, resnet_bench.BS, resnet_bench.IMAGE):
        kind, N, H, W, K, O, stride, has_r = shape
        a = cs.bn_case(dev, dtype, *shape)
        fwd, plain_fwd, bwd, plain_bwd = cs.bn_calls(kind, a, stride)
        x64 = cs.bn_calls(kind, cs.bn_double(a), stride)
        out, grads = fwd(), bwd()
        p_out, p_grads = plain_fwd(), plain_bwd()
        torch.cuda.synchronize()
        want_out, want_grads = x64[1](), x64[3]()
        row = {"kind": kind, "N": N, "H": H, "W": W, "K": K, "O": O,
               "stride": stride, "residual": has_r,
               "f64": {**f64_dist(cs, [out], [p_out], [want_out], FWD_OUT),
                       **f64_dist(cs, grads, p_grads, want_grads,
                                  BWD_OUT)}}
        del want_out, want_grads, p_out, p_grads, x64
        kernels = [("bn_matmul_fwd" if kind == "1x1" else "bn_conv3x3_fwd",
                    fwd, False),
                   ("bn_matmul_bwd" if kind == "1x1" else "bn_conv3x3_bwd",
                    bwd, True)]
        if kind == "3x3":
            kernels.append(("bn_conv3x3_fwd_v2",
                            cs.bn_calls(kind, a, stride, v2=True)[0], False))
        for name, fn, back in kernels:
            b_ms, b_by = cs.bn_bound(kind, a, O, back, dtype)
            ms = cs.time_ms(fn, iters=10)
            row[name] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                         "bound_share": b_ms / ms}
        rows.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
        del a, out, grads
    print(json.dumps({
        "root": os.path.abspath(args.root),
        "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(),
        "dtype": args.dtype, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
