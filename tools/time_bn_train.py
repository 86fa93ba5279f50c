"""Time the fused BatchNorm -> convolution kernels K11-K15 on one CUDA card.

Usage (repository root, on a machine with a CUDA card and nvcc):

    python3 tools/time_bn_train.py [--root DIR] [--dtype bfloat16|float32]
                                   [--kernels NAME,...]

At every fused shape of ResNet-50's bench program (``chip_smoke.fused_shapes``:
batch 128, 224 x 224, read from the program's desc) it builds the kernels,
runs the forward (K11 for a 1x1, K13 and K14 for a 3x3) and the backward
(K12, K15) once on the same inputs as ``chip_smoke.bn_case`` makes them,
and holds each output against the plain version in float64 from the same
inputs (f32 inputs moved clear of the ReLU's kink, ``chip_smoke.
bn_clear_of_kinks``): the distance (max |error| over max |value|, each
tensor) of the kernel and of the plain version in the kernel's dtype
(K14's output as ``out_v2``, and whether it has K13's bits).  Two kernels that differ only
in the order of their sums are told apart there, not by their distance to
the plain version.  Then it times each kernel (CUDA events,
``chip_smoke.time_ms``) beside its bound (``chip_smoke.bn_bound``: each
input read once and each output written once at 3.35 TB/s, or the
products at the body's peak rate, whichever is longer), and the plain
forward at each 3x3 shape, and prints one JSON line with the card's name
and power limit.  ``--root`` imports the package and ``chip_smoke`` of
another checkout instead of this one (a parent commit unpacked with
``git archive``), so two designs are compared on one card in one call:
run parent, change, change, parent.  ``--kernels`` times only the named
kernels, at the shapes that run them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

KIND_KERNELS = {"1x1": ("bn_matmul_fwd", "bn_matmul_bwd"),
                "3x3": ("bn_conv3x3_fwd", "bn_conv3x3_bwd",
                        "bn_conv3x3_fwd_v2")}
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
    ap.add_argument("--kernels", default="",
                    help="comma-separated kernel names to time (default "
                    "all); a shape without one of them is skipped")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.models import resnet_bench
    from paddle_tpu_torch.ops.cuda_kernels import bn_conv as bnc

    if not torch.cuda.is_available():
        print("time_bn_train: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dtype = getattr(torch, args.dtype)
    rows = []
    only = set(filter(None, args.kernels.split(",")))
    for shape in cs.fused_shapes(50, resnet_bench.BS, resnet_bench.IMAGE):
        kind, N, H, W, K, O, stride, has_r = shape
        if only and not only & set(KIND_KERNELS[kind]):
            continue
        a = cs.bn_case(dev, dtype, *shape)
        if dtype == torch.float32:
            # as the smoke: no f32 ReLU input within 1e-3 of the kink,
            # where f32 and float64 may take different masks
            a = cs.bn_clear_of_kinks(a)
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
        if kind == "3x3":
            out_v2 = cs.bn_calls(kind, a, stride, v2=True)[0]()
            torch.cuda.synchronize()
            row["f64"].update(f64_dist(cs, [out_v2], [p_out], [want_out],
                                       ("out_v2",)))
            row["v2_equals_v1"] = torch.equal(out_v2, out)
            row["plain_fwd_ms"] = cs.time_ms(plain_fwd, iters=5)
            del out_v2
        del want_out, want_grads, p_out, p_grads, x64
        kernels = [("bn_matmul_fwd" if kind == "1x1" else "bn_conv3x3_fwd",
                    fwd, False),
                   ("bn_matmul_bwd" if kind == "1x1" else "bn_conv3x3_bwd",
                    bwd, True)]
        if kind == "3x3":
            kernels.append(("bn_conv3x3_fwd_v2",
                            cs.bn_calls(kind, a, stride, v2=True)[0], False))
        for name, fn, back in kernels:
            if only and name not in only:
                continue
            design = cs.DESIGN[dtype][name]
            # a 3xTF32 body's bound (the root's bn_bound takes its design)
            b_ms, b_by = cs.bn_bound(kind, a, O, back, dtype, *(
                [design] if design.endswith("mma_3xtf32") else []))
            ms = cs.time_ms(fn, iters=10)
            row[name] = {"ms": ms, "design": design, "bound_ms": b_ms,
                         "bound_by": b_by, "bound_share": b_ms / ms}
            if name == "bn_conv3x3_fwd_v2":
                row[name]["block_o"] = bnc._v2_block_o(O)
        for width in (64, 128):
            if kind != "3x3" or "bn_conv3x3_fwd_v2" not in row or \
                    bnc._v2_block_o(O) == width or width >= O:
                continue
            # K14 with O blocks of another width: 128 where it takes 256
            # (O 512), 64 (the width of K13's 64 x 64 tiles) elsewhere
            block_o = bnc._v2_block_o
            bnc._v2_block_o = lambda o, w=width: w
            try:
                row[f"bn_conv3x3_fwd_v2_block{width}_ms"] = cs.time_ms(
                    cs.bn_calls(kind, a, stride, v2=True)[0], iters=10)
            finally:
                bnc._v2_block_o = block_o
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
