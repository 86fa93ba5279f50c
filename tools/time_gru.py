"""Time the GRU time-loop kernels K9 and K10 on one CUDA card.

Usage (repository root, on a machine with a CUDA card and nvcc):

    python3 tools/time_gru.py [--root DIR] [--dtype float32|bfloat16]
    python3 tools/time_gru.py --split

At path B's shape (B 64, T 64, H 512, full lengths: the NMT encoder's
bench batch, one direction) and the parity shape (B 8, T 16, H 512, ragged
lengths), in each dtype asked for (both by default), it runs K9 and K10
once on the inputs ``chip_smoke.rnn_case`` makes and holds their outputs
and the plain versions' against the same function in float64 (no rounding
of the products' operands): the distance (max |error| over max |value|, a
tensor) of the kernel and of the plain version.  Then it times each kernel
warm (CUDA events, ``chip_smoke.time_ms``) beside its bound
(``chip_smoke.rnn_bound``: the products at the dtype's peak rate or the
bytes at 3.35 TB/s, whichever is longer, ignoring that the steps depend on
each other), with the bound's share and the time a step (the call over T),
and splits K10's device time between its kernels under ``torch.profiler``
(the loop and the dW products; empty where the profiler sees no kernel).
Each call's route and device launches are read from the library's own
tally (``gru.device_launches``; a tree without it has the step kernels
only, counted by the profiler).  Prints one JSON line with the card's name
and power limit, nvcc's ptxas report of the GRU kernels and the dynamic
shared memory a block of the persistent kernels asks for
(``ptt_gru_smem_bytes``).  ``--root`` imports the package of another
checkout instead of this one (a parent commit unpacked with ``git
archive``); the cases and the timing stay this checkout's, so two designs
are compared on the same inputs on one card in one call: run parent,
change, change, parent.

``--split`` times where a step of the persistent loops goes, at path B's
shape in both dtypes: this checkout's ``csrc/gru.cu`` built whole; without
the barriers' spin (``group_wait`` defined as ``__syncthreads``: the
arrivals stay, nobody waits for them); without the products (``warp_stream``
defined away: no operand rows read from L2, no product; the barriers
stay); without both; and, in f32, without the FMA (``fmaf`` defined away:
the rows are still read).  K10's times are its loop kernel's
(``torch.profiler``), the dW launches apart.  Only the whole build's
results are right: the others are timed, not checked.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import sys
import tempfile

import time_lstm as tl

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [("path_b", 64, 64, 512, "full"), ("parity", 8, 16, 512, "ragged")]
KERNEL_NAMES = ("gru_fwd_persistent", "gru_bwd_persistent", "gru_gates",
                "gru_fwd_cand", "gru_bwd_cand", "gru_bwd_drh", "gru_bwd_dh",
                "rnn_dw_kernel")
# the --split variants: source text compiled in place of gru.cu
VARIANTS = {
    "no_spin": """#include "persistent.cuh"
#define group_wait(counter, target) __syncthreads()
#include "gru.cu"
""",
    "no_product": """#include "persistent.cuh"
namespace ptt { namespace { namespace rnn_p {
template <int NBUF, typename... A>
__device__ __forceinline__ void skip_stream(A&&...) {}
} } }
#define warp_stream skip_stream
#include "gru.cu"
""",
    "no_fma": """#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#define fmaf(a, b, c) (c)
#include "gru.cu"
"""}
VARIANTS["no_spin_no_product"] = VARIANTS["no_product"].replace(
    '#define warp_stream skip_stream\n',
    '#define warp_stream skip_stream\n'
    '#define group_wait(counter, target) __syncthreads()\n')


def gru_f64(torch, a):
    """The forward and BPTT in float64 on the case's inputs, with no
    rounding of the products' operands: (hs, hT), (dx, dh0, dw)."""
    d = {k: a[k].double() for k in ("x", "h0", "w", "dhs")}
    B, T, H3 = d["x"].shape
    H = H3 // 3
    m = (torch.arange(T, device=d["x"].device)[None, :]
         < a["lengths"][:, None]).double()
    w_g, w_c = d["w"][:, :2 * H], d["w"][:, 2 * H:]
    h = d["h0"]
    hs, saved = [], []
    for t in range(T):
        x_t = d["x"][:, t]
        g = x_t[:, :2 * H] + h @ w_g
        u, r = torch.sigmoid(g[:, :H]), torch.sigmoid(g[:, H:])
        c = torch.tanh(x_t[:, 2 * H:] + (r * h) @ w_c)
        saved.append((u, r, c, h))
        mt = m[:, t, None]
        h = mt * (u * h + (1 - u) * c) + (1 - mt) * h
        hs.append(h)
    dh = torch.zeros_like(h)
    dw = torch.zeros_like(d["w"])
    dx = [None] * T
    for t in reversed(range(T)):
        u, r, c, hp = saved[t]
        mt = m[:, t, None]
        dh_acc = d["dhs"][:, t] + dh
        dh_raw = mt * dh_acc
        du = dh_raw * (hp - c)
        da_c = dh_raw * (1 - u) * (1 - c * c)
        drh = da_c @ w_c.t()
        dg = torch.cat([du * u * (1 - u), drh * hp * r * (1 - r)], 1)
        dx[t] = torch.cat([dg, da_c], 1)
        dw[:, :2 * H] += hp.t() @ dg
        dw[:, 2 * H:] += (r * hp).t() @ da_c
        dh = (1 - mt) * dh_acc + dh_raw * u + drh * r + dg @ w_g.t()
    return (torch.stack(hs, 1), h), (torch.stack(dx, 1), dh, dw)


def dynamic_smem(torch, _common, dev, h=512):
    """Bytes of dynamic shared memory a block of the persistent kernels
    asks for at hidden width `h` (``ptt_gru_smem_bytes``); None for a
    tree without it."""
    if not hasattr(_common.load(), "ptt_gru_smem_bytes"):
        return None
    return {f"{what}/{str(dt).split('.')[1]}": _common.query(
                "ptt_gru_smem_bytes", h, _common.dtype_code(dt), kernel,
                device=dev)
            for dt in (torch.float32, torch.bfloat16)
            for kernel, what in enumerate(("gru_fwd_persistent",
                                           "gru_bwd_persistent"))}


def timing(args, torch, cs):
    from paddle_tpu_torch.ops.cuda_kernels import _common
    from paddle_tpu_torch.ops.cuda_kernels import gru as gru_k

    dev = torch.device("cuda", 0)
    so = _common.build()
    rows = []
    for dtype_name in args.dtype:
        dtype = getattr(torch, dtype_name)
        for tag, B, T, H, lengths in SHAPES:
            a = cs.rnn_case(dev, dtype, 3, B, T, H, lengths)
            ins = (a["x"], a["h0"], a["w"], a["lengths"])
            got = gru_k.gru_forward(*ins)
            plain = gru_k.gru_forward_ref(*ins)
            grads = gru_k.gru_backward(*ins, plain[0], a["dhs"])
            plain_g = gru_k.gru_backward_ref(*ins, plain[0], a["dhs"])
            torch.cuda.synchronize()
            want, want_g = gru_f64(torch, a)
            row = {"case": tag, "dtype": dtype_name, "B": B, "T": T, "H": H,
                   "lengths": lengths, "valid_steps": a["steps"],
                   "f64": {**tl.f64_dist(cs, ("hs", "hT"), got, plain, want),
                           **tl.f64_dist(cs, ("dx", "dh0", "dw"), grads,
                                         plain_g, want_g)},
                   "plain_max_abs_err": {
                       "forward": max(cs.max_err(g, p)
                                      for g, p in zip(got, plain)),
                       "backward_rel": max(cs.rel_err(g, p)
                                           for g, p in zip(grads, plain_g))}}
            del want, want_g
            for name, fn, back in (
                    ("gru_forward", lambda: gru_k.gru_forward(*ins), False),
                    ("gru_backward",
                     lambda: gru_k.gru_backward(*ins, plain[0], a["dhs"]),
                     True)):
                counts = tl.launched(torch, gru_k, dev, fn, KERNEL_NAMES)
                body = "persistent" if any("persistent" in k
                                           for k in counts) else "steps"
                if hasattr(gru_k, "route") and \
                        body != gru_k.route(a["x"], backward=back):
                    raise AssertionError(f"{name} ran {body}, not the "
                                         f"route gru.route chose")
                n = sum(counts.values()) or (4 * T + 2 if back else 2 * T)
                ms = cs.time_ms(fn, iters=max(2, 400 // n))
                b_ms, b_by = cs.rnn_bound(3, a, B, T, H, back, dtype)
                row[name] = {"route": body, "device_launches": counts,
                             "ms": ms, "us_a_step": ms / T * 1e3,
                             "bound_ms": b_ms, "bound_by": b_by,
                             "bound_share": b_ms / ms}
                if back:
                    row[name]["device_ms_by_kernel"] = \
                        tl.device_ms_by_kernel(torch, fn, names=KERNEL_NAMES)
            rows.append(row)
            print(json.dumps(row), file=sys.stderr, flush=True)
    return {"rows": rows,
            "ptxas": tl.ptxas_report(so[:-3] + ".log", KERNEL_NAMES),
            "dynamic_smem": dynamic_smem(torch, _common, dev)}


def persistent_calls(torch, _common, lib, a):
    """(forward, backward) closures calling `lib`'s GRU entry points on
    the persistent route with the case's inputs, as gru.py would."""
    x, w, h0, lens = a["x"], a["w"], a["h0"], a["lengths"]
    B, T, H3 = x.shape
    H, dt, dev = H3 // 3, x.dtype, x.device
    code = _common.dtype_code(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    groups = -(-B // 16)

    def p(t):
        return None if t is None else t.data_ptr()

    rhs, hs, hT = (torch.empty(B, T, H, dtype=dt, device=dev),
                   torch.empty(B, T, H, dtype=dt, device=dev),
                   torch.empty(B, H, dtype=dt, device=dev))
    cnt_f = torch.zeros(groups, dtype=torch.int32, device=dev)
    dh = torch.zeros(B, H, dtype=torch.float32, device=dev)
    rh_all = torch.empty(B, T, H, dtype=torch.float32, device=dev)
    rh16 = None if dt == torch.float32 else torch.empty_like(hs)
    dx = torch.empty_like(x)
    dg32 = None if dt == torch.float32 else torch.empty(
        B, T, H3, dtype=torch.float32, device=dev)
    dw = torch.empty_like(w)
    cnt_b = torch.zeros(2 * groups, dtype=torch.int32, device=dev)
    saved = a["saved_hs"]

    def fwd():
        cnt_f.zero_()
        rc = lib.ptt_gru_forward(p(x), p(w), p(h0), None, None, None, None,
                                 p(rhs), p(hs), p(hT), p(lens), p(cnt_f), B,
                                 T, H, code, 1, stream)
        assert rc == 0, rc

    def bwd():
        cnt_b.zero_()
        rc = lib.ptt_gru_backward(p(x), p(w), p(h0), p(saved), p(a["dhs"]),
                                  p(dh), None, None, p(rh_all), p(rh16),
                                  p(dx), p(dg32), p(dw), p(lens), p(cnt_b),
                                  B, T, H, code, 1, stream)
        assert rc == 0, rc

    return fwd, bwd


def split(torch, cs):
    """The persistent loops at path B's shape, whole and with parts cut."""
    from paddle_tpu_torch.ops.cuda_kernels import _common
    from paddle_tpu_torch.ops.cuda_kernels import gru as gru_k

    dev = torch.device("cuda", 0)
    libs = {"whole": ctypes.CDLL(_common.build())}
    work = tempfile.mkdtemp(dir=os.path.dirname(_common.library_path()))
    for k, text in VARIANTS.items():
        path = os.path.join(work, k + ".cu")
        with open(path, "w") as f:
            f.write(text)
        libs[k] = tl.nvcc_so(_common, path, os.path.join(work, k + ".so"),
                             extra=("-I", _common._CSRC))
    for lib in libs.values():
        for name in ("ptt_gru_forward", "ptt_gru_backward"):
            fn = getattr(lib, name)
            fn.argtypes = _common._SIGNATURES[name]
            fn.restype = ctypes.c_int
    _, B, T, H, lengths = SHAPES[0]
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        a = cs.rnn_case(dev, dtype, 3, B, T, H, lengths)
        a["saved_hs"] = gru_k.gru_forward_ref(a["x"], a["h0"], a["w"],
                                              a["lengths"])[0]
        row = {"dtype": str(dtype).split(".")[1], "B": B, "T": T, "H": H,
               "forward": {}, "backward_loop": {}}
        for k, lib in libs.items():
            if k == "no_fma" and dtype != torch.float32:
                continue
            fwd, bwd = persistent_calls(torch, _common, lib, a)
            f_ms = cs.time_ms(fwd)
            b_ms = tl.device_ms_by_kernel(torch, bwd, names=KERNEL_NAMES).get(
                "gru_bwd_persistent")
            row["forward"][k] = {"ms": f_ms, "us_a_step": f_ms / T * 1e3}
            row["backward_loop"][k] = {
                "ms": b_ms, "us_a_step": None if b_ms is None
                else b_ms / T * 1e3}
        rows.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
    return {"split_rows": rows}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--dtype", action="append",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--split", action="store_true")
    args = ap.parse_args()
    args.dtype = args.dtype or ["float32", "bfloat16"]
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("time_gru: no CUDA device", file=sys.stderr)
        return 2
    # this checkout's cases and timing, over the root's package
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from paddle_tpu_torch.ops.cuda_kernels import _common

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    res = split(torch, cs) if args.split else timing(args, torch, cs)
    print(json.dumps({"root": os.path.abspath(args.root),
                      "package": os.path.dirname(_common.__file__),
                      "nvidia_smi": tl.smi(), **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
