"""Time the LSTM time-loop kernels K7 and K8 on one CUDA card.

Usage (repository root, on a machine with a CUDA card and nvcc):

    python3 tools/time_lstm.py [--root DIR] [--dtype bfloat16|float32]
    python3 tools/time_lstm.py --split

At path A's shape (B 64, T 96, H 512, full lengths: the stacked-LSTM
classifier's bench batch) and the parity shape (B 16, T 32, H 512, ragged
lengths), in each dtype asked for (both by default), it runs K7 and K8
once on the inputs ``chip_smoke.rnn_case`` makes and holds their outputs
and the plain versions' against the same function in float64 (no rounding
of the product's operands): the distance (max |error| over max |value|, a
tensor) of the kernel and of the plain version.  Then it times each kernel
warm (CUDA events, ``chip_smoke.time_ms``) beside its bound
(``chip_smoke.rnn_bound``: the products at the dtype's peak rate or the
bytes at 3.35 TB/s, whichever is longer, ignoring that the steps depend on
each other) with the bound's share and the time a step (the call over T),
and splits K8's device time between its kernels under ``torch.profiler``
(the loop and the dW product).  Prints one JSON line with the card's name
and power limit, the route each call took and its device launches (read
from the kernels ``torch.profiler`` sees, ``chip_smoke.rnn_body``; a
tree without ``lstm.route`` has the step kernels only), nvcc's ptxas
report of the LSTM kernels and the dynamic shared memory a block of the
persistent kernels asks for (the library's ``ptt_lstm_smem_bytes``).
``--root`` imports the package of another checkout instead of this one (a
parent commit unpacked with ``git archive``); the cases and the timing
stay this checkout's, so two designs are compared on the same inputs on
one card in one call: run parent, change, change, parent.

``--split`` times where a step of the step route goes, at path A's shape
in both dtypes: an empty kernel launched on the step route's grid as many
times as it launches (the launch floor); this checkout's ``csrc/lstm.cu``
built with its FMA loops removed (``fmaf`` defined away: the operand loads
and the gate math stay); and the step route itself.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [("path_a", 64, 96, 512, "full"), ("parity", 16, 32, 512, "ragged")]
KERNEL_NAMES = ("lstm_fwd_persistent", "lstm_bwd_persistent", "lstm_dw_mma",
                "lstm_fwd_step", "lstm_bwd_gates", "lstm_bwd_dh",
                "rnn_dw_kernel")
EMPTY_CU = r"""
#include <cuda_runtime.h>
__global__ void ptt_empty_kernel() {}
extern "C" int ptt_empty_steps(int n, int gx, int gy, int threads,
                               void* stream) {
  for (int i = 0; i < n; ++i)
    ptt_empty_kernel<<<dim3(gx, gy), threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""
NO_FMA_CU = """#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#define fmaf(a, b, c) (c)
#include "{src}"
"""


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def ptxas_report(log_path, names=KERNEL_NAMES):
    """{kernel entry: [ptxas lines]} for the kernels whose entry names hold
    one of `names` (the LSTM's by default)."""
    out, name = {}, None
    with open(log_path) as f:
        for line in f:
            if "Compiling entry function" in line:
                name = line.split("'")[1]
                name = name if any(k in name for k in names) else None
                if name:
                    out[name] = []
            elif name and ("registers" in line or "spill" in line):
                out[name].append(line.strip())
    return out


def dynamic_smem(torch, _common, dev, h=512):
    """Bytes of dynamic shared memory a block of the persistent kernels
    asks for at hidden width `h` (ptxas reports only static shared
    memory), from the library's query ``ptt_lstm_smem_bytes``; None for a
    tree without it."""
    if not hasattr(_common.load(), "ptt_lstm_smem_bytes"):
        return None
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for kernel, what in enumerate(("lstm_fwd_persistent",
                                       "lstm_bwd_persistent", "lstm_dw_mma")):
            if kernel < 2 or dtype == torch.bfloat16:
                out[f"{what}/{name}"] = _common.query(
                    "ptt_lstm_smem_bytes", h, _common.dtype_code(dtype),
                    kernel, device=dev)
    return out


def lstm_f64(torch, a):
    """The forward and BPTT in float64 on the case's inputs, with no
    rounding of the product's operands: (hs, cs, hT, cT), (dx, dh0, dc0,
    dw)."""
    d = {k: a[k].double() for k in ("x", "h0", "c0", "w", "dhs", "dcs")}
    B, T, H4 = d["x"].shape
    H = H4 // 4
    m = (torch.arange(T, device=d["x"].device)[None, :]
         < a["lengths"][:, None]).double()
    h, c, w = d["h0"], d["c0"], d["w"]
    hs, cs, gates = [], [], []
    for t in range(T):
        g = d["x"][:, t] + h @ w
        i, f = torch.sigmoid(g[:, :H]), torch.sigmoid(g[:, H:2 * H])
        u, o = torch.tanh(g[:, 2 * H:3 * H]), torch.sigmoid(g[:, 3 * H:])
        gates.append((i, f, u, o, c))
        mt = m[:, t, None]
        c_new = f * c + i * u
        h = mt * o * torch.tanh(c_new) + (1 - mt) * h
        c = mt * c_new + (1 - mt) * c
        hs.append(h)
        cs.append(c)
    hp = [d["h0"]] + hs[:-1]
    dh, dc = torch.zeros_like(h), torch.zeros_like(c)
    dw = torch.zeros_like(w)
    dx = [None] * T
    for t in reversed(range(T)):
        i, f, u, o, cp = gates[t]
        tc = torch.tanh(f * cp + i * u)
        mt = m[:, t, None]
        dh_acc, dc_acc = d["dhs"][:, t] + dh, d["dcs"][:, t] + dc
        dh_raw = mt * dh_acc
        dc_raw = mt * dc_acc + dh_raw * o * (1 - tc * tc)
        dg = torch.cat([dc_raw * u * i * (1 - i), dc_raw * cp * f * (1 - f),
                        dc_raw * i * (1 - u * u),
                        dh_raw * tc * o * (1 - o)], 1)
        dx[t] = dg
        dw += hp[t].t() @ dg
        dh = (1 - mt) * dh_acc + dg @ w.t()
        dc = (1 - mt) * dc_acc + dc_raw * f
    return ((torch.stack(hs, 1), torch.stack(cs, 1), h, c),
            (torch.stack(dx, 1), dh, dc, dw))


def f64_dist(cs, names, got, plain, want):
    return {n: {"kernel": cs.rel_err(g, w), "plain": cs.rel_err(p, w)}
            for n, g, p, w in zip(names, got, plain, want)}


def kernels_seen(torch, fn):
    """{kernel name: launches} of one call of `fn`, as torch.profiler
    records the CUDA kernels on the card (any tree's kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            counts[e.name] = counts.get(e.name, 0) + 1
    return counts


def launched(torch, mod, dev, fn, names=KERNEL_NAMES):
    """{kernel name: device launches} of one call of `fn`: the library's
    own tally (``mod.device_launches``) where the tree has one, else the
    kernels of `names` that torch.profiler saw (which another CUPTI user
    on the machine can leave blind)."""
    if hasattr(mod, "device_launches"):
        before = mod.device_launches(dev)
        fn()
        after = mod.device_launches(dev)
        return {k: n - before[k] for k, n in after.items() if n > before[k]}
    counts = {}
    for name, n in kernels_seen(torch, fn).items():
        k = next((k for k in names if k in name), None)
        if k is not None:
            counts[k] = counts.get(k, 0) + n
    return counts


def device_ms_by_kernel(torch, fn, calls=5, names=KERNEL_NAMES):
    """Device ms a call of `fn`, by the first of `names` (the LSTM's
    kernels by default) in each kernel's name, else "other"
    (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = next((k for k in names if k in e.name), "other")
            out[name] = out.get(name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / calls
    return out


def timing(args, torch, cs):
    from paddle_tpu_torch.ops.cuda_kernels import _common
    from paddle_tpu_torch.ops.cuda_kernels import lstm as lstm_k

    dev = torch.device("cuda", 0)
    so = _common.build()
    route = getattr(lstm_k, "route", None)
    rows = []
    for dtype_name in args.dtype:
        dtype = getattr(torch, dtype_name)
        for tag, B, T, H, lengths in SHAPES:
            a = cs.rnn_case(dev, dtype, 4, B, T, H, lengths)
            ins = (a["x"], a["h0"], a["c0"], a["w"], a["lengths"])
            got = lstm_k.lstm_forward(*ins)
            plain = lstm_k.lstm_forward_ref(*ins)
            grads = lstm_k.lstm_backward(*ins, *plain[:2], a["dhs"],
                                         a["dcs"])
            plain_g = lstm_k.lstm_backward_ref(*ins, *plain[:2], a["dhs"],
                                               a["dcs"])
            torch.cuda.synchronize()
            want, want_g = lstm_f64(torch, a)
            row = {"case": tag, "dtype": dtype_name, "B": B, "T": T, "H": H,
                   "lengths": lengths, "valid_steps": a["steps"],
                   "f64": {**f64_dist(cs, ("hs", "cs", "hT", "cT"), got,
                                      plain, want),
                           **f64_dist(cs, ("dx", "dh0", "dc0", "dw"), grads,
                                      plain_g, want_g)},
                   "plain_max_abs_err": {
                       "forward": max(cs.max_err(g, p)
                                      for g, p in zip(got, plain)),
                       "backward_rel": max(cs.rel_err(g, p)
                                           for g, p in zip(grads, plain_g))}}
            del want, want_g
            for name, fn, back in (
                    ("lstm_forward", lambda: lstm_k.lstm_forward(*ins),
                     False),
                    ("lstm_backward",
                     lambda: lstm_k.lstm_backward(*ins, *plain[:2], a["dhs"],
                                                  a["dcs"]), True)):
                # the route and launches of the library's tally; a tree
                # without lstm.route has the step kernels only
                body, launches = cs.rnn_body(
                    "lstm", launched(torch, lstm_k, dev, fn), back)
                if route and body != route(a["x"], backward=back):
                    raise AssertionError(f"{name} ran {body}, not the "
                                         f"route lstm.route chose")
                ms = cs.time_ms(fn, iters=max(2, 400 // launches))
                b_ms, b_by = cs.rnn_bound(4, a, B, T, H, back, dtype)
                row[name] = {"route": body, "device_launches": launches,
                             "ms": ms, "ms_a_step": ms / T, "bound_ms": b_ms,
                             "bound_by": b_by, "bound_share": b_ms / ms}
                if back:
                    row[name]["device_ms_by_kernel"] = device_ms_by_kernel(
                        torch, fn)
            rows.append(row)
            print(json.dumps(row), file=sys.stderr, flush=True)
    return {"rows": rows, "ptxas": ptxas_report(so[:-3] + ".log"),
            "dynamic_smem": dynamic_smem(torch, _common, dev)}


def nvcc_so(cs_common, src, out, extra=()):
    """Compile one .cu into a shared library (the kernels' flags)."""
    p = subprocess.run([cs_common._nvcc(), *cs_common.NVCC_FLAGS, *extra,
                        "-shared", src, "-o", out], capture_output=True,
                       text=True, timeout=600)
    if p.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{p.stdout}{p.stderr}")
    return ctypes.CDLL(out)


def split(torch, cs):
    """The step route at path A's shape: launch floor, no FMA, whole."""
    from paddle_tpu_torch.ops.cuda_kernels import _common
    from paddle_tpu_torch.ops.cuda_kernels import lstm as lstm_k

    dev = torch.device("cuda", 0)
    libs = {"whole": ctypes.CDLL(_common.build())}
    work = tempfile.mkdtemp(dir=os.path.dirname(_common.library_path()))
    lstm_cu = os.path.join(_common._CSRC, "lstm.cu")
    srcs = {"empty": EMPTY_CU, "no_fma": NO_FMA_CU.format(src=lstm_cu)}
    for k, text in srcs.items():
        path = os.path.join(work, k + ".cu")
        with open(path, "w") as f:
            f.write(text)
        libs[k] = nvcc_so(_common, path, os.path.join(work, k + ".so"))
    for k in ("whole", "no_fma"):
        for name in ("ptt_lstm_forward", "ptt_lstm_backward"):
            fn = getattr(libs[k], name)
            fn.argtypes = _common._SIGNATURES[name]
            fn.restype = ctypes.c_int
    libs["empty"].ptt_empty_steps.argtypes = [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    _, B, T, H, lengths = SHAPES[0]
    grid = (-(-H // 16), -(-B // 16))
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        a = cs.rnn_case(dev, dtype, 4, B, T, H, lengths)
        ins = (a["x"], a["h0"], a["c0"], a["w"], a["lengths"])
        hs, cs_, _, _ = lstm_k.lstm_forward_ref(*ins)
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _common.dtype_code(a["x"])
        ptr = [a[k].data_ptr() for k in ("x", "w", "h0", "c0")]
        lens = a["lengths"].data_ptr()

        def fwd(lib):
            hbuf = torch.empty(2, B, H, dtype=torch.float32, device=dev)
            hbuf[0] = a["h0"]
            c = a["c0"].float().clone()
            outs = [torch.empty(B, T, H, dtype=dtype, device=dev)
                    for _ in range(2)] + [torch.empty(B, H, dtype=dtype,
                                                      device=dev)
                                          for _ in range(2)]

            def call():
                rc = lib.ptt_lstm_forward(
                    *ptr, hbuf.data_ptr(), c.data_ptr(),
                    *[o.data_ptr() for o in outs], lens, None, B, T, H,
                    code, 0, stream)
                assert rc == 0, rc
            return call

        def bwd(lib):
            carry = torch.zeros(2, B, H, dtype=torch.float32, device=dev)
            dx = torch.empty_like(a["x"])
            dg32 = None if dtype == torch.float32 else torch.empty(
                B, T, 4 * H, dtype=torch.float32, device=dev)
            dw = torch.empty_like(a["w"])
            saved = [t.data_ptr() for t in (hs, cs_, a["dhs"], a["dcs"])]

            def call():
                carry.zero_()  # the step route's dh, dc carry starts at 0
                rc = lib.ptt_lstm_backward(
                    *ptr, *saved, carry[0].data_ptr(), carry[1].data_ptr(),
                    dx.data_ptr(), None if dg32 is None else dg32.data_ptr(),
                    dw.data_ptr(), lens, None, B, T, H, code, 0, stream)
                assert rc == 0, rc
            return call

        def empty(n):
            def call():
                rc = libs["empty"].ptt_empty_steps(n, *grid, 512, stream)
                assert rc == 0, rc
            return call

        row = {"dtype": str(dtype).split(".")[1], "B": B, "T": T, "H": H}
        for name, launches, make in (("forward", T, fwd),
                                     ("backward", 2 * T + 1, bwd)):
            iters = max(2, 400 // launches)
            ms = {"launch_floor": cs.time_ms(empty(launches), iters=iters),
                  "no_fma": cs.time_ms(make(libs["no_fma"]), iters=iters),
                  "whole": cs.time_ms(make(libs["whole"]), iters=iters)}
            row[name] = {"device_launches": launches, "ms": ms,
                         "us_a_step": {k: v / T * 1e3 for k, v in ms.items()}}
        rows.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
    return {"split_rows": rows}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--dtype", action="append",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--split", action="store_true")
    args = ap.parse_args()
    args.dtype = args.dtype or ["bfloat16", "float32"]
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("time_lstm: no CUDA device", file=sys.stderr)
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
                      "nvidia_smi": smi(), **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
