"""Time the paged attention kernels K2 and K3 on one CUDA card, warm and cold.

Usage (repository root, on a machine with a CUDA card and nvcc):

    python3 tools/time_paged.py [--root DIR]

Runs ``chip_smoke.py``'s phases 3 (K2) and 6 (K3) of this checkout: K2 at
the engine's decode step (8 ragged slots, ctx 1 to 1024), all 8 slots at
ctx 1024 and one slot alone at 1024; K3 at the v2 mixed step (4 chunk
lanes of 32 rows) and the speculative verify (8 slots of 5 rows); each in
float32 and bfloat16, held to its plain version on poisoned pools, timed
warm (``kernel_ms``: 100 calls on one pool, whose pages stay in the 50 MB
L2) and cold (``kernel_cold_ms``: each call on the next of several pool
copies, one per layer as a serve reads ``kpool[i]``, at least 100 MB a
round), beside the bound (bytes read once at 3.35 TB/s, or the products at
the peak rate, whichever is longer).  Prints one JSON line with the card's
name and power limit, the rows, nvcc's ptxas report (registers, spills)
of each paged kernel and the dynamic shared memory a block of this
checkout's kernels asks for (``--smem`` prints it alone, without a card).
``--root`` imports the kernels of another checkout instead (a parent
commit unpacked with ``git archive``); the cases and the timing stay this
checkout's, so two designs are compared on the same inputs, on one card,
in one call: run parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ptxas_report(log_path):
    """{kernel entry: [ptxas lines]} for the paged kernels."""
    out, name = {}, None
    with open(log_path) as f:
        for line in f:
            if "Compiling entry function" in line:
                name = line.split("'")[1] if "paged_attn" in line else None
                if name:
                    out[name] = []
            elif name and ("registers" in line or "spill" in line):
                out[name].append(line.strip())
    return out


def dynamic_smem(dh=64, ps=16):
    """Bytes of dynamic shared memory a block of each paged kernel asks
    for at head dim `dh` and page size `ps` (ptxas reports only static
    shared memory), by the launchers' formulas: K2 (``paged_attention.cu``
    ``launch``) 4 warps x (3 staged pages of K and V + the merge row), K3
    (``paged_attention_mq.cu`` ``launch``) the Q tile + max(ring, merge
    area), per dtype and m-tiles (1: the verify's C 5, 2: the mixed
    step's C 32), with ``dispatch_mt``'s warps."""
    out = {}
    for dtype, size in (("float32", 4), ("bfloat16", 2)):
        ch = -(-dh * size // 16)
        ldc = (ch + 7) & ~7
        nc = 1  # chunks a lane holds: ceil(ch / 4) up to a power of two
        while nc < -(-ch // 4):
            nc *= 2
        red = (2 + nc * 4 * (16 // size)) * 4
        out[f"paged_attn_split_kernel/{dtype}"] = 4 * (
            3 * 2 * ps * ldc * 16 + red)
        dp = 64 if dh <= 64 else 128
        ld = dp + (4 if size == 4 else 8)
        for mt in (1, 2, 4):
            # warps: kWarps (4), kWarpsWideF32 (8) for f32 at 2+ m-tiles
            kg = (8 if size == 4 and mt > 1 else 4) // mt
            nstage = 1 + -(-4 // kg)
            ring = nstage * kg * 2 * 16 * ld * size
            merge = kg * mt * 16 * (dp + 2) * 4
            out[f"paged_attn_mq_split_kernel/{dtype}/mt{mt}"] = \
                mt * 16 * ld * size + max(ring, merge)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--smem", action="store_true",
                    help="print dynamic_smem() at the serving shape and "
                         "exit (no card needed)")
    args = ap.parse_args()
    if args.smem:
        print(json.dumps(dynamic_smem()))
        return 0
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("time_paged: no CUDA device", file=sys.stderr)
        return 2
    # this checkout's cases and timing, over the root's package
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from paddle_tpu_torch.ops.cuda_kernels import _common

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    so = _common.build()
    rows = []
    for kernel, phase in (("paged_attention", cs.paged_phase),
                          ("paged_attention_mq", cs.mq_phase)):
        for r in phase(dev)[0]:
            r.pop("design")  # names this checkout's body, not the root's
            rows.append({"kernel": kernel, **r})
    print(json.dumps({
        "root": os.path.abspath(args.root),
        "package": os.path.dirname(_common.__file__),
        "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(),
        "rows": rows, "ptxas": ptxas_report(so[:-3] + ".log"),
        "dynamic_smem_this_checkout": dynamic_smem()}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
