"""batch_norm on the single-process mesh, two checkouts side by side.

    python3 tools/time_mesh_bn.py --parent DIR [--out DIR] [--deterministic]

Runs the ``dp_mp`` and ``fsdp`` modes of ``parallel/modes.py`` (the ResNet
tower with batch_norm over a dp-sharded batch, {"dp": 4, "mp": 2}) through
``ParallelExecutor`` on eight positions of cuda:0, f32, from the seed's
startup state: 2 warm-up steps and 30 timed ones, each synchronized, at
batch 8 and 64.  Each checkout runs in a process of its own, in the order
parent, change, change, parent; each run prints one ``MESH_BN {...}`` line
(median and least ms a step, the losses) and saves its final state under
`--out`.  The last line, ``MESH_BN_AB {...}``, holds each mode's ms a step
of both trees, and how far the change's losses and state lie from the
parent's beside how far each tree's two runs lie from each other (the
card's own run-to-run spread): bitwise or not, the largest relative
difference of a loss (and the first step whose loss differs, and the
first four steps' relative differences), and of a state tensor over its
largest |value|.
`--deterministic` runs with ``torch.use_deterministic_algorithms`` and
cuDNN's deterministic algorithms, so that each tree repeats itself and the
trees' distance is their own.  Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("dp_mp", "fsdp")
BATCHES = (8, 64)
WARM, TIMED = 2, 30

_RUN = r'''
import json, os, sys, time
sys.path.insert(0, ".")
import numpy as np
import torch
import paddle_tpu_torch as fluid
from paddle_tpu_torch.framework.scope import Scope, to_numpy
from paddle_tpu_torch.parallel import mesh as pmesh, modes
from paddle_tpu_torch.parallel.parallel_executor import ParallelExecutor

out, tag = sys.argv[1], sys.argv[2]
warm, timed = int(sys.argv[3]), int(sys.argv[4])
if sys.argv[7] == "1":
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
dev = torch.device("cuda", 0)
rows, state = {}, {}
for name in json.loads(sys.argv[5]):
    for bs in json.loads(sys.argv[6]):
        fluid.reset()
        mode, prog, loss = modes.build_mode(name)
        startup = fluid.default_startup_program()
        startup.random_seed = 0
        scope = Scope()
        pe = ParallelExecutor(mesh=pmesh.make_mesh(mode.mesh_axes,
                                                   devices=[dev] * 8),
                              **mode.executor_kwargs)
        pe.run(startup, scope=scope)
        rng = np.random.RandomState(0)
        feeds = [mode.feed_fn(rng, bs) for _ in range(warm + timed)]
        losses, ms = [], []
        for f in feeds:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            got = pe.run(prog, feed=f, fetch_list=[loss], scope=scope)
            torch.cuda.synchronize()
            ms.append((time.monotonic() - t0) * 1e3)
            losses.append(float(np.asarray(got[0]).ravel()[0]))
        key = f"{name}_bs{bs}"
        rows[key] = {"ms_per_step_median": float(np.median(ms[warm:])),
                     "ms_per_step_min": float(min(ms[warm:])),
                     "losses": losses}
        for n, v in prog.global_block().vars.items():
            if v.persistable and scope.find(n) is not None:
                state[f"{key}/{n}"] = to_numpy(scope.find(n))
np.savez(os.path.join(out, tag + ".npz"), **state)
print("MESH_BN " + json.dumps({"tree": tag, **rows}), flush=True)
'''


def run_in(tree, tag, out, deterministic):
    env = dict(os.environ)
    if deterministic:
        env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    r = subprocess.run(
        [sys.executable, "-c", _RUN, out, tag, str(WARM), str(TIMED),
         json.dumps(MODES), json.dumps(BATCHES),
         "1" if deterministic else "0"],
        cwd=tree, env=env, capture_output=True, text=True, timeout=900)
    sys.stdout.write(r.stdout)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("MESH_BN ")]
    if r.returncode != 0 or not line:
        raise RuntimeError(f"{tree}: exit {r.returncode}\n{r.stderr[-3000:]}")
    return json.loads(line[0][len("MESH_BN "):])


def distance(got, want):
    """(bitwise, largest over the tensors of max |got - want| / max
    |want|)."""
    worst, same = 0.0, True
    for k, w in want.items():
        g, w = np.asarray(got[k], np.float64), np.asarray(w, np.float64)
        same = same and np.array_equal(g, w)
        if w.size:
            worst = max(worst, float(np.abs(g - w).max())
                        / max(float(np.abs(w).max()), 1e-30))
    return same, worst


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="checkout of the commit to compare against")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "mesh_bn"))
    ap.add_argument("--deterministic", action="store_true")
    args = ap.parse_args(argv)
    args.out = os.path.abspath(args.out)
    import torch

    if not torch.cuda.is_available():
        print("time_mesh_bn: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    runs = []
    for i, (tag, tree) in enumerate((("parent", args.parent),
                                     ("change", ROOT), ("change", ROOT),
                                     ("parent", args.parent))):
        runs.append(run_in(os.path.abspath(tree), f"{tag}{i}", args.out,
                           args.deterministic))
    states = {}
    for i, r in enumerate(runs):
        with np.load(os.path.join(args.out, r["tree"] + ".npz")) as z:
            states[i] = {k: z[k] for k in z.files}
    res = {}
    for key in runs[0]:
        if key == "tree":
            continue
        sub = {i: {k: v for k, v in s.items() if k.startswith(key + "/")}
               for i, s in states.items()}

        def apart(i, j):
            li = np.asarray(runs[i][key]["losses"])
            lj = np.asarray(runs[j][key]["losses"])
            same, worst = distance(sub[i], sub[j])
            rel = np.abs(li - lj) / np.abs(lj)
            parted = np.flatnonzero(li != lj)
            return {"bitwise": bool(same and np.array_equal(li, lj)),
                    "losses_part_at_step": int(parted[0]) + 1
                    if parted.size else None,
                    "loss_rel_steps_1_to_4": rel[:4].tolist(),
                    "loss_max_rel": float(rel.max()),
                    "state_max_rel_of_max": worst}

        res[key] = {
            "parent_ms_median": [runs[i][key]["ms_per_step_median"]
                                 for i in (0, 3)],
            "change_ms_median": [runs[i][key]["ms_per_step_median"]
                                 for i in (1, 2)],
            "parent_ms_min": [runs[i][key]["ms_per_step_min"]
                              for i in (0, 3)],
            "change_ms_min": [runs[i][key]["ms_per_step_min"]
                              for i in (1, 2)],
            "change_vs_parent": apart(1, 0),
            "parent_vs_parent": apart(3, 0),
            "change_vs_change": apart(2, 1)}
    print("MESH_BN_AB " + json.dumps({"deterministic": args.deterministic,
                                      **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
