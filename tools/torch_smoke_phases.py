"""Run named phases of ``chip_smoke.py`` on the card, alone or parent
against change.

    python3 tools/torch_smoke_phases.py router
    python3 tools/torch_smoke_phases.py measurement
    python3 tools/torch_smoke_phases.py parallel
    python3 tools/torch_smoke_phases.py book
    python3 tools/torch_smoke_phases.py v2
    python3 tools/torch_smoke_phases.py deploy
    python3 tools/torch_smoke_phases.py multiprocess
    python3 tools/torch_smoke_phases.py v1_rnn generation --parent DIR

Without ``--parent`` the phases run once in this process after the kernel
build, each printing its rows as the smoke does.  With ``--parent DIR`` (an
unpacked checkout of another commit, e.g. ``git archive HEAD~1``) each tree
runs the phases in a process of its own, in the order parent, change,
change, parent, and each run prints one ``AB {...}`` JSON line with the
wall seconds of every phase (the kernel build excluded).  Exits 2 without
a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the phase's call, with `cs` the smoke module, `name`/`smi` the card's
PHASES = {
    "router": "cs.router_phase(name, smi)",
    "v1_rnn": "cs.v1_rnn_phase(name, smi)",
    "generation": "cs.generation_phase(torch.device('cuda', 0), name, smi)",
    "measurement": "cs.measurement_phase(name, smi)",
    "parallel": "cs.parallel_phase(torch.device('cuda', 0), name, smi)",
    "book": "cs.book_phase(torch.device('cuda', 0), name, smi)",
    "v2": "cs.v2_api_phase(torch.device('cuda', 0), name, smi)",
    "deploy": "cs.deploy_phase(torch.device('cuda', 0), name, smi)",
    "multiprocess": "cs.multiprocess_phase(name, smi)",
}

_RUN = r'''
import json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
cs.build()
name, smi = cs.card()
secs = {}
for phase, call in json.loads(sys.argv[1]).items():
    t0 = time.monotonic()
    eval(call)
    secs[phase] = time.monotonic() - t0
print("AB " + json.dumps(secs), flush=True)
'''


def run_in(tree, phases):
    """The phases in a new process whose working directory is `tree`;
    returns their wall seconds."""
    calls = json.dumps({p: PHASES[p] for p in phases})
    r = subprocess.run([sys.executable, "-c", _RUN, calls], cwd=tree,
                       capture_output=True, text=True, timeout=1800)
    sys.stdout.write(r.stdout)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("AB ")]
    if r.returncode != 0 or not line:
        raise RuntimeError(f"{tree}: exit {r.returncode}\n{r.stderr[-2000:]}")
    return json.loads(line[0][3:])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phases", nargs="+", choices=sorted(PHASES))
    ap.add_argument("--parent", help="checkout of the commit to compare "
                    "against (parent, change, change, parent)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_smoke_phases: no CUDA device", file=sys.stderr)
        return 2
    if args.parent is None:
        run_in(ROOT, args.phases)
        return 0
    for tag, tree in (("parent", args.parent), ("change", ROOT),
                      ("change", ROOT), ("parent", args.parent)):
        secs = run_in(os.path.abspath(tree), args.phases)
        print("AB_RUN " + json.dumps({"tree": tag, **secs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
