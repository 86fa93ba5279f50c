"""Memory optimization (reference python/paddle/v2/fluid/
memory_optimization_transpiler.py — liveness-based variable reuse,
ControlFlowGraph :32, memory_optimize :167) — the port of
``paddle_tpu/memory_optimization_transpiler.py``.

The lever is rematerialization: marking a grad op (``__remat__``) asks
for its forward to be recomputed in the backward instead of keeping the
forward activation live.  Peak memory drops, FLOPs rise.

Remat is not free, so ``memory_optimize`` is *selective*: it computes a
desc-level projection of peak residency (persistent state + the peak
live-activation set from a first-def/last-use sweep, batch dims bound to
a given batch size) and marks grad ops — largest forward-activation
footprint first — only until the projection fits the memory budget.  A
program that already fits is left untouched (0 ops marked); ``level=1``
marks everything (the blanket trade).

The port honours ``__remat__`` marks as unmarked ops until it records a
backward tape of its own (ROADMAP.md Queue A item 4): a marking changes
the desc — its digest, the cost model's grad-op FLOPs and this
projection — exactly as the JAX package's does, and nothing on the
device yet.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from .framework.core import Program, np_dtype

_DEFAULT_HBM = 16 * 1024**3  # the budget when neither the card nor
                             # $PADDLE_TPU_HBM_BYTES names one


def _var_bytes(var, batch_size: int) -> int:
    """Desc-level byte estimate: -1/None dims bound to `batch_size`."""
    if var is None or var.shape is None:
        return 0
    n = 1
    for s in var.shape:
        s = int(s) if s is not None else -1
        n *= batch_size if s < 0 else max(s, 1)
    try:
        item = np.dtype(np_dtype(var.dtype or "float32")).itemsize
    except Exception:
        item = 4
    return n * item


def _lifetimes(block, batch_size: int, skip_uses_of=()):
    """(first_def, last_use, bytes) per transient var from a first-def /
    last-use sweep.  Uses by ops in `skip_uses_of` (remat-marked grad ops)
    are ignored for the vars those ops recompute: a checkpointed grad op
    re-derives its forward outputs instead of keeping them live."""
    first_def: Dict[str, int] = {}
    last_use: Dict[str, int] = {}
    # per-op recompute sets: a marked grad op re-derives ONLY its own
    # forward outputs; its other inputs (possibly another marked op's
    # outputs) remain checkpoint residuals it still consumes live (a
    # union set would under-count the live set when adjacent grad ops
    # are both marked)
    own_recompute: Dict[int, set] = {}
    for op in skip_uses_of:
        own_recompute[id(op)] = {
            name for slot in op.attrs.get("__fwd_output_slots__", ())
            for name in op.input(slot)}
    for i, op in enumerate(block.ops):
        for name in op.output_names():
            first_def.setdefault(name, i)
            last_use[name] = i
        skip = own_recompute.get(id(op), ())
        for name in op.input_names():
            if name in skip:
                continue
            last_use[name] = i

    sizes: Dict[str, int] = {}
    for name, d in first_def.items():
        v = block._find_var_recursive(name)
        if (v is not None and not v.persistable and not v.is_data
                and v.shape is not None):
            sizes[name] = _var_bytes(v, batch_size)
    return first_def, last_use, sizes


def analyze_liveness(block, batch_size: int = 64, skip_uses_of=(),
                     lifetimes=None):
    """Per-op live-byte profile of the transient (activation + gradient)
    set.  Returns (per_op_live_bytes, peak_bytes, peak_op_index)."""
    first_def, last_use, sizes = (lifetimes if lifetimes is not None
                                  else _lifetimes(block, batch_size,
                                                  skip_uses_of))
    n_ops = len(block.ops)
    deltas = [0] * (n_ops + 1)
    for name, b in sizes.items():
        deltas[first_def[name]] += b
        deltas[last_use[name] + 1] -= b
    live = []
    cur = 0
    for i in range(n_ops):
        cur += deltas[i]
        live.append(cur)
    peak_i = int(np.argmax(live)) if live else 0
    return live, (live[peak_i] if live else 0), peak_i


def projected_peak_bytes(program: Program, batch_size: int = 64,
                         block_id: int = 0,
                         honor_remat: bool = False) -> Dict[str, int]:
    """Desc-level projection of peak HBM residency for one train step:
    persistent state (params + optimizer moments, counted once — donation
    updates them in place) plus the peak live transient set.
    `honor_remat=True` applies the program's CURRENT ``__remat__``
    marking (the quantified-contract currency —
    analysis/contracts.planner_peak_bytes delegates here so the PTV017
    referee and the pass share one formula)."""
    block = program.blocks[block_id]
    persistent = sum(
        _var_bytes(v, batch_size) for v in block.vars.values()
        if v.persistable)
    marked = ([op for op in block.ops if op.attrs.get("__remat__")]
              if honor_remat else ())
    _, act_peak, peak_i = analyze_liveness(block, batch_size, marked)
    return {
        "persistent_bytes": int(persistent),
        "activation_peak_bytes": int(act_peak),
        "total_bytes": int(persistent + act_peak),
        "peak_op_index": peak_i,
    }


def _grad_candidates(block, batch_size: int = 64, peak_i=None,
                     marked=(), lifetimes=None) -> List[tuple]:
    """(savings_bytes, op) for each unmarked generic_grad.

    Savings = bytes of the op's forward-output activations that are LIVE
    AT THE CURRENT PEAK op (span peak_i under the current marking) — a
    var that dies before the peak contributes nothing to it, and marking
    its grad op would pay remat FLOPs without moving peak HBM.
    `lifetimes` lets the caller pass the (first_def, last_use, sizes)
    triple it already computed for the same (block, batch_size, marked)."""
    first_def, last_use, sizes = (lifetimes if lifetimes is not None
                                  else _lifetimes(block, batch_size,
                                                  marked))
    marked_ids = {id(op) for op in marked}
    out = []
    for op in block.ops:
        if op.type != "generic_grad" or id(op) in marked_ids \
                or op.attrs.get("__remat__"):
            continue
        saved = 0
        for slot in op.attrs.get("__fwd_output_slots__", ()):
            for name in op.input(slot):
                if name not in sizes:
                    continue
                if peak_i is None or (first_def.get(name, 0) <= peak_i
                                      <= last_use.get(name, -1)):
                    saved += sizes[name]
        out.append((saved, op))
    return out


def memory_optimize(program: Program, level: int = 0,
                    batch_size: int = 64,
                    hbm_bytes: Optional[int] = None,
                    block_id: int = 0) -> int:
    """Mark grad ops for rematerialization; returns #ops marked.

    level=0 (default): selective — nothing is marked while the projected
    peak fits 90% of the HBM budget; above it, grad ops are marked
    largest-forward-footprint first until the projection fits (or all are
    marked).  level=1: blanket marking (every grad op), for programs that
    cannot compile without full checkpointing.

    hbm_bytes: explicit budget; defaults to the card's capacity
    (``memory.total()`` of CUDAPlace(0), read only when CUDA is already
    initialized in this process), then $PADDLE_TPU_HBM_BYTES, then
    16 GiB.
    batch_size binds -1 feed dims in the projection.

    Under PADDLE_TPU_VERIFY=1 the pass runs inside its verified-in/
    verified-out contract (analysis/contracts.py): program checked before
    and after, the marking must provably not extend any live range
    (PTV012), a level-0 marking must provably REDUCE the projected
    peak (PTV017) — `contracts.checked_memory_optimize(report={})`
    returns the quantified before/after/reduction — and the pass must
    PROVE it changed no semantics (analysis/equivalence.py: the marking
    may only touch attrs, so the canonical forms must be identical;
    structural drift is PTV022).  For the workspace-aware absolute
    estimate see `analysis.memory.peak_estimate`; this module's
    projection is the planner's own optimistic currency.
    """
    from .analysis import contracts

    if contracts.should_wrap():
        return contracts.checked_memory_optimize(
            program, level=level, batch_size=batch_size,
            hbm_bytes=hbm_bytes, block_id=block_id)
    block = program.blocks[block_id]
    if level >= 1:
        n = 0
        for op in block.ops:
            if op.type == "generic_grad":
                op.attrs["__remat__"] = True
                n += 1
        program._bump()
        return n

    if hbm_bytes is None:
        hbm_bytes = 0
        import torch

        # ask the card only when CUDA is already up: a desc-level pass
        # never initializes a device
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            from . import memory as _memory
            from .framework.place import CUDAPlace

            hbm_bytes = _memory.total(CUDAPlace(0))
        if not hbm_bytes:
            hbm_bytes = int(os.environ.get("PADDLE_TPU_HBM_BYTES",
                                           _DEFAULT_HBM))
    budget = int(hbm_bytes * 0.9)

    persistent = sum(
        _var_bytes(v, batch_size) for v in block.vars.values()
        if v.persistable)

    # iterative peak-aware greedy: each round recomputes liveness under
    # the current marking (marked grad ops' recomputed activations die at
    # their last FORWARD use), then marks the candidate saving the most
    # bytes AT the current peak.  Stops when the projection fits, or when
    # no candidate moves the peak (marking further would pay remat FLOPs
    # without making the program fit — e.g. a persistent-state deficit
    # remat cannot fix).
    marked: List = []
    while True:
        lt = _lifetimes(block, batch_size, marked)  # one sweep per round
        _, act_peak, peak_i = analyze_liveness(block, batch_size, marked,
                                               lifetimes=lt)
        if persistent + act_peak <= budget:
            break
        cands = _grad_candidates(block, batch_size, peak_i, marked,
                                 lifetimes=lt)
        best = max(cands, key=lambda t: t[0], default=(0, None))
        if best[1] is None or best[0] <= 0:
            break
        marked.append(best[1])
    for op in marked:
        op.attrs["__remat__"] = True
    if marked:
        program._bump()
    return len(marked)


def release_memory(program: Program):
    """API parity (reference release_memory): the executor drops each
    step's transients when the step ends; nothing to do at desc level."""
    return program
