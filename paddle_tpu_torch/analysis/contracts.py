"""Verified-in/verified-out contracts around the transpilers — the port
of ``paddle_tpu/analysis/contracts.py``.

Each wrapper verifies the program BEFORE the pass (garbage in is the
pass author's best alibi — take it away), runs the pass, then verifies
the result plus pass-specific postconditions, and carries a
translation-validation proof obligation (analysis/equivalence.
prove_equivalent): invariants bound the damage, equivalence establishes
the rewrite MEANS the same thing.

  checked_memory_optimize — liveness may only shrink (PTV012), a
                            selective marking must reduce the projected
                            peak (PTV017), and the marking must leave the
                            program structurally equivalent (PTV022)
  checked_fuse_batch_norm — still-inference program, folds conserved, and
                            the fold PROVEN by the differential oracle:
                            the before-program over the pre-fold scope
                            snapshot against the after-program over the
                            folded scope, on the fetches
  checked_sharding_plan   — parallel.DistributeTranspiler.transpile: the
                            program verifies, stays unmutated (version
                            and canonical form) and every plan key names
                            a declared variable (PTV013)
  checked_distribute_transpile — the pserver split
                            (distributed/distribute_transpiler.py): the
                            trainer program still materializes every
                            gradient the pserver round expects, no
                            optimizer op survives (PTV014), and pruned to
                            the gradients trainer and original
                            canonicalize identically (PTV022)

A refuted obligation raises VerificationError with PTV022/PTV024
findings.  The wrappers are also installed *inside* their passes
(``memory_optimize``, ``inference_transpiler.fuse_batch_norm``, the
distribute transpiler's ``transpile``) behind the PADDLE_TPU_VERIFY=1
env gate (see `should_wrap`), so a flag flip turns the pass into a
checked pass without touching call sites.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from .verifier import (Finding, Report, VerificationError,
                       env_verify_enabled, verify_program)

_local = threading.local()


def _depth() -> int:
    return getattr(_local, "depth", 0)


def should_wrap() -> bool:
    """True when a transpiler entry point should route through its checked
    wrapper: the env gate is on and we are not already inside one."""
    return env_verify_enabled() and _depth() == 0


class _inside:
    def __enter__(self):
        _local.depth = _depth() + 1

    def __exit__(self, *exc):
        _local.depth = _depth() - 1
        return False


def _verify(program, stage, **kw) -> Report:
    rep = verify_program(program, **kw)
    rep.raise_if_errors(stage)
    return rep


# ---------------------------------------------------------------------------
# memory_optimize: liveness must only shrink


def liveness_snapshot(program, batch_size: int = 64, block_id: int = 0) -> dict:
    """Effective (first_def, last_use) intervals + projected peak under the
    program's CURRENT remat marking — the memory_optimize postcondition
    baseline."""
    from ..memory_optimization_transpiler import _lifetimes, analyze_liveness

    block = program.blocks[block_id]
    marked = [op for op in block.ops if op.attrs.get("__remat__")]
    lt = _lifetimes(block, batch_size, marked)
    _, peak, _ = analyze_liveness(block, batch_size, marked, lifetimes=lt)
    first_def, last_use, sizes = lt
    return {"first_def": dict(first_def), "last_use": dict(last_use),
            "peak": int(peak), "n_ops": len(block.ops)}


def liveness_diff(before: dict, program, batch_size: int = 64,
                  block_id: int = 0) -> List[Finding]:
    """PTV012 findings for every var whose effective live interval grew —
    or a projected-peak regression — relative to `before`."""
    after = liveness_snapshot(program, batch_size, block_id)
    findings: List[Finding] = []
    for name, lu in after["last_use"].items():
        b_lu = before["last_use"].get(name)
        if b_lu is not None and lu > b_lu:
            findings.append(Finding(
                "PTV012", f"last use moved from op {b_lu} to op {lu}",
                block=block_id, var=name))
    for name, fd in after["first_def"].items():
        b_fd = before["first_def"].get(name)
        if b_fd is not None and fd < b_fd:
            findings.append(Finding(
                "PTV012", f"first def moved from op {b_fd} to op {fd}",
                block=block_id, var=name))
    if after["peak"] > before["peak"]:
        findings.append(Finding(
            "PTV012", f"projected activation peak rose "
            f"{before['peak']} -> {after['peak']} bytes", block=block_id))
    return findings


def planner_peak_bytes(program, batch_size: int = 64,
                       block_id: int = 0) -> int:
    """Projected peak (persistent + activation peak) in the
    memory_optimize PLANNER's own model, under the program's CURRENT
    remat marking — the currency the pass promises to reduce."""
    from ..memory_optimization_transpiler import projected_peak_bytes

    return int(projected_peak_bytes(program, batch_size, block_id,
                                    honor_remat=True)["total_bytes"])


def quantified_peak_reduction(before_peak: int, program,
                              batch_size: int = 64, block_id: int = 0,
                              marked: int = 0) -> tuple:
    """(after_peak, findings): PTV017 when the pass marked ops yet its
    projected peak did not drop — remat FLOPs paid for no memory win."""
    after_peak = planner_peak_bytes(program, batch_size, block_id)
    findings: List[Finding] = []
    if marked > 0 and after_peak >= before_peak:
        findings.append(Finding(
            "PTV017", f"marked {marked} grad op(s) for remat but the "
            f"projected peak went {before_peak} -> {after_peak} bytes "
            f"(reduction {before_peak - after_peak})", block=block_id))
    return after_peak, findings


def checked_memory_optimize(program, level: int = 0, batch_size: int = 64,
                            hbm_bytes: Optional[int] = None,
                            block_id: int = 0,
                            report: Optional[dict] = None) -> int:
    """memory_optimize under contract; returns #ops marked (same as the
    raw pass).  Raises VerificationError on bad input, bad output, any
    extended live range / peak regression (PTV012), a marking that did
    not reduce the projected peak (PTV017), or a marking that changed
    program STRUCTURE at all (PTV022 — the remat attr is the only thing
    this pass may touch; the equivalence proof runs at the structural
    tier).  Pass `report={}` to receive {"peak_before", "peak_after",
    "reduction_bytes", "marked"}."""
    from ..framework.core import Program
    from ..memory_optimization_transpiler import memory_optimize
    from .equivalence import prove_equivalent

    _verify(program, "memory_optimize:in", block_id=block_id,
            check_shapes=False)
    before = liveness_snapshot(program, batch_size, block_id)
    peak_before = planner_peak_bytes(program, batch_size, block_id)
    before_prog = Program.from_json(program.to_json())
    with _inside():
        n = memory_optimize(program, level=level, batch_size=batch_size,
                            hbm_bytes=hbm_bytes, block_id=block_id)
    _verify(program, "memory_optimize:out", block_id=block_id,
            check_shapes=False)
    bad = liveness_diff(before, program, batch_size, block_id)
    if bad:
        raise VerificationError("memory_optimize:liveness", bad)
    prove_equivalent(before_prog, program, block_id=block_id,
                     execute="never").raise_if_failed(
        "memory_optimize:equivalence")
    # level>=1 is the blanket trade: its contract is PTV012 only (marking
    # everything may leave the peak where it was on an activation-light
    # program)
    peak_after, findings = quantified_peak_reduction(
        peak_before, program, batch_size, block_id,
        marked=n if level < 1 else 0)
    if report is not None:
        report.update(peak_before=int(peak_before),
                      peak_after=int(peak_after),
                      reduction_bytes=int(peak_before - peak_after),
                      marked=int(n))
    if findings:
        raise VerificationError("memory_optimize:peak", findings)
    return n


# ---------------------------------------------------------------------------
# the pserver distribute transpiler


def checked_distribute_transpile(transpiler, trainer_id, program=None,
                                 pservers: str = "", trainers: int = 1,
                                 split_method=None, startup_program=None):
    """DistributeTranspiler.transpile under contract.  The out-check runs
    with fetch_names = the grad fetch list: the trainer program must still
    materialize every gradient the pserver round expects — deleting a
    grad-producing op (the reference's lost send op) is PTV004.  The
    equivalence obligation is stated over the SAME fetch set with
    preserve_state=False: pruned to the gradients, trainer and original
    must canonicalize identically — the split may move the optimizer
    update to the pserver, it may not change what a gradient means."""
    from ..framework.core import Program, default_main_program
    from .equivalence import prove_equivalent

    program = program if program is not None else default_main_program()
    _verify(program, "distribute_transpile:in", check_shapes=False)
    before_prog = Program.from_json(program.to_json())
    with _inside():
        result = transpiler.transpile(
            trainer_id, program=program, pservers=pservers,
            trainers=trainers, split_method=split_method,
            startup_program=startup_program)
    verify_distribute_result(transpiler)
    grad_names = sorted(transpiler.param_grad.values())
    if grad_names:
        prove_equivalent(before_prog, transpiler.program,
                         fetch_names=grad_names,
                         preserve_state=False).raise_if_failed(
            "distribute_transpile:equivalence")
    return result


def verify_distribute_result(transpiler):
    """Out-half of the distribute contract, callable on its own against a
    (possibly further-mutated) transpiled trainer program."""
    grad_names = list(transpiler.param_grad.values())
    _verify(transpiler.program, "distribute_transpile:out",
            fetch_names=grad_names, check_shapes=False)
    remaining = [op.type for b in transpiler.program.blocks for op in b.ops
                 if op.type in _optimize_op_types()]
    if remaining:
        raise VerificationError("distribute_transpile:out", [Finding(
            "PTV014", f"optimizer ops {remaining} survived the split — "
            f"the pserver would double-apply updates")])


def _optimize_op_types():
    from ..distributed.distribute_transpiler import OPTIMIZE_OP_TYPES

    return OPTIMIZE_OP_TYPES


# ---------------------------------------------------------------------------
# the sharding transpiler


def checked_sharding_plan(transpiler, program, mesh) -> Dict[str, object]:
    """parallel.DistributeTranspiler.transpile under contract: the program
    must verify before AND be unmutated after (this transpiler assigns
    shardings, it must not rewrite), and every plan key must name a
    declared variable (PTV013).  The version check catches honest
    mutation; the equivalence proof (structural tier, execute="never")
    additionally catches a pass that edits descs while restoring the
    version counter — the program must CANONICALIZE identically."""
    from ..framework.core import Program
    from .equivalence import prove_equivalent

    _verify(program, "sharding_transpile:in", check_shapes=False)
    version = program._version
    before_prog = Program.from_json(program.to_json())
    with _inside():
        plan = transpiler.transpile(program, mesh)
    if program._version != version:
        raise VerificationError("sharding_transpile:out", [Finding(
            "PTV014", "sharding transpiler mutated the program (version "
            f"{version} -> {program._version}); it must only assign specs")])
    prove_equivalent(before_prog, program,
                     execute="never").raise_if_failed(
        "sharding_transpile:equivalence")
    declared = set()
    for b in program.blocks:
        declared.update(b.vars)
    bad = [Finding("PTV013", "plan assigns a sharding to an undeclared "
                   "variable", var=n)
           for n in plan if n not in declared]
    if bad:
        raise VerificationError("sharding_transpile:out", bad)
    return plan


# ---------------------------------------------------------------------------
# inference transpiler


def _scope_snapshot(program, scope, block_id: int = 0) -> dict:
    """Copies of every scope value the block references — the pre-pass
    world the equivalence oracle replays the BEFORE program against (the
    fold rewrites filter values in place)."""
    block = program.blocks[block_id]
    names = set()
    for op in block.ops:
        names.update(n for n in op.input_names() if n)
        names.update(n for n in op.output_names() if n)
    out = {}
    for n in names:
        v = scope.find(n) if scope is not None else None
        if v is not None:
            out[n] = v.detach().clone()
    return out


def _place_of(values):
    """Where the scope's values live: the differential oracle runs there
    (a card's values are checked on the card, not copied off it)."""
    from ..framework.place import CPUPlace, CUDAPlace

    for v in values:
        if v.device.type == "cuda":
            return CUDAPlace(v.device.index or 0)
    return CPUPlace()


def checked_fuse_batch_norm(program, scope, block_id: int = 0,
                            fetch_names=(), rtol: float = 1e-3,
                            atol: float = 1e-5) -> int:
    """fuse_batch_norm under contract; returns #folds.  Postconditions:
    the program still verifies, every batch_norm that folded is gone, no
    fold touched a declared fetch target — and the fold PROVES
    equivalence: the fused program over the folded scope must produce
    the same fetches as the original program over the pre-fold scope
    snapshot on deterministic feeds (the differential oracle; a fold is
    structurally different by design, so structure alone cannot clear
    it).  `rtol`/`atol` bound the float drift the float64 fold math is
    allowed (PTV024 beyond it).  The oracle runs where the scope's values
    live."""
    from ..framework.core import Program
    from ..framework.scope import Scope
    from ..inference_transpiler import fuse_batch_norm
    from .equivalence import prove_equivalent, sink_outputs

    fetch = list(fetch_names)
    _verify(program, "fuse_batch_norm:in", fetch_names=fetch or None,
            block_id=block_id, check_shapes=False)
    n_bn_before = sum(1 for op in program.blocks[block_id].ops
                      if op.type == "batch_norm")
    before_prog = Program.from_json(program.to_json())
    snapshot = _scope_snapshot(program, scope, block_id)
    with _inside():
        folded = fuse_batch_norm(program, scope, block_id,
                                 fetch_names=fetch)
    _verify(program, "fuse_batch_norm:out", fetch_names=fetch or None,
            block_id=block_id, check_shapes=False)
    n_bn_after = sum(1 for op in program.blocks[block_id].ops
                     if op.type == "batch_norm")
    if n_bn_before - n_bn_after != folded:
        raise VerificationError("fuse_batch_norm:out", [Finding(
            "PTV014", f"pass reported {folded} folds but batch_norm count "
            f"went {n_bn_before} -> {n_bn_after}", block=block_id)])
    if folded:
        scope_before = Scope()
        for n, v in snapshot.items():
            scope_before.set(n, v)
        # preserve_state=False: the obligation is the inference FETCHES —
        # the fold legitimately drops batch_norm's pass-through running-
        # stat write-backs (test-mode no-ops), which full state
        # comparison would misread as divergence
        prove_equivalent(
            before_prog, program,
            fetch_names=fetch or sink_outputs(program.blocks[block_id]),
            block_id=block_id, scope_before=scope_before,
            scope_after=scope, preserve_state=False, rtol=rtol,
            atol=atol, place=_place_of(snapshot.values())).raise_if_failed(
                "fuse_batch_norm:equivalence")
    return folded
