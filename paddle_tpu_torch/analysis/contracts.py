"""Verified-in/verified-out contracts around the transpilers — the port
of ``paddle_tpu/analysis/contracts.py``.

Each wrapper verifies the program BEFORE the pass (garbage in is the
pass author's best alibi — take it away), runs the pass, then verifies
the result plus pass-specific postconditions, and carries a
translation-validation proof obligation (analysis/equivalence.
prove_equivalent): invariants bound the damage, equivalence establishes
the rewrite MEANS the same thing.

  checked_fuse_batch_norm — still-inference program, folds conserved, and
                            the fold PROVEN by the differential oracle:
                            the before-program over the pre-fold scope
                            snapshot against the after-program over the
                            folded scope, on the fetches

The wrappers of the passes the port lacks raise, naming their ROADMAP.md
Queue A item: `checked_memory_optimize`
(``memory_optimization_transpiler.py``, item 7),
`checked_distribute_transpile` and `checked_sharding_plan` (the
distribute and sharding transpilers, item 11).

A refuted obligation raises VerificationError with PTV022/PTV024
findings.  The fold's wrapper is also installed *inside*
``inference_transpiler.fuse_batch_norm`` behind the PADDLE_TPU_VERIFY=1
env gate (see `should_wrap`), so a flag flip turns the pass into a
checked pass without touching call sites.
"""

from __future__ import annotations

import threading
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
# passes the port lacks


def _unported(what, item, module):
    return NotImplementedError(
        f"{what}: {module} is not ported (ROADMAP.md Queue A item {item})")


def checked_memory_optimize(program, level: int = 0, batch_size: int = 64,
                            hbm_bytes=None, block_id: int = 0, report=None):
    raise _unported("checked_memory_optimize", 7,
                    "memory_optimization_transpiler.py")


def checked_distribute_transpile(transpiler, trainer_id, program=None,
                                 pservers: str = "", trainers: int = 1,
                                 split_method=None, startup_program=None):
    raise _unported("checked_distribute_transpile", 11,
                    "distributed/distribute_transpiler.py")


def checked_sharding_plan(transpiler, program, mesh):
    raise _unported("checked_sharding_plan", 11, "parallel/transpiler.py")


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
