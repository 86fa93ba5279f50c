"""ProgramDesc verifier: a rule engine with stable IDs and severities —
the port of ``paddle_tpu/analysis/verifier.py`` (same rule ids, titles
and severities).

Every rule has a stable ``PTVnnn`` id (never renumbered — suppressions and
CI greps depend on them), a severity, and a checker.  `verify_program`
runs the enabled rules over a Program and returns a `Report`; only
``error`` findings make `raise_if_errors` throw, so warning-tier rules can
flag suspicious-but-legal programs without failing runs.

Suppression syntax (documented in docs/analysis.md):
  * per-op:   op.attrs["__verify_suppress__"] = "PTV007,PTV010"  (or list,
              or "*" for all) — silences findings anchored to that op
  * per-call: verify_program(..., suppress={"PTV006"})

The shape/dtype rule (PTV006) runs each op's registered torch emitter on
``torch.device("meta")`` tensors, which carry shape and dtype and hold no
data — the op registry IS the shape-inference oracle, so there is no
second shape-function corpus to drift out of sync.  An emitter that
raises there (one that reads a value on the host: ``.item()``,
``nonzero``, LoD lengths) poisons its outputs, and the rule never
guesses past it.  Declared dtypes are kept as declared (the JAX package
narrows int64/float64 as JAX's 32-bit mode does; under its 64-bit mode
the two agree).

The rules that need a sharding plan (PTV016, PTV018-PTV021) run when
``verify_program`` is given one (``analysis/sharding.py``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set

import torch

from . import dataflow

ERROR = "error"
WARNING = "warning"
INFO = "info"

_SEV_ORDER = {ERROR: 0, WARNING: 1, INFO: 2}


@dataclass(frozen=True)
class Rule:
    id: str
    title: str
    severity: str
    doc: str


# The catalog. IDs are stable; add new rules at the end, never renumber.
RULES: Dict[str, Rule] = {r.id: r for r in [
    Rule("PTV001", "use-before-def", ERROR,
         "an op reads a variable whose only in-block definition comes "
         "later; the executor would feed it a stale scope value (or fail)"),
    Rule("PTV002", "unregistered-op", ERROR,
         "op type has no emitter in ops/registry.py — lowering would fail"),
    Rule("PTV003", "dangling-feed", WARNING,
         "a feed target names no variable declared anywhere in the "
         "program (warning: Executor._prepare_feeds passes undeclared "
         "feed names through, so a superset feed dict is legal)"),
    Rule("PTV004", "dangling-fetch", ERROR,
         "a fetch target is neither produced by the block, nor fed, nor "
         "read from the scope — Executor.run would KeyError"),
    Rule("PTV005", "invalid-sub-block", ERROR,
         "a control-flow op's block attr (sub_block/true_block/false_block) "
         "is out of range, self-referential, or points at block 0"),
    Rule("PTV006", "shape-dtype-mismatch", WARNING,
         "abstract eval of the op's emitter disagrees with the declared "
         "static shape/dtype of an output variable"),
    Rule("PTV007", "waw-hazard", WARNING,
         "two writes to the same variable with no happens-before path: a "
         "reordering pass or concurrent region can flip which write wins"),
    Rule("PTV008", "war-hazard", WARNING,
         "a read and a later write of the same variable with no "
         "happens-before path: scheduling the write first changes the "
         "value the read observes"),
    Rule("PTV009", "missing-grad", WARNING,
         "a trainable parameter feeds the differentiated region but no op "
         "produces its @GRAD — it would silently never train"),
    Rule("PTV010", "dead-op", WARNING,
         "no output of the op is consumed, persistable, fetched, or "
         "side-effecting — it is dead weight a pass probably orphaned"),
    Rule("PTV011", "unused-var", INFO,
         "a declared non-persistable variable no op reads or writes"),
    Rule("PTV012", "live-range-extended", ERROR,
         "a transpiler pass extended a variable's live interval or raised "
         "projected peak residency (memory_optimize contract)"),
    Rule("PTV013", "unknown-plan-var", ERROR,
         "a sharding plan entry names a variable the program does not "
         "declare (parallel transpiler contract)"),
    Rule("PTV014", "contract-postcondition", ERROR,
         "a transpiler broke its own output contract: optimizer ops "
         "survived the distribute split, fold count disagrees with the "
         "batch_norm census, or a plan-only pass mutated the program"),
    Rule("PTV015", "donated-overwrite-race", WARNING,
         "a read of donated (read-then-written) scope state races a BLIND "
         "overwrite (a write whose op does not consume the old value): "
         "under buffer donation the overwrite invalidates the storage the "
         "read needs, so an unordered schedule is a use-after-free, not "
         "just a value change"),
    Rule("PTV016", "sharded-donated-state", WARNING,
         "donated rw-state is sharded over mesh axes under the given "
         "plan: host materialization of a stale handle after the step "
         "(checkpoint gathers, np.asarray on the old array) is the native "
         "jax-CPU crash family contained in tests/_native_isolation.py — "
         "gather on device or go through distributed.checkpoint"),
    Rule("PTV017", "remat-peak-not-reduced", ERROR,
         "memory_optimize marked grad ops for rematerialization but the "
         "projected HBM peak did not drop — remat FLOPs paid for no "
         "memory win (quantified memory_optimize contract)"),
    Rule("PTV018", "sharding-conflict", ERROR,
         "two sharding rules force incompatible specs on one variable "
         "(one mesh axis claimed by two dims, or an explicit constraint "
         "contradicting the rule-derived spec) — no device assignment "
         "satisfies the plan"),
    Rule("PTV019", "implicit-reshard", WARNING,
         "sharding propagation had to insert a reshard of a TRANSIENT "
         "value at an op boundary: the gather is re-paid every step "
         "(feeds/params reshard once at distribution time and are "
         "exempt)"),
    Rule("PTV020", "replicated-large-tensor", INFO,
         "a large tensor is left fully replicated although a mesh axis "
         "divides one of its dims — a sharding rule could cut its "
         "per-device residency by the axis size"),
    Rule("PTV021", "dcn-crossing-collective", WARNING,
         "a collective inside the inner step spans a DCN mesh axis "
         "('dcn' name prefix, parallel/mesh.py): DCN bandwidth is ~10x "
         "below ICI, so per-step collectives must stay intra-slice"),
    Rule("PTV022", "transpiler-changed-semantics", ERROR,
         "translation validation refuted a rewrite: the canonical forms "
         "differ and either the contract forbids structural drift, a "
         "fetch's abstract shape/dtype signature moved, or the "
         "differential oracle confirmed divergence "
         "(analysis/equivalence.prove_equivalent)"),
    Rule("PTV023", "duplicate-canonical-subgraph", INFO,
         "an op recomputes a value an earlier op already produces (same "
         "type, attrs, and operand value numbers) — a duplicate "
         "canonical subgraph / missed CSE a pass probably introduced"),
    Rule("PTV024", "differential-fetch-divergence", ERROR,
         "concrete differential execution of an original/rewritten "
         "program pair on identical deterministic feeds produced "
         "fetch values outside tolerance — a semantics counterexample"),
]}

# ops the executor skips (framework/executor.py _NOOP_TYPES) plus desc-only
# markers: never checked against the registry
_DESC_ONLY_TYPES = ("feed", "fetch")

# ops whose execution has effects beyond their outputs: never "dead"
_SIDE_EFFECT_TYPES = ("save", "print", "while", "cond", "static_rnn",
                      "recompute")


@dataclass
class Finding:
    rule: str
    message: str
    severity: str = ""
    block: int = 0
    op: Optional[int] = None
    var: Optional[str] = None

    def __post_init__(self):
        if not self.severity:
            self.severity = RULES[self.rule].severity

    def format(self) -> str:
        where = f"block {self.block}"
        if self.op is not None:
            where += f" op {self.op}"
        if self.var:
            where += f" var {self.var!r}"
        return (f"{self.rule} [{self.severity}] {RULES[self.rule].title} "
                f"({where}): {self.message}")


class Report:
    """Findings of one verify_program run, most severe first."""

    def __init__(self, findings: Sequence[Finding], stats: Optional[dict] = None):
        self.findings = sorted(findings,
                               key=lambda f: (_SEV_ORDER[f.severity],
                                              f.rule, f.block,
                                              -1 if f.op is None else f.op))
        self.stats = stats or {}

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == WARNING]

    def __bool__(self):
        return bool(self.findings)

    def __len__(self):
        return len(self.findings)

    def render(self) -> str:
        ops = self.stats.get("ops", "?")
        vars_ = self.stats.get("vars", "?")
        if not self.findings:
            return f"OK: 0 findings ({ops} ops, {vars_} vars checked)"
        lines = [f.format() for f in self.findings]
        lines.append(
            f"{len(self.errors)} error(s), {len(self.warnings)} warning(s), "
            f"{len(self.findings) - len(self.errors) - len(self.warnings)} "
            f"info ({ops} ops, {vars_} vars checked)")
        return "\n".join(lines)

    def raise_if_errors(self, stage: str = "verify"):
        if self.errors:
            raise VerificationError(stage, self.errors)
        return self


class VerificationError(RuntimeError):
    """Program failed verification; carries the error-severity findings."""

    def __init__(self, stage: str, findings: Sequence[Finding]):
        self.stage = stage
        self.findings = list(findings)
        msg = "\n  ".join(f.format() for f in self.findings)
        super().__init__(
            f"program verification failed at {stage!r} "
            f"({len(self.findings)} error(s)):\n  {msg}")


# ---------------------------------------------------------------------------
# rule implementations — each yields Findings


def _op_suppressions(op) -> Set[str]:
    raw = op.attrs.get("__verify_suppress__")
    if raw is None:
        return set()
    if isinstance(raw, str):
        raw = raw.split(",")
    return {s.strip() for s in raw if s and s.strip()}


def _registered(op_type: str) -> bool:
    from ..ops.registry import has_op

    return op_type in _DESC_ONLY_TYPES or has_op(op_type)


def _check_registry(program):
    for b in program.blocks:
        for i, op in enumerate(b.ops):
            if not _registered(op.type):
                yield Finding("PTV002", f"op type {op.type!r} has no "
                              f"registered emitter", block=b.idx, op=i)


def _check_sub_blocks(program):
    n = len(program.blocks)
    for b in program.blocks:
        for i, op in enumerate(b.ops):
            for key in dataflow.SUB_BLOCK_ATTRS:
                if key not in op.attrs:
                    continue
                idx = op.attrs[key]
                if not isinstance(idx, int) or isinstance(idx, bool) \
                        or idx <= 0 or idx >= n:
                    yield Finding(
                        "PTV005", f"attr {key}={idx!r} does not name a "
                        f"nested block (program has blocks 1..{n - 1})",
                        block=b.idx, op=i)
                elif idx == b.idx:
                    yield Finding("PTV005", f"attr {key} points at the "
                                  f"op's own block", block=b.idx, op=i)
                elif program.blocks[idx].parent_idx != b.idx:
                    yield Finding(
                        "PTV005", f"attr {key}={idx}: that block's "
                        f"parent_idx is {program.blocks[idx].parent_idx}, "
                        f"not this block ({b.idx})", severity=WARNING,
                        block=b.idx, op=i)


def _is_external(block, name) -> bool:
    """May `name` legitimately come from outside the block (scope state or
    an enclosing block's dataflow)?"""
    v = block._find_var_recursive(name)
    if v is None:
        # undeclared names still resolve through the scope at run time
        # (lod length companions, loader-injected values) — treat as
        # external rather than invent a stricter rule than the executor's
        return True
    if v.persistable or v.is_data:
        return True
    # declared in an ancestor block -> outer dataflow provides it
    return name not in block.vars


def _check_use_before_def(program):
    # top-level blocks only: nested blocks' carried vars are defined by the
    # enclosing control-flow op's semantics, not by textual order
    for b in program.blocks:
        if b.parent_idx >= 0:
            continue
        defs, uses = dataflow.def_use(b)
        for name, dlist in defs.items():
            first_def = dlist[0]
            for k in uses.get(name, []):
                if k < first_def and not _is_external(b, name):
                    yield Finding(
                        "PTV001", f"read at op {k} precedes the first "
                        f"definition at op {first_def}", block=b.idx,
                        op=k, var=name)
                    break  # one finding per name


def _check_feeds(program, feed_names):
    declared = set()
    for b in program.blocks:
        declared.update(b.vars)
    for name in feed_names or ():
        if name not in declared:
            yield Finding("PTV003", f"feed target {name!r} is not a "
                          f"declared variable", var=name)


def _check_fetches(program, block_id, fetch_names, feed_names):
    if not fetch_names:
        return
    block = program.blocks[block_id]
    available = set(feed_names or ())  # feeds land in the env directly
    for op in block.ops:
        available.update(n for n in op.input_names() if n)   # scope reads
        available.update(n for n in op.output_names() if n)  # produced
    for name in fetch_names:
        if name not in available:
            yield Finding(
                "PTV004", f"fetch target {name!r} is neither produced nor "
                f"read by block {block_id} — nothing would materialize it",
                block=block_id, var=name)


def _check_hazards(program):
    for b in program.blocks:
        if b.parent_idx >= 0:
            continue
        for kind, name, i, j in dataflow.hazards(b):
            rule = "PTV007" if kind == "WAW" else "PTV008"
            verb = "write" if kind == "WAW" else "read"
            yield Finding(
                rule, f"{verb} at op {i} ({b.ops[i].type}) and write at op "
                f"{j} ({b.ops[j].type}) have no happens-before path",
                block=b.idx, op=j, var=name)


def _donated_by_block(program, feed_names):
    """{block_idx: rw-state names} for top-level blocks — the buffers
    the executor donates, computed ONCE and shared by PTV015/PTV016.
    Feed context defaults to the declared data vars when the caller gave
    none (matching what Executor.run would classify)."""
    out = {}
    for b in program.blocks:
        if b.parent_idx >= 0:
            continue
        feeds = feed_names
        if feeds is None:
            feeds = [n for n, v in b.vars.items() if v.is_data]
        _, rw_state, _ = dataflow.state_classes(b, feeds)
        out[b.idx] = rw_state
    return out


def _check_donation_races(program, donated):
    """PTV015: for every donated name, each read of the OLD (scope)
    value — i.e. before the first in-block write — must happen-before
    that write, UNLESS the writing op itself consumes the old value
    (the sgd Param->ParamOut / beta-pow / K/V-pool self-update idiom,
    where XLA's aliasing keeps the in-place update sound regardless of
    schedule).  A blind overwrite with an unordered reader is flagged:
    donation makes that schedule a use-after-free.  The happens-before
    closure is only built when a blind-write candidate exists — clean
    programs (every state write a self-update) never pay for it."""
    for b in program.blocks:
        rw = donated.get(b.idx)
        if not rw:
            continue
        defs, uses = dataflow.def_use(b)
        candidates = []
        for name in rw:
            dlist = defs.get(name)
            if not dlist:
                continue
            first_def = dlist[0]
            # old-value readers: only reads BEFORE the first write observe
            # the scope (donated) buffer; reads between writes observe SSA
            # values and belong to PTV008's WAR domain
            readers = [k for k in uses.get(name, []) if k < first_def]
            if not readers:
                continue
            # EVERY blind write races them, not just the first — a clean
            # self-update first write must not shadow a later blind one
            # (the donated allocation stays aliased through the chain)
            blind = [j for j in dlist
                     if name not in b.ops[j].input_names()]
            if blind:
                candidates.append((name, blind, readers))
        if not candidates:
            continue
        anc = dataflow.happens_before(b)
        for name, blind, readers in candidates:
            done = False
            for j in blind:
                for k in readers:
                    if not (anc[j] >> k) & 1:
                        yield Finding(
                            "PTV015",
                            f"op {k} ({b.ops[k].type}) reads the donated "
                            f"buffer and op {j} ({b.ops[j].type}) blindly "
                            f"overwrites it with no happens-before path",
                            block=b.idx, op=j, var=name)
                        done = True
                        break  # one finding per name
                if done:
                    break


def _check_sharded_donation(program, donated, plan, provenance=None):
    """PTV016: donated rw-state sharded over >=1 mesh axis under `plan`.
    Sharded-ness is judged by NAMED AXES in the spec, not the byte
    divisor: a bare PartitionSpec carries no mesh (divisor would be 1)
    yet still declares the var sharded — the rule must not go silently
    inert on that documented input.  A NamedSharding whose named axes
    all have size 1 is effectively replicated and exempt.  `provenance`
    ({var: "which rule produced this spec"}, from
    `ParallelExecutor.static_plan(provenance=...)`) pins each finding to
    the AXIS RULE that made the state sharded."""
    from .memory import shard_divisor, _spec_entries

    if not plan:
        return
    provenance = provenance or {}
    for b in program.blocks:
        if b.parent_idx >= 0:
            continue
        for name in donated.get(b.idx, ()):
            sh = plan.get(name)
            if sh is None:
                continue
            axes = tuple(_spec_entries(sh))
            if not axes:
                continue
            if getattr(sh, "mesh", None) is not None \
                    and shard_divisor(sh) <= 1:
                continue  # size-1 axes: replicated in practice
            src = provenance.get(name)
            yield Finding(
                "PTV016",
                f"donated state sharded over axes {axes} — host "
                f"materialization of a stale handle after the step can "
                f"abort natively"
                + (f" (sharded by rule: {src})" if src else ""),
                block=b.idx, var=name)


def _grad_name(name: str) -> str:
    from ..framework.core import GRAD_SUFFIX

    return name + GRAD_SUFFIX


def _check_missing_grad(program):
    from ..framework.core import GRAD_SUFFIX

    for b in program.blocks:
        if b.parent_idx >= 0:
            continue
        grad_ops = [op for op in b.ops
                    if op.type == "generic_grad" or op.type.endswith("_grad")]
        if not grad_ops:
            continue  # inference program: nothing to expect
        grads_defined = {n for op in b.ops for n in op.output_names()
                         if n and n.endswith(GRAD_SUFFIX)}
        differentiated = {n[: -len(GRAD_SUFFIX)] for n in grads_defined}
        for p in b.all_parameters():
            if not getattr(p, "trainable", True):
                continue
            if _grad_name(p.name) in grads_defined:
                continue
            reach = dataflow.forward_closure(
                b, {p.name},
                stop_types=("generic_grad",)) - {p.name}
            if reach & differentiated:
                yield Finding(
                    "PTV009", f"trainable parameter feeds differentiated "
                    f"values ({sorted(reach & differentiated)[:3]}...) but "
                    f"no op produces {_grad_name(p.name)!r}",
                    block=b.idx, var=p.name)


def _check_dead_ops(program, block_id, fetch_names):
    if fetch_names is None:
        # without fetch context any sink may be the caller's fetch target;
        # claiming deadness would be guesswork
        return
    live_targets = set(fetch_names)
    used_anywhere = set()
    for b in program.blocks:
        for op in b.ops:
            used_anywhere.update(n for n in op.input_names() if n)
    block = program.blocks[block_id]
    for i, op in enumerate(block.ops):
        if op.type in _SIDE_EFFECT_TYPES or op.type in _DESC_ONLY_TYPES:
            continue
        if dataflow.sub_block_indices(op):
            continue  # conservative: nested blocks may have effects
        outs = [n for n in op.output_names() if n]
        if not outs:
            continue

        def _live(n):
            if n in used_anywhere or n in live_targets:
                return True
            v = block._find_var_recursive(n)
            return v is not None and (v.persistable or v.is_data)

        if not any(_live(n) for n in outs):
            yield Finding(
                "PTV010", f"op {op.type!r} outputs {outs[:4]} are consumed "
                f"by nothing and fetch nothing", block=block_id, op=i)


def _check_unused_vars(program):
    touched = set()
    for b in program.blocks:
        for op in b.ops:
            touched.update(n for n in op.input_names() if n)
            touched.update(n for n in op.output_names() if n)
    for b in program.blocks:
        for name, v in b.vars.items():
            if name in touched or v.persistable or v.is_data:
                continue
            yield Finding("PTV011", "declared but never referenced by any "
                          "op", block=b.idx, var=name)


# ---------------------------------------------------------------------------
# PTV006: abstract shape/dtype eval against the op registry


class _Unknown:
    __slots__ = ()


_UNKNOWN = _Unknown()

_META = torch.device("meta")


def _bind_shape(shape, batch_size):
    return tuple(batch_size if (s is None or int(s) < 0) else int(s)
                 for s in shape)


def _abstract_seed(block, name, batch_size):
    """A meta tensor for an externally-provided value, or _UNKNOWN."""
    from ..framework.core import torch_dtype

    v = block._find_var_recursive(name)
    if v is None or v.shape is None or v.dtype is None:
        return _UNKNOWN
    try:
        return torch.empty(_bind_shape(v.shape, batch_size),
                           dtype=torch_dtype(v.dtype), device=_META)
    except (KeyError, ValueError, TypeError, RuntimeError):
        return _UNKNOWN


def _meta_lower_block(program, ctx):
    """ctx.lower_block for a meta walk: every op of the nested block in
    order on the given env, as the executor's ``_lower_block`` does."""
    from ..framework.executor import Executor

    def lower(idx, env):
        for op in program.blocks[idx].ops:
            Executor._run_op(op, env, ctx)
        return env

    return lower


def abstract_eval(program, block_id=0, batch_size=2):
    """Walk block `block_id` on meta tensors: each op's emitter runs on
    the inferred inputs.  Returns (env, outputs): env maps every value
    name seen to its meta tensor or _UNKNOWN; outputs lists (op index,
    {output name: meta tensor or _UNKNOWN}) per evaluated op.  Any op
    that cannot be evaluated (unknown inputs, host reads, data-dependent
    shapes) is skipped and poisons its outputs — the oracle never
    guesses.  No device code runs."""
    from ..framework.core import GRAD_SUFFIX
    from ..ops.registry import EmitContext, get_op_info, unbound_slots

    block = program.blocks[block_id]
    is_test = not any(op.type.endswith("_grad") for op in block.ops)
    env: Dict[str, object] = {}
    outputs = []
    for i, op in enumerate(block.ops):
        if op.type in _DESC_ONLY_TYPES or not _registered(op.type):
            continue
        skip = unbound_slots(op)
        ins = {}
        ok = True
        for slot, names in op.inputs.items():
            vals = []
            for n in names:
                if not n or slot in skip:
                    vals.append(None)
                    continue
                if n not in env:
                    env[n] = _abstract_seed(block, n, batch_size)
                if env[n] is _UNKNOWN:
                    ok = False
                    break
                vals.append(env[n])
            if not ok:
                break
            ins[slot] = vals
        outs_abs = None
        if ok:
            attrs = op.attrs
            if op.type == "generic_grad":
                attrs = dict(op.attrs)
                attrs["__wanted__"] = {
                    (slot[: -len(GRAD_SUFFIX)], k)
                    for slot, names in op.outputs.items()
                    for k, n in enumerate(names) if n}
            ctx = EmitContext(_META, is_test=is_test, program=program)
            ctx.lower_block = _meta_lower_block(program, ctx)
            try:
                with torch.no_grad():
                    outs_abs = get_op_info(op.type).emit(ctx, ins, attrs)
            except Exception:  # noqa: BLE001 — any failure poisons
                outs_abs = None
        got_by_name = {}
        for slot, names in op.outputs.items():
            vals = (outs_abs or {}).get(slot, []) if outs_abs else []
            for k, n in enumerate(names):
                if not n:
                    continue
                got = vals[k] if k < len(vals) else None
                if not isinstance(got, torch.Tensor) or got.device != _META:
                    env[n] = got_by_name[n] = _UNKNOWN
                    continue
                env[n] = got_by_name[n] = got
        outputs.append((i, got_by_name))
    return env, outputs


def abstract_walk(program, block_id=0, batch_size=2):
    """(env, findings): `abstract_eval` run to its end, each inferred
    output compared to its declared static shape and dtype (the PTV006
    mismatches).  env maps every value name to its meta tensor (or
    _UNKNOWN) — the oracle the equivalence engine's abstract tier reads
    fetch signatures from."""
    from ..framework.core import canonical_dtype

    block = program.blocks[block_id]
    findings: List[Finding] = []
    env, outputs = abstract_eval(program, block_id, batch_size)
    for i, outs in outputs:
        for n, got in outs.items():
            if got is _UNKNOWN:
                continue
            v = block._find_var_recursive(n)
            if v is None or v.shape is None:
                continue
            want = v.shape
            got_shape = tuple(int(s) for s in got.shape)
            static = all(s is not None and int(s) >= 0 for s in want)
            if static and len(want) == len(got_shape) \
                    and tuple(int(s) for s in want) != got_shape:
                findings.append(Finding(
                    "PTV006", f"declared shape {tuple(want)} but the "
                    f"registered emitter produces {got_shape}",
                    block=block_id, op=i, var=n))
            elif len(want) != len(got_shape) and static:
                findings.append(Finding(
                    "PTV006", f"declared rank {len(want)} "
                    f"{tuple(want)} but the registered emitter "
                    f"produces rank {len(got_shape)} {got_shape}",
                    block=block_id, op=i, var=n))
            elif v.dtype is not None:
                try:
                    declared = canonical_dtype(v.dtype)
                    inferred = canonical_dtype(got.dtype)
                except (KeyError, ValueError, TypeError):
                    continue
                if declared != inferred:
                    findings.append(Finding(
                        "PTV006", f"declared dtype {declared} but the "
                        f"registered emitter produces {inferred}",
                        block=block_id, op=i, var=n))
    return env, findings


def _check_shapes(program, block_id, batch_size):
    return abstract_walk(program, block_id, batch_size)[1]


# ---------------------------------------------------------------------------
# entry point


def verify_program(program, feed_names: Optional[Iterable[str]] = None,
                   fetch_names: Optional[Iterable[str]] = None, *,
                   block_id: int = 0, batch_size: int = 2,
                   rules: Optional[Iterable[str]] = None,
                   suppress: Iterable[str] = (),
                   check_shapes: bool = True,
                   plan: Optional[dict] = None,
                   plan_provenance: Optional[dict] = None) -> Report:
    """Run the rule engine over `program`; returns a `Report`.

    feed_names/fetch_names give the run context (PTV003/PTV004/PTV010 need
    them; omit fetch_names and dead-op analysis is skipped rather than
    guessed).  `rules` restricts to a subset of RULE ids; `suppress`
    removes ids globally; per-op suppression rides the
    ``__verify_suppress__`` attr.  `check_shapes=False` skips the abstract
    eval (PTV006) for desc-only speed.  `plan` ({var: NamedSharding /
    PartitionSpec}, e.g. `ParallelExecutor.static_plan(program)`) arms the
    sharded-donation rule (PTV016) AND the sharding-propagation family
    (PTV018-PTV021, analysis/sharding.py) for SPMD programs;
    `plan_provenance` ({var: rule description}, from
    `static_plan(provenance=...)`) names the axis rule inside PTV016
    findings."""
    feed_names = list(feed_names) if feed_names is not None else None
    fetch_names = list(fetch_names) if fetch_names is not None else None
    enabled = set(rules) if rules is not None else set(RULES)
    enabled -= set(suppress)

    findings: List[Finding] = []

    def want(rid):
        return rid in enabled

    if want("PTV002"):
        findings.extend(_check_registry(program))
    if want("PTV005"):
        findings.extend(_check_sub_blocks(program))
    if want("PTV001"):
        findings.extend(_check_use_before_def(program))
    if want("PTV003"):
        findings.extend(_check_feeds(program, feed_names))
    if want("PTV004"):
        findings.extend(_check_fetches(program, block_id, fetch_names,
                                       feed_names))
    if want("PTV007") or want("PTV008"):
        findings.extend(f for f in _check_hazards(program) if want(f.rule))
    if want("PTV009"):
        findings.extend(_check_missing_grad(program))
    if want("PTV010"):
        findings.extend(_check_dead_ops(program, block_id, fetch_names))
    if want("PTV011"):
        findings.extend(_check_unused_vars(program))
    if want("PTV015") or (want("PTV016") and plan):
        donated = _donated_by_block(program, feed_names)
        if want("PTV015"):
            findings.extend(_check_donation_races(program, donated))
        if want("PTV016"):
            findings.extend(_check_sharded_donation(program, donated,
                                                    plan,
                                                    plan_provenance))
    if want("PTV023"):
        from .equivalence import duplicate_findings

        findings.extend(duplicate_findings(program, block_id))
    if plan and any(want(r) for r in ("PTV018", "PTV019", "PTV020",
                                      "PTV021")):
        from .sharding import sharding_findings

        got, _ = sharding_findings(program, plan, batch_size=batch_size,
                                   block_id=block_id,
                                   provenance=plan_provenance)
        findings.extend(f for f in got if want(f.rule))
    if want("PTV006") and check_shapes \
            and not any(f.rule in ("PTV001", "PTV002") for f in findings):
        # abstract eval assumes a lowerable block; structural errors first
        findings.extend(_check_shapes(program, block_id, batch_size))

    # per-op suppressions
    kept = []
    for f in findings:
        if f.op is not None:
            sup = _op_suppressions(program.blocks[f.block].ops[f.op])
            if "*" in sup or f.rule in sup:
                continue
        kept.append(f)

    stats = {"ops": sum(len(b.ops) for b in program.blocks),
             "vars": sum(len(b.vars) for b in program.blocks),
             "blocks": len(program.blocks)}
    return Report(kept, stats)


def env_verify_enabled() -> bool:
    """The PADDLE_TPU_VERIFY=1 gate (Executor.run / transpiler contracts)."""
    return os.environ.get("PADDLE_TPU_VERIFY", "") not in ("", "0")
