"""Translation validation: prove a rewritten ProgramDesc means the same
thing as the original — the port of ``paddle_tpu/analysis/equivalence.py``.

Every desc-rewriting pass in this repo (memory_optimize, the conv+BN
fold, the distribute split, io.prune, future fusion passes and the
ROADMAP #2 partitioner collapse) so far ran under *invariant* contracts
(analysis/contracts.py): the output is well-formed, specific properties
hold.  Invariants bound the damage; they do not establish that the
rewrite preserved semantics.  This module adds the classic compiler
answer — translation validation (TVM validates graph rewrites against
reference semantics; TensorFlow's graph transformations carry the same
burden, PAPERS.md) — in three tiers, cheapest first:

1. **Canonicalization + structural equivalence** (`canonicalize`,
   `prove_equivalent` tier "structural"): both programs are normalized
   to a canonical form — dead ops pruned against the fetch set
   (reusing dataflow liveness), commutative operands sorted by value
   number, ops scheduled in a deterministic hazard-respecting
   topological order keyed by a structural hash, and transient names
   alpha-renamed to SSA-style ``%k``.  Identical canonical forms PROVE
   equivalence (the canonical order only reorders ops the data order
   leaves free).  Interface names — feeds, fetches, persistables,
   scope reads — are the program's ABI and are never renamed.

2. **Abstract differential interpretation** (tier "abstract"): when
   the canonical forms differ (a fusion-style rewrite), each fetch
   target's shape/dtype is derived by the PTV006 abstract-eval oracle
   (the op registry on meta tensors) on both sides; a disagreement is a
   semantics change no concrete run needs to witness.

3. **Concrete differential execution** (tier "differential"): both
   programs run on the port's Executor — on the CPU unless the caller
   gives a `place` — over small deterministic random feeds (seeded per
   feed NAME, so both sides see identical inputs; missing scope state
   is seeded the same way), with the executor's PRNG pinned via
   ``Executor.run(rng_step=0)``.  Per-fetch divergence beyond tolerance
   is a counterexample (PTV024); agreement validates
   structurally-different-but-equal rewrites (the fused-op case).

Failures surface as verifier findings with stable IDs: PTV022
(transpiler-changed-semantics, error), PTV023 (duplicate canonical
subgraph / missed CSE, info — found during canonicalization and by
`verify_program`), PTV024 (differential-test fetch divergence,
error).  `python -m paddle_tpu_torch diff a b` is the CLI face.

Plan equivalence of the parallelism modes (`mode_plan_equivalence`,
`plan_equivalence_report`) proves each mode's rule-driven plan and its
propagated collective footprint equal to the archive the port keeps
(``parallel/mode_plans_golden.json``, its own copy of the JAX
package's); `hybrid_parity_report` runs a 2-slice ``{dcn_dp, dp}`` step
against the flat ``{dp: 8}`` one at bitwise tolerance.  `loop_parity_report`
holds ``run(steps_per_dispatch=K)`` to K sequential runs, as the JAX
package's does; on the card, where the fused side replays a captured
CUDA graph, not on the CPU, where it walks the steps in sequence.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..framework.core import Program
from . import dataflow

# ---------------------------------------------------------------------------
# canonical form

# attrs that never change what a program COMPUTES: __uid__ is a PRNG
# identity salt (compared via execution, not structure), __remat__ is
# the memory_optimize perf marking, __verify_suppress__ is lint
# metadata.  Stripped recursively — generic_grad nests the forward op's
# attrs (including its __uid__) under __fwd_attrs__.
STRIP_ATTRS = ("__uid__", "__remat__", "__verify_suppress__")

# ops where swapping the X/Y operands is semantics-preserving when the
# declared operand shapes match (equal shapes ⇒ the broadcast `axis`
# attr is inert)
_COMMUTATIVE_XY = ("elementwise_add", "elementwise_mul",
                   "elementwise_max", "elementwise_min")
# variadic commutative reduction: operand order in the X list is free
_COMMUTATIVE_LIST = ("sum",)

# ops whose value depends on the PRNG stream, not only on inputs: two
# textually identical instances are DIFFERENT computations (their
# __uid__ salts differ), so they are exempt from duplicate detection
STOCHASTIC_TYPES = ("dropout", "uniform_random", "gaussian_random",
                    "truncated_gaussian_random", "sampling_id")

_SIDE_EFFECT_TYPES = ("save", "print", "while", "cond", "static_rnn",
                      "recompute")
_DESC_ONLY_TYPES = ("feed", "fetch")


def _strip_attrs(attrs):
    """Deep copy of `attrs` with the semantics-free keys removed at
    every nesting level (JSON-serializable output)."""
    if isinstance(attrs, dict):
        return {k: _strip_attrs(v) for k, v in sorted(attrs.items())
                if k not in STRIP_ATTRS}
    if isinstance(attrs, (list, tuple)):
        return [_strip_attrs(v) for v in attrs]
    if isinstance(attrs, set):
        return sorted(_strip_attrs(v) for v in attrs)
    return attrs


def _frozen_attrs(attrs) -> str:
    return json.dumps(_strip_attrs(attrs), sort_keys=True, default=str)


def _block_digest(program, idx: int, _seen=None) -> str:
    """Structural digest of nested block `idx`, recursively covering its
    own sub-blocks.  Raw names are stable here: every outer name a
    nested block references is pinned as interface by the canonicalizer
    (never renamed), so two equal programs digest equally.  Without
    this, an op's hash would cover only the sub_block INDEX and a
    rewrite editing ops INSIDE a while/cond body would be falsely
    proven at the structural tier."""
    _seen = _seen if _seen is not None else set()
    if idx in _seen or idx < 0 or idx >= len(program.blocks):
        return _h("bad-block", idx)
    _seen = _seen | {idx}  # per-path guard: a (malformed) block cycle
    parts = []               # must terminate, not recurse forever
    for op in program.blocks[idx].ops:
        a = _frozen_attrs(op.attrs)
        for i in dataflow.sub_block_indices(op):
            a += "|" + _block_digest(program, i, _seen)
        parts.append((op.type, a,
                      tuple(sorted((s, tuple(ns))
                                   for s, ns in op.inputs.items())),
                      tuple(sorted((s, tuple(ns))
                                   for s, ns in op.outputs.items()))))
    return _h("block", *parts)


def _op_attr_sig(op) -> str:
    """Frozen attrs of `op`, with every sub-block ATTR augmented by the
    digest of that block's contents — the one signature both the
    scheduling hash and `semantic_diff` compare."""
    sig = _frozen_attrs(op.attrs)
    subs = dataflow.sub_block_indices(op)
    if subs:
        program = op.block.program
        sig += "|" + "|".join(_block_digest(program, i) for i in subs)
    return sig


def _h(*parts) -> str:
    m = hashlib.sha256()
    for p in parts:
        m.update(repr(p).encode())
        m.update(b"\x00")
    return m.hexdigest()[:16]


def sink_outputs(block, include_persistable: bool = False) -> List[str]:
    """Outputs no op in the program consumes — the default equivalence
    obligations when the caller gives no fetch context (op_test-style
    programs: the sinks ARE the point)."""
    consumed = set()
    for b in block.program.blocks:
        for op in b.ops:
            consumed.update(n for n in op.input_names() if n)
    sinks: List[str] = []
    for op in block.ops:
        for n in op.output_names():
            if not n or n in consumed or n in sinks:
                continue
            v = block._find_var_recursive(n)
            if v is not None and v.persistable and not include_persistable:
                continue
            sinks.append(n)
    return sinks


def _nested_block_names(program, block_id: int = 0) -> set:
    """Names referenced by ops OUTSIDE block `block_id` (nested control
    flow blocks): alpha-renaming must leave them alone — a per-def SSA
    split of a name a sub-block reads could not be disambiguated."""
    names = set()
    for b in program.blocks:
        if b.idx == block_id:
            continue
        for op in b.ops:
            names.update(n for n in op.input_names() if n)
            names.update(n for n in op.output_names() if n)
    return names


def _op_is_pinned(op) -> bool:
    return (op.type in _SIDE_EFFECT_TYPES
            or bool(dataflow.sub_block_indices(op)))


def _dup_eligible(op) -> bool:
    """May `op` count as a PTV023 duplicate?  Shared by canonicalize
    and duplicate_findings so the two reporters can never diverge:
    real inputs (source ops like fill_constant are trivially 'equal'),
    deterministic (stochastic ops differ by PRNG salt), and free of
    side effects / nested blocks."""
    return (any(n for n in op.input_names())
            and op.type not in STOCHASTIC_TYPES
            and op.type not in _DESC_ONLY_TYPES
            and not _op_is_pinned(op))


def _eliminate_dead(block, fetch_names, preserve_state: bool = True) -> int:
    """Reverse liveness sweep toward `fetch_names`: drop ops whose
    outputs feed nothing needed.  Side-effecting / sub-block ops are
    always kept; with `preserve_state` (the default), so is every op
    writing persistable state — the step's scope write-backs are part
    of its semantics.  Returns #ops removed."""
    live = set(fetch_names)
    keep: List = []
    for op in reversed(block.ops):
        outs = [n for n in op.output_names() if n]
        needed = (_op_is_pinned(op) or op.type in _DESC_ONLY_TYPES
                  or any(n in live for n in outs))
        if not needed and preserve_state:
            for n in outs:
                v = block._find_var_recursive(n)
                if v is not None and v.persistable:
                    needed = True
                    break
        if needed:
            keep.append(op)
            live.update(n for n in op.input_names() if n)
    removed = len(block.ops) - len(keep)
    block.ops[:] = list(reversed(keep))
    return removed


def _ordering_edges(block) -> List[set]:
    """preds[j]: op indices that must schedule before op j — RAW edges
    plus the WAR/WAW hazard orderings the linear executor's in-order
    env threading implies.  Any topological order of this graph
    computes the same values."""
    last_def: Dict[str, int] = {}
    reads_since_def: Dict[str, List[int]] = {}
    preds: List[set] = []
    for j, op in enumerate(block.ops):
        p: set = set()
        for n in op.input_names():
            if not n:
                continue
            if n in last_def:
                p.add(last_def[n])          # RAW
            reads_since_def.setdefault(n, []).append(j)
        for n in op.output_names():
            if not n:
                continue
            if n in last_def:
                p.add(last_def[n])          # WAW
            for k in reads_since_def.get(n, ()):
                if k != j:
                    p.add(k)                # WAR
            last_def[n] = j
            reads_since_def[n] = []
        p.discard(j)
        preds.append(p)
    return preds


def _op_hash(op, vn_of, block=None) -> Tuple[str, Dict[str, List[str]]]:
    """(structural hash, canonical inputs) for `op` given `vn_of`
    (input name -> value number).  Commutative operand lists are sorted
    by value number; the returned inputs dict carries the REORDERED
    name lists so the canonical desc stays executable."""
    ins_sig = []
    canon_inputs: Dict[str, List[str]] = {}
    shapes = {}

    def _shape(n):
        if block is None or not n:
            return None
        if n not in shapes:
            v = block._find_var_recursive(n)
            shapes[n] = tuple(v.shape) if v is not None and v.shape \
                else None
        return shapes[n]

    commut_xy = (op.type in _COMMUTATIVE_XY
                 and len(op.input("X")) == 1 and len(op.input("Y")) == 1
                 and _shape(op.input("X")[0]) is not None
                 and _shape(op.input("X")[0]) == _shape(op.input("Y")[0]))
    if commut_xy:
        x, y = op.input("X")[0], op.input("Y")[0]
        a, b = sorted([x, y], key=lambda n: vn_of(n))
        canon_inputs["X"], canon_inputs["Y"] = [a], [b]
        ins_sig.append(("XY", (vn_of(a), vn_of(b))))
        for slot, names in sorted(op.inputs.items()):
            if slot in ("X", "Y"):
                continue
            canon_inputs[slot] = list(names)
            ins_sig.append((slot, tuple(vn_of(n) if n else "" for n in names)))
    elif op.type in _COMMUTATIVE_LIST and "X" in op.inputs:
        xs = sorted(op.input("X"), key=lambda n: vn_of(n))
        canon_inputs["X"] = xs
        ins_sig.append(("X", tuple(sorted(vn_of(n) for n in xs))))
        for slot, names in sorted(op.inputs.items()):
            if slot == "X":
                continue
            canon_inputs[slot] = list(names)
            ins_sig.append((slot, tuple(vn_of(n) if n else "" for n in names)))
    else:
        for slot, names in sorted(op.inputs.items()):
            canon_inputs[slot] = list(names)
            ins_sig.append((slot, tuple(vn_of(n) if n else "" for n in names)))

    outs_sig = tuple((slot, len(names))
                     for slot, names in sorted(op.outputs.items()))
    h = _h(op.type, _op_attr_sig(op), tuple(ins_sig), outs_sig)
    return h, canon_inputs


@dataclass
class CanonInfo:
    """What canonicalization did — and what it noticed on the way."""

    dead_removed: int = 0
    renamed: int = 0
    duplicates: List[dict] = field(default_factory=list)  # PTV023 payloads
    op_hashes: List[str] = field(default_factory=list)


def canonicalize(program, fetch_names: Optional[Iterable[str]] = None,
                 feed_names: Optional[Iterable[str]] = None,
                 block_id: int = 0, preserve_state: bool = True
                 ) -> Tuple[Program, CanonInfo]:
    """Canonical form of `program` (a fresh Program; the input is not
    mutated).  See the module docstring for the normalization steps.
    `fetch_names=None` skips dead-op elimination (no fetch context —
    every sink may be someone's target); `preserve_state=False` makes
    the fetch set the ONLY obligations (io.prune semantics: the
    distribute contract compares gradient computations, not the
    optimizer writes the split deliberately removed)."""
    p = Program.from_json(program.to_json())
    block = p.blocks[block_id]
    info = CanonInfo()

    if fetch_names is not None:
        info.dead_removed = _eliminate_dead(block, list(fetch_names),
                                            preserve_state)

    # --- deterministic hazard-respecting topological order ---------------
    preds = _ordering_edges(block)
    n_ops = len(block.ops)
    succs: List[set] = [set() for _ in range(n_ops)]
    indeg = [0] * n_ops
    for j, ps in enumerate(preds):
        indeg[j] = len(ps)
        for i in ps:
            succs[i].add(j)

    vns: Dict[str, str] = {}

    def vn_of(name: str) -> str:
        if not name:
            return ""
        if name not in vns:
            vns[name] = _h("ext", name)  # interface identity
        return vns[name]

    ready = [j for j in range(n_ops) if indeg[j] == 0]
    order: List[int] = []
    canon_ins: Dict[int, Dict[str, List[str]]] = {}
    hash_first: Dict[str, int] = {}
    scheduled_hash: Dict[int, str] = {}
    # an op's hash is fixed the moment it becomes ready: every def it
    # reads is a scheduled pred, and later writers of those names are
    # WAR-blocked behind it — so hash once, not once per iteration
    hash_cache: Dict[int, tuple] = {}
    while ready:
        # pick deterministically by (structural hash, original index):
        # name-independent where it matters, stable where hashes tie
        # (genuinely identical ops are interchangeable)
        best = None
        for j in ready:
            if j not in hash_cache:
                hash_cache[j] = _op_hash(block.ops[j], vn_of, block)
            h, ci = hash_cache[j]
            key = (h, j)
            if best is None or key < best[0]:
                best = (key, j, h, ci)
        _, j, h, ci = best
        ready.remove(j)
        op = block.ops[j]
        order.append(j)
        canon_ins[j] = ci
        scheduled_hash[j] = h
        info.op_hashes.append(h)
        # duplicate canonical subgraph (missed CSE): same op hash seen
        # before, and the op actually computes from inputs
        if h in hash_first:
            if _dup_eligible(op):
                info.duplicates.append({
                    "op": j, "first": hash_first[h], "type": op.type,
                    "hash": h})
        else:
            hash_first[h] = j
        # outputs take their value numbers from the op hash
        for slot, names in op.outputs.items():
            for k, n in enumerate(names):
                if n:
                    vns[n] = _h("out", h, slot, k)
        for s in succs[j]:
            indeg[s] -= 1
            if indeg[s] == 0:
                ready.append(s)
    if len(order) != n_ops:
        # unreachable on any desc: _ordering_edges only points at
        # EARLIER ops, so the graph is a DAG by construction — if an
        # edge-rule change ever breaks that, fail loudly rather than
        # emit a half-scheduled "canonical" form
        raise AssertionError(
            f"canonicalize: scheduling stalled at {len(order)}/{n_ops} "
            f"ops (ordering edges formed a cycle)")

    new_ops = []
    for j in order:
        op = block.ops[j]
        op.inputs = {k: list(v) for k, v in canon_ins[j].items()}
        new_ops.append(op)
    block.ops[:] = new_ops
    p._bump()

    # --- SSA-style alpha renaming ----------------------------------------
    keep_names = set(feed_names or ())
    keep_names.update(fetch_names or ())
    if fetch_names is None:
        # no fetch context: every sink may be someone's fetch target —
        # they are kept as dead-op roots above, so their NAMES are
        # interface too
        keep_names.update(sink_outputs(block))
    keep_names.update(_nested_block_names(p, block_id))
    # reads with no prior in-block def observe scope state: interface
    defined: set = set()
    for op in block.ops:
        for n in op.input_names():
            if n and n not in defined:
                keep_names.add(n)
        for n in op.output_names():
            if n:
                defined.add(n)
    for name, v in list(block.vars.items()):
        if v.persistable or v.is_data:
            keep_names.add(name)

    counter = 0
    cur: Dict[str, str] = {}  # original name -> current canonical name
    var_meta: Dict[str, str] = {}  # canonical name -> original (metadata)
    for op in block.ops:
        for slot, names in op.inputs.items():
            op.inputs[slot] = [cur.get(n, n) if n else n for n in names]
        for slot, names in op.outputs.items():
            out = []
            for n in names:
                if not n or n in keep_names:
                    cur.pop(n, None)
                    out.append(n)
                    continue
                canon = "%%%d" % counter
                counter += 1
                cur[n] = canon
                var_meta[canon] = n
                out.append(canon)
            op.outputs[slot] = out
    info.renamed = counter

    # rename propagated names inside nested blocks never happens (multi-
    # def names referenced there were pinned via keep_names); rebuild
    # the var table: canonical names inherit the original metadata
    for canon, orig in var_meta.items():
        v = block.vars.get(orig) or block._find_var_recursive(orig)
        if v is not None:
            d = v.to_dict()
            d["name"] = canon
            from ..framework.core import Variable

            nv = Variable.from_dict(block, d)
            nv.name = canon
            block.vars[canon] = nv
    from ..framework.core import drop_orphaned_vars

    drop_orphaned_vars(block, keep=set(fetch_names or ()) | set(
        feed_names or ()))
    p._bump()
    return p, info


# ---------------------------------------------------------------------------
# structural comparison


def _render_op(op) -> str:
    ins = ", ".join(f"{slot}={names}" for slot, names in
                    sorted(op.inputs.items()) if any(names))
    outs = ", ".join(f"{slot}={names}" for slot, names in
                     sorted(op.outputs.items()) if any(names))
    attrs = _strip_attrs(op.attrs)
    attrs = {k: v for k, v in attrs.items() if not k.startswith("__fwd_")}
    a = json.dumps(attrs, sort_keys=True, default=str) if attrs else ""
    return f"{outs or '()'} = {op.type}({ins})" + (f" {a}" if a else "")


def _op_sig(op) -> str:
    return _h(op.type, _op_attr_sig(op),
              tuple(sorted((s, tuple(ns)) for s, ns in op.inputs.items())),
              tuple(sorted((s, tuple(ns)) for s, ns in op.outputs.items())))


@dataclass
class SemanticDiff:
    """Human-readable structural delta between two canonical forms:
    which ops/edges differ, not just "unequal"."""

    only_in_a: List[str] = field(default_factory=list)
    only_in_b: List[str] = field(default_factory=list)
    first_mismatch: Optional[tuple] = None  # (pos, rendered_a, rendered_b)
    interface_diff: List[str] = field(default_factory=list)
    note: str = ""

    def __bool__(self):
        return bool(self.only_in_a or self.only_in_b or self.first_mismatch
                    or self.interface_diff)

    def summary(self) -> str:
        bits = []
        if self.only_in_a:
            bits.append(f"{len(self.only_in_a)} op(s) only in A")
        if self.only_in_b:
            bits.append(f"{len(self.only_in_b)} op(s) only in B")
        if self.interface_diff:
            bits.append(f"{len(self.interface_diff)} interface change(s)")
        if not bits and self.first_mismatch:
            bits.append(f"op order/wiring differs at position "
                        f"{self.first_mismatch[0]}")
        return "; ".join(bits) or "no structural difference"

    def render(self, limit: int = 12) -> str:
        if not self:
            return "programs are structurally identical (canonical forms " \
                   "match)"
        lines = [f"semantic diff: {self.summary()}"]
        for tag, ops in (("- only in A:", self.only_in_a),
                         ("+ only in B:", self.only_in_b)):
            for s in ops[:limit]:
                lines.append(f"  {tag[0]} {s}")
            if len(ops) > limit:
                lines.append(f"  {tag[0]} ... {len(ops) - limit} more")
        for s in self.interface_diff[:limit]:
            lines.append(f"  ! {s}")
        if self.first_mismatch and not (self.only_in_a or self.only_in_b):
            pos, ra, rb = self.first_mismatch
            lines.append(f"  @ position {pos}:")
            lines.append(f"  - {ra}")
            lines.append(f"  + {rb}")
        if self.note:
            lines.append(f"  ({self.note})")
        return "\n".join(lines)


def semantic_diff(canon_a: Program, canon_b: Program,
                  block_id: int = 0) -> SemanticDiff:
    """Structural delta of two CANONICAL programs (run `canonicalize`
    first).  Empty diff ⇔ structurally equivalent."""
    a, b = canon_a.blocks[block_id], canon_b.blocks[block_id]
    diff = SemanticDiff()
    sig_a = [_op_sig(op) for op in a.ops]
    sig_b = [_op_sig(op) for op in b.ops]
    if sig_a == sig_b:
        pass
    else:
        from collections import Counter

        ca, cb = Counter(sig_a), Counter(sig_b)
        extra_a = ca - cb
        extra_b = cb - ca
        for i, op in enumerate(a.ops):
            if extra_a.get(sig_a[i], 0) > 0:
                extra_a[sig_a[i]] -= 1
                diff.only_in_a.append(_render_op(op))
        for i, op in enumerate(b.ops):
            if extra_b.get(sig_b[i], 0) > 0:
                extra_b[sig_b[i]] -= 1
                diff.only_in_b.append(_render_op(op))
        for i in range(min(len(sig_a), len(sig_b))):
            if sig_a[i] != sig_b[i]:
                diff.first_mismatch = (i, _render_op(a.ops[i]),
                                       _render_op(b.ops[i]))
                break
    # interface (ABI) delta: declared shape/dtype of shared interface
    # vars, and interface vars present on one side only.  Only vars some
    # op actually REFERENCES count — an orphaned persistable declaration
    # (drop_orphaned_vars keeps persistables; the distribute transpiler
    # flips persistable on an LR-schedule tmp whose ops dead-eliminate
    # away) changes nothing the program computes, and counting it would
    # silently demote a structural proof to concrete double-execution
    def _iface(blk):
        referenced = set()
        for b in blk.program.blocks:
            for op in b.ops:
                referenced.update(n for n in op.input_names() if n)
                referenced.update(n for n in op.output_names() if n)
        out = {}
        for name, v in blk.vars.items():
            if (v.persistable or v.is_data) and name in referenced:
                out[name] = (tuple(v.shape) if v.shape else None, v.dtype,
                             v.persistable, v.is_data)
        return out

    ia, ib = _iface(a), _iface(b)
    for name in sorted(set(ia) | set(ib)):
        if name not in ib:
            diff.interface_diff.append(f"interface var {name!r} only in A "
                                       f"{ia[name][:2]}")
        elif name not in ia:
            diff.interface_diff.append(f"interface var {name!r} only in B "
                                       f"{ib[name][:2]}")
        elif ia[name] != ib[name]:
            diff.interface_diff.append(
                f"interface var {name!r} changed: {ia[name][:2]} -> "
                f"{ib[name][:2]}")
    return diff


def duplicate_findings(program, block_id: int = 0) -> List:
    """PTV023 findings for block `block_id`: ops recomputing a value an
    earlier op already computed (same type, attrs modulo STRIP_ATTRS,
    and operand value numbers).  In-order value numbering, no
    reordering — `verify_program` calls this directly."""
    from .verifier import Finding

    block = program.blocks[block_id]
    vns: Dict[str, str] = {}

    def vn_of(name: str) -> str:
        if not name:
            return ""
        if name not in vns:
            vns[name] = _h("ext", name)
        return vns[name]

    findings: List = []
    first: Dict[str, int] = {}
    for j, op in enumerate(block.ops):
        h, _ = _op_hash(op, vn_of, block)
        if h in first:
            if _dup_eligible(op):
                findings.append(Finding(
                    "PTV023",
                    f"op {j} ({op.type}) recomputes the value op "
                    f"{first[h]} ({block.ops[first[h]].type}) already "
                    f"produces — duplicate canonical subgraph (missed "
                    f"CSE)", block=block_id, op=j))
        else:
            first[h] = j
        for slot, names in op.outputs.items():
            for k, n in enumerate(names):
                if n:
                    vns[n] = _h("out", h, slot, k)
    return findings


# ---------------------------------------------------------------------------
# differential oracle


def _seed_array(name: str, shape, dtype: str, seed: int) -> np.ndarray:
    """Deterministic value for `name` — keyed by NAME so both programs
    of a differential pair see identical inputs.  Integer dtypes draw
    from {0,1}: valid class labels for any >=2-way softmax and valid
    ids for any vocab >=2."""
    h = int(hashlib.sha256(f"{seed}:{name}".encode()).hexdigest()[:8], 16)
    rng = np.random.RandomState(h)
    shape = tuple(int(s) for s in shape)
    if dtype.startswith("int") or dtype.startswith("uint"):
        return rng.randint(0, 2, size=shape).astype(dtype)
    if dtype == "bool":
        return (rng.rand(*shape) > 0.5)
    return (rng.randn(*shape) * 0.1).astype(
        "float32" if dtype == "bfloat16" else dtype)


def _bind(shape, batch_size: int):
    return tuple(batch_size if (s is None or int(s) < 0) else int(s)
                 for s in (shape or ()))


def build_feeds(program, feed_names: Sequence[str], batch_size: int = 2,
                seed: int = 0, block_id: int = 0) -> Dict[str, np.ndarray]:
    """Small deterministic random feed dict from the var descs."""
    block = program.blocks[block_id]
    feeds = {}
    for name in feed_names:
        v = block._find_var_recursive(name)
        shape = _bind(v.shape if v is not None else (1,), batch_size)
        dtype = (v.dtype if v is not None and v.dtype else "float32")
        feeds[name] = _seed_array(name, shape, dtype, seed)
    return feeds


def _run_once(program, scope, feeds, fetch_names, block_id: int = 0,
              seed: int = 0, executor=None, place=None):
    """One deterministic execution: state copied into a child scope
    (a step updates state in place, so it must consume copies, never
    the caller's tensors), missing state seeded deterministically by
    name, PRNG pinned to step 0.  Returns (fetches, written_state) — the
    state the step persisted back is part of its semantics (a training
    program with no fetch context is still fully comparable through its
    parameter updates).  `executor` overrides the default Executor on
    `place` (the CPU when None)."""
    from ..framework.executor import Executor
    from ..framework.place import CPUPlace
    from ..framework.scope import Scope

    block = program.blocks[block_id]
    child = Scope()
    ext, rw, written = dataflow.state_classes(block, list(feeds))
    for name in list(ext) + list(rw):
        v = scope.find(name) if scope is not None else None
        if v is not None:
            child.set(name, v.detach().clone())
            continue
        dv = block._find_var_recursive(name)
        if dv is not None and dv.shape is not None:
            child.set(name, _seed_array(
                name, _bind(dv.shape, 1), dv.dtype or "float32", seed))
    exe = executor if executor is not None else Executor(
        place if place is not None else CPUPlace())
    outs = exe.run(program, feed=dict(feeds), fetch_list=list(fetch_names),
                   scope=child, block_id=block_id, verify=False,
                   rng_step=0)
    state = {n: child.find_np(n) for n in written
             if child.find(n) is not None}
    return {n: np.asarray(v) for n, v in zip(fetch_names, outs)}, state


def differential_run(prog_a, prog_b, feed_names, fetch_names, *,
                     scope_a=None, scope_b=None, batch_size: int = 2,
                     seed: int = 0, rtol: float = 1e-4,
                     atol: float = 1e-6, block_id: int = 0,
                     compare_state: bool = True,
                     executor_a=None, executor_b=None, place=None) -> List:
    """Execute both programs on identical deterministic feeds and
    compare every fetch — plus, with `compare_state` (default), every
    scope value the step writes back (a training step with no fetch
    context is still fully comparable through its parameter updates).
    Returns PTV024 findings (empty = agreement).  Raises whatever the
    executor raises if a side fails to run — the caller decides what a
    crash proves.  Both sides run on `place` (the CPU when None)."""
    from .verifier import Finding

    feeds = build_feeds(prog_a, feed_names, batch_size, seed, block_id)
    got_a, state_a = _run_once(prog_a, scope_a, feeds, fetch_names,
                               block_id, seed, executor=executor_a,
                               place=place)
    got_b, state_b = _run_once(prog_b, scope_b, feeds, fetch_names,
                               block_id, seed, executor=executor_b,
                               place=place)
    findings: List = []

    def _compare(name, a, b, what):
        if a is None or b is None:
            findings.append(Finding(
                "PTV024", f"{what} {name!r} written by only one side",
                block=block_id, var=name))
            return
        if a.shape != b.shape:
            findings.append(Finding(
                "PTV024", f"{what} {name!r} shape diverged: {a.shape} "
                f"vs {b.shape}", block=block_id, var=name))
            return
        if a.dtype.kind in "fc" or b.dtype.kind in "fc":
            ok = np.allclose(a.astype(np.float64), b.astype(np.float64),
                             rtol=rtol, atol=atol)
        else:
            ok = np.array_equal(a, b)
        if not ok:
            af, bf = a.astype(np.float64), b.astype(np.float64)
            max_abs = float(np.max(np.abs(af - bf))) if a.size else 0.0
            denom = np.maximum(np.abs(bf), atol)
            max_rel = float(np.max(np.abs(af - bf) / denom)) if a.size \
                else 0.0
            findings.append(Finding(
                "PTV024",
                f"{what} {name!r} diverged on the deterministic feed: "
                f"max|a-b|={max_abs:.3e}, max rel={max_rel:.3e} "
                f"(rtol={rtol}, atol={atol})", block=block_id, var=name))

    for name in fetch_names:
        _compare(name, got_a[name], got_b[name], "fetch")
    if compare_state:
        for name in sorted(set(state_a) | set(state_b)):
            _compare(name, state_a.get(name), state_b.get(name),
                     "written state")
    return findings


def abstract_fetch_sigs(program, fetch_names, batch_size: int = 2,
                        block_id: int = 0) -> Dict[str, Optional[tuple]]:
    """{fetch: (shape, dtype) | None} via the PTV006 abstract-eval
    oracle; None where the walk could not derive a signature."""
    from ..framework.core import canonical_dtype
    from .verifier import abstract_walk, _UNKNOWN

    env, _ = abstract_walk(program, block_id, batch_size)
    out = {}
    for name in fetch_names:
        sig = env.get(name)
        if sig is None or sig is _UNKNOWN:
            out[name] = None
        else:
            out[name] = (tuple(int(s) for s in sig.shape),
                         canonical_dtype(sig.dtype))
    return out


# ---------------------------------------------------------------------------
# the proof obligation


@dataclass
class EquivalenceProof:
    """Result of `prove_equivalent`.  `tier` names the level that
    settled it: "structural" (canonical forms match — proof),
    "abstract" (fetch signatures disagree — refutation), or
    "differential" (concrete execution agreed/diverged).  `findings`
    carries PTV022/PTV023/PTV024; `diff` the structural delta (present
    even on differential success, as context)."""

    equivalent: bool
    tier: str
    findings: List = field(default_factory=list)
    diff: Optional[SemanticDiff] = None
    detail: dict = field(default_factory=dict)

    @property
    def errors(self) -> List:
        return [f for f in self.findings if f.severity == "error"]

    def raise_if_failed(self, stage: str = "equivalence"):
        if not self.equivalent:
            from .verifier import VerificationError

            raise VerificationError(stage, self.errors or self.findings)
        return self

    def render(self) -> str:
        head = ("EQUIVALENT" if self.equivalent else "NOT EQUIVALENT")
        lines = [f"{head} (tier: {self.tier})"]
        if "oracle_unavailable" in self.detail:
            lines.append(
                "  WARNING: differential oracle could not run — value-"
                "level drift (e.g. differing weights) was NOT checked: "
                + str(self.detail["oracle_unavailable"]))
        for k in ("ops_a", "ops_b", "dead_removed_a", "dead_removed_b",
                  "fetches"):
            if k in self.detail:
                lines.append(f"  {k}: {self.detail[k]}")
        for f in self.findings:
            lines.append("  " + f.format())
        if self.diff and (not self.equivalent or self.tier != "structural"):
            lines.append(self.diff.render())
        return "\n".join(lines)


def prove_equivalent(before, after, feed_names=None, fetch_names=None, *,
                     block_id: int = 0, batch_size: int = 2,
                     scope_before=None, scope_after=None,
                     preserve_state: bool = True, execute: str = "auto",
                     seed: int = 0, rtol: float = 1e-4,
                     atol: float = 1e-6, place=None) -> EquivalenceProof:
    """Prove (or refute) that `after` computes the same thing as
    `before`.  Tiers: structural (canonical-form identity), abstract
    (fetch shape/dtype via the PTV006 oracle), differential (concrete
    execution on deterministic feeds on `place`, the CPU when None,
    scope state from `scope_before`/`scope_after` or seeded by name).

    `execute`: "auto" falls through to the differential oracle only
    when the structural check fails; "never" makes a structural
    mismatch final (desc-only contracts: memory_optimize's marking may
    not change structure at all); "always" runs the oracle even on a
    structural match (catches scope-value corruption — a pass that
    leaves descs alone but perturbs weights).

    `preserve_state=False` restricts the obligation to the fetch set
    (prune semantics) — the distribute contract's "same gradients"
    claim."""
    if feed_names is None:
        feed_names = [v.name for v in
                      before.blocks[block_id].vars.values() if v.is_data]
    feed_names = list(feed_names)
    if fetch_names is None:
        fetch_names = sink_outputs(before.blocks[block_id])
    fetch_names = list(fetch_names)

    canon_a, info_a = canonicalize(before, fetch_names, feed_names,
                                   block_id, preserve_state)
    canon_b, info_b = canonicalize(after, fetch_names, feed_names,
                                   block_id, preserve_state)
    from .verifier import Finding

    findings: List = [Finding(
        "PTV023", f"rewrite introduced a duplicate of op "
        f"{d['first']} ({d['type']}) at op {d['op']} — missed CSE",
        block=block_id, op=d["op"])
        for d in info_b.duplicates
        if d["hash"] not in {x["hash"] for x in info_a.duplicates}]
    detail = {"ops_a": len(canon_a.blocks[block_id].ops),
              "ops_b": len(canon_b.blocks[block_id].ops),
              "dead_removed_a": info_a.dead_removed,
              "dead_removed_b": info_b.dead_removed,
              "fetches": fetch_names}
    diff = semantic_diff(canon_a, canon_b, block_id)

    if not diff and execute != "always":
        return EquivalenceProof(True, "structural", findings, diff, detail)

    if diff and execute == "never":
        findings.append(Finding(
            "PTV022", f"rewrite changed program semantics and the "
            f"contract forbids structural drift: {diff.summary()}",
            block=block_id))
        return EquivalenceProof(False, "structural", findings, diff,
                                detail)

    # abstract tier: a fetch whose shape/dtype moved is a refutation no
    # concrete run needs to witness
    if diff:
        sig_a = abstract_fetch_sigs(before, fetch_names, batch_size,
                                    block_id)
        sig_b = abstract_fetch_sigs(after, fetch_names, batch_size,
                                    block_id)
        for name in fetch_names:
            a, b = sig_a.get(name), sig_b.get(name)
            if a is not None and b is not None and a != b:
                findings.append(Finding(
                    "PTV022", f"fetch {name!r} abstract signature "
                    f"changed: {a} -> {b}", block=block_id, var=name))
        if any(f.rule == "PTV022" for f in findings):
            return EquivalenceProof(False, "abstract", findings, diff,
                                    detail)

    # differential tier
    try:
        div = differential_run(
            before, after, feed_names, fetch_names,
            scope_a=scope_before, scope_b=scope_after,
            batch_size=batch_size, seed=seed, rtol=rtol, atol=atol,
            block_id=block_id, compare_state=preserve_state, place=place)
    except Exception as e:  # a side that cannot run proves nothing good
        if not diff:
            # execute="always" on a structural match: the structural
            # proof stands — an oracle that cannot run here (an op the
            # CPU Executor lacks) is an environment limit, not a
            # counterexample
            detail["oracle_unavailable"] = (
                f"{type(e).__name__}: {str(e)[:300]}")
            return EquivalenceProof(True, "structural", findings, diff,
                                    detail)
        findings.append(Finding(
            "PTV022", f"structural forms differ ({diff.summary()}) and "
            f"the differential oracle could not execute the pair: "
            f"{type(e).__name__}: {str(e)[:300]}", block=block_id))
        return EquivalenceProof(False, "differential", findings, diff,
                                detail)
    findings.extend(div)
    if div:
        if diff:
            findings.append(Finding(
                "PTV022", f"rewrite changed semantics: "
                f"{diff.summary()}; differential oracle confirms "
                f"divergence", block=block_id))
        return EquivalenceProof(False, "differential", findings, diff,
                                detail)
    return EquivalenceProof(True, "differential", findings, diff, detail)


# ---------------------------------------------------------------------------
# plan equivalence: archived bespoke mode wiring vs logical-axis rules


def _norm_spec(sharding, ndim=None) -> tuple:
    from .sharding import spec_of

    spec = spec_of(sharding, ndim)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def _json_spec(spec) -> list:
    """JSON-comparable form of a normalized spec (tuples -> lists)."""
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def golden_mode_plans() -> Optional[dict]:
    """The archived per-mode plans of the DELETED bespoke wiring
    (parallel/mode_plans_golden.json, captured at the last commit where
    it existed).  None when the archive is absent."""
    import json
    import os

    from .. import parallel as _parallel

    path = os.path.join(os.path.dirname(_parallel.__file__),
                        "mode_plans_golden.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def capture_golden_mode_plans(path: str, batch_size: int = 8) -> dict:
    """Re-archive the CURRENT rule-driven plans as the golden baseline.
    Only legitimate
    when the live sweep is 11/11 PROVEN against the existing golden —
    the archive's whole point is to pin the deleted wiring's output, so
    regeneration must be an explicit, reviewed act."""
    import json

    from ..parallel import modes as pmodes
    from .sharding import propagate

    doc = {
        "_comment": (
            "Archived per-mode sharding plans: the prove_equivalent "
            "baseline for the deleted bespoke partitioner wiring "
            "(ISSUE 19 / ROADMAP #1).  mode_plan_equivalence judges the "
            "live rule-driven plan against these specs and collective "
            "footprints.  Regenerate ONLY via "
            "`capture_golden_mode_plans` after a PROVEN sweep."),
        "modes": {},
    }
    for name in pmodes.MODE_NAMES:
        mode, program, _loss = pmodes.build_mode(name)
        mesh, plan, provenance = pmodes.mode_plan(mode, program)
        block = program.global_block()
        specs = {}
        for var in sorted(plan):
            v = block._find_var_recursive(var)
            ndim = len(v.shape) if v is not None and v.shape else None
            specs[var] = _json_spec(_norm_spec(plan.get(var), ndim))
        ana = propagate(program, mesh=mesh, plan=plan,
                        batch_size=batch_size, provenance=provenance)
        doc["modes"][name] = {
            "mesh": dict(mode.mesh_axes),
            "batch_size": batch_size,
            "specs": specs,
            "provenance": {k: str(v) for k, v in provenance.items()},
            "per_kind": ana.per_kind(),
        }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return doc


def mode_plan_equivalence(name: str, batch_size: int = 8) -> dict:
    """Prove one dryrun parallelism mode's live plan equal to the
    archived output of the deleted bespoke wiring: per-var specs AND
    the propagated collective footprint (kind -> count/bytes).

    Three-way check (ROADMAP #1 prove_equivalent obligation for the
    partitioner collapse, PTV022-024 stance):

      1. live ParallelExecutor plan vs golden archive -> `spec_diffs`
         (did deleting the wiring change any var's sharding?)
      2. live executor plan vs a bare LogicalPartitioner over the same
         rule table -> `executor_diffs` (is the executor really just
         the rule table — any drift means bespoke logic regrew)
      3. live propagated comm footprint vs archived footprint ->
         `comm` delta (same collectives, same wire bytes)

    Verdict "PROVEN" only when all three agree and the rule table had
    no conflicts.  Without the archive (golden=False) the check
    degrades to 2+3 live-vs-live."""
    from ..parallel import modes as pmodes
    from .sharding import propagate

    mode, program, loss_name = pmodes.build_mode(name)
    mesh, plan, provenance = pmodes.mode_plan(mode, program)
    lp, lplan = pmodes.logical_plan(mode, program, mesh)

    golden_doc = golden_mode_plans()
    golden = None
    if golden_doc is not None:
        entry = golden_doc.get("modes", {}).get(name)
        if entry is not None and entry.get("batch_size") == batch_size:
            golden = entry

    block = program.global_block()

    def live_spec(p, var):
        v = block._find_var_recursive(var)
        ndim = len(v.shape) if v is not None and v.shape else None
        return _json_spec(_norm_spec(p.get(var), ndim))

    executor_diffs = []
    for var in sorted(set(plan) | set(lplan)):
        sa, sb = live_spec(plan, var), live_spec(lplan, var)
        if sa != sb:
            executor_diffs.append({
                "var": var, "executor": sa, "logical": sb,
                "rule": provenance.get(var, "axis rule"),
            })

    spec_diffs = []
    if golden is not None:
        gspecs = golden.get("specs", {})
        gprov = golden.get("provenance", {})
        for var in sorted(set(plan) | set(gspecs)):
            sl = live_spec(plan, var)
            sg = list(gspecs.get(var, []))
            if sl != sg:
                spec_diffs.append({
                    "var": var, "bespoke": sg, "logical": sl,
                    "bespoke_rule": gprov.get(var, "transpiler default"),
                })

    ana = propagate(program, mesh=mesh, plan=plan,
                    batch_size=batch_size, provenance=provenance)
    pk_l = ana.per_kind()
    if golden is not None:
        pk_b = {k: dict(v) for k, v in golden.get("per_kind", {}).items()}
    else:
        ana_b = propagate(program, mesh=mesh, plan=lplan,
                          batch_size=batch_size)
        pk_b = ana_b.per_kind()
    comm_delta = {}
    for kind in sorted(set(pk_b) | set(pk_l)):
        b = pk_b.get(kind, {"count": 0, "bytes": 0})
        l = pk_l.get(kind, {"count": 0, "bytes": 0})
        if dict(b) != dict(l):
            comm_delta[kind] = {
                "bespoke": dict(b), "logical": dict(l),
                "bytes_delta": int(b["bytes"]) - int(l["bytes"])}

    proven = (not spec_diffs and not executor_diffs and not comm_delta
              and not lp.conflicts)
    return {
        "mode": name,
        "mesh": dict(mode.mesh_axes),
        "verdict": "PROVEN" if proven else "DIVERGED",
        "golden": golden is not None,
        "spec_diffs": spec_diffs,
        "executor_diffs": executor_diffs,
        "rule_conflicts": list(lp.conflicts),
        "comm": {"bespoke": pk_b, "logical": pk_l, "delta": comm_delta},
        "pipeline": bool(mode.pipeline),
    }


def plan_equivalence_report(names: Optional[Sequence[str]] = None,
                            batch_size: int = 8) -> List[dict]:
    """The 11-mode plan-equivalence sweep."""
    from ..parallel import modes as pmodes

    return [mode_plan_equivalence(n, batch_size=batch_size)
            for n in (names or pmodes.MODE_NAMES)]


def hybrid_parity_report(batch_size: int = 8, place=None) -> dict:
    """2-slice simulated-DCN run vs single-slice, judged by the
    differential oracle at BITWISE tolerance (rtol=atol=0).

    Both sides run the same Momentum-MLP training step with
    cross-replica weight-update sharding active (`zero_dp_states=True`,
    arXiv:2004.13336): side A on a flat `{dp: 8}` mesh, side B on a
    `make_hybrid_mesh({dp: 4}, {dcn_dp: 2})` multi-slice mesh whose
    batch and state0 dims shard over the ``("dcn_dp", "dp")`` tuple.
    The same 8 positions in the same order, and the port's psum adds a
    group in flat position order whatever the mesh's shape → every
    fetch and every written state value (params AND sharded velocities)
    must match bit-for-bit.  The positions are on the card unless
    `place` is ``CPUPlace()`` (``modes.ensure_virtual_devices``).  The record also publishes the
    analyzer's predicted wire bytes per link class for both layouts —
    the bench artifact for the ICI-reduce-scatter → DCN-all-reduce →
    ICI-all-gather decomposition."""
    from ..parallel import modes as pmodes
    from ..parallel.mesh import make_hybrid_mesh
    from ..parallel.parallel_executor import ParallelExecutor
    from .sharding import comm_report, propagate, spec_of

    devices = pmodes.ensure_virtual_devices(8, place)
    mode, program, loss_name = pmodes.build_mode("dp")
    block = program.global_block()
    feed_names = sorted(n for n, v in block.vars.items() if v.is_data)

    exe_a = ParallelExecutor(axes={"dp": 8}, devices=devices,
                             zero_dp_states=True)
    mesh_b = make_hybrid_mesh({"dp": 4}, {"dcn_dp": 2}, devices=devices)
    exe_b = ParallelExecutor(mesh=mesh_b, zero_dp_states=True)

    findings = differential_run(
        program, program, feed_names, [loss_name],
        batch_size=batch_size, rtol=0.0, atol=0.0,
        executor_a=exe_a, executor_b=exe_b, place=place)

    def link_report(exe):
        prov: Dict[str, str] = {}
        plan = exe.static_plan(program, provenance=prov)
        ana = propagate(program, mesh=exe.mesh, plan=plan,
                        batch_size=batch_size, provenance=prov)
        rep = comm_report(ana)
        return plan, {
            "per_kind": ana.per_kind(),
            "link_bytes": rep["link_bytes"],
            "ici_time_s": rep["ici_time_s"],
            "dcn_time_s": rep["dcn_time_s"],
            "decomposed": [e["decomposed"] for e in rep["breakdown"]
                           if "decomposed" in e],
        }

    plan_a, comm_a = link_report(exe_a)
    plan_b, comm_b = link_report(exe_b)
    velocity_specs = {
        n: [list(e) if isinstance(e, tuple) else e
            for e in spec_of(s)]
        for n, s in sorted(plan_b.items()) if "velocity" in n}
    return {
        "analysis": "hybrid_parity",
        "mesh_single": {"dp": 8},
        "mesh_hybrid": {"dcn_dp": 2, "dp": 4},
        "weight_update_sharding": True,
        "bitwise": not findings,
        "verdict": "PROVEN" if not findings else "DIVERGED",
        "findings": [f.format() for f in findings],
        "fetches": [loss_name],
        "velocity_specs_hybrid": velocity_specs,
        "comm": {"single": comm_a, "hybrid": comm_b},
    }


# ---------------------------------------------------------------------------
# fused K-step dispatch vs K sequential dispatches


def _loop_models():
    """The two loop-parity obligations: a Momentum-MLP (hidden layer +
    velocity state, the smallest real training step) and the standing
    small decoder LM (attention, layernorm, Adam moments — the stateful
    stochastic program family step_loop must not perturb)."""
    from ..framework import unique_name
    from ..framework.core import Program, program_guard

    def mlp():
        import paddle_tpu_torch as fluid

        x = fluid.layers.data(name="x", shape=[16])
        y = fluid.layers.data(name="y", shape=[1])
        h = fluid.layers.fc(x, size=32, act="relu")
        pred = fluid.layers.fc(h, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.Momentum(learning_rate=0.01,
                                 momentum=0.9).minimize(loss)
        return loss.name, ["x", "y"]

    def small_lm():
        from ..models import standing

        feed, fetches, _bs = standing.build_small_lm()
        return _name_of(fetches[0]), sorted(feed)

    for kind, build in (("mlp", mlp), ("small_lm", small_lm)):
        main, startup = Program(), Program()
        with unique_name.guard(), program_guard(main, startup):
            loss_name, feed_names = build()
        yield kind, main, startup, loss_name, feed_names


def _name_of(f):
    return f if isinstance(f, str) else f.name


def loop_parity_report(ks: Sequence[int] = (1, 2, 4, 8),
                       batch_size: int = 4, place=None,
                       dispatches: int = 3) -> dict:
    """K-step fused dispatch (`Executor.run(steps_per_dispatch=K)`,
    framework/step_loop.py) vs the same steps as sequential `run()`
    calls, judged at BITWISE tolerance on every per-step fetch AND every
    written-back state value (params, velocities, Adam moments).

    Both sides start from an identical copy of the startup-initialized
    state and see the same deterministic feed batches (`build_feeds`
    seeded per step); the sequential side pins `rng_step` to the step,
    the fused side to the first step of its dispatch.  The fused side
    makes `dispatches` dispatches of K steps on one key, against
    `dispatches` x K sequential steps.

    `place` defaults to the card (`default_place()`).  There the first
    dispatch of a key runs its K steps eagerly, the second captures them
    as one CUDA graph and replays it, and the third replays it again
    (`dispatches=3`), so agreement proves the replayed graph IS K steps;
    a K > 1 case whose fused side replayed no graph is a finding.  On the
    CPU there is no graph and a fused dispatch walks its K steps in
    sequence: a CPU run proves only the feed stacking, the stacked
    fetches and the `rng_step` offsets, not a captured loop.  Each case
    says which route its fused side took (`replayed`)."""
    from ..analysis import dataflow
    from ..framework.executor import Executor
    from ..framework.place import default_place
    from ..framework.scope import Scope

    place = default_place() if place is None else place
    dispatches = int(dispatches)
    if dispatches < 1:
        raise ValueError(f"dispatches={dispatches} must be >= 1")
    cases = []
    for kind, main, startup, loss_name, feed_names in _loop_models():
        block = main.global_block()
        ext, rw, written = dataflow.state_classes(block, feed_names)
        for k in ks:
            k = int(k)
            exe = Executor(place)
            sa, sb = Scope(), Scope()
            exe.run(startup, scope=sa, verify=False)
            for n in set(ext) | set(rw):
                v = sa.find(n)
                if v is not None:
                    sb.set(n, v.detach().clone())
            n_steps = k * dispatches
            feeds = [build_feeds(main, feed_names, batch_size, seed=i)
                     for i in range(n_steps)]
            seq = [np.asarray(exe.run(main, feed=feeds[i],
                                      fetch_list=[loss_name], scope=sb,
                                      rng_step=i, verify=False)[0])
                   for i in range(n_steps)]
            fused, findings = [], []
            for d in range(dispatches):
                block_feeds = feeds[d * k:(d + 1) * k]
                # K=1 is the identity path (no stacking in, none out):
                # its "parity" is plain run-to-run determinism
                stacked = (block_feeds[0] if k == 1 else
                           {n: np.stack([f[n] for f in block_feeds])
                            for n in feed_names})
                out = np.asarray(exe.run(
                    main, feed=stacked, fetch_list=[loss_name], scope=sa,
                    rng_step=d * k, verify=False,
                    steps_per_dispatch=k)[0])
                if k > 1 and tuple(out.shape[:1]) != (k,):
                    findings.append(
                        f"fetch {loss_name!r} not stacked (K, ...): "
                        f"{out.shape}")
                    out = np.broadcast_to(out, (k,) + out.shape[1:])
                fused.extend(out if k > 1 else [out])
            replayed = any(e.loop is not None for e in exe._loops.values())
            exe.close()
            if k > 1 and exe.device.type == "cuda" and not replayed:
                findings.append(
                    f"fused side replayed no captured graph in "
                    f"{dispatches} dispatches of {k} steps")
            for i in range(n_steps):
                a = fused[i]
                if a.shape != seq[i].shape or not np.array_equal(a, seq[i]):
                    findings.append(
                        f"fetch {loss_name!r} step {i} diverged: "
                        f"fused={a!r} sequential={seq[i]!r}")
            for n in written:
                a, b = sa.find_np(n), sb.find_np(n)
                if a.shape != b.shape:
                    findings.append(
                        f"written state {n!r} shape diverged: "
                        f"{a.shape} vs {b.shape}")
                elif not np.array_equal(a, b):
                    d = np.max(np.abs(a.astype(np.float64)
                                      - b.astype(np.float64)))
                    findings.append(
                        f"written state {n!r} diverged after {n_steps} "
                        f"steps: max|a-b|={d:.3e}")
            cases.append({
                "model": kind, "k": k, "dispatches": dispatches,
                "fetches": [loss_name],
                "written_state": len(written),
                "replayed": replayed,
                "bitwise": not findings,
                "findings": findings,
            })
    all_ok = all(c["bitwise"] for c in cases)
    return {
        "analysis": "loop_parity",
        "device": str(place.device),
        "ks": [int(k) for k in ks],
        "batch_size": int(batch_size),
        "models": sorted({c["model"] for c in cases}),
        "cases": cases,
        "bitwise": all_ok,
        "verdict": "PROVEN" if all_ok else "DIVERGED",
        "findings": [f for c in cases for f in c["findings"]],
    }
