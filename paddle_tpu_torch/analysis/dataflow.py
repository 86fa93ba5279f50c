"""Dataflow analysis over Program/Block/Operator descs — the port of
``paddle_tpu/analysis/dataflow.py``.

Everything here is desc-level (no tensors run), so it works on any
program, including ones the executor would reject: the verifier must
diagnose exactly those.

  def_use(block)          — per-name ordered def/use op-index chains
  dependency_graph(block) — RAW data-dependency predecessors per op
  happens_before(block)   — transitive-ancestor bitmasks over that graph
  hazards(block)          — WAW/WAR pairs with NO happens-before path
  var_intervals(block)    — (first_def, last_use) per name
  state_classes(block)    — what the executor reads from and writes back
                            to the scope
  forward_closure(block)  — names reachable from seeds through op dataflow

The happens-before relation is the *data* order, not the textual order:
two ops are ordered iff a chain of produced-consumed values connects
them.  The executor walks ops in textual order, which is always a valid
schedule, but a desc-rewriting pass is free to reorder ops that the data
order leaves unordered; a write that races another access of the same
name across that freedom is a hazard.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# attr names holding nested-block indices (while/static_rnn/recompute use
# sub_block; cond uses one per branch)
SUB_BLOCK_ATTRS = ("sub_block", "true_block", "false_block")


def sub_block_indices(op) -> List[int]:
    """Indices of the nested blocks an op's attrs reference, in attr order."""
    return [op.attrs[key] for key in SUB_BLOCK_ATTRS if key in op.attrs]


def def_use(block) -> Tuple[Dict[str, List[int]], Dict[str, List[int]]]:
    """(defs, uses): per variable name, the ordered op indices writing and
    reading it.  "" placeholder names (grad holes) are ignored."""
    defs: Dict[str, List[int]] = {}
    uses: Dict[str, List[int]] = {}
    for i, op in enumerate(block.ops):
        for n in op.input_names():
            if n:
                uses.setdefault(n, []).append(i)
        for n in op.output_names():
            if n:
                defs.setdefault(n, []).append(i)
    return defs, uses


def dependency_graph(block) -> List[List[int]]:
    """preds[j] = op indices j directly depends on (RAW edges): for each
    input name, the most recent in-block def before j.  Reads satisfied from
    the scope (no in-block def yet) contribute no edge."""
    last_def: Dict[str, int] = {}
    preds: List[List[int]] = []
    for j, op in enumerate(block.ops):
        p = set()
        for n in op.input_names():
            if n in last_def:
                p.add(last_def[n])
        preds.append(sorted(p))
        for n in op.output_names():
            if n:
                last_def[n] = j
    return preds


def happens_before(block, preds: Optional[List[List[int]]] = None
                   ) -> List[int]:
    """ancestors[j]: bitmask of op indices with a data path INTO op j.
    `(ancestors[j] >> i) & 1` answers "does i happen-before j?" in O(1);
    building the closure is O(ops × edges / 64) via int bitsets."""
    if preds is None:
        preds = dependency_graph(block)
    ancestors = [0] * len(preds)
    for j, ps in enumerate(preds):
        mask = 0
        for i in ps:
            mask |= ancestors[i] | (1 << i)
        ancestors[j] = mask
    return ancestors


def hazards(block) -> List[Tuple[str, str, int, int]]:
    """(kind, name, i, j) races: accesses of the same name with no
    happens-before path ordering them.

      WAW — ops i<j both write `name`, i ⇏ j: whichever runs last wins, so
            any pass free to reorder them changes the program's result.
      WAR — op i reads `name` (a value defined in-block before i), op j>i
            overwrites it, i ⇏ j: scheduling j first would feed i the new
            value.  Reads with NO prior in-block definition are exempt —
            they observe scope state, and the read-params-then-update-them
            shape (every forward op vs its optimizer write, the beta-pow
            finish-update) is the universal training idiom, not a race.
    """
    preds = dependency_graph(block)
    anc = happens_before(block, preds)
    defs, uses = def_use(block)
    found: List[Tuple[str, str, int, int]] = []
    for name, dlist in defs.items():
        # WAW: consecutive-and-beyond write pairs
        for a in range(len(dlist)):
            for b in range(a + 1, len(dlist)):
                i, j = dlist[a], dlist[b]
                if not (anc[j] >> i) & 1:
                    found.append(("WAW", name, i, j))
        # WAR: a read of an in-block-defined value must happen-before any
        # later write of the same name.  Reads at or before the first
        # in-block def observe scope state (exempt, see docstring); an op
        # that reads and writes the name itself (in-place increment / the
        # sgd Param->ParamOut idiom) is excluded by j > k.
        first_def = dlist[0]
        for k in uses.get(name, []):
            if k <= first_def:
                continue
            for j in dlist:
                if j > k and not (anc[j] >> k) & 1:
                    found.append(("WAR", name, k, j))
    return found


def var_intervals(block) -> Dict[str, Tuple[int, int]]:
    """name -> (first_def, last_access) op-index interval.  A name that is
    only read (scope state) gets first_def = -1; last_access covers both
    reads and writes — the span a buffer for `name` must stay live."""
    iv: Dict[str, List[int]] = {}
    for i, op in enumerate(block.ops):
        for n in op.input_names():
            if not n:
                continue
            if n in iv:
                iv[n][1] = i
            else:
                iv[n] = [-1, i]
        for n in op.output_names():
            if not n:
                continue
            if n in iv:
                iv[n][1] = i
                if iv[n][0] < 0:
                    iv[n][0] = i
            else:
                iv[n] = [i, i]
    return {n: (a, b) for n, (a, b) in iv.items()}


def state_classes(block, feed_names=(), skip_types=("feed", "fetch")
                  ) -> Tuple[List[str], List[str], List[str]]:
    """(external_reads, rw_state, written_state) for one block:

      external_reads — names read from the scope and never overwritten
      rw_state       — read BEFORE written: pre-existing state updated in
                       place (the executor writes it back by reference)
      written_state  — every name persisted back to the scope (rw_state
                       plus persistable outputs that were never read)"""
    produced = set(feed_names)
    external_reads: List[str] = []
    rw_state: List[str] = []
    written_state: List[str] = []
    seen_reads = set()
    written_set = set()  # the names of written_state, for lookups
    for op in block.ops:
        if op.type in skip_types:
            continue
        for n in op.input_names():
            if n and n not in produced and n not in seen_reads:
                seen_reads.add(n)
                external_reads.append(n)
        for n in op.output_names():
            if not n:
                continue
            if n in seen_reads and n not in written_set:
                rw_state.append(n)
                written_state.append(n)
                written_set.add(n)
            produced.add(n)
    for op in block.ops:
        if op.type in skip_types:
            continue
        for n in op.output_names():
            if not n or n in written_set:
                continue
            v = block._find_var_recursive(n)
            if v is not None and v.persistable:
                written_state.append(n)
                written_set.add(n)
    rw_set = set(rw_state)
    external_reads = [n for n in external_reads if n not in rw_set]
    return external_reads, rw_state, written_state


def forward_closure(block, seeds, stop_types=()) -> set:
    """Names reachable FROM `seeds` through op dataflow (op order), skipping
    ops whose type is in `stop_types`.  Used by the missing-grad rule to ask
    "does this parameter feed the differentiated region?"."""
    tainted = set(seeds)
    for op in block.ops:
        if op.type in stop_types:
            continue
        if any(n in tainted for n in op.input_names()):
            tainted.update(n for n in op.output_names() if n)
    return tainted
