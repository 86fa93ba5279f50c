"""Dataflow analysis over Program/Block/Operator descs — the part of
``paddle_tpu/analysis/dataflow.py`` that the HBM estimate
(``analysis/memory.py``) calls: the state classification."""

from __future__ import annotations

from typing import List, Tuple


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
