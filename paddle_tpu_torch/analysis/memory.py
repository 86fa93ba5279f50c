"""Static device-memory peak estimate over Program descs — the desc-only
part of ``paddle_tpu/analysis/memory.py`` that the serving engine's
``hbm_report`` (and through it the v2 admission watermark) calls.

    peak = persistent state (parameters, KV pools; counted ONCE — written
           state is updated in place, ``donated_bytes`` of it)
         + feed buffers
         + the peak of the transient live set

Shapes are the declared ones (``infer_shapes=False`` in the reference):
-1 dims bind to `batch_size`.  No sharding plan: the port runs on one
card.  The serving programs hold no gradient ops,
so the reference's backward refinements (grad-dependency classes and
backward workspaces of compound ops) are not carried; a block with a
gradient op raises instead of being priced without them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..framework.core import torch_dtype
from . import dataflow


def bind_shape(shape, batch_size: int):
    """-1/None dims (feed-time batch axes) bound to `batch_size`."""
    return tuple(batch_size if (s is None or int(s) < 0) else int(s)
                 for s in shape)


def dtype_bytes(dtype) -> int:
    """Bytes per element of a desc dtype (bfloat16: 2)."""
    try:
        return int(torch_dtype(dtype or "float32").itemsize)
    except (KeyError, ValueError, TypeError):
        return 4


def var_bytes(var, batch_size: int) -> int:
    """Desc-level byte size of one variable's buffer (0 if shapeless)."""
    if var is None or var.shape is None:
        return 0
    n = 1
    for s in bind_shape(var.shape, batch_size):
        n *= max(int(s), 1)
    return n * dtype_bytes(var.dtype)


def _transient_lifetimes(block, batch_size: int):
    """(first_def, last_use, sizes) for the transient set: each op
    output's first definition and last access, and the byte size of each
    non-persistable, non-feed one."""
    first_def: Dict[str, int] = {}
    last_use: Dict[str, int] = {}
    for i, op in enumerate(block.ops):
        if op.type.endswith("_grad"):
            raise NotImplementedError(
                f"op {op.type!r}: the port's memory estimate prices "
                f"forward programs only")
        for name in op.output_names():
            first_def.setdefault(name, i)
            last_use[name] = i
        for name in op.input_names():
            last_use[name] = i
    sizes: Dict[str, int] = {}
    for name in first_def:
        v = block._find_var_recursive(name)
        if v is None or v.persistable or v.is_data:
            continue
        if v.shape is not None:
            sizes[name] = var_bytes(v, batch_size)
    return first_def, last_use, sizes


def peak_estimate(program, batch_size: int = 64) -> dict:
    """Projected peak device residency (bytes) for one execution of the
    program's global block; see the module docstring."""
    block = program.global_block()
    persistent = 0
    feed_bytes = 0
    for v in block.vars.values():
        if v.persistable:
            persistent += var_bytes(v, batch_size)
        elif v.is_data:
            feed_bytes += var_bytes(v, batch_size)

    first_def, last_use, sizes = _transient_lifetimes(block, batch_size)
    n_ops = len(block.ops)
    deltas = [0] * (n_ops + 1)
    for name, b in sizes.items():
        deltas[first_def[name]] += b
        deltas[last_use[name] + 1] -= b
    live, cur = [], 0
    for i in range(n_ops):
        cur += deltas[i]
        live.append(cur)
    peak_i = int(np.argmax(live)) if live else 0
    act_peak = live[peak_i] if live else 0

    # state read then written in place: no second copy is ever live
    feed_names = [n for n, v in block.vars.items() if v.is_data]
    _, rw_state, _ = dataflow.state_classes(block, feed_names)
    in_place = sum(
        var_bytes(block._find_var_recursive(n), batch_size)
        for n in rw_state
        if block._find_var_recursive(n) is not None
        and block._find_var_recursive(n).persistable)
    return {
        "batch_size": int(batch_size),
        "persistent_bytes": int(persistent),
        "feed_bytes": int(feed_bytes),
        "activation_peak_bytes": int(act_peak),
        "peak_op_index": peak_i,
        "total_peak_bytes": int(persistent + feed_bytes + act_peak),
        "donated_bytes": int(in_place),
    }
