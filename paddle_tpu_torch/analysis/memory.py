"""Static device-memory peak estimation over Program descs — the port of
``paddle_tpu/analysis/memory.py``.

Prices the `dataflow.var_intervals` live ranges by declared (or
abstractly inferred) shape and dtype and rolls them into a projected
peak-residency number for one step:

    peak = persistent state (params + optimizer moments, counted ONCE —
           written state is updated in place)
         + feed buffers
         + the peak of the transient (activation + gradient) live set

The transient sweep is REMAT-AWARE (a `__remat__`-marked grad op
re-derives its forward outputs instead of keeping them live) and
DONATION-AWARE (`donation_savings_bytes` quantifies the second copy of
every read-then-written buffer that in-place updates avoid;
`donate=False` prices the no-donation world).  The formulas are the JAX
package's, so both price one desc to the byte; the card's measured peak
(`torch.cuda.max_memory_allocated`) is a different quantity (eager
PyTorch frees at each tensor's last Python reference, and its caching
allocator rounds), and `chip_smoke.py` prints the two side by side.

A sharding plan (`{name: NamedSharding}` as built by
``parallel.DistributeTranspiler`` / ``ParallelExecutor.static_plan``)
switches to per-shard accounting, as the JAX package's does: planned vars
divide by their shard counts, batch-led transients by the feeds' batch
split.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from . import dataflow


def bind_shape(shape, batch_size: int):
    """-1/None dims (feed-time batch axes) bound to `batch_size`."""
    return tuple(batch_size if (s is None or int(s) < 0) else int(s)
                 for s in shape)


def dtype_bytes(dtype) -> int:
    """Bytes per element of a desc dtype (bfloat16: 2)."""
    from ..framework.core import torch_dtype

    try:
        return int(torch_dtype(dtype or "float32").itemsize)
    except (KeyError, ValueError, TypeError):
        return 4


def var_bytes(var, batch_size: int, divisor: int = 1) -> int:
    """Desc-level byte size of one variable's buffer (0 if shapeless),
    divided by `divisor` (its shard count under a plan)."""
    if var is None or var.shape is None:
        return 0
    n = 1
    for s in bind_shape(var.shape, batch_size):
        n *= max(int(s), 1)
    return (n * dtype_bytes(var.dtype)) // max(int(divisor), 1)


# ---------------------------------------------------------------------------
# sharding plans -> per-var byte divisors


def _spec_entries(sharding):
    """Flat mesh-axis names a plan entry shards over ('' entries and
    None skipped).  Accepts NamedSharding, PartitionSpec, or any
    iterable of axis names / tuples / None."""
    spec = getattr(sharding, "spec", sharding)
    axes = []
    try:
        entries = tuple(spec)
    except TypeError:
        return axes
    for e in entries:
        if e is None:
            continue
        if isinstance(e, (tuple, list)):
            axes.extend(a for a in e if a)
        elif e:
            axes.append(e)
    return axes


def _mesh_axis_sizes(sharding) -> Dict[str, int]:
    mesh = getattr(sharding, "mesh", None)
    if mesh is None:
        return {}
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def shard_divisor(sharding) -> int:
    """How many devices one shard of this var is split across: the
    product of the sizes of the mesh axes its spec names."""
    if sharding is None:
        return 1
    sizes = _mesh_axis_sizes(sharding)
    d = 1
    for a in _spec_entries(sharding):
        d *= int(sizes.get(a, 1))
    return max(d, 1)


def _batch_divisor(plan, feed_names) -> int:
    """The per-shard divisor for batch-led transients: the largest
    leading-axis divisor any FEED entry in the plan carries
    (activations inherit the batch sharding of the data they are
    computed from).  Only feed entries count — a row-sharded WEIGHT
    also has a named dim-0 axis, but it says nothing about how the
    batch is split."""
    best = 1
    for name in feed_names:
        sh = (plan or {}).get(name)
        if sh is None:
            continue
        spec = getattr(sh, "spec", sh)
        try:
            first = tuple(spec)[0] if tuple(spec) else None
        except TypeError:
            first = None
        if first:
            sizes = _mesh_axis_sizes(sh)
            names = ([first] if not isinstance(first, (tuple, list))
                     else list(first))
            d = 1
            for a in names:
                d *= int(sizes.get(a, 1))
            best = max(best, d)
    return best


# ---------------------------------------------------------------------------
# the estimator

# The generic_grad DESC lists every forward operand as an input
# (default_grad_maker carries all slots), but a backward only needs what
# its residuals keep — so desc-level liveness classifies forward ops by
# what their backward keeps, or the estimator charges every add/scale
# activation all the way into the backward pass.  The classes are the
# JAX package's (its vjp's residuals), so both packages price a desc
# alike.

# vjp independent of the primal values (linear / data movement): the
# grad op extends NO forward operand's live range and has no workspace
LINEAR_GRAD_TYPES = frozenset((
    "elementwise_add", "elementwise_sub", "minus", "scale", "sum", "mean",
    "reshape", "squeeze", "unsqueeze", "transpose", "concat", "split",
    "cast", "pad", "sequence_concat", "lod_reset", "slice",
))

# single-kernel nonlinear maps: the vjp keeps the INPUTS (or the output
# for the OUTPUT_RESIDUAL set) but fuses into the surrounding
# elementwise chain — no hidden re-derivation workspace.  Matmuls also
# live here: their backward is two more matmuls writing straight into
# the declared @GRAD vars, nothing extra materializes.
ELEMENTWISE_GRAD_TYPES = frozenset((
    "square", "relu", "prelu", "leaky_relu", "brelu", "soft_relu", "abs",
    "clip", "pow", "log", "floor", "ceil", "round", "dropout",
    "elementwise_mul", "elementwise_div", "elementwise_max",
    "elementwise_min", "elementwise_pow", "mul", "matmul",
    "sigmoid", "tanh", "exp", "sqrt", "reciprocal", "gelu", "swish",
    "elu", "selu", "softplus", "softsign", "hard_sigmoid", "thresholded_relu",
))

# ops whose saved residual IS the forward output (jax's tanh/sigmoid/
# softmax vjp rules): the output stays live into the backward; for
# everything else the recomputed residuals come from the inputs and the
# output's desc-level use by the grad op is DCE'd
OUTPUT_RESIDUAL_TYPES = frozenset((
    "softmax", "log_softmax", "sigmoid", "tanh", "exp", "sqrt",
    "reciprocal", "sequence_softmax",
))


# ---------------------------------------------------------------------------
# backward workspace: temporaries a compound op's backward materializes
# that are no block var at all.  Each formula names its physical buffer
# as the JAX package measured it (its lowering's buffers, kept so both
# packages price one desc alike); operands arrive as {slot: [(shape,
# dtype_bytes) | None]} from the forward slots of the grad op's desc.


def _operand(ins, slot):
    v = ins.get(slot, [None])
    return v[0] if v else None


def _bytes_of(o):
    if o is None:
        return 0
    n = 1
    for s in o[0]:
        n *= max(int(s), 1)
    return n * o[1]


def _ws_conv(ins, outs, attrs):
    """Patch matrix of the grad-input/grad-filter correlation (im2col on
    CPU, the dilated/padded halo buffer of the transposed conv on TPU):
    out_spatial x k_spatial x Cin/groups."""
    w = _operand(ins, "Filter")
    out = _operand(outs, "Output") or _operand(outs, "Out")
    if w is None or out is None or len(w[0]) < 3:
        return 0
    k_spatial = 1
    for s in w[0][2:]:
        k_spatial *= int(s)
    out_spatial_bytes = _bytes_of(out) // max(int(w[0][0]), 1)
    return out_spatial_bytes * k_spatial * int(w[0][1])


def _ws_xent(ins, outs, attrs):
    """Probabilities + dlogits + the one-hot label scatter matrix —
    3x the logits buffer (the f32[N,V] trio visible in the HLO)."""
    x = _operand(ins, "X") or _operand(ins, "Logits")
    return 3 * _bytes_of(x)


def _ws_lookup(ins, outs, attrs):
    """Scatter-add of the table gradient goes through an [ids, vocab]
    one-hot matmul on the XLA lowering."""
    ids = _operand(ins, "Ids")
    w = _operand(ins, "W")
    if ids is None or w is None or len(w[0]) < 1:
        return 0
    n_ids = 1
    for s in ids[0]:
        n_ids *= max(int(s), 1)
    return n_ids * int(w[0][0]) * 4


def _ws_sdpa(ins, outs, attrs):
    """The O(T^2) buffers flash kernels exist to avoid: the dense
    backward materializes scores, probabilities, and their two
    cotangents — 4 x B*H*T*S."""
    q = _operand(ins, "Q")
    k = _operand(ins, "K")
    if q is None or k is None or len(q[0]) != 4:
        return 0
    b, h, t, _ = q[0]
    s = k[0][2]
    return 4 * int(b) * int(h) * int(t) * int(s) * q[1]


def _ws_norm(ins, outs, attrs):
    """x_hat and dx_hat of the normalization backward: 2 x input."""
    x = _operand(ins, "X") or _operand(ins, "Input")
    return 2 * _bytes_of(x)


def _ws_pool(ins, outs, attrs):
    """Select-and-scatter workspace of the max-pool backward: XLA's
    scatter lowering materializes ~rank s32 coordinate grids of the
    input window space beside the scattered values (4 x input in the
    measured digits buffer assignment: 3 index grids + the [rows, rank]
    coordinate table)."""
    x = _operand(ins, "X") or _operand(ins, "Input")
    return 4 * _bytes_of(x)


# fwd type -> workspace formula; compound types not listed here charge
# one extra copy of their transient operand set (generic re-derivation)
GRAD_WORKSPACE: Dict[str, object] = {
    "conv2d": _ws_conv,
    "depthwise_conv2d": _ws_conv,
    "conv2d_transpose": _ws_conv,
    "conv3d": _ws_conv,
    "conv3d_transpose": _ws_conv,
    "softmax_with_cross_entropy": _ws_xent,
    "cross_entropy": _ws_xent,
    "lookup_table": _ws_lookup,
    "scaled_dot_product_attention": _ws_sdpa,
    "batch_norm": _ws_norm,
    "layer_norm": _ws_norm,
    "lrn": _ws_norm,
    "pool2d": _ws_pool,
    "pool3d": _ws_pool,
    "max_pool2d_with_index": _ws_pool,
    "max_pool3d_with_index": _ws_pool,
}



def abstract_sizes(program, block_id: int, batch_size: int
                   ) -> Dict[str, tuple]:
    """{name: (shape, itemsize)} of every op output the PTV006 oracle
    infers (each op's emitter run on meta tensors,
    `verifier.abstract_eval`), reused for SIZING: declared desc shapes
    carry -1 markers that only mean "batch" on feed vars (a flattened
    [-1, V] logits var really has B*T rows), and helper tmp vars have no
    declared shape at all.  Ops that cannot evaluate poison their
    outputs (callers fall back to declared shapes); nothing runs on a
    device."""
    from .verifier import _UNKNOWN, abstract_eval

    out: Dict[str, tuple] = {}
    for _, outs in abstract_eval(program, block_id, batch_size)[1]:
        for n, got in outs.items():
            if got is _UNKNOWN:
                continue
            out[n] = (tuple(int(s) for s in got.shape),
                      int(got.dtype.itemsize))
    return out


def _operand_view(block, op, slots, batch_size, inferred=None):
    inferred = inferred or {}
    out = {}
    for slot in slots:
        vals = []
        for n in op.input(slot):
            if n in inferred:
                vals.append(inferred[n])
                continue
            v = block._find_var_recursive(n) if n else None
            if v is None or v.shape is None:
                vals.append(None)
            else:
                vals.append((bind_shape(v.shape, batch_size),
                             dtype_bytes(v.dtype)))
        out[slot] = vals
    return out


def _transient_lifetimes(block, batch_size: int, inferred=None):
    """(first_def, last_use, sizes, spike_names, spike_bytes) for the
    transient set.  `inferred` ({name: (shape, itemsize)} from
    abstract_sizes) overrides declared-shape pricing where available.

    Like memory_optimization_transpiler._lifetimes (remat-marked grad
    ops re-derive their own forward outputs) plus two backward-pass
    refinements the peak VALIDATION demanded (the planner deliberately
    keeps the coarser model — its contract tests pin it):

      * grad-dependency classes — a grad op only extends the live range
        of operands its vjp actually keeps: nothing for
        LINEAR_GRAD_TYPES, inputs for the rest, the output additionally
        for OUTPUT_RESIDUAL_TYPES (cotangent slots always count);
      * backward workspace of COMPOUND ops — while grad op i runs, its
        vjp materializes temporaries that are no block var at all.
        Ops with a GRAD_WORKSPACE formula get spike_bytes[i] (conv's
        patch matrix, the softmax/one-hot trio, attention scores,
        x_hat chains); other compound ops get spike_names[i] — one
        extra copy of their transient operand set (generic
        re-derivation), priced by the caller so per-shard scaling
        applies uniformly.  Fused single-kernel ops
        (ELEMENTWISE_GRAD_TYPES, matmuls) have no such workspace.
    """
    first_def: Dict[str, int] = {}
    last_use: Dict[str, int] = {}
    skip_of: Dict[int, frozenset] = {}
    spike_names: Dict[int, frozenset] = {}
    spike_bytes: Dict[int, int] = {}
    for idx, op in enumerate(block.ops):
        if op.type != "generic_grad":
            continue
        fwd_type = op.attrs.get("__fwd_type__")
        in_slots = tuple(op.attrs.get("__fwd_input_slots__", ()))
        out_slots = tuple(op.attrs.get("__fwd_output_slots__", ()))
        out_names = frozenset(n for slot in out_slots
                              for n in op.input(slot) if n)
        in_names = frozenset(n for slot in in_slots
                             for n in op.input(slot) if n)
        # what this grad op's vjp never reads, by forward-op class
        if fwd_type in LINEAR_GRAD_TYPES:
            skip = in_names | out_names
        elif fwd_type in OUTPUT_RESIDUAL_TYPES:
            skip = frozenset()
        else:
            skip = out_names - in_names
        if op.attrs.get("__remat__"):
            # checkpointed: additionally re-derives its own forward
            # outputs — they stop being live residuals (the planner's
            # optimistic model; no workspace spike, as the re-derived
            # values die inside the fused backward and charging them
            # would double-count any output another grad op still keeps)
            skip = skip | out_names
        if skip:
            skip_of[idx] = skip
        if fwd_type in LINEAR_GRAD_TYPES \
                or fwd_type in ELEMENTWISE_GRAD_TYPES \
                or op.attrs.get("__remat__"):
            continue  # fused / checkpointed: no hidden workspace
        ws_fn = GRAD_WORKSPACE.get(fwd_type)
        if ws_fn is not None:
            ins_sd = _operand_view(block, op, in_slots, batch_size,
                                   inferred)
            outs_sd = _operand_view(block, op, out_slots, batch_size,
                                    inferred)
            try:
                spike_bytes[idx] = int(ws_fn(
                    ins_sd, outs_sd, op.attrs.get("__fwd_attrs__", {})))
            except (TypeError, ValueError, IndexError):
                spike_names[idx] = in_names | out_names
        else:
            spike_names[idx] = (in_names | out_names
                                if fwd_type in OUTPUT_RESIDUAL_TYPES
                                else in_names)
    for i, op in enumerate(block.ops):
        for name in op.output_names():
            first_def.setdefault(name, i)
            last_use[name] = i
        skip = skip_of.get(i, ())
        for name in op.input_names():
            if name in skip:
                continue
            last_use[name] = i

    inferred = inferred or {}
    sizes: Dict[str, int] = {}
    for name, d in first_def.items():
        v = block._find_var_recursive(name)
        if v is None or v.persistable or v.is_data:
            continue
        if name in inferred:
            shape, item = inferred[name]
            n = 1
            for s in shape:
                n *= max(int(s), 1)
            sizes[name] = n * item
        elif v.shape is not None:
            sizes[name] = var_bytes(v, batch_size)
    return first_def, last_use, sizes, spike_names, spike_bytes


def peak_estimate(program, batch_size: int = 64, block_id: int = 0,
                  plan: Optional[Dict[str, object]] = None,
                  donate: bool = True, infer_shapes: bool = True) -> dict:
    """Projected peak device residency (bytes) for one execution of block
    `block_id`; see the module docstring for the model.  `donate=False`
    prices the no-donation world (read-then-written state counted twice
    at the update).  `infer_shapes=False` skips the abstract-eval shape
    oracle and prices declared shapes only (desc-only speed; -1 markers
    bind to batch_size, which misprices flattened intermediates).  `plan`
    ({var: NamedSharding}, e.g. ``ParallelExecutor.static_plan``)
    switches to per-shard accounting: a planned var divides by its shard
    count, a batch-led transient by the feeds' batch split."""
    block = program.blocks[block_id]
    plan = plan or {}
    inferred = {}
    if infer_shapes:
        inferred = abstract_sizes(program, block_id, batch_size)

    def div_of(name):
        return shard_divisor(plan.get(name)) if plan else 1

    persistent = 0
    feed_bytes = 0
    for name, v in block.vars.items():
        if v.persistable:
            persistent += var_bytes(v, batch_size, div_of(name))
        elif v.is_data:
            feed_bytes += var_bytes(v, batch_size, div_of(name))

    first_def, last_use, sizes, spike_names, spike_bytes = \
        _transient_lifetimes(block, batch_size, inferred)
    feed_names = [n for n, v in block.vars.items() if v.is_data]
    bdiv = _batch_divisor(plan, feed_names) if plan else 1
    if plan:

        def shard_scale(name, b):
            if name in plan:
                return b // max(div_of(name), 1)
            if bdiv > 1:
                v = block._find_var_recursive(name)
                if v is not None and v.shape and int(v.shape[0]) < 0:
                    return b // bdiv  # batch-led: rides the dp split
                if (v is not None and v.shape is None
                        and name in inferred):
                    # helper tmp with no declared shape: batch-led when
                    # its inferred leading dim divides by the feed split
                    shp = inferred[name][0]
                    if shp and shp[0] >= bdiv and shp[0] % bdiv == 0:
                        return b // bdiv
            return b

        sizes = {n: shard_scale(n, b) for n, b in sizes.items()}

    n_ops = len(block.ops)
    deltas = [0] * (n_ops + 1)
    for name, b in sizes.items():
        deltas[first_def[name]] += b
        deltas[last_use[name] + 1] -= b
    live, cur = [], 0
    for i in range(n_ops):
        cur += deltas[i]
        spike = sum(sizes.get(n, 0) for n in spike_names.get(i, ()))
        spike += spike_bytes.get(i, 0) // (bdiv if plan else 1)
        live.append(cur + spike)

    peak_i = int(np.argmax(live)) if live else 0
    act_peak = live[peak_i] if live else 0

    # donation: every read-then-written buffer would otherwise need old
    # and new copies live across the update
    _, rw_state, _ = dataflow.state_classes(block, feed_names)
    donated = sum(
        var_bytes(block._find_var_recursive(n), batch_size, div_of(n))
        for n in rw_state
        if block._find_var_recursive(n) is not None
        and block._find_var_recursive(n).persistable)

    total = persistent + feed_bytes + act_peak
    if not donate:
        total += donated
    return {
        "batch_size": int(batch_size),
        "block_id": int(block_id),
        "persistent_bytes": int(persistent),
        "feed_bytes": int(feed_bytes),
        "activation_peak_bytes": int(act_peak),
        "peak_op_index": peak_i,
        "total_peak_bytes": int(total),
        "donated_bytes": int(donated),
        "donation_savings_bytes": int(donated if donate else 0),
        "remat_marked_ops": sum(1 for op in block.ops
                                if op.attrs.get("__remat__")),
        "per_shard": bool(plan),
    }


def fits(report: dict, hbm_bytes: int, headroom: float = 0.9) -> bool:
    """Does the projected peak fit `headroom` of a device-memory budget?"""
    return report["total_peak_bytes"] <= int(hbm_bytes * headroom)


def render(report: dict) -> str:
    def gib(b):
        if b >= 1 << 30:
            return f"{b / 1024**3:.2f} GiB"
        if b >= 1 << 20:
            return f"{b / 1024**2:.2f} MiB"
        return f"{b} B"

    lines = [
        f"HBM peak (static, batch={report['batch_size']}"
        + (", per-shard" if report["per_shard"] else "") + ")",
        f"  persistent state   {gib(report['persistent_bytes'])}",
        f"  feed buffers       {gib(report['feed_bytes'])}",
        f"  activation peak    {gib(report['activation_peak_bytes'])}"
        f" (at op {report['peak_op_index']},"
        f" {report['remat_marked_ops']} remat-marked)",
        f"  total              {gib(report['total_peak_bytes'])}",
        f"  donation saves     {gib(report['donation_savings_bytes'])}",
    ]
    return "\n".join(lines)
