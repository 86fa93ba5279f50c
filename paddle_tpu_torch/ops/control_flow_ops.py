"""Control-flow ops, the port of ``paddle_tpu/ops/control_flow_ops.py``:
the comparisons, ``logical_*`` and ``select``; ``is_empty``; ``cond``,
``while`` and ``static_rnn``, which run a nested block through
``ctx.lower_block``; and the tensor arrays (``create_array``,
``array_write``, ``array_read``) as dense fixed-capacity buffers; and
``recompute``, the rematerialization segment.

The JAX package lowers a nested block into ``lax.cond`` /
``lax.while_loop`` / ``lax.scan``; here the loop and the branch run on
the host, op by op.  ``cond`` and ``static_rnn`` differentiate through
``generic_grad``, which re-runs them under autograd (the branch and the
time loop trace naturally; gradients reach the taken branch's externals
only, as with ``lax.cond``).  ``while`` takes no gradient, as in the JAX
package.  ``recompute`` runs its straight-line segment once forward, and
its ``generic_grad`` runs it again under autograd (the JAX package's
``jax.checkpoint``)."""

from __future__ import annotations

import torch

from ..framework.core import torch_dtype
from .registry import register_op


def _cmp(fn):
    def emit(ctx, ins, attrs):
        return {"Out": [fn(ins["X"][0], ins["Y"][0])]}

    return emit


for _name, _fn in [
    ("less_than", torch.lt),
    ("less_equal", torch.le),
    ("greater_than", torch.gt),
    ("greater_equal", torch.ge),
    ("equal", torch.eq),
    ("not_equal", torch.ne),
    ("logical_and", torch.logical_and),
    ("logical_or", torch.logical_or),
    ("logical_xor", torch.logical_xor),
]:
    register_op(_name, _cmp(_fn), grad=None)

register_op("logical_not", lambda ctx, ins, attrs: {
    "Out": [torch.logical_not(ins["X"][0])]}, grad=None)


@register_op("select", non_diff_inputs=("Mask",))
def select(ctx, ins, attrs):
    """Out = Mask ? X : Y, with Mask broadcast from [B, 1]."""
    mask = ins["Mask"][0]
    x, y = ins["X"][0], ins["Y"][0]
    while mask.ndim < max(x.ndim, y.ndim):
        mask = mask[..., None]
    return {"Out": [torch.where(mask != 0, x, y)]}


@register_op("is_empty", grad=None)
def is_empty(ctx, ins, attrs):
    return {"Out": [torch.tensor(ins["X"][0].numel() == 0,
                                 device=ctx.device)]}


# --- cond, while, static_rnn ---------------------------------------------


def _pred(t) -> bool:
    """A one-element predicate tensor, read on the host."""
    return bool(t.reshape(()) != 0)


@register_op("cond", non_diff_inputs=("Cond",))
def cond(ctx, ins, attrs):
    """Two-branch conditional on a one-element predicate.

    attrs: true_block/false_block (sub-block idx), out_names (produced by
    both branches), x_names (external vars either branch may read,
    declared as inputs so gradients flow to them).  The predicate is read
    on the host and only the taken branch runs."""
    env = dict(zip(attrs.get("x_names", []), ins.get("X", [])))
    taken = attrs["true_block"] if _pred(ins["Cond"][0]) \
        else attrs["false_block"]
    ctx.lower_block(int(taken), env)
    return {"Out": [env[n] for n in attrs["out_names"]]}


@register_op("while", grad=None)
def while_op(ctx, ins, attrs):
    """Run a sub-block while its condition holds (while_op.cc).

    attrs: sub_block (idx), carry_names (vars updated each iteration,
    the condition var among them), cond_name, x_names (read-only
    externals).  Inputs: Carry (initial values, ordered as carry_names)
    + X.  The trip count depends on the data, so the condition is read
    on the host once before each iteration: one device-to-host sync per
    iteration, and a block holding ``while`` never rides a captured step
    loop (``framework/step_loop.safety_report``)."""
    carry_names = list(attrs["carry_names"])
    cond_pos = carry_names.index(attrs["cond_name"])
    sub_block = int(attrs["sub_block"])
    base_env = dict(zip(attrs.get("x_names", []), ins.get("X", [])))
    carry = list(ins["Carry"])
    while _pred(carry[cond_pos]):
        env = dict(base_env)
        env.update(zip(carry_names, carry))
        ctx.lower_block(sub_block, env)
        carry = [env[n] for n in carry_names]
    return {"Out": carry}


@register_op("static_rnn", non_diff_inputs=("Length",))
def static_rnn(ctx, ins, attrs):
    """Run a sub-block once per step of the time axis (recurrent_op.cc).

    attrs: sub_block, step_input_names (outer [B,T,...] vars, sliced to
    [B,...] per step under the same names), memory_pairs [[mem, updated],
    ..] (mem reads the previous step's `updated`), out_names (per-step
    outputs, stacked to [B,T,...]), x_names (externals, e.g. the step's
    weights).  Inputs: StepInputs, MemInit, X, and an optional Length
    [B]: a memory keeps its value past its row's length (DynamicRNN; the
    static-shape stand-in for shrink_rnn_memory) and the outputs there
    are zero."""
    step_names = list(attrs["step_input_names"])
    mem_pairs = [tuple(p) for p in attrs["memory_pairs"]]
    out_names = list(attrs["out_names"])
    sub_block = int(attrs["sub_block"])
    seq_inputs = ins["StepInputs"]
    lengths = None
    if ins.get("Length") and ins["Length"][0] is not None:
        lengths = ins["Length"][0]
    base_env = dict(zip(attrs.get("x_names", []), ins.get("X", [])))
    T = seq_inputs[0].shape[1]

    mems = list(ins["MemInit"])
    per_step = []
    for t in range(T):
        env = dict(base_env)
        for name, seq in zip(step_names, seq_inputs):
            env[name] = seq[:, t]
        for (mname, _), m in zip(mem_pairs, mems):
            env[mname] = m
        ctx.lower_block(sub_block, env)
        new_mems = []
        for (_, uname), m in zip(mem_pairs, mems):
            nm = env[uname]
            if lengths is not None:
                alive = (t < lengths).to(nm.dtype).reshape(
                    (-1,) + (1,) * (nm.ndim - 1))
                nm = alive * nm + (1 - alive) * m
            new_mems.append(nm)
        mems = new_mems
        per_step.append([env[n] for n in out_names])
    outs = [torch.stack([s[j] for s in per_step], dim=1)
            for j in range(len(out_names))]
    if lengths is not None:
        # LoD semantics: steps past a row's end do not exist
        tmask = (torch.arange(T, device=lengths.device)[None, :]
                 < lengths[:, None])
        outs = [o * tmask.reshape(tmask.shape + (1,) * (o.ndim - 2)).to(
            o.dtype) for o in outs]
    return {"Out": outs, "MemFinal": mems}


@register_op("recompute")
def recompute_op(ctx, ins, attrs):
    """Rematerialization segment (``layers.recompute``): the sub-block
    runs once on its externals X, and every value it produces leaves as
    Out.  The op's ``generic_grad`` re-runs it under autograd, so the
    segment's activations are recomputed in the backward instead of kept:
    the ops inside reach their own autograd paths there (flash attention's
    K4 forward and K5/K6 backward, the fused BatchNorm-convolution
    kernels).  No trip count, no data-dependent shape: a segment whose ops
    are loop-safe rides a captured step loop
    (``framework/step_loop.safety_report``)."""
    env = dict(zip(attrs["x_names"], ins.get("X", [])))
    ctx.lower_block(int(attrs["sub_block"]), env)
    return {"Out": [env[n] for n in attrs["out_names"]]}


# --- tensor arrays (dense [cap, ...] buffers) ------------------------------


def _index(i, cap):
    """The array index as a [1] int64 device tensor, clamped into
    [0, cap) as ``lax.dynamic_*_slice`` clamps it (no host read)."""
    return i.reshape(1).long().clamp(0, cap - 1)


@register_op("array_write", grad=None)
def array_write(ctx, ins, attrs):
    """Out = Array with X written at index I (a new buffer: the value
    leaves the op)."""
    arr, x, i = ins["Array"][0], ins["X"][0], ins["I"][0]
    return {"Out": [arr.index_copy(0, _index(i, arr.shape[0]),
                                   x.to(arr.dtype)[None])]}


@register_op("array_read", grad=None)
def array_read(ctx, ins, attrs):
    arr, i = ins["Array"][0], ins["I"][0]
    return {"Out": [arr.index_select(0, _index(i, arr.shape[0]))[0]]}


@register_op("create_array", grad=None)
def create_array(ctx, ins, attrs):
    """Zeros of attrs["shape"] = [cap, ...]; a -1 takes the batch size of
    Ref's dim 0."""
    shape = [int(s) for s in attrs["shape"]]
    if any(s < 0 for s in shape):
        ref = ins["Ref"][0]
        shape = [ref.shape[0] if s < 0 else s for s in shape]
    return {"Out": [torch.zeros(shape, dtype=torch_dtype(
        attrs.get("dtype", "float32")), device=ctx.device)]}
