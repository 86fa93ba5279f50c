"""Desc-level autodiff: ``append_backward``, the port of
``paddle_tpu/framework/backward.py``.

Walks the block's ops in reverse from the loss, asks each op's grad maker
for grad op descs, accumulates duplicate gradients with `sum` ops, and
appends the grad ops to the same block.  The program this builds is the
JAX package's op for op; each grad op's computation comes from the port's
registry (``generic_grad``: autograd over a re-run of the forward
emitter).  Where a variable's gradient materializes, a variable marked
``print_gradient`` gets a ``print`` of it and one with an ``error_clip``
(``clip.ErrorClipByValue``) gets its clip, before any upstream grad op
reads it.  ``calc_gradient`` backpropagates arbitrary targets to
arbitrary inputs through a surrogate sum.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from ..ops.registry import default_grad_maker, get_op_info
from . import unique_name
from .core import GRAD_SUFFIX, Parameter, Variable, grad_var_name


def _compute_requires_grad(block, no_grad_set: Set[str],
                           extra_sources: Optional[Set[str]] = None
                           ) -> Set[str]:
    """Forward taint pass: a var requires grad iff it is a trainable Parameter
    (or an un-stopped feed) or an output of an op with a requiring-grad
    input, minus stop_gradient / no_grad vars.  `extra_sources` adds taint
    roots (calc_gradient's inputs that are neither Parameters nor
    feeds)."""
    req: Set[str] = set(extra_sources or ())
    for v in block.vars.values():
        if isinstance(v, Parameter) and v.trainable and v.name not in no_grad_set:
            req.add(v.name)
        elif v.is_data and not v.stop_gradient and v.name not in no_grad_set:
            req.add(v.name)
    for op in block.ops:
        info = get_op_info(op.type)
        if info.grad is None:
            continue
        if any(n in req for n in op.input_names()):
            for n in op.output_names():
                if not n:
                    continue
                v = block._find_var_recursive(n)
                if v is not None and v.stop_gradient:
                    continue
                if n in no_grad_set:
                    continue
                req.add(n)
    return req


def _ensure_grad_var(block, primal_name: str, grad_name: str):
    if grad_name in block.vars:
        return block.vars[grad_name]
    primal = block._find_var_recursive(primal_name)
    return block.create_var(
        name=grad_name,
        shape=primal.shape if primal is not None else None,
        dtype=primal.dtype if primal is not None else "float32",
        stop_gradient=True,
    )


def append_backward(
    loss: Variable,
    parameter_list: Optional[List[str]] = None,
    no_grad_set: Optional[Set[str]] = None,
    callbacks=None,
    extra_sources: Optional[Set[str]] = None,
):
    """Append grad ops for `loss` to its block; returns [(param, grad_var)].
    Each of `callbacks` is called as ``cb(block, {"grad_names": [...]})``
    once the gradients have materialized (``clip.error_clip_callback``).
    `extra_sources`: more var names to take gradients to
    (calc_gradient's inputs); their grads are materialized too."""
    block = loss.block
    no_grad = set(no_grad_set or ())
    for v in block.vars.values():
        if v.stop_gradient:
            no_grad.add(v.name)
    no_grad -= set(extra_sources or ())

    requires_grad = _compute_requires_grad(block, no_grad,
                                           extra_sources=extra_sources)
    if loss.name not in requires_grad:
        raise ValueError(
            f"loss {loss.name!r} does not depend on any trainable parameter"
        )

    fwd_ops = list(block.ops)
    # seed d(loss)/d(loss) = 1
    loss_grad = grad_var_name(loss.name)
    _ensure_grad_var(block, loss.name, loss_grad)
    block.append_op(
        "fill_constant",
        outputs={"Out": [loss_grad]},
        attrs={
            "shape": list(loss.shape or (1,)),
            "value": 1.0,
            "dtype": loss.dtype,
        },
    )

    # pending grads per primal var (names of partial grads to be summed)
    pending: Dict[str, List[str]] = {loss.name: [loss_grad]}
    finalized: Set[str] = {loss.name}

    def finalize(name: str) -> Optional[str]:
        """Materialize the accumulated gradient of `name` as <name>@GRAD."""
        parts = pending.get(name)
        if not parts:
            return None
        gname = grad_var_name(name)
        if name in finalized:
            return gname
        if len(parts) == 1:
            if parts[0] != gname:
                _ensure_grad_var(block, name, gname)
                block.append_op(
                    "assign", inputs={"X": [parts[0]]}, outputs={"Out": [gname]}
                )
        else:
            _ensure_grad_var(block, name, gname)
            block.append_op(
                "sum", inputs={"X": list(parts)}, outputs={"Out": [gname]}
            )
        finalized.add(name)
        v = block._find_var_recursive(name)
        if v is not None and getattr(v, "print_gradient", False):
            block.append_op(
                "print", inputs={"X": [gname]}, outputs={"Out": [gname]},
                attrs={"message": f"{gname}: "})
        ec = getattr(v, "error_clip", None) if v is not None else None
        if ec is not None:
            ec.append_clip_op(block, gname)
            v._error_clip_applied = True
        return gname

    def record(name: str, grad_name: str):
        pending.setdefault(name, []).append(grad_name)

    for op in reversed(fwd_ops):
        info = get_op_info(op.type)
        if info.grad is None:
            continue
        has_out_grad = any(
            n in pending for n in op.output_names() if n
        )
        needs_in_grad = any(
            n in requires_grad and n not in no_grad
            for n in op.input_names()
            if n
        )
        if not has_out_grad or not needs_in_grad:
            continue

        # materialize cotangents for this op's outputs
        for n in op.output_names():
            if n and n in pending:
                finalize(n)

        wanted = {n for n in op.input_names() if n in requires_grad and n not in no_grad}
        for gtype, gins, gouts, gattrs in default_grad_maker(op, wanted):
            # rewrite grad-op *outputs* that collide with already-recorded
            # grads: record partials under fresh names, sum lazily
            new_outs = {}
            for slot, names in gouts.items():
                rewritten = []
                for n in names:
                    if not n:
                        rewritten.append("")
                        continue
                    primal = n[: -len(GRAD_SUFFIX)]
                    if primal in pending:
                        n = unique_name.generate(n + "@RENAME")
                    _ensure_grad_var(block, primal, n)
                    record(primal, n)
                    rewritten.append(n)
                new_outs[slot] = rewritten
            # grad-op *inputs* that reference missing out-grads: leave "" —
            # the generic emitter gives them zero cotangents
            new_ins = {}
            for slot, names in gins.items():
                if slot.endswith(GRAD_SUFFIX):
                    new_ins[slot] = [
                        n if (n[: -len(GRAD_SUFFIX)] in finalized) else ""
                        for n in names
                    ]
                else:
                    new_ins[slot] = list(names)
            block.append_op(gtype, inputs=new_ins, outputs=new_outs, attrs=gattrs)

    # finalize parameter grads
    params = (
        [block.var(p) if isinstance(p, str) else p for p in parameter_list]
        if parameter_list
        else block.all_parameters()
    )
    result = []
    for p in params:
        if not getattr(p, "trainable", True):
            continue
        g = finalize(p.name)
        if g is not None:
            result.append((p, block.var(g)))
    # materialize grads of un-stopped feeds so they are fetchable
    feed_grads = 0
    for v in list(block.vars.values()):
        if v.is_data and not v.stop_gradient:
            if finalize(v.name) is not None:
                feed_grads += 1
    for name in (extra_sources or ()):
        if finalize(name) is not None:
            feed_grads += 1
    if not result and not feed_grads:
        raise ValueError("append_backward produced no parameter gradients")
    if callbacks:
        grad_names = [grad_var_name(p.name) for p, _ in result]
        grad_names += [grad_var_name(v.name) for v in block.vars.values()
                       if v.is_data and not v.stop_gradient
                       and grad_var_name(v.name) in block.vars]
        for cb in callbacks:
            cb(block, {"grad_names": grad_names})
    return result


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """Backpropagate targets' gradients to inputs (reference fluid
    backward.py:463).

    Built as the surrogate scalar sum_i <target_i, seed_i> (``elementwise_mul``,
    ``reduce_sum``, ``sum``), whose backward seeds each target with seed_i
    (ones when `target_gradients` is None): d(sum <t, s>)/dx = J^T s, the
    requested vector-Jacobian product.  The inputs are un-stopped for the
    pass and their ``stop_gradient`` restored after it.  Returns one grad
    Variable per input, None where the input does not reach the
    targets."""
    targets = list(targets) if isinstance(targets, (list, tuple)) \
        else [targets]
    inputs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    if target_gradients is None:
        seeds = [None] * len(targets)
    else:
        seeds = (list(target_gradients)
                 if isinstance(target_gradients, (list, tuple))
                 else [target_gradients])
    if len(seeds) != len(targets):
        raise ValueError("Should have the same number of target_gradients "
                         "as targets")
    block = targets[0].block

    def tmp(dtype):
        return block.create_var(name=unique_name.generate("calc_grad"),
                                shape=None, dtype=dtype,
                                stop_gradient=False)

    parts = []
    for t, s in zip(targets, seeds):
        v = t
        if s is not None:
            m = tmp(t.dtype)
            block.append_op("elementwise_mul",
                            inputs={"X": [t.name], "Y": [s.name]},
                            outputs={"Out": [m.name]})
            v = m
        r = tmp(t.dtype)
        block.append_op("reduce_sum", inputs={"X": [v.name]},
                        outputs={"Out": [r.name]},
                        attrs={"dim": None, "keep_dim": False})
        parts.append(r)
    if len(parts) == 1:
        total = parts[0]
    else:
        total = tmp(targets[0].dtype)
        block.append_op("sum", inputs={"X": [p.name for p in parts]},
                        outputs={"Out": [total.name]})
    total.shape = (1,)
    # a later minimize() on this program must not inherit the inputs as
    # gradient sources: restore their stop_gradient
    prior = [(iv, iv.stop_gradient) for iv in inputs]
    for iv in inputs:
        iv.stop_gradient = False
    try:
        append_backward(total, no_grad_set=no_grad_set,
                        extra_sources={iv.name for iv in inputs})
    finally:
        for iv, flag in prior:
            iv.stop_gradient = flag
    return [block.vars.get(grad_var_name(iv.name)) for iv in inputs]
