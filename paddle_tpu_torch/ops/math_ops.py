"""Math ops, the port of the part of ``paddle_tpu/ops/math_ops.py`` that
the LM tower and its backward use: elementwise_add/sub/mul/div with the
reference's ``axis`` broadcast (y's shape aligns to x starting at `axis`,
default -1 = trailing alignment), the flattening matmul ``mul``, ``sum``
and ``mean``.  The GEMMs go to ``torch.matmul`` (cuBLAS on the card), as
the JAX package leaves them to XLA."""

from __future__ import annotations

import math

import torch

from .registry import register_op


def _broadcast_y(x, y, axis):
    if y.ndim >= x.ndim:
        # equal rank, or X the smaller operand: plain trailing broadcast
        return y
    if axis == -1 or axis is None:
        axis = x.ndim - y.ndim
    axis = int(axis)
    shape = [1] * x.ndim
    for i in range(y.ndim):
        shape[axis + i] = y.shape[i]
    return y.reshape(shape)


def _ew(fn):
    def emit(ctx, ins, attrs):
        x, y = ins["X"][0], ins["Y"][0]
        y = _broadcast_y(x, y, attrs.get("axis", -1))
        return {"Out": [fn(x, y)]}

    return emit


for _name, _fn in [
    ("elementwise_add", torch.add),
    ("elementwise_sub", torch.sub),
    ("elementwise_mul", torch.mul),
    ("elementwise_div", torch.div),
]:
    register_op(_name, _ew(_fn))


@register_op("mul")
def mul(ctx, ins, attrs):
    """Flattening matmul: X flattened to 2-D at x_num_col_dims, Y at
    y_num_col_dims."""
    x, y = ins["X"][0], ins["Y"][0]
    xnc = int(attrs.get("x_num_col_dims", 1))
    ync = int(attrs.get("y_num_col_dims", 1))
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(-1, math.prod(xs[xnc:]))
    y2 = y.reshape(math.prod(ys[:ync]), -1)
    return {"Out": [torch.matmul(x2, y2).reshape(xs[:xnc] + ys[ync:])]}


@register_op("sum")
def sum_op(ctx, ins, attrs):
    xs = [x for x in ins["X"] if x is not None]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


@register_op("mean")
def mean(ctx, ins, attrs):
    return {"Out": [ins["X"][0].mean().reshape(1)]}
