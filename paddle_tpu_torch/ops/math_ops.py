"""Math ops, the port of the part of ``paddle_tpu/ops/math_ops.py`` that
the models, the regularizers, the gradient clips and the learning-rate
schedules use: elementwise_add/sub/mul/div/pow/max/min with the
reference's ``axis`` broadcast (y's shape aligns to x starting at `axis`,
default -1 = trailing alignment), the flattening matmul ``mul``, the
batched ``matmul``, ``sum``, ``mean``, the reduce family
(``reduce_sum/mean/max/min/prod``, one emitter), ``scale``, ``sign``,
``clip``, ``cos_sim``, ``clip_by_norm`` and ``squared_l2_norm``.  The
GEMMs go to ``torch.matmul`` (cuBLAS on the card), as the JAX package
leaves them to XLA.

Dtypes follow the JAX ops: a bf16 gradient times an f32 ``[1]`` scale is
f32, ``squared_l2_norm`` sums in its input's dtype, and ``maximum`` and
``minimum`` split the gradient at a tie, as ``jnp.maximum`` does.
``clip_by_norm`` chooses with ``torch.where``, on the device."""

from __future__ import annotations

import math

import torch

from .activation_ops import jclip
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
    ("elementwise_pow", torch.pow),
    ("elementwise_max", torch.maximum),
    ("elementwise_min", torch.minimum),
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


@register_op("matmul")
def matmul(ctx, ins, attrs):
    """``jnp.matmul`` (batched, broadcast) after the optional swap of each
    operand's last two axes, times ``alpha``."""
    x, y = ins["X"][0], ins["Y"][0]
    if attrs.get("transpose_X") and x.ndim > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y") and y.ndim > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": [out]}


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


def _prod_dims(x, dims, keep):
    """``jnp.prod`` over several axes: ``torch.prod`` takes one at a time
    (highest first, so the lower indices stay put)."""
    for d in sorted((d % x.ndim for d in dims), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keep)
    return x


# the reduce family, each ``fn(x, dims, keep)`` over a non-empty tuple of
# axes; ``amax``/``amin`` split the gradient among ties, as jnp.max does
_REDUCES = {
    "reduce_sum": lambda x, d, k: torch.sum(x, dim=d, keepdim=k),
    "reduce_mean": lambda x, d, k: torch.mean(x, dim=d, keepdim=k),
    "reduce_max": lambda x, d, k: torch.amax(x, dim=d, keepdim=k),
    "reduce_min": lambda x, d, k: torch.amin(x, dim=d, keepdim=k),
    "reduce_prod": _prod_dims,
}


def _reduce(fn):
    def emit(ctx, ins, attrs):
        """Reduce over `dim` (an int or a list; None or ``reduce_all``:
        every axis, to rank-1 [1] as reference reduce_op.cc makes it)."""
        x = ins["X"][0]
        dim = attrs.get("dim", None)
        keep = bool(attrs.get("keep_dim", False))
        if attrs.get("reduce_all", False) or dim is None:
            out = fn(x, tuple(range(x.ndim)), keep)
            return {"Out": [out if keep else out.reshape(1)]}
        dims = [int(d) for d in dim] if isinstance(dim, (list, tuple)) \
            else [int(dim)]
        # no axes reduces nothing, as jnp's axis=() (torch's dim=() would
        # reduce them all)
        return {"Out": [fn(x, tuple(dims), keep) if dims else x]}

    return emit


for _name, _fn in _REDUCES.items():
    register_op(_name, _reduce(_fn))


@register_op("scale")
def scale(ctx, ins, attrs):
    s = attrs.get("scale", 1.0)
    b = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return {"Out": [ins["X"][0] * s + b]}
    return {"Out": [(ins["X"][0] + b) * s]}


@register_op("sign")
def sign(ctx, ins, attrs):
    return {"Out": [torch.sign(ins["X"][0])]}


@register_op("clip")
def clip(ctx, ins, attrs):
    return {"Out": [jclip(ins["X"][0], attrs["min"], attrs["max"])]}


@register_op("cos_sim")
def cos_sim(ctx, ins, attrs):
    """Row-wise cosine similarity of X and Y [N, D] (Y may be one row,
    broadcast) → Out [N, 1], with the norms XNorm and YNorm."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    yn = torch.sqrt(torch.sum(y * y, dim=1, keepdim=True))
    out = torch.sum(x * y, dim=1, keepdim=True) / (xn * yn + 1e-12)
    return {"Out": [out], "XNorm": [xn], "YNorm": [yn]}


@register_op("clip_by_norm")
def clip_by_norm(ctx, ins, attrs):
    x = ins["X"][0]
    mn = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(x * x))
    return {"Out": [torch.where(norm > mn, x * (mn / norm), x)]}


@register_op("squared_l2_norm")
def squared_l2_norm(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [torch.sum(x * x).reshape(1)]}
