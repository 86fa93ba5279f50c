"""Math ops, the port of the part of ``paddle_tpu/ops/math_ops.py`` that
the models, the regularizers, the gradient clips and the learning-rate
schedules use: elementwise_add/sub/mul/div/pow/max/min with the
reference's ``axis`` broadcast (y's shape aligns to x starting at `axis`,
default -1 = trailing alignment), the flattening matmul ``mul``, the
batched ``matmul``, ``sum``, ``mean``, the reduce family
(``reduce_sum/mean/max/min/prod``, one emitter), ``scale``, ``sign``,
``clip``, ``cos_sim``, ``clip_by_norm``, ``squared_l2_norm``, and the
v1 layers' ``minus``, ``norm``, ``l1_norm`` and ``squared_l2_distance``.  The
GEMMs go to ``torch.matmul`` (cuBLAS on the card), as the JAX package
leaves them to XLA.

Dtypes follow the JAX ops: a bf16 gradient times an f32 ``[1]`` scale is
f32, ``squared_l2_norm`` sums in its input's dtype, and ``maximum`` and
``minimum`` split the gradient at a tie, as ``jnp.maximum`` does.
``clip_by_norm`` chooses with ``torch.where``, on the device."""

from __future__ import annotations

import math

import torch

from .activation_ops import _Abs, jclip
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

@register_op("minus")
def minus(ctx, ins, attrs):
    return {"Out": [ins["X"][0] - ins["Y"][0]]}


@register_op("norm")
def norm(ctx, ins, attrs):
    """L2-normalize along `axis`: Out = X / Norm, Norm = sqrt(sum X² +
    epsilon) kept on that axis; an optional Scale multiplies each slice
    along it (the SSD normalize layer)."""
    x = ins["X"][0]
    axis = int(attrs.get("axis", 1)) % x.ndim
    eps = float(attrs.get("epsilon", 1e-10))
    n = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True) + eps)
    out = x / n
    if ins.get("Scale") and ins["Scale"][0] is not None:
        out = out * ins["Scale"][0].reshape(
            [-1 if i == axis else 1 for i in range(x.ndim)])
    return {"Out": [out], "Norm": [n]}


@register_op("l1_norm")
def l1_norm(ctx, ins, attrs):
    """sum |X| as [1]; the gradient is +1 at 0, as ``jnp.abs``'s."""
    return {"Out": [torch.sum(_Abs.apply(ins["X"][0])).reshape(1)]}


@register_op("squared_l2_distance")
def squared_l2_distance(ctx, ins, attrs):
    """Row-wise sum of (X − Y)² as [N, 1], and X − Y as sub_result."""
    d = ins["X"][0] - ins["Y"][0]
    sub = d.reshape(d.shape[0], -1)
    return {"Out": [torch.sum(sub * sub, dim=1, keepdim=True)],
            "sub_result": [d]}

# analytic cost formulas (analysis/cost.py; mechanism in registry.py)

from .registry import register_cost  # noqa: E402


def _mul_cost(ins, outs, attrs):
    """2*M*K*N for the flattening matmul: X 2-D at x_num_col_dims, Y at
    y_num_col_dims — the MXU op every fc/attention projection lowers to."""
    x = ins.get("X", [None])[0]
    y = ins.get("Y", [None])[0]
    if x is None or y is None:
        return {}
    xnc = int(attrs.get("x_num_col_dims", 1))
    ync = int(attrs.get("y_num_col_dims", 1))
    m = k = n = 1
    for s in x.shape[:xnc]:
        m *= s
    for s in x.shape[xnc:]:
        k *= s
    for s in y.shape[ync:]:
        n *= s
    return {"flops": 2 * m * k * n}


register_cost("mul", _mul_cost)


def _matmul_cost(ins, outs, attrs):
    """2 * out_elements * K; K is x's contraction dim after transpose."""
    x = ins.get("X", [None])[0]
    out = outs.get("Out", [None])[0]
    if x is None or out is None or len(x.shape) < 1:
        return {}
    if len(x.shape) == 1:
        k = x.shape[0]
    else:
        k = x.shape[-2] if attrs.get("transpose_X") else x.shape[-1]
    return {"flops": 2 * out.size * k}


register_cost("matmul", _matmul_cost)

# ---------------------------------------------------------------------------
# sharding-propagation rule (analysis/sharding.py; mechanism in registry),
# as the JAX package's

from .registry import register_sharding  # noqa: E402


def _mul_sharding(ctx, ins, outs, attrs):
    """The flattening matmul's propagation: out rows inherit X's batch
    lead, out cols inherit Y's output-dim entry; the shared
    `ctx.matmul` helper prices the contraction (partial-sum all-reduce
    on a free sharded axis, param all-gather on the FSDP collision)."""
    x = ins.get("X", [None])[0]
    y = ins.get("Y", [None])[0]
    out = outs.get("Out", [None])[0]
    if x is None or y is None or out is None:
        return {}
    lead, n = ctx.matmul(x, y, out.name)
    ndim = len(out.shape)
    if ndim >= 2:
        spec = (lead,) + (None,) * (ndim - 2) + (n,)
    else:
        spec = (lead,) if ndim else ()
    return {"Out": [spec]}


register_sharding("mul", _mul_sharding)


def _matmul_sharding(ctx, ins, outs, attrs):
    x = ins.get("X", [None])[0]
    y = ins.get("Y", [None])[0]
    out = outs.get("Out", [None])[0]
    if x is None or y is None or out is None:
        return {}
    if len(y.shape) == 2:
        lead, n = ctx.matmul(x, y, out.name,
                             w_contract_dim=1 if attrs.get("transpose_Y")
                             else 0)
        ndim = len(out.shape)
        spec = ((lead,) + (None,) * (ndim - 2) + (n,)) if ndim >= 2 \
            else ((lead,) if ndim else ())
        return {"Out": [spec]}
    # batched matmul: rows follow X, cols follow Y's last entry
    ndim = len(out.shape)
    spec = list(x.spec[:ndim]) + [None] * max(0, ndim - len(x.spec))
    if ndim >= 1 and y.spec:
        spec[-1] = y.spec[-1]
    return {"Out": [tuple(spec)]}


register_sharding("matmul", _matmul_sharding)
