"""Tensor-building layer functions, the port of
``paddle_tpu/layers/tensor.py``: fill_constant, assign, cast, concat,
sums, reshape, transpose, scale, the elementwise add, sub, mul and div,
and the reductions reduce_sum, reduce_mean, reduce_max and reduce_min."""

from __future__ import annotations

from ..framework.layer_helper import LayerHelper


def fill_constant(shape, dtype, value, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_tmp_variable(dtype, shape=tuple(shape),
                                         stop_gradient=True)
    helper.append_op(
        "fill_constant", outputs={"Out": [out.name]},
        attrs={"shape": list(shape), "dtype": dtype, "value": value},
    )
    return out


def assign(input, output=None):
    helper = LayerHelper("assign")
    if output is None:
        output = helper.create_tmp_variable(input.dtype, shape=input.shape)
    helper.append_op("assign", inputs={"X": [input.name]},
                     outputs={"Out": [output.name]})
    return output


def cast(x, dtype):
    helper = LayerHelper("cast")
    out = helper.create_tmp_variable(dtype, shape=x.shape)
    helper.append_op("cast", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"out_dtype": dtype})
    return out


def concat(input, axis=0):
    helper = LayerHelper("concat")
    shape = list(input[0].shape)
    shape[axis] = sum(i.shape[axis] for i in input) if all(
        i.shape and i.shape[axis] > 0 for i in input) else -1
    out = helper.create_tmp_variable(input[0].dtype, shape=tuple(shape))
    helper.append_op("concat", inputs={"X": [i.name for i in input]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    return out


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_tmp_variable(input[0].dtype, shape=input[0].shape)
    helper.append_op("sum", inputs={"X": [i.name for i in input]},
                     outputs={"Out": [out.name]})
    return out


def reshape(x, shape, name=None):
    helper = LayerHelper("reshape", name=name)
    out = helper.create_tmp_variable(x.dtype, shape=tuple(shape))
    helper.append_op("reshape", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"shape": list(shape)})
    return out


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", name=name)
    out = helper.create_tmp_variable(
        x.dtype, shape=tuple(x.shape[p] for p in perm) if x.shape else None)
    helper.append_op("transpose", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": list(perm)})
    return out


def scale(x, scale=1.0, bias=0.0, name=None):
    helper = LayerHelper("scale", name=name)
    out = helper.create_tmp_variable(x.dtype, shape=x.shape)
    helper.append_op("scale", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"scale": scale, "bias": bias})
    return out


def elementwise_op(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, act=act, name=name)
    out = helper.create_tmp_variable(x.dtype, shape=x.shape)
    helper.append_op(op_type, inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    return helper.append_activation(out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_add", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_mul", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_sub", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_div", x, y, axis, act, name)


def _reduce_layer(op_type, x, dim=None, keep_dim=False, name=None):
    """One reduce op over `dim` (None: every axis, to [1], or all-ones
    with `keep_dim`); the declared shape drops or keeps the reduced
    axes."""
    helper = LayerHelper(op_type, name=name)
    if x.shape is None:
        oshape = None
    elif dim is None:
        oshape = tuple(1 for _ in x.shape) if keep_dim else (1,)
    else:
        dims = [dim] if isinstance(dim, int) else list(dim)
        dims = [d % len(x.shape) for d in dims]
        oshape = tuple(
            (1 if keep_dim else None) if i in dims else s
            for i, s in enumerate(x.shape))
        oshape = tuple(s for s in oshape if s is not None) or (1,)
    out = helper.create_tmp_variable(x.dtype, shape=oshape)
    helper.append_op(op_type, inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"dim": dim, "keep_dim": keep_dim,
                            "reduce_all": dim is None})
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_sum", input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_mean", input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_max", input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_min", input, dim, keep_dim, name)
