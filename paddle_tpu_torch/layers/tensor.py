"""Tensor-building layer functions, the part of
``paddle_tpu/layers/tensor.py`` that the ported models build:
fill_constant, assign, cast, concat, reshape, transpose, scale,
elementwise_add and elementwise_mul."""

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
