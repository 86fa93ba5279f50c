"""fluid-compatible layer entry points, from
``paddle_tpu/layers/fluid_compat.py``: create_parameter,
fill_constant_batch_size_like and the dense tensor arrays
(create_array, array_write, array_read)."""

from __future__ import annotations

from ..framework.layer_helper import LayerHelper


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper("create_parameter")
    attr = dict(attr or {})
    if name:
        attr.setdefault("name", name)
    return helper.create_parameter(attr=attr, shape=list(shape), dtype=dtype,
                                   is_bias=is_bias,
                                   default_initializer=default_initializer)


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_tmp_variable(dtype, shape=tuple(shape),
                                     stop_gradient=True)
    helper.append_op("fill_constant_batch_size_like",
                     inputs={"Input": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "value": float(value),
                            "input_dim_idx": int(input_dim_idx),
                            "output_dim_idx": int(output_dim_idx)})
    return out


def create_array(dtype, cap, elem_shape, ref=None):
    """A tensor array as a dense [cap, ...] buffer of zeros (the
    static-shape reading of LoDTensorArray).  A -1 in elem_shape is the
    batch dim, taken from `ref`'s dim 0 at run time."""
    helper = LayerHelper("create_array")
    out = helper.create_tmp_variable(dtype, shape=None, stop_gradient=True)
    shape = [int(cap)] + [int(s) for s in elem_shape]
    inputs = {}
    if any(s < 0 for s in shape[1:]):
        if ref is None:
            raise ValueError("create_array: elem_shape has a batch (-1) dim "
                             "-> pass ref= (a var whose dim 0 is the batch)")
        inputs["Ref"] = [ref.name]
    helper.append_op("create_array", inputs=inputs,
                     outputs={"Out": [out.name]},
                     attrs={"shape": shape, "dtype": dtype})
    return out


def array_write(x, i, array):
    helper = LayerHelper("array_write")
    out = helper.create_tmp_variable(x.dtype, shape=None, stop_gradient=True)
    helper.append_op("array_write",
                     inputs={"Array": [array.name], "X": [x.name],
                             "I": [i.name]},
                     outputs={"Out": [out.name]})
    return out


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_tmp_variable(array.dtype, shape=None,
                                     stop_gradient=True)
    helper.append_op("array_read",
                     inputs={"Array": [array.name], "I": [i.name]},
                     outputs={"Out": [out.name]})
    return out
