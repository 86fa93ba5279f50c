"""fluid-compatible layer entry points, from
``paddle_tpu/layers/fluid_compat.py``: conv2d_transpose, split,
create_parameter, fill_constant_batch_size_like, ones, zeros and the
dense tensor arrays (create_array, array_write, array_read)."""

from __future__ import annotations

from ..framework.layer_helper import LayerHelper
from . import tensor as _tensor


def _pair(v):
    return [int(v)] * 2 if not isinstance(v, (list, tuple)) \
        else [int(x) for x in v]


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=None, stride=None, dilation=None,
                     param_attr=None, name=None):
    """A conv2d_transpose op on an NCHW input, filter [C_in, C_out, kh,
    kw]; without `filter_size`, the size that makes `output_size`."""
    helper = LayerHelper("conv2d_transpose", param_attr=param_attr,
                         name=name)
    C = int(input.shape[1])
    stride = stride or 1
    padding = padding if padding is not None else 0
    dilation = dilation or 1
    st, pd, dl = _pair(stride), _pair(padding), _pair(dilation)
    if filter_size is None:
        if output_size is None:
            raise ValueError("conv2d_transpose needs filter_size or "
                             "output_size")
        os = _pair(output_size)
        H, W = int(input.shape[2]), int(input.shape[3])
        filter_size = [
            (os[i] - (([H, W][i] - 1) * st[i] - 2 * pd[i] + 1)) // dl[i] + 1
            for i in range(2)]
    ks = _pair(filter_size)
    w = helper.create_parameter(
        attr=param_attr if isinstance(param_attr, dict) else {},
        shape=[C, int(num_filters)] + ks, dtype=input.dtype)
    shape = None
    if input.shape is not None:

        def _od(i, idx):
            # an unknown dim (-1) stays unknown
            if i is None or int(i) < 0:
                return -1
            return (int(i) - 1) * st[idx] - 2 * pd[idx] \
                + dl[idx] * (ks[idx] - 1) + 1

        shape = (input.shape[0], int(num_filters),
                 _od(input.shape[2], 0), _od(input.shape[3], 1))
    out = helper.create_tmp_variable(input.dtype, shape=shape)
    helper.append_op(
        "conv2d_transpose",
        inputs={"Input": [input.name], "Filter": [w.name]},
        outputs={"Output": [out.name]},
        attrs={"strides": st, "paddings": pd, "dilations": dl})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    """A split op into `num_or_sections` equal parts, or parts of these
    lengths; returns the list of parts."""
    helper = LayerHelper("split", name=name)
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "axis": int(dim)}
    else:
        n = len(num_or_sections)
        attrs = {"sections": [int(s) for s in num_or_sections],
                 "axis": int(dim)}
    outs = [helper.create_tmp_variable(input.dtype, shape=None)
            for _ in range(n)]
    helper.append_op("split", inputs={"X": [input.name]},
                     outputs={"Out": [o.name for o in outs]}, attrs=attrs)
    return outs


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


def ones(shape, dtype, **kwargs):
    return _tensor.fill_constant(shape=shape, dtype=dtype, value=1.0)


def zeros(shape, dtype, **kwargs):
    return _tensor.fill_constant(shape=shape, dtype=dtype, value=0.0)


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
