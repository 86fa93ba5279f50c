"""Layer functions building ops into the default main program — the part
of ``paddle_tpu/layers/nn.py`` that ``decoder_lm`` builds.  They only
append descs; which ops have torch emitters is the registry's business."""

from __future__ import annotations

from typing import Optional, Sequence, Union

from ..framework.core import Variable
from ..framework.initializer import ConstantInitializer
from ..framework.layer_helper import LayerHelper
from .sequence import propagate_length


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True):
    """Declare an input: prepends batch dim -1."""
    helper = LayerHelper("data")
    full_shape = ([-1] + list(shape)) if append_batch_size else list(shape)
    return helper.block.create_var(
        name=name,
        shape=full_shape,
        dtype=dtype,
        lod_level=lod_level,
        stop_gradient=True,
        is_data=True,
    )


def _shape_prod(shape):
    p = 1
    for s in shape:
        p *= int(s)
    return p


def fc(
    input: Union[Variable, Sequence[Variable]],
    size: int,
    num_flatten_dims: int = 1,
    param_attr=None,
    bias_attr=None,
    act: Optional[str] = None,
    name=None,
):
    """Fully connected: mul per input + sum + bias + act."""
    helper = LayerHelper("fc", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    mul_results = []
    for inp in inputs:
        in_dims = inp.shape[num_flatten_dims:]
        w = helper.create_parameter(
            attr=param_attr if isinstance(param_attr, dict) else {},
            shape=[_shape_prod(in_dims), size],
            dtype=inp.dtype,
        )
        out = helper.create_tmp_variable(
            inp.dtype, shape=tuple(inp.shape[:num_flatten_dims]) + (size,)
        )
        helper.append_op(
            "mul",
            inputs={"X": [inp.name], "Y": [w.name]},
            outputs={"Out": [out.name]},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
        )
        mul_results.append(out)
    if len(mul_results) == 1:
        pre = mul_results[0]
    else:
        pre = helper.create_tmp_variable(mul_results[0].dtype,
                                         shape=mul_results[0].shape)
        helper.append_op("sum", inputs={"X": [m.name for m in mul_results]},
                         outputs={"Out": [pre.name]})
    pre = helper.append_bias_op(pre, dim_start=num_flatten_dims)
    return helper.append_activation(pre)


def embedding(input, size, is_sparse=False, padding_idx=None, param_attr=None,
              dtype="float32"):
    """Embedding → lookup_table op."""
    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(
        attr=param_attr if isinstance(param_attr, dict) else {},
        shape=list(size), dtype=dtype,
    )
    in_shape = tuple(input.shape[:-1]) if input.shape and input.shape[-1] == 1 \
        else tuple(input.shape or ())
    out = helper.create_tmp_variable(dtype, shape=in_shape + (size[1],))
    helper.append_op(
        "lookup_table",
        inputs={"W": [w.name], "Ids": [input.name]},
        outputs={"Out": [out.name]},
        attrs={"is_sparse": bool(is_sparse),
               "padding_idx": -1 if padding_idx is None else int(padding_idx)},
    )
    return out


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", act=act, name=name)
    norm_shape = [_shape_prod(input.shape[begin_norm_axis:])]
    ins = {"X": [input.name]}
    if scale:
        s = helper.create_parameter(
            attr=param_attr if isinstance(param_attr, dict) else {},
            shape=norm_shape, dtype=input.dtype,
            default_initializer=ConstantInitializer(1.0))
        ins["Scale"] = [s.name]
    if shift:
        b = helper.create_parameter(
            attr=bias_attr if isinstance(bias_attr, dict) else {},
            shape=norm_shape, dtype=input.dtype, is_bias=True)
        ins["Bias"] = [b.name]
    out = helper.create_tmp_variable(input.dtype, shape=input.shape)
    mean = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    var = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    helper.append_op(
        "layer_norm", inputs=ins,
        outputs={"Y": [out.name], "Mean": [mean.name], "Variance": [var.name]},
        attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis},
    )
    return helper.append_activation(out)


def multi_head_attention(queries, keys, values, num_heads, causal=False,
                         param_attr=None, name=None):
    """Multi-head attention over [B, T, D]: QKV and output projections are
    fc ops, the core is one scaled_dot_product_attention op."""
    helper = LayerHelper("multi_head_attention", name=name)
    D = queries.shape[-1]
    if D % num_heads:
        raise ValueError(f"hidden size {D} must divide num_heads={num_heads}")
    q = fc(queries, D, num_flatten_dims=2, param_attr=param_attr,
           bias_attr=False)
    k = fc(keys, D, num_flatten_dims=2, param_attr=param_attr,
           bias_attr=False)
    v = fc(values, D, num_flatten_dims=2, param_attr=param_attr,
           bias_attr=False)

    def split_heads(x):
        r = helper.create_tmp_variable(x.dtype)
        helper.append_op("reshape", inputs={"X": [x.name]},
                         outputs={"Out": [r.name]},
                         attrs={"shape": [0, 0, num_heads, D // num_heads]})
        t = helper.create_tmp_variable(x.dtype)
        helper.append_op("transpose", inputs={"X": [r.name]},
                         outputs={"Out": [t.name]},
                         attrs={"axis": [0, 2, 1, 3]})
        return t

    qh, kh, vh = split_heads(q), split_heads(k), split_heads(v)
    attn = helper.create_tmp_variable(queries.dtype)
    helper.append_op(
        "scaled_dot_product_attention",
        inputs={"Q": [qh.name], "K": [kh.name], "V": [vh.name]},
        outputs={"Out": [attn.name]},
        attrs={"causal": causal},
    )
    back = helper.create_tmp_variable(queries.dtype)
    helper.append_op("transpose", inputs={"X": [attn.name]},
                     outputs={"Out": [back.name]},
                     attrs={"axis": [0, 2, 1, 3]})
    merged = helper.create_tmp_variable(queries.dtype, shape=queries.shape)
    helper.append_op("reshape", inputs={"X": [back.name]},
                     outputs={"Out": [merged.name]},
                     attrs={"shape": [0, 0, D]})
    out = fc(merged, D, num_flatten_dims=2, bias_attr=False)
    return propagate_length(queries, out)
