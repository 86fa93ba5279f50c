"""Layer functions building ops into the default main program — the part
of ``paddle_tpu/layers/nn.py`` that ``decoder_lm``, ``lm_loss``, ResNet,
the model zoo and the book's fit_a_line and recognize_digits build.
They only append descs; which ops have torch emitters is the registry's
business."""

from __future__ import annotations

from typing import Optional, Sequence, Union

from ..framework.core import Variable
from ..framework.initializer import ConstantInitializer, NormalInitializer
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
                         param_attr=None, name=None, sp_mode="ring",
                         sp_schedule="plain"):
    """Multi-head attention over [B, T, D]: QKV and output projections are
    fc ops, the core is one scaled_dot_product_attention op.  `sp_mode`
    and `sp_schedule` are recorded on the op for a sequence-parallel mesh;
    on one device they have no effect."""
    helper = LayerHelper("multi_head_attention", name=name)
    if sp_mode not in ("ring", "alltoall"):
        raise ValueError(f"sp_mode {sp_mode!r}: use 'ring' or 'alltoall'")
    if sp_schedule not in ("plain", "zigzag"):
        raise ValueError(
            f"sp_schedule {sp_schedule!r}: use 'plain' or 'zigzag'")
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
        attrs={"causal": causal, "sp_mode": sp_mode,
               "sp_schedule": sp_schedule},
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


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    minus_out = helper.create_tmp_variable(input.dtype, shape=input.shape)
    helper.append_op("elementwise_sub",
                     inputs={"X": [input.name], "Y": [label.name]},
                     outputs={"Out": [minus_out.name]}, attrs={"axis": -1})
    sq = helper.create_tmp_variable(input.dtype, shape=input.shape)
    helper.append_op("square", inputs={"X": [minus_out.name]},
                     outputs={"Out": [sq.name]})
    return sq


def cross_entropy(input, label, soft_label=False):
    helper = LayerHelper("cross_entropy")
    out = helper.create_tmp_variable(
        input.dtype, shape=tuple(input.shape[:-1]) + (1,))
    helper.append_op(
        "cross_entropy",
        inputs={"X": [input.name], "Label": [label.name]},
        outputs={"Y": [out.name]},
        attrs={"soft_label": soft_label},
    )
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax = helper.create_tmp_variable(logits.dtype, shape=logits.shape)
    loss = helper.create_tmp_variable(
        logits.dtype, shape=tuple(logits.shape[:-1]) + (1,))
    helper.append_op(
        "softmax_with_cross_entropy",
        inputs={"Logits": [logits.name], "Label": [label.name]},
        outputs={"Loss": [loss.name], "Softmax": [softmax.name]},
        attrs={"soft_label": soft_label},
    )
    return loss


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_tmp_variable(x.dtype, shape=(1,))
    helper.append_op("mean", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]})
    return out


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None, name=None,
           data_format="NCHW"):
    """A conv2d op with an OIHW filter drawn from N(0, sqrt(2 / fan_in)),
    then the optional bias (an elementwise_add on the channel axis) and
    activation."""
    helper = LayerHelper("conv2d", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    nhwc = data_format == "NHWC"
    num_channels = input.shape[3] if nhwc else input.shape[1]
    fs = filter_size if isinstance(filter_size, (list, tuple)) else (
        filter_size, filter_size)
    stride = stride if isinstance(stride, (list, tuple)) else (stride, stride)
    padding = padding if isinstance(padding, (list, tuple)) else (
        padding, padding)
    dilation = dilation if isinstance(dilation, (list, tuple)) else (
        dilation, dilation)
    w = helper.create_parameter(
        attr=param_attr if isinstance(param_attr, dict) else {},
        shape=[num_filters, num_channels // groups, fs[0], fs[1]],
        dtype=input.dtype,
        default_initializer=NormalInitializer(
            0.0, (2.0 / (fs[0] * fs[1] * num_channels)) ** 0.5),
    )

    def _od(i, k, s, p, d):
        if i is None or i < 0:
            return -1
        ke = d * (k - 1) + 1
        return (i + 2 * p - ke) // s + 1

    h_ax, w_ax = (1, 2) if nhwc else (2, 3)
    oh = _od(input.shape[h_ax], fs[0], stride[0], padding[0], dilation[0])
    ow = _od(input.shape[w_ax], fs[1], stride[1], padding[1], dilation[1])
    oshape = ((input.shape[0], oh, ow, num_filters) if nhwc
              else (input.shape[0], num_filters, oh, ow))
    out = helper.create_tmp_variable(input.dtype, shape=oshape)
    helper.append_op(
        "conv2d",
        inputs={"Input": [input.name], "Filter": [w.name]},
        outputs={"Output": [out.name]},
        attrs={"strides": list(stride), "paddings": list(padding),
               "dilations": list(dilation), "groups": groups,
               "data_format": data_format},
    )
    if bias_attr is not False:
        b = helper.create_parameter(
            attr=bias_attr if isinstance(bias_attr, dict) else {},
            shape=[num_filters], dtype=input.dtype, is_bias=True)
        tmp = helper.create_tmp_variable(out.dtype, shape=out.shape)
        helper.append_op(
            "elementwise_add",
            inputs={"X": [out.name], "Y": [b.name]},
            outputs={"Out": [tmp.name]},
            attrs={"axis": 3 if nhwc else 1},
        )
        out = tmp
    return helper.append_activation(out)


def pool2d(input, pool_size=2, pool_type="max", pool_stride=None,
           pool_padding=0, global_pooling=False, ceil_mode=False, name=None,
           data_format="NCHW"):
    helper = LayerHelper("pool2d", name=name)
    nhwc = data_format == "NHWC"
    ps = pool_size if isinstance(pool_size, (list, tuple)) else (
        pool_size, pool_size)
    st = pool_stride or ps
    st = st if isinstance(st, (list, tuple)) else (st, st)
    pd = pool_padding if isinstance(pool_padding, (list, tuple)) else (
        pool_padding, pool_padding)

    def _od(i, k, s, p):
        if i is None or i < 0:
            return -1
        return (i + 2 * p - k) // s + 1

    h_ax, w_ax = (1, 2) if nhwc else (2, 3)
    if global_pooling:
        oh = ow = 1
    else:
        oh = _od(input.shape[h_ax], ps[0], st[0], pd[0])
        ow = _od(input.shape[w_ax], ps[1], st[1], pd[1])
    ch = input.shape[3] if nhwc else input.shape[1]
    oshape = ((input.shape[0], oh, ow, ch) if nhwc
              else (input.shape[0], ch, oh, ow))
    out = helper.create_tmp_variable(input.dtype, shape=oshape)
    helper.append_op(
        "pool2d",
        inputs={"X": [input.name]},
        outputs={"Out": [out.name]},
        attrs={"pooling_type": pool_type, "ksize": list(ps),
               "strides": list(st), "paddings": list(pd),
               "global_pooling": global_pooling,
               "data_format": data_format},
    )
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               name=None):
    """A batch_norm op; scale, bias and the running Mean and Variance take
    the input's dtype (bf16 in the ResNet bench)."""
    helper = LayerHelper("batch_norm", act=act, name=name)
    c = input.shape[-1] if data_layout == "NHWC" else input.shape[1]
    dtype = input.dtype
    scale = helper.create_parameter(
        attr=param_attr if isinstance(param_attr, dict) else {},
        shape=[c], dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(
        attr=bias_attr if isinstance(bias_attr, dict) else {},
        shape=[c], dtype=dtype, is_bias=True)
    mean = helper.create_global_variable(shape=(c,), dtype=dtype)
    variance = helper.create_global_variable(shape=(c,), dtype=dtype)
    helper.set_initialized(mean, ConstantInitializer(0.0))
    helper.set_initialized(variance, ConstantInitializer(1.0))
    saved_mean = helper.create_tmp_variable(dtype, shape=(c,),
                                            stop_gradient=True)
    saved_var = helper.create_tmp_variable(dtype, shape=(c,),
                                           stop_gradient=True)
    out = helper.create_tmp_variable(dtype, shape=input.shape)
    helper.append_op(
        "batch_norm",
        inputs={"X": [input.name], "Scale": [scale.name], "Bias": [bias.name],
                "Mean": [mean.name], "Variance": [variance.name]},
        outputs={"Y": [out.name], "MeanOut": [mean.name],
                 "VarianceOut": [variance.name],
                 "SavedMean": [saved_mean.name],
                 "SavedVariance": [saved_var.name]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout},
    )
    return helper.append_activation(out)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    """Out = X with each element kept with probability 1 − dropout_prob
    (op ``dropout``).  `seed` is accepted for the reference's signature
    and unused, as in the JAX package: the mask's stream is the program's
    seed, the run step and the op's uid."""
    helper = LayerHelper("dropout", name=name)
    out = helper.create_tmp_variable(x.dtype, shape=x.shape)
    mask = helper.create_tmp_variable(x.dtype, shape=x.shape,
                                      stop_gradient=True)
    helper.append_op(
        "dropout",
        inputs={"X": [x.name]},
        outputs={"Out": [out.name], "Mask": [mask.name]},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "dropout_implementation": dropout_implementation},
    )
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    """A matmul op: batched ``x @ y`` after the optional swap of each
    operand's last two axes, times `alpha`."""
    helper = LayerHelper("matmul", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(
        "matmul",
        inputs={"X": [x.name], "Y": [y.name]},
        outputs={"Out": [out.name]},
        attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y,
               "alpha": alpha},
    )
    return out


def softmax(input, name=None):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_tmp_variable(input.dtype, shape=input.shape)
    helper.append_op("softmax", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]})
    return out


def topk(input, k):
    helper = LayerHelper("top_k")
    values = helper.create_tmp_variable(
        input.dtype, shape=tuple(input.shape[:-1]) + (k,), stop_gradient=True)
    indices = helper.create_tmp_variable(
        "int64", shape=tuple(input.shape[:-1]) + (k,), stop_gradient=True)
    helper.append_op("top_k", inputs={"X": [input.name]},
                     outputs={"Out": [values.name], "Indices": [indices.name]},
                     attrs={"k": k})
    return values, indices


def beam_search(pre_ids, pre_scores, cand_ids, cand_scores, beam_size,
                end_id, is_accumulated=True, name=None):
    """One composable beam step (beam_search_op.h:96), usable inside a
    While body around any decoder; see ops/beam_ops.py.  Returns
    (selected_ids [B,K], selected_scores [B,K], parent_idx [B,K])."""
    helper = LayerHelper("beam_search", name=name)
    B, K = pre_ids.shape[0], int(beam_size)
    sel_ids = helper.create_tmp_variable(pre_ids.dtype, shape=(B, K),
                                         stop_gradient=True)
    sel_scores = helper.create_tmp_variable("float32", shape=(B, K),
                                            stop_gradient=True)
    parent = helper.create_tmp_variable("int32", shape=(B, K),
                                        stop_gradient=True)
    helper.append_op(
        "beam_search",
        inputs={"PreIds": [pre_ids.name], "PreScores": [pre_scores.name],
                "Ids": [cand_ids.name], "Scores": [cand_scores.name]},
        outputs={"SelectedIds": [sel_ids.name],
                 "SelectedScores": [sel_scores.name],
                 "ParentIdx": [parent.name]},
        attrs={"beam_size": int(beam_size), "end_id": int(end_id),
               "is_accumulated": bool(is_accumulated)})
    return sel_ids, sel_scores, parent


def beam_search_decode(ids, parent_idx, scores, end_id, step_count=None,
                       name=None):
    """Backtrack the per-step beam selections, the [L, B, K] arrays a
    generation loop fills by array_write, into sentences
    (beam_search_decode_op.cc:41).  Returns (sentence_ids [B,K,L],
    sentence_scores [B,K], sentence_length [B,K])."""
    helper = LayerHelper("beam_search_decode", name=name)
    L, B, K = ids.shape
    sent = helper.create_tmp_variable(ids.dtype, shape=(B, K, L),
                                      stop_gradient=True)
    sscores = helper.create_tmp_variable("float32", shape=(B, K),
                                         stop_gradient=True)
    slen = helper.create_tmp_variable("int32", shape=(B, K),
                                      stop_gradient=True)
    inputs = {"Ids": [ids.name], "ParentIdx": [parent_idx.name],
              "Scores": [scores.name]}
    if step_count is not None:
        inputs["StepCount"] = [step_count.name]
    helper.append_op(
        "beam_search_decode", inputs=inputs,
        outputs={"SentenceIds": [sent.name],
                 "SentenceScores": [sscores.name],
                 "SentenceLength": [slen.name]},
        attrs={"end_id": int(end_id)})
    return sent, sscores, slen


def accuracy(input, label, k=1):
    helper = LayerHelper("accuracy")
    _, indices = topk(input, k)
    acc = helper.create_tmp_variable("float32", shape=(1,),
                                     stop_gradient=True)
    correct = helper.create_tmp_variable("int64", shape=(1,),
                                         stop_gradient=True)
    total = helper.create_tmp_variable("int64", shape=(1,),
                                       stop_gradient=True)
    helper.append_op(
        "accuracy",
        inputs={"Indices": [indices.name], "Label": [label.name]},
        outputs={"Accuracy": [acc.name], "Correct": [correct.name],
                 "Total": [total.name]},
    )
    return acc
