"""fluid-compatible layer entry points, from
``paddle_tpu/layers/fluid_compat.py``: conv2d_transpose, split,
create_parameter, fill_constant_batch_size_like, ones, zeros, the dense
tensor arrays (create_array, array_write, array_read, array_length), the
single recurrent steps (gru_unit, lstm_unit), chunk_eval, cos_sim,
l2_normalize, the sequence API (sequence_expand, sequence_first_step,
sequence_last_step, sequence_reshape) and the LoD names on the
padded+lengths representation: a rank table is the order of the lengths,
descending (lod_rank_table, max_sequence_len,
reorder_lod_tensor_by_rank), a tensor array of a sequence its time-major
transpose (lod_tensor_to_array, array_to_lod_tensor), shrink_memory the
identity (the masks keep the batch whole), and split_lod_tensor /
merge_lod_tensor ``select`` by a row mask, and ``warpctc`` (CTC over
padded logits and labels with their lengths)."""

from __future__ import annotations

import torch

from ..framework import unique_name
from ..framework.core import default_main_program
from ..framework.place import CPUPlace, CUDAPlace, default_place
from ..framework.layer_helper import LayerHelper
from . import tensor as _tensor
from .nn import fc
from .sequence import _set_length, get_length_var, propagate_length, \
    sequence_pool


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


def array_length(array):
    """The static capacity of a dense tensor array (its dim 0), int64
    [1]."""
    helper = LayerHelper("array_length")
    sh = helper.create_tmp_variable("int64", shape=None, stop_gradient=True)
    helper.append_op("shape", inputs={"Input": [array.name]},
                     outputs={"Out": [sh.name]})
    out = helper.create_tmp_variable("int64", shape=None, stop_gradient=True)
    helper.append_op("slice", inputs={"Input": [sh.name]},
                     outputs={"Out": [out.name]},
                     attrs={"axes": [0], "starts": [0], "ends": [1]})
    return out


# -- single recurrent steps, metrics, the sequence API ------------------------

def gru_unit(input, hidden, size, weight=None, bias=None, activation="tanh",
             gate_activation="sigmoid", param_attr=None, bias_attr=None):
    """A gru_unit op (`size` is 3·H): returns (updated hidden,
    reset_hidden_prev, gate)."""
    helper = LayerHelper("gru_unit", param_attr=param_attr)
    H = size // 3
    if weight is None:
        weight = helper.create_parameter(
            attr=param_attr if isinstance(param_attr, dict) else {},
            shape=[H, 3 * H], dtype=input.dtype)
    inputs = {"Input": [input.name], "HiddenPrev": [hidden.name],
              "Weight": [weight.name]}
    if bias is None and bias_attr is not False:
        bias = helper.create_parameter(
            attr=bias_attr if isinstance(bias_attr, dict) else {},
            shape=[3 * H], dtype=input.dtype, is_bias=True)
    if bias is not None:
        inputs["Bias"] = [bias.name]
    h = helper.create_tmp_variable(input.dtype, shape=(-1, H))
    g = helper.create_tmp_variable(input.dtype, shape=None)
    r = helper.create_tmp_variable(input.dtype, shape=None)
    helper.append_op("gru_unit", inputs=inputs,
                     outputs={"Hidden": [h.name], "Gate": [g.name],
                              "ResetHiddenPrev": [r.name]},
                     attrs={"activation": activation,
                            "gate_activation": gate_activation})
    return h, r, g


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """fc([x_t, h_prev]) to the 4·H gates, then an lstm_unit op; returns
    (h, c)."""
    helper = LayerHelper("lstm_unit", name=name)
    H = int(cell_t_prev.shape[-1])
    gates = fc([x_t, hidden_t_prev], size=4 * H, param_attr=param_attr,
               bias_attr=bias_attr)
    c = helper.create_tmp_variable(x_t.dtype, shape=(-1, H))
    h = helper.create_tmp_variable(x_t.dtype, shape=(-1, H))
    helper.append_op("lstm_unit",
                     inputs={"X": [gates.name], "C_prev": [cell_t_prev.name]},
                     outputs={"C": [c.name], "H": [h.name]},
                     attrs={"forget_bias": float(forget_bias)})
    return h, c


def cos_sim(X, Y, **kwargs):
    helper = LayerHelper("cos_sim")
    out = helper.create_tmp_variable(X.dtype, shape=(-1, 1))
    helper.append_op("cos_sim", inputs={"X": [X.name], "Y": [Y.name]},
                     outputs={"Out": [out.name]})
    return out


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, **kwargs):
    """A chunk_eval op; returns (precision, recall, f1, num_infer_chunks,
    num_label_chunks, num_correct_chunks)."""
    helper = LayerHelper("chunk_eval")
    inputs = {"Inference": [input.name], "Label": [label.name]}
    lv = get_length_var(input) or get_length_var(label)
    if lv is not None:
        inputs["Length"] = [lv.name]
    outs = [helper.create_tmp_variable("float32", shape=None)
            for _ in range(3)]
    counts = [helper.create_tmp_variable("int64", shape=None)
              for _ in range(3)]
    helper.append_op(
        "chunk_eval", inputs=inputs,
        outputs={"Precision": [outs[0].name], "Recall": [outs[1].name],
                 "F1-Score": [outs[2].name],
                 "NumInferChunks": [counts[0].name],
                 "NumLabelChunks": [counts[1].name],
                 "NumCorrectChunks": [counts[2].name]},
        attrs={"chunk_scheme": chunk_scheme,
               "num_chunk_types": int(num_chunk_types),
               "excluded_chunk_types": list(excluded_chunk_types or [])})
    return (*outs, *counts)


def sequence_expand(x, y, name=None):
    """One row of x per sequence of y, broadcast over y's steps."""
    helper = LayerHelper("sequence_expand", name=name)
    lv = get_length_var(y)
    T = int(y.shape[1]) if y.shape and int(y.shape[1]) > 0 else -1
    out = helper.create_tmp_variable(x.dtype, shape=None)
    inputs = {"X": [x.name], "Length": [lv.name]}
    if T < 0:  # T unknown when the program is built: y's at run time
        inputs["Ref"] = [y.name]
    helper.append_op("sequence_expand", inputs=inputs,
                     outputs={"Out": [out.name]}, attrs={"max_len": T})
    propagate_length(y, out)
    return out


def sequence_first_step(input, **kwargs):
    return sequence_pool(input, pool_type="first")


def sequence_last_step(input, **kwargs):
    return sequence_pool(input, pool_type="last")


def sequence_reshape(input, new_dim):
    helper = LayerHelper("sequence_reshape")
    lv = get_length_var(input)
    out = helper.create_tmp_variable(input.dtype, shape=None)
    newlen = helper.create_tmp_variable("int32", shape=None)
    helper.append_op("sequence_reshape",
                     inputs={"X": [input.name], "Length": [lv.name]},
                     outputs={"Out": [out.name], "LengthOut": [newlen.name]},
                     attrs={"new_dim": int(new_dim)})
    _set_length(out, newlen.name)
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    """x / sqrt(max(sum(x², axis), epsilon)), from elementwise ops."""
    sq = _tensor.elementwise_mul(x, x)
    s = _tensor.reduce_sum(sq, dim=axis, keep_dim=True)
    helper = LayerHelper("l2_normalize", name=name)
    clipped = helper.create_tmp_variable(x.dtype, shape=None)
    helper.append_op("clip", inputs={"X": [s.name]},
                     outputs={"Out": [clipped.name]},
                     attrs={"min": float(epsilon), "max": 3.4e38})
    rsq = helper.create_tmp_variable(x.dtype, shape=None)
    helper.append_op("sqrt", inputs={"X": [clipped.name]},
                     outputs={"Out": [rsq.name]})
    return _tensor.elementwise_div(x, rsq)


def create_tensor(dtype, name=None, persistable=False):
    block = default_main_program().current_block()
    return block.create_var(
        name=name or unique_name.generate("create_tensor"), shape=None,
        dtype=dtype, persistable=persistable)


# -- the LoD names on padded+lengths ------------------------------------------

def lod_rank_table(x, level=0):
    """The batch's rows by length, longest first (equal lengths in row
    order): argsort of the negated length var."""
    lv = get_length_var(x)
    helper = LayerHelper("lod_rank_table")
    neg = helper.create_tmp_variable("float32", shape=None,
                                     stop_gradient=True)
    helper.append_op("scale", inputs={"X": [lv.name]},
                     outputs={"Out": [neg.name]},
                     attrs={"scale": -1.0, "bias": 0.0})
    out = helper.create_tmp_variable("int64", shape=None, stop_gradient=True)
    helper.append_op("arg_sort", inputs={"X": [neg.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": 0})
    out._rank_source = x
    return out


def max_sequence_len(rank_table_or_seq):
    """The longest length in the batch (a reduce_max of the length var) of
    a sequence or of the sequence a rank table ranks."""
    v = getattr(rank_table_or_seq, "_rank_source", None)
    lv = get_length_var(rank_table_or_seq if v is None else v)
    helper = LayerHelper("max_sequence_len")
    out = helper.create_tmp_variable("int32", shape=None, stop_gradient=True)
    helper.append_op("reduce_max", inputs={"X": [lv.name]},
                     outputs={"Out": [out.name]},
                     attrs={"dim": 0, "keep_dim": True})
    return out


def reorder_lod_tensor_by_rank(x, rank_table):
    """x's rows, and its lengths, gathered into the rank table's order."""
    helper = LayerHelper("reorder_by_rank")
    out = helper.create_tmp_variable(x.dtype, shape=x.shape)
    helper.append_op("gather", inputs={"X": [x.name],
                                       "Index": [rank_table.name]},
                     outputs={"Out": [out.name]})
    lv = get_length_var(x)
    nl = helper.create_tmp_variable(lv.dtype, shape=None, stop_gradient=True)
    helper.append_op("gather", inputs={"X": [lv.name],
                                       "Index": [rank_table.name]},
                     outputs={"Out": [nl.name]})
    _set_length(out, nl.name)
    return out


def lod_tensor_to_array(x, table=None):
    """[B, T, ...] sequence → its time-major [T, B, ...] array."""
    nd = len(x.shape) if x.shape else 3
    return _tensor.transpose(x, [1, 0] + list(range(2, nd)))


def array_to_lod_tensor(x, table=None):
    """The inverse of lod_tensor_to_array."""
    nd = len(x.shape) if x.shape else 3
    return _tensor.transpose(x, [1, 0] + list(range(2, nd)))


def shrink_memory(x, i, table):
    """The identity: the batch stays whole and the masks of the sequence
    ops stand for the rows that have ended."""
    return x


def split_lod_tensor(input, mask, level=0):
    """Both branches of an IfElse see the whole batch, the other branch's
    rows zeroed: (rows where mask, rows where not)."""
    helper = LayerHelper("split_lod_tensor")
    zero = _tensor.fill_constant(shape=[1], dtype=input.dtype, value=0.0)
    t = helper.create_tmp_variable(input.dtype, shape=input.shape)
    f = helper.create_tmp_variable(input.dtype, shape=input.shape)
    helper.append_op("select", inputs={"Mask": [mask.name],
                                       "X": [input.name],
                                       "Y": [zero.name]},
                     outputs={"Out": [t.name]})
    helper.append_op("select", inputs={"Mask": [mask.name],
                                       "X": [zero.name],
                                       "Y": [input.name]},
                     outputs={"Out": [f.name]})
    return t, f


def merge_lod_tensor(in_true, in_false, x, mask, level=0):
    """The two branches' outputs merged row by row by mask."""
    helper = LayerHelper("merge_lod_tensor")
    out = helper.create_tmp_variable(in_true.dtype, shape=in_true.shape)
    helper.append_op("select", inputs={"Mask": [mask.name],
                                       "X": [in_true.name],
                                       "Y": [in_false.name]},
                     outputs={"Out": [out.name]})
    return out


def get_places(device_count=None, device_type=None):
    """Places to run on: the CUDA cards (all of them unless
    `device_count`), or `device_count` CPU places when `device_type` is
    "cpu"."""
    if device_type == "cpu":
        return [CPUPlace() for _ in range(device_count or 1)]
    default_place()  # raises without a card
    n = device_count or torch.cuda.device_count()
    return [CUDAPlace(i) for i in range(n)]


def warpctc(input, label, blank=0, norm_by_times=False, **kwargs):
    """fluid nn.py warpctc -> warpctc op over padded logits/labels with
    companion lengths.  The op declares the reference's ``WarpCTCGrad``
    output, which its emitter does not write (``unwritten_outputs``)."""
    helper = LayerHelper("warpctc")
    ilen, llen = get_length_var(input), get_length_var(label)
    if ilen is None or llen is None:
        raise ValueError("warpctc: input and label must be sequences")
    loss = helper.create_tmp_variable(input.dtype, shape=None)
    grad = helper.create_tmp_variable(input.dtype, shape=None)
    helper.append_op(
        "warpctc",
        inputs={"Logits": [input.name], "Label": [label.name],
                "LogitsLength": [ilen.name], "LabelLength": [llen.name]},
        outputs={"Loss": [loss.name], "WarpCTCGrad": [grad.name]},
        attrs={"blank": int(blank), "norm_by_times": bool(norm_by_times)})
    return loss
