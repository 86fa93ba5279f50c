"""Sequence layer functions over the padded+length representation — the
port of ``paddle_tpu/layers/sequence.py``: the layers of the stacked-LSTM
classifier, the attention-NMT model and ``nets.sequence_conv_pool``, and
the CRF pair ``linear_chain_crf`` / ``crf_decoding``.

A ``sequence_data`` variable carries a companion ``<name>@LENGTH`` int32
variable (fed automatically from LoDTensor feeds, see
``Executor._feed_tensor``); layers pass the companion on through
shape-preserving ops via ``_length_var_name``.
"""

from __future__ import annotations

from ..framework.core import Variable
from ..framework.layer_helper import LayerHelper
from ..lod import LENGTH_SUFFIX


def _set_length(var: Variable, length_name: str) -> Variable:
    var._length_var_name = length_name
    return var


def get_length_var(var: Variable):
    name = getattr(var, "_length_var_name", None)
    if name is None:
        raise ValueError(
            f"variable {var.name} carries no sequence-length companion — "
            f"was it produced from a lod_level>0 data var?")
    return var.block.var(name)


def propagate_length(src: Variable, dst: Variable) -> Variable:
    name = getattr(src, "_length_var_name", None)
    if name is not None:
        dst._length_var_name = name
    return dst


def sequence_data(name, shape, dtype="float32", max_len=None):
    """Declare a ragged input: creates `<name>` padded [batch, T, *shape] and
    `<name>@LENGTH` [batch]. Feed a LoDTensor (or list of np sequences)."""
    helper = LayerHelper("data")
    var = helper.block.create_var(
        name=name,
        shape=[-1, -1 if max_len is None else max_len] + list(shape),
        dtype=dtype,
        lod_level=1,
        stop_gradient=True,
        is_data=True,
    )
    lvar = helper.block.create_var(
        name=name + LENGTH_SUFFIX,
        shape=[-1],
        dtype="int32",
        stop_gradient=True,
        is_data=True,
    )
    return _set_length(var, lvar.name)


def sequence_pool(input, pool_type="average"):
    helper = LayerHelper("sequence_pool")
    length = get_length_var(input)
    out = helper.create_tmp_variable(
        input.dtype,
        shape=(input.shape[0],) + tuple(input.shape[2:]) if input.shape
        else None)
    helper.append_op(
        "sequence_pool",
        inputs={"X": [input.name], "Length": [length.name]},
        outputs={"Out": [out.name]},
        attrs={"pooltype": pool_type},
    )
    return out


def sequence_softmax(input):
    helper = LayerHelper("sequence_softmax")
    length = get_length_var(input)
    out = helper.create_tmp_variable(input.dtype, shape=input.shape)
    helper.append_op(
        "sequence_softmax",
        inputs={"X": [input.name], "Length": [length.name]},
        outputs={"Out": [out.name]},
    )
    return propagate_length(input, out)


def sequence_reverse(input):
    helper = LayerHelper("sequence_reverse")
    length = get_length_var(input)
    out = helper.create_tmp_variable(input.dtype, shape=input.shape)
    helper.append_op(
        "sequence_reverse",
        inputs={"X": [input.name], "Length": [length.name]},
        outputs={"Y": [out.name]},
    )
    return propagate_length(input, out)


def sequence_conv(input, num_filters, filter_size=3, param_attr=None,
                  act=None):
    """A sequence_conv op: a window of `filter_size` steps centred on each
    step, projected to `num_filters`, then `act`."""
    helper = LayerHelper("sequence_conv", act=act, param_attr=param_attr)
    length = get_length_var(input)
    D = input.shape[-1]
    w = helper.create_parameter(
        attr=param_attr if isinstance(param_attr, dict) else {},
        shape=[filter_size * D, num_filters], dtype=input.dtype)
    out = helper.create_tmp_variable(
        input.dtype, shape=tuple(input.shape[:-1]) + (num_filters,))
    helper.append_op(
        "sequence_conv",
        inputs={"X": [input.name], "Filter": [w.name],
                "Length": [length.name]},
        outputs={"Out": [out.name]},
        attrs={"contextLength": filter_size,
               "contextStart": -(filter_size // 2)},
    )
    out = helper.append_activation(out)
    return propagate_length(input, out)


def sequence_fc(input, size, act=None, param_attr=None, bias_attr=None):
    """Per-timestep fc on [B,T,D] (fluid fc with num_flatten_dims=2)."""
    from . import nn

    out = nn.fc(input, size, num_flatten_dims=2, act=act,
                param_attr=param_attr, bias_attr=bias_attr)
    return propagate_length(input, out)


def sequence_embedding(input, size, padding_idx=None, param_attr=None,
                       dtype="float32"):
    """Embedding over ragged int ids [B,T] or [B,T,1] → [B,T,D]."""
    from . import nn

    out = nn.embedding(input, size, padding_idx=padding_idx,
                       param_attr=param_attr, dtype=dtype)
    return propagate_length(input, out)


def dynamic_lstm(input, size, h0=None, c0=None, param_attr=None,
                 bias_attr=None, use_peepholes=False, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh"):
    """fluid nn.py dynamic_lstm: `input` is [B,T,4H] (pre-projected by an fc
    of size 4H); returns (hidden [B,T,H], cell [B,T,H]).  use_peepholes
    grows the bias to [7H] = [4H gate bias, W_ic, W_fc, W_oc]
    (lstm_op.cc's peephole packing; default off here — the reference fluid
    default is on, but a 7H bias changes checkpoint shapes)."""
    helper = LayerHelper("dynamic_lstm", param_attr=param_attr,
                         bias_attr=bias_attr)
    length = get_length_var(input)
    H = size // 4
    w = helper.create_parameter(
        attr=param_attr if isinstance(param_attr, dict) else {},
        shape=[H, 4 * H], dtype=input.dtype)
    bias = helper.create_parameter(
        attr=bias_attr if isinstance(bias_attr, dict) else {},
        shape=[7 * H if use_peepholes else 4 * H], dtype=input.dtype,
        is_bias=True)
    hidden = helper.create_tmp_variable(
        input.dtype, shape=tuple(input.shape[:2]) + (H,))
    cell = helper.create_tmp_variable(
        input.dtype, shape=tuple(input.shape[:2]) + (H,))
    ins = {"Input": [input.name], "Weight": [w.name], "Bias": [bias.name],
           "Length": [length.name]}
    if h0 is not None:
        ins["H0"] = [h0.name]
    if c0 is not None:
        ins["C0"] = [c0.name]
    helper.append_op(
        "lstm", inputs=ins,
        outputs={"Hidden": [hidden.name], "Cell": [cell.name]},
        attrs={"is_reverse": is_reverse,
               "use_peepholes": bool(use_peepholes),
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation},
    )
    propagate_length(input, hidden)
    propagate_length(input, cell)
    return hidden, cell


def dynamic_gru(input, size, h0=None, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh"):
    """fluid dynamic_gru: input [B,T,3H] pre-projected; returns [B,T,H]."""
    helper = LayerHelper("dynamic_gru", param_attr=param_attr,
                         bias_attr=bias_attr)
    length = get_length_var(input)
    H = size
    w = helper.create_parameter(
        attr=param_attr if isinstance(param_attr, dict) else {},
        shape=[H, 3 * H], dtype=input.dtype)
    bias = helper.create_parameter(
        attr=bias_attr if isinstance(bias_attr, dict) else {},
        shape=[3 * H], dtype=input.dtype, is_bias=True)
    hidden = helper.create_tmp_variable(
        input.dtype, shape=tuple(input.shape[:2]) + (H,))
    ins = {"Input": [input.name], "Weight": [w.name], "Bias": [bias.name],
           "Length": [length.name]}
    if h0 is not None:
        ins["H0"] = [h0.name]
    helper.append_op(
        "gru", inputs=ins, outputs={"Hidden": [hidden.name]},
        attrs={"is_reverse": is_reverse, "gate_activation": gate_activation,
               "activation": candidate_activation},
    )
    propagate_length(input, hidden)
    return hidden


def linear_chain_crf(input, label, param_attr=None):
    """The CRF loss: emission [B,T,C] and label [B,T,1] → each row's
    negative log-likelihood [B,1].  The transition parameter [(C+2), C]
    rides on the result as ``_crf_transition``, for ``crf_decoding``."""
    helper = LayerHelper("linear_chain_crf", param_attr=param_attr)
    length = get_length_var(input)
    C = input.shape[-1]
    transition = helper.create_parameter(
        attr=param_attr if isinstance(param_attr, dict) else {},
        shape=[C + 2, C], dtype="float32")
    nll = helper.create_tmp_variable("float32")
    alpha = helper.create_tmp_variable("float32", stop_gradient=True)
    helper.append_op(
        "linear_chain_crf",
        inputs={"Emission": [input.name], "Transition": [transition.name],
                "Label": [label.name], "Length": [length.name]},
        outputs={"LogLikelihood": [nll.name], "Alpha": [alpha.name]},
    )
    nll._crf_transition = transition
    return nll


def crf_decoding(input, transition):
    """Viterbi decoding of emission [B,T,C] under the CRF's transition
    variable → the int32 path [B,T]."""
    helper = LayerHelper("crf_decoding")
    length = get_length_var(input)
    path = helper.create_tmp_variable("int32", stop_gradient=True)
    helper.append_op(
        "crf_decoding",
        inputs={"Emission": [input.name], "Transition": [transition.name],
                "Length": [length.name]},
        outputs={"ViterbiPath": [path.name]},
    )
    return propagate_length(input, path)
