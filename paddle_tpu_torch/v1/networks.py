"""v1 network presets (reference trainer_config_helpers/networks.py:
simple_img_conv_pool :144, vgg_16_network :547, simple_lstm, simple_gru
:1076, bidirectional_gru/lstm :1226/:1310, simple_attention :1400)."""

from __future__ import annotations

from .. import layers as fl
from ..framework.layer_helper import LayerHelper
from .layers import get_length_var
from .activations import LinearActivation, ReluActivation, TanhActivation, \
    act_name
from .layers import (LayerOutput, _apply_act, _var, _wrap, batch_norm_layer,
                     concat_layer, fc_layer, grumemory, img_conv_layer,
                     img_pool_layer, lstmemory, pooling_layer)
from .poolings import MaxPooling


def simple_img_conv_pool(input, filter_size, num_filters, pool_size,
                         pool_stride=None, act=None, pool_type=None,
                         padding=None, **kw):
    """conv + pool (networks.py:144)."""
    conv = img_conv_layer(
        input, filter_size=filter_size, num_filters=num_filters,
        padding=padding if padding is not None else filter_size // 2, act=act)
    return img_pool_layer(conv, pool_size=pool_size,
                          stride=pool_stride or pool_size,
                          pool_type=pool_type)


def img_conv_group(input, conv_num_filter, conv_filter_size=3, pool_size=2,
                   pool_stride=2, conv_act=None, conv_with_batchnorm=False,
                   pool_type=None):
    """Stacked convs + one pool (networks.py img_conv_group)."""
    tmp = input
    for nf in (conv_num_filter if isinstance(conv_num_filter, (list, tuple))
               else [conv_num_filter]):
        tmp = img_conv_layer(tmp, filter_size=conv_filter_size,
                             num_filters=nf, padding=conv_filter_size // 2,
                             act=None if conv_with_batchnorm else conv_act)
        if conv_with_batchnorm:
            tmp = batch_norm_layer(tmp, act=conv_act)
    return img_pool_layer(tmp, pool_size=pool_size, stride=pool_stride,
                          pool_type=pool_type)


def vgg_16_network(input_image, num_channels=3, num_classes=1000):
    """VGG-16 (networks.py:547)."""
    relu = ReluActivation()
    tmp = input_image
    for filters, convs in ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3)):
        tmp = img_conv_group(tmp, [filters] * convs, conv_act=relu,
                             conv_with_batchnorm=True)
    from .activations import SoftmaxActivation

    tmp = fc_layer(tmp, size=4096, act=relu)
    tmp = fc_layer(tmp, size=4096, act=relu)
    return fc_layer(tmp, size=num_classes, act=SoftmaxActivation())


def simple_lstm(input, size, reverse=False, act=None, **kw):
    """fc(4H) + lstmemory (networks.py simple_lstm)."""
    proj = fc_layer(input, size=size * 4)
    return lstmemory(proj, size=size, reverse=reverse, act=act)


def simple_gru(input, size, reverse=False, act=None, **kw):
    """fc(3H) + grumemory (networks.py:1076)."""
    proj = fc_layer(input, size=size * 3)
    return grumemory(proj, size=size, reverse=reverse, act=act)


def bidirectional_lstm(input, size, return_seq=False, **kw):
    """Forward + backward lstm, concat (networks.py:1310)."""
    fwd = simple_lstm(input, size)
    bwd = simple_lstm(input, size, reverse=True)
    if return_seq:
        return concat_layer([fwd, bwd])
    f = pooling_layer(fwd, pooling_type=MaxPooling)
    b = pooling_layer(bwd, pooling_type=MaxPooling)
    return concat_layer([f, b])


def bidirectional_gru(input, size, return_seq=False, **kw):
    """networks.py:1226."""
    fwd = simple_gru(input, size)
    bwd = simple_gru(input, size, reverse=True)
    if return_seq:
        return concat_layer([fwd, bwd])
    f = pooling_layer(fwd, pooling_type=MaxPooling)
    b = pooling_layer(bwd, pooling_type=MaxPooling)
    return concat_layer([f, b])


def sequence_conv_pool(input, context_len, hidden_size, act=None,
                       pool_type=None, **kw):
    """Context-window conv + sequence pool (networks.py sequence_conv_pool,
    the text-conv building block)."""
    conv = fl.sequence_conv(_var(input), num_filters=hidden_size,
                            filter_size=context_len)
    conv = _apply_act(conv, act)
    lo = _wrap(conv, "seq_conv", size=hidden_size, parents=[input])
    return pooling_layer(lo, pooling_type=pool_type or MaxPooling)


def simple_attention(encoded_sequence, encoded_proj, decoder_state,
                     transform_param_attr=None, softmax_param_attr=None,
                     name=None):
    """Additive (Bahdanau) attention (networks.py:1400): score each encoder
    step against the decoder state, softmax over true steps, weighted-sum
    context.  The building block of the book NMT model."""
    helper = LayerHelper("simple_attention")
    enc = _var(encoded_sequence)   # [B, T, D]
    proj = _var(encoded_proj)      # [B, T, A]
    state = _var(decoder_state)    # [B, A]
    lv = get_length_var(enc) or get_length_var(proj)
    A = int(proj.shape[-1])
    # broadcast decoder state over time: [B,1,A] + [B,T,A] (no static T)
    state3 = fl.reshape(state, [-1, 1, A])
    comb = fl.elementwise_add(proj, state3)
    comb = _apply_act(comb, TanhActivation())
    from .attrs import to_param_attr

    scores = fl.sequence_fc(comb, size=1,
                            param_attr=to_param_attr(transform_param_attr))
    flat = helper.create_tmp_variable(scores.dtype, shape=None)
    helper.append_op("squeeze", inputs={"X": [scores.name]},
                     outputs={"Out": [flat.name]}, attrs={"axes": [-1]})
    weights = helper.create_tmp_variable(scores.dtype, shape=None)
    helper.append_op("sequence_softmax",
                     inputs={"X": [flat.name], "Length": [lv.name]},
                     outputs={"Out": [weights.name]})
    wexp = helper.create_tmp_variable(scores.dtype, shape=None)
    helper.append_op("unsqueeze", inputs={"X": [weights.name]},
                     outputs={"Out": [wexp.name]}, attrs={"axes": [-1]})
    # context = sum_t w_t * enc_t  (static feature dim so downstream fc
    # layers can size their weights)
    weighted = fl.elementwise_mul(enc, wexp)
    ctx = helper.create_tmp_variable(enc.dtype,
                                     shape=(-1, int(enc.shape[-1])))
    helper.append_op("reduce_sum", inputs={"X": [weighted.name]},
                     outputs={"Out": [ctx.name]},
                     attrs={"dim": 1, "keep_dim": False})
    return _wrap(ctx, "attention",
                 size=getattr(encoded_sequence, "size", None))


# --- recurrent-group presets (reference networks.py lstmemory_unit/group,
# gru_unit/group — the step-level building blocks of attention decoders) ----

def lstmemory_unit(input, out_memory=None, name=None, size=None,
                   param_attr=None, act=None, gate_act=None, state_act=None,
                   input_proj_bias_attr=None, input_proj_layer_attr=None,
                   lstm_bias_attr=None, lstm_layer_attr=None):
    """One LSTM time step for use inside recurrent_group (reference
    networks.py lstmemory_unit): projection of [x_t, h_{t-1}] into 4H then
    lstm_step_layer; cell state rides a named memory."""
    from .layers import (full_matrix_projection, get_output_layer,
                         identity_projection, lstm_step_layer, memory,
                         mixed_layer)
    from ..framework import unique_name

    if size is None:
        size = input.size // 4
    name = name or unique_name.generate("lstmemory_unit")
    if out_memory is None:
        out_mem = memory(name=name, size=size)
    else:
        out_mem = out_memory

    state_mem = memory(name=f"{name}_state", size=size)
    with mixed_layer(name=f"{name}_input_recurrent", size=size * 4,
                     bias_attr=input_proj_bias_attr) as m:
        m += identity_projection(input=input)
        m += full_matrix_projection(input=out_mem, param_attr=param_attr)
    lstm_out = lstm_step_layer(
        name=name, input=m, state=state_mem, size=size,
        bias_attr=lstm_bias_attr, act=act, gate_act=gate_act,
        state_act=state_act)
    get_output_layer(name=f"{name}_state", input=lstm_out, arg_name="state")
    return lstm_out


def lstmemory_group(input, size=None, name=None, out_memory=None,
                    reverse=False, param_attr=None, act=None, gate_act=None,
                    state_act=None, input_proj_bias_attr=None,
                    input_proj_layer_attr=None, lstm_bias_attr=None,
                    lstm_layer_attr=None):
    """recurrent_group form of LSTM (reference networks.py lstmemory_group):
    per-step states stay accessible, unlike the fused lstmemory."""
    from .layers import recurrent_group

    def __lstm_step__(ipt):
        return lstmemory_unit(
            input=ipt, name=name, size=size, out_memory=out_memory,
            act=act, gate_act=gate_act, state_act=state_act,
            param_attr=param_attr, input_proj_bias_attr=input_proj_bias_attr,
            lstm_bias_attr=lstm_bias_attr)

    return recurrent_group(
        name=f"{name}_recurrent_group" if name else None,
        step=__lstm_step__, reverse=reverse, input=input)


def gru_unit(input, memory_boot=None, size=None, name=None, gru_bias_attr=None,
             gru_param_attr=None, act=None, gate_act=None,
             gru_layer_attr=None, naive=False):
    """One GRU time step for use inside recurrent_group (reference
    networks.py gru_unit): input must already be the 3H projection."""
    from .layers import gru_step_layer, gru_step_naive_layer, memory
    from ..framework import unique_name

    if size is None:
        size = input.size // 3
    name = name or unique_name.generate("gru_unit")
    out_mem = memory(name=name, size=size, boot_layer=memory_boot)
    step = gru_step_naive_layer if naive else gru_step_layer
    return step(name=name, size=size, bias_attr=gru_bias_attr,
                param_attr=gru_param_attr, act=act, gate_act=gate_act,
                input=input, output_mem=out_mem)


def gru_group(input, memory_boot=None, size=None, name=None,
              reverse=False, gru_bias_attr=None, gru_param_attr=None,
              act=None, gate_act=None, gru_layer_attr=None, naive=False):
    """recurrent_group form of GRU (reference networks.py gru_group)."""
    from .layers import recurrent_group

    def __gru_step__(ipt):
        return gru_unit(input=ipt, name=name, memory_boot=memory_boot,
                        size=size, gru_bias_attr=gru_bias_attr,
                        gru_param_attr=gru_param_attr, act=act,
                        gate_act=gate_act, naive=naive)

    return recurrent_group(
        name=f"{name}_recurrent_group" if name else None,
        step=__gru_step__, reverse=reverse, input=input)


def simple_gru2(input, size, name=None, reverse=False, mixed_param_attr=None,
                mixed_bias_attr=False, gru_param_attr=None,
                gru_bias_attr=True, act=None, gate_act=None, **kw):
    """simple_gru2 (reference networks.py): mixed projection + gru_group —
    same math as grumemory with the group-form building blocks."""
    from .layers import full_matrix_projection, mixed_layer

    proj = mixed_layer(size=size * 3, input=[full_matrix_projection(
        input=input, size=size * 3, param_attr=mixed_param_attr)],
        bias_attr=mixed_bias_attr)
    return gru_group(input=proj, size=size, name=name, reverse=reverse,
                     gru_bias_attr=gru_bias_attr,
                     gru_param_attr=gru_param_attr, act=act,
                     gate_act=gate_act)


def text_conv_pool(input, context_len, hidden_size, act=None, **kw):
    """text_conv_pool (reference networks.py): alias of sequence_conv_pool."""
    return sequence_conv_pool(input, context_len=context_len,
                              hidden_size=hidden_size, act=act, **kw)
