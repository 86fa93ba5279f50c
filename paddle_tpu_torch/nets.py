"""Network presets, the port of ``paddle_tpu/nets.py``:
``simple_img_conv_pool``, ``img_conv_group``, ``glu``,
``dot_product_attention`` and ``sequence_conv_pool``."""

from __future__ import annotations

from . import layers
from .framework.layer_helper import LayerHelper


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act=None, pool_type="max",
                         param_attr=None):
    """conv2d (no padding) with its activation, then pool2d."""
    conv_out = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        param_attr=param_attr, act=act)
    return layers.pool2d(input=conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def img_conv_group(input, conv_num_filter, conv_filter_size=3,
                   conv_act="relu", conv_with_batchnorm=False,
                   conv_batchnorm_drop_rate=0.0, pool_size=2, pool_stride=2,
                   pool_type="max", param_attr=None, data_format="NCHW"):
    """One 'same'-padded conv2d per entry of `conv_num_filter`, each
    followed by its activation, or by ``batch_norm(act=conv_act)`` and an
    optional dropout where `conv_with_batchnorm` says so; then pool2d."""
    tmp = input
    if not isinstance(conv_with_batchnorm, (list, tuple)):
        conv_with_batchnorm = [conv_with_batchnorm] * len(conv_num_filter)
    if not isinstance(conv_batchnorm_drop_rate, (list, tuple)):
        conv_batchnorm_drop_rate = [conv_batchnorm_drop_rate] * len(
            conv_num_filter)
    for i, nf in enumerate(conv_num_filter):
        local_act = None if conv_with_batchnorm[i] else conv_act
        tmp = layers.conv2d(
            input=tmp, num_filters=nf, filter_size=conv_filter_size,
            padding=(conv_filter_size - 1) // 2, param_attr=param_attr,
            act=local_act, data_format=data_format)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act,
                                    data_layout=data_format)
            if conv_batchnorm_drop_rate[i] > 0:
                tmp = layers.dropout(x=tmp,
                                     dropout_prob=conv_batchnorm_drop_rate[i])
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_stride=pool_stride, pool_type=pool_type,
                         data_format=data_format)


def glu(input, dim=-1):
    """Gated linear unit: split `input` in two halves a, b along `dim`,
    out = a * sigmoid(b)."""
    helper = LayerHelper("glu")
    shape = list(input.shape)
    a = helper.create_tmp_variable(input.dtype)
    b = helper.create_tmp_variable(input.dtype)
    helper.append_op("split", inputs={"X": [input.name]},
                     outputs={"Out": [a.name, b.name]},
                     attrs={"num": 2, "axis": dim if dim >= 0 else
                            len(shape) - 1})
    gate = helper.create_tmp_variable(input.dtype)
    helper.append_op("sigmoid", inputs={"X": [b.name]},
                     outputs={"Out": [gate.name]})
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("elementwise_mul",
                     inputs={"X": [a.name], "Y": [gate.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": -1})
    return out


def dot_product_attention(querys, keys, values):
    """Unscaled dot-product attention over padded [B, T, D] tensors;
    returns (context, weights)."""
    product = layers.matmul(querys, keys, transpose_y=True)
    weights = layers.softmax(product)
    context = layers.matmul(weights, values)
    return context, weights


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max"):
    """sequence_conv with its activation, then sequence_pool."""
    conv = layers.sequence_conv(input, num_filters=num_filters,
                                filter_size=filter_size,
                                param_attr=param_attr, act=act)
    return layers.sequence_pool(conv, pool_type=pool_type)
