"""Network presets, the port of ``simple_img_conv_pool`` in
``paddle_tpu/nets.py``.  ``img_conv_group`` and the rest are not ported
yet (ROADMAP.md Queue A item 7)."""

from __future__ import annotations

from . import layers


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act=None, pool_type="max",
                         param_attr=None):
    """conv2d (no padding) with its activation, then pool2d."""
    conv_out = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        param_attr=param_attr, act=act)
    return layers.pool2d(input=conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)
