"""Tensor-building layer functions: elementwise_add."""

from __future__ import annotations

from ..framework.layer_helper import LayerHelper


def elementwise_add(x, y, axis=-1, act=None, name=None):
    helper = LayerHelper("elementwise_add", act=act, name=name)
    out = helper.create_tmp_variable(x.dtype, shape=x.shape)
    helper.append_op("elementwise_add", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    return helper.append_activation(out)
