"""fluid-compatible layer entry points: create_parameter."""

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
