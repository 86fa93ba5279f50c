"""One layer per unary op, the port of ``paddle_tpu/layers/ops.py``:
every entry of the activation table (``layers.sigmoid(x)``,
``layers.sqrt(x)``, ...), with ``elementwise_max``, ``elementwise_min``
and ``clip``."""

from __future__ import annotations

from ..framework.layer_helper import LayerHelper
from ..ops.activation_ops import ACTIVATIONS
from .tensor import elementwise_op

__activations__ = list(ACTIVATIONS)

__all__ = ["elementwise_max", "elementwise_min", "clip"] + __activations__


def _unary_layer(op_type):
    def layer(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_tmp_variable(x.dtype, shape=x.shape)
        helper.append_op(op_type, inputs={"X": [x.name]},
                         outputs={"Out": [out.name]}, attrs=attrs)
        return out

    layer.__name__ = op_type
    layer.__doc__ = f"{op_type} applied elementwise."
    return layer


for _n in __activations__:
    globals()[_n] = _unary_layer(_n)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_max", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_min", x, y, axis, act, name)


def clip(x, min, max, name=None):  # noqa: A002  (reference signature)
    helper = LayerHelper("clip", name=name)
    out = helper.create_tmp_variable(x.dtype, shape=x.shape)
    helper.append_op("clip", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"min": float(min), "max": float(max)})
    return out
