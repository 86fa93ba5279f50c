"""One layer per unary op, the port of ``paddle_tpu/layers/ops.py``:
every entry of the activation table (``layers.sigmoid(x)``,
``layers.sqrt(x)``, ...), with the plain-op wrappers ``mul``,
``sigmoid_cross_entropy_with_logits``, ``elementwise_max``,
``elementwise_min`` and ``clip``."""

from __future__ import annotations

from ..framework.layer_helper import LayerHelper
from ..ops.activation_ops import ACTIVATIONS
from .tensor import elementwise_op

__activations__ = list(ACTIVATIONS)

__all__ = [
    "mul",
    "sigmoid_cross_entropy_with_logits",
    "elementwise_max",
    "elementwise_min",
    "clip",
] + __activations__


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


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    """The flattening matmul op: x flattened after x_num_col_dims, y up
    to y_num_col_dims."""
    helper = LayerHelper("mul", name=name)
    shape = None
    if x.shape is not None and y.shape is not None:
        shape = tuple(x.shape[:x_num_col_dims]) + tuple(
            y.shape[y_num_col_dims:])
    out = helper.create_tmp_variable(x.dtype, shape=shape)
    helper.append_op("mul", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return out


def sigmoid_cross_entropy_with_logits(x, label, name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_tmp_variable(x.dtype, shape=x.shape)
    helper.append_op("sigmoid_cross_entropy_with_logits",
                     inputs={"X": [x.name], "Label": [label.name]},
                     outputs={"Out": [out.name]})
    return out


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
