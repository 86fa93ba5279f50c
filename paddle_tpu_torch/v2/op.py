"""Operator sugar on v2/v1 layer outputs, the port of
``paddle_tpu/v2/op.py`` (reference python/paddle/v2/op.py): `a + b`,
`a - 2.0`, `-a`, `0.5 * a`, plus the generated unary math ops
(`paddle.v2.op.exp(x)`, ...).  Same composition rules as the
reference — equal sizes add via identity projections in a mixed layer,
a size-1 operand broadcasts via repeat/scaling, scalars ride
slope_intercept."""

from __future__ import annotations

import numbers

from ..v1 import layers as v1


def _is_num(x) -> bool:
    return isinstance(x, numbers.Number)


def _unary(op_name, act):
    def op(input, name=None):
        return v1.mixed_layer(
            input=[v1.identity_projection(input=input)],
            size=input.size, act=act, name=name)

    op.__name__ = op_name
    return op


__all__ = []
for _name, _act in [
        ("exp", "exp"), ("log", "log"), ("abs", "abs"),
        ("sigmoid", "sigmoid"), ("tanh", "tanh"), ("square", "square"),
        ("relu", "relu"), ("sqrt", "sqrt"), ("reciprocal", "reciprocal"),
        ("softmax", "softmax")]:
    globals()[_name] = _unary(_name, _act)
    __all__.append(_name)


def _add(a, b):
    if _is_num(b):
        return v1.slope_intercept_layer(input=a, intercept=float(b))
    if not isinstance(b, v1.LayerOutput):
        raise TypeError("Layer can only be added with another Layer or a "
                        "number")
    if a.size == b.size:
        return v1.mixed_layer(input=[
            v1.identity_projection(input=a),
            v1.identity_projection(input=b)], size=a.size)
    if b.size != 1 and a.size != 1:
        raise TypeError(
            f"Two Layer can be added only if they have equal size or one "
            f"of their sizes is 1. sizes are {a.size} and {b.size}")
    if a.size == 1:
        a, b = b, a
    b = v1.repeat_layer(b, a.size)
    return v1.mixed_layer(input=[
        v1.identity_projection(input=a),
        v1.identity_projection(input=b)], size=a.size)


def _neg(a):
    return v1.slope_intercept_layer(input=a, slope=-1.0)


def _sub(a, b):
    if _is_num(b):
        return v1.slope_intercept_layer(input=a, intercept=-float(b))
    if not isinstance(b, v1.LayerOutput):
        raise TypeError("Layer can only be subtracted with another Layer "
                        "or a number")
    return _add(a, _neg(b))


def _rsub(a, b):
    return _add(_neg(a), b)


def _mul(a, b):
    if _is_num(b):
        return v1.slope_intercept_layer(input=a, slope=float(b))
    if not isinstance(b, v1.LayerOutput):
        raise TypeError("Layer can only be multiplied with another Layer "
                        "or a number")
    if a.size == 1:
        return v1.scaling_layer(input=b, weight=a)
    if b.size == 1:
        return v1.scaling_layer(input=a, weight=b)
    raise TypeError("At least one of the operand of '*' must be a number "
                    "or a Layer with size=1")


v1.LayerOutput.__add__ = _add
v1.LayerOutput.__radd__ = _add
v1.LayerOutput.__neg__ = _neg
v1.LayerOutput.__sub__ = _sub
v1.LayerOutput.__rsub__ = _rsub
v1.LayerOutput.__mul__ = _mul
v1.LayerOutput.__rmul__ = _mul
