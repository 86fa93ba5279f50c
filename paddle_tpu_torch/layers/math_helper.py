"""Python operators on Variables, the port of
``paddle_tpu/layers/math_helper.py``: ``x + y``, ``2.0 - x``, ``x * y``,
``x / 3`` append one elementwise op; a scalar operand becomes a
``fill_constant`` of shape [1] first."""

from __future__ import annotations

import numpy as np


def elementwise_binary(x, other, op_type, reverse=False):
    from ..framework.layer_helper import LayerHelper

    helper = LayerHelper(op_type)
    if np.isscalar(other):
        const = helper.create_tmp_variable(x.dtype, shape=(1,),
                                           stop_gradient=True)
        helper.append_op(
            "fill_constant",
            outputs={"Out": [const.name]},
            attrs={"shape": [1], "value": float(other), "dtype": x.dtype},
        )
        other = const
    a, b = (other, x) if reverse else (x, other)
    out = helper.create_tmp_variable(x.dtype, shape=x.shape)
    helper.append_op(
        op_type,
        inputs={"X": [a.name], "Y": [b.name]},
        outputs={"Out": [out.name]},
        attrs={"axis": -1},
    )
    return out
