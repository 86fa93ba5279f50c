"""``increment``, the part of ``paddle_tpu/layers/control_flow.py`` the
training options use.  ``While``, ``StaticRNN``, ``DynamicRNN``, ``ifelse``
and the tensor arrays are not ported (ROADMAP.md Queue A item 5)."""

from __future__ import annotations

from ..framework.layer_helper import LayerHelper


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_tmp_variable(x.dtype,
                                                        shape=x.shape)
    helper.append_op("increment", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"step": value})
    return out
