"""Comparison, logical and ``select`` ops, the port of
``paddle_tpu/ops/control_flow_ops.py:34-77``: each comparison gives a bool
tensor and takes no gradient; ``select`` is ``Mask ? X : Y`` by
``torch.where``, the mask broadcast from its trailing side (the
piecewise learning-rate schedule chooses its segment with it, on the
device).  ``While``, ``cond`` and the tensor arrays are not ported
(ROADMAP.md Queue A item 5)."""

from __future__ import annotations

import torch

from .registry import register_op


def _cmp(fn):
    def emit(ctx, ins, attrs):
        return {"Out": [fn(ins["X"][0], ins["Y"][0])]}

    return emit


for _name, _fn in [
    ("less_than", torch.lt),
    ("less_equal", torch.le),
    ("greater_than", torch.gt),
    ("greater_equal", torch.ge),
    ("equal", torch.eq),
    ("not_equal", torch.ne),
    ("logical_and", torch.logical_and),
    ("logical_or", torch.logical_or),
    ("logical_xor", torch.logical_xor),
]:
    register_op(_name, _cmp(_fn), grad=None)

register_op("logical_not", lambda ctx, ins, attrs: {
    "Out": [torch.logical_not(ins["X"][0])]}, grad=None)


@register_op("select", non_diff_inputs=("Mask",))
def select(ctx, ins, attrs):
    """Out = Mask ? X : Y, with Mask broadcast from [B, 1]."""
    mask = ins["Mask"][0]
    x, y = ins["X"][0], ins["Y"][0]
    while mask.ndim < max(x.ndim, y.ndim):
        mask = mask[..., None]
    return {"Out": [torch.where(mask != 0, x, y)]}
