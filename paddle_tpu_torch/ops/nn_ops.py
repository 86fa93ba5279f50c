"""``layer_norm``, the port of its emitter in ``paddle_tpu/ops/nn_ops.py``.
The variance is the population variance, as ``jnp.var`` computes it."""

from __future__ import annotations

import torch

from .registry import register_op


@register_op("layer_norm")
def layer_norm(ctx, ins, attrs):
    x = ins["X"][0]
    eps = float(attrs.get("epsilon", 1e-5))
    begin = int(attrs.get("begin_norm_axis", 1))
    axes = tuple(range(begin, x.ndim))
    var, mean = torch.var_mean(x, dim=axes, correction=0, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    if ins.get("Scale") and ins["Scale"][0] is not None:
        y = y * ins["Scale"][0]
    if ins.get("Bias") and ins["Bias"][0] is not None:
        y = y + ins["Bias"][0]
    return {"Y": [y], "Mean": [mean.reshape(-1)],
            "Variance": [var.reshape(-1)]}
