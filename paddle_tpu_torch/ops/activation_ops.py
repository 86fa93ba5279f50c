"""Activation ops, the part of ``paddle_tpu/ops/activation_ops.py`` that
the LM tower uses: ``gelu`` in the tanh form, which is ``jax.nn.gelu``'s
default."""

from __future__ import annotations

import torch.nn.functional as F

from .registry import register_op


@register_op("gelu")
def gelu(ctx, ins, attrs):
    return {"Out": [F.gelu(ins["X"][0], approximate="tanh")]}
