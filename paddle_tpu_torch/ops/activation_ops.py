"""Activation ops, the part of ``paddle_tpu/ops/activation_ops.py`` that
the ported models use: ``gelu`` in the tanh form, which is
``jax.nn.gelu``'s default (the LM tower), and ``tanh`` (the NMT decoder's
initial state)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register_op


@register_op("gelu")
def gelu(ctx, ins, attrs):
    return {"Out": [F.gelu(ins["X"][0], approximate="tanh")]}


@register_op("tanh")
def tanh(ctx, ins, attrs):
    return {"Out": [torch.tanh(ins["X"][0])]}
