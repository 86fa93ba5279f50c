"""Activation ops, the part of ``paddle_tpu/ops/activation_ops.py`` that
the ported models use: ``gelu`` in the tanh form, which is
``jax.nn.gelu``'s default (the LM tower), ``tanh`` (the NMT decoder's
initial state), ``relu`` and ``softmax`` (ResNet)."""

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


@register_op("relu")
def relu(ctx, ins, attrs):
    return {"Out": [torch.relu(ins["X"][0])]}


@register_op("softmax")
def softmax(ctx, ins, attrs):
    return {"Out": [torch.softmax(ins["X"][0], dim=-1)]}
