"""``cross_entropy``, ``softmax_with_cross_entropy``,
``sigmoid_cross_entropy_with_logits`` and ``accuracy``, the port of their
emitters in ``paddle_tpu/ops/loss_ops.py``: hard labels (int64, gathered
as indices) or soft ones;
``Label`` takes no grad and ``Softmax`` no cotangent; ``accuracy`` is a
metric, not differentiated."""

from __future__ import annotations

import torch

from .activation_ops import _Abs, _softplus
from .registry import register_op


@register_op("cross_entropy", non_diff_inputs=("Label",))
def cross_entropy(ctx, ins, attrs):
    """-log of the label's probability (X holds probabilities), with the
    JAX emitter's 1e-8 inside the log."""
    x = ins["X"][0]
    label = ins["Label"][0]
    eps = 1e-8
    if attrs.get("soft_label", False):
        loss = -(label * torch.log(x + eps)).sum(dim=-1, keepdim=True)
    else:
        idx = label.reshape(x.shape[:-1] + (1,)).long()
        loss = -torch.log(x.gather(-1, idx) + eps)
    return {"Y": [loss]}


@register_op("softmax_with_cross_entropy", non_diff_inputs=("Label",),
             non_diff_outputs=("Softmax",))
def softmax_with_cross_entropy(ctx, ins, attrs):
    logits = ins["Logits"][0]
    label = ins["Label"][0]
    logp = torch.log_softmax(logits, dim=-1)
    if attrs.get("soft_label", False):
        loss = -(label * logp).sum(dim=-1, keepdim=True)
    else:
        idx = label.reshape(logp.shape[:-1] + (1,)).long()
        loss = -logp.gather(-1, idx)
    return {"Loss": [loss], "Softmax": [torch.exp(logp)]}


@register_op("sigmoid_cross_entropy_with_logits", non_diff_inputs=("Label",))
def sigmoid_cross_entropy_with_logits(ctx, ins, attrs):
    """Elementwise max(x, 0) − x·label + softplus(−|x|), written as the
    JAX expression down to its gradient at x = 0 (``jnp.maximum`` splits
    it, ``jnp.abs`` passes +1)."""
    x = ins["X"][0]
    label = ins["Label"][0].to(x.dtype)
    loss = (torch.maximum(x, torch.zeros_like(x)) - x * label
            + _softplus(-_Abs.apply(x)))
    return {"Out": [loss]}


@register_op("accuracy", grad=None)
def accuracy(ctx, ins, attrs):
    """Top-k accuracy from ``top_k``'s indices [N, k]: the share of rows
    whose label is among them (f32 [1]), and the int64 counts."""
    pred = ins["Indices"][0]
    label = ins["Label"][0].reshape(-1, 1)
    correct = (pred == label).any(dim=1).to(torch.float32).sum()
    n = pred.shape[0]
    return {"Accuracy": [(correct / n).reshape(1)],
            "Correct": [correct.to(torch.int64).reshape(1)],
            "Total": [torch.full((1,), n, dtype=torch.int64,
                                 device=pred.device)]}
