"""``softmax_with_cross_entropy`` and ``accuracy``, the port of their
emitters in ``paddle_tpu/ops/loss_ops.py``: hard or soft labels;
``Label`` takes no grad and ``Softmax`` no cotangent; ``accuracy`` is a
metric, not differentiated."""

from __future__ import annotations

import torch

from .registry import register_op


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
