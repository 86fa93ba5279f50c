"""``softmax_with_cross_entropy``, the port of its emitter in
``paddle_tpu/ops/loss_ops.py``: hard or soft labels; ``Label`` takes no
grad and ``Softmax`` no cotangent."""

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
