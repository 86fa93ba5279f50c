"""``cross_entropy``, ``softmax_with_cross_entropy``,
``sigmoid_cross_entropy_with_logits``, ``accuracy``, ``chunk_eval``,
``auc``, ``precision_recall`` and ``positive_negative_pair``, the port of
their emitters in ``paddle_tpu/ops/loss_ops.py``: hard labels (int64,
gathered as indices) or soft ones; ``Label`` takes no grad and
``Softmax`` no cotangent; the metrics are not differentiated."""

from __future__ import annotations

import torch

from .activation_ops import _Abs, _softplus
from .cuda_kernels._recurrent import step_mask
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


_NUM_TAG = {"plain": 1, "IOB": 2, "IOE": 2, "IOBES": 4}


def _shifted(x, by):
    """x [B, T] moved one step later (by=1) or earlier (by=-1), -1 in
    the step that opens."""
    edge = torch.full_like(x[:, :1], -1)
    return torch.cat([edge, x[:, :-1]], 1) if by > 0 \
        else torch.cat([x[:, 1:], edge], 1)


def _chunk_markers(labels, lengths, num_chunk_types, scheme):
    """Per-step chunk start, end, type and validity of a [B, T] int tag
    sequence under a CoNLL tagging scheme (tag = type · num_tag + position
    in the chunk; tags from num_chunk_types · num_tag on are outside)."""
    num_tag = _NUM_TAG[scheme]
    valid = (step_mask(lengths, labels.shape[1], torch.int8) > 0) \
        & (labels < num_chunk_types * num_tag)
    neg = torch.full_like(labels, -1)
    ctype = torch.where(valid, labels // num_tag, neg)
    tag = torch.where(valid, labels % num_tag, neg)
    diff_prev = _shifted(ctype, 1) != ctype
    diff_next = _shifted(ctype, -1) != ctype
    prev_tag, next_tag = _shifted(tag, 1), _shifted(tag, -1)
    if scheme == "plain":
        start, end = diff_prev, diff_next
    elif scheme == "IOB":  # B=0 I=1
        start = (tag == 0) | ((tag == 1) & diff_prev)
        end = diff_next | (next_tag == 0)
    elif scheme == "IOE":  # I=0 E=1
        start = diff_prev | (prev_tag == 1)
        end = (tag == 1) | ((tag == 0) & diff_next)
    else:  # IOBES: B=0 I=1 E=2 S=3
        start = (tag == 0) | (tag == 3) | ((tag != -1) & diff_prev)
        end = (tag == 2) | (tag == 3) | ((tag != -1) & diff_next)
    return start & valid, end & valid, ctype


@register_op("chunk_eval", grad=None, non_diff_inputs=("Inference", "Label",
                                                       "Length"))
def chunk_eval(ctx, ins, attrs):
    """Chunk-level precision, recall and F1 (f32 [1]) and the int64 [1]
    counts of inferred, labelled and correct chunks; a chunk is correct
    when a label chunk has its span and type.  One loop over the steps
    carries, per row, whether the two open chunks started together with
    one type and have stayed alike."""
    inf = ins["Inference"][0].to(torch.int32)
    lab = ins["Label"][0].to(torch.int32)
    # each flattened on its own: a [B, T] path against a [B, T, 1] label
    # is the book's pair, which the JAX emitter refuses (ROADMAP.md Queue C)
    if inf.ndim > 2:
        inf = inf.reshape(inf.shape[0], -1)
    if lab.ndim > 2:
        lab = lab.reshape(lab.shape[0], -1)
    B, T = inf.shape
    lengths = (ins["Length"][0].to(torch.int32)
               if ins.get("Length") and ins["Length"][0] is not None
               else torch.full((B,), T, dtype=torch.int32,
                               device=inf.device))
    ncls = int(attrs["num_chunk_types"])
    scheme = attrs.get("chunk_scheme", "IOB")
    i_start, i_end, i_type = _chunk_markers(inf, lengths, ncls, scheme)
    l_start, l_end, l_type = _chunk_markers(lab, lengths, ncls, scheme)
    same = i_type == l_type
    open_ = torch.zeros(B, dtype=torch.bool, device=inf.device)
    correct = torch.zeros(B, dtype=torch.int64, device=inf.device)
    for t in range(T):
        both_start = i_start[:, t] & l_start[:, t] & same[:, t]
        open_ = torch.where(i_start[:, t] | l_start[:, t], both_start, open_)
        open_ = open_ & same[:, t]
        correct += open_ & i_end[:, t] & l_end[:, t]
        open_ = open_ & ~(i_end[:, t] | l_end[:, t])
    n_inf, n_lab, n_correct = (v.sum().reshape(1) for v in
                               (i_start.long(), l_start.long(), correct))
    prec = n_correct.double() / n_inf.clamp(min=1)
    rec = n_correct.double() / n_lab.clamp(min=1)
    f1 = 2 * prec * rec / (prec + rec).clamp(min=1e-6)
    return {"Precision": [prec.float()], "Recall": [rec.float()],
            "F1-Score": [f1.float()], "NumInferChunks": [n_inf],
            "NumLabelChunks": [n_lab], "NumCorrectChunks": [n_correct]}



@register_op("auc", grad=None)
def auc(ctx, ins, attrs):
    """Batch AUC by the rank statistic: ranks 1..n in a stable ascending
    order of the positive-class probability (ties take the lower index
    first, as XLA's sort does)."""
    pred = ins["Predict"][0]
    probs = pred[:, 1] if pred.ndim == 2 else pred
    label = ins["Label"][0].reshape(-1).to(torch.float32)
    order = torch.argsort(probs, stable=True)
    n = probs.shape[0]
    ranks = torch.empty(n, dtype=torch.int64, device=probs.device)
    ranks[order] = torch.arange(1, n + 1, device=probs.device)
    npos = label.sum()
    nneg = label.shape[0] - npos
    auc_v = ((ranks * label).sum() - npos * (npos + 1) / 2) \
        / torch.clamp(npos * nneg, min=1.0)
    return {"AUC": [auc_v.reshape(1)]}


@register_op("precision_recall", grad=None)
def precision_recall(ctx, ins, attrs):
    """Macro precision, recall and F1 over `class_number` classes from
    predicted indices and labels."""
    idx = ins["Indices"][0].reshape(-1)
    label = ins["Label"][0].reshape(-1)
    ncls = int(attrs["class_number"])
    classes = torch.arange(ncls, device=idx.device)
    pred_1h = idx[:, None] == classes[None, :]
    lab_1h = label[:, None] == classes[None, :]
    tp = (pred_1h & lab_1h).sum(0).to(torch.float32)
    fp = (pred_1h & ~lab_1h).sum(0).to(torch.float32)
    fn = (~pred_1h & lab_1h).sum(0).to(torch.float32)
    prec = tp / torch.clamp(tp + fp, min=1.0)
    rec = tp / torch.clamp(tp + fn, min=1.0)
    f1 = 2 * prec * rec / torch.clamp(prec + rec, min=1e-6)
    macro = torch.stack([prec.mean(), rec.mean(), f1.mean()])
    return {"BatchMetrics": [macro], "AccumMetrics": [macro]}


@register_op("positive_negative_pair", grad=None)
def positive_negative_pair(ctx, ins, attrs):
    """Among same-query pairs with different labels, the concordant,
    discordant and tied-score pair counts, each added to its
    ``Accumulate*`` input when given."""
    score = ins["Score"][0].reshape(-1)
    label = ins["Label"][0].reshape(-1).to(torch.float32)
    qid = ins["QueryID"][0].reshape(-1)
    n = score.shape[0]
    same_q = qid[:, None] == qid[None, :]
    upper = torch.ones((n, n), dtype=torch.bool,
                       device=score.device).triu(1)
    informative = same_q & upper & (label[:, None] != label[None, :])
    ds = score[:, None] - score[None, :]
    dl = label[:, None] - label[None, :]

    def count(mask):
        return (informative & mask).sum().to(torch.float32)

    def acc(slot, v):
        if ins.get(slot) and ins[slot][0] is not None:
            v = v + ins[slot][0].reshape(-1)[0]
        return v.reshape(1)

    return {"PositivePair": [acc("AccumulatePositivePair",
                                 count(ds * dl > 0))],
            "NegativePair": [acc("AccumulateNegativePair",
                                 count(ds * dl < 0))],
            "NeutralPair": [acc("AccumulateNeutralPair", count(ds == 0))]}

# ---------------------------------------------------------------------------
# sharding-propagation rule (analysis/sharding.py; mechanism in registry),
# as the JAX package's

from .registry import register_sharding  # noqa: E402


def _swce_sharding(ctx, ins, outs, attrs):
    """Softmax-with-cross-entropy over a vocab-sharded logits tensor
    pays the log-softmax max+sum reductions over the sharded dim (two
    row-shaped all-reduces); row-sharded (batch) logits are free."""
    from ..analysis.sharding import entry_axes

    logits = ins.get("Logits", [None])[0]
    loss = outs.get("Loss", [None])[0]
    soft = outs.get("Softmax", [None])[0]
    if logits is None or not logits.spec:
        return {}
    loss_spec = tuple(logits.spec[:-1]) + (None,)
    vocab_axes = tuple(a for a in entry_axes(logits.spec[-1])
                       if ctx.axis_size(a) > 1)
    if vocab_axes and loss is not None:
        ctx.collective("all-reduce", vocab_axes,
                       2 * ctx.device_bytes(loss.name, loss_spec),
                       var=loss.name,
                       why="log-softmax max+sum over the sharded vocab "
                           "dim", scales_with_axes=True)
    out = {"Loss": [loss_spec]}
    if soft is not None:
        out["Softmax"] = [tuple(logits.spec)]
    return out


register_sharding("softmax_with_cross_entropy", _swce_sharding)
