"""The loss and metric ops, the port of ``paddle_tpu/ops/loss_ops.py``:
``cross_entropy``, ``softmax_with_cross_entropy``,
``sigmoid_cross_entropy_with_logits``, the regression and ranking losses
(``log_loss``, ``hinge_loss``, ``huber_loss``, ``smooth_l1_loss``,
``rank_loss``, ``margin_rank_loss``, ``modified_huber_loss``), the v1
costs (``hsigmoid``, ``huber_classification``, ``cross_entropy_selfnorm``,
``lambda_rank``, ``cross_entropy_over_beam``), and the metrics
``accuracy``, ``chunk_eval``, ``auc``, ``precision_recall`` and
``positive_negative_pair``: hard labels (int64, gathered as indices) or
soft ones; ``Label`` takes no grad and ``Softmax`` no cotangent; the
metrics are not differentiated.  Each loss is the JAX expression in
torch down to its gradient at a kink: ``jnp.maximum`` splits it at a tie
(``torch.maximum`` does too), ``jnp.abs`` passes +1 at 0 (``_Abs``)."""

from __future__ import annotations

import torch

import math

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


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


@register_op("log_loss", non_diff_inputs=("Labels",))
def log_loss(ctx, ins, attrs):
    p = ins["Predicted"][0]
    y = ins["Labels"][0]
    eps = float(attrs.get("epsilon", 1e-7))
    return {"Loss": [-(y * torch.log(p + eps)
                       + (1 - y) * torch.log(1 - p + eps))]}


@register_op("hinge_loss", non_diff_inputs=("Labels",))
def hinge_loss(ctx, ins, attrs):
    logits = ins["Logits"][0]
    y = ins["Labels"][0]
    return {"Loss": [torch.maximum(_zero(logits),
                                   1.0 - (2 * y - 1) * logits)]}


@register_op("huber_loss")
def huber_loss(ctx, ins, attrs):
    """0.5·r² where |r| ≤ delta, else delta·(|r| − delta/2); r = Y − X is
    the Residual output."""
    x, y = ins["X"][0], ins["Y"][0]
    d = float(attrs.get("delta", 1.0))
    r = y - x
    a = _Abs.apply(r)
    return {"Out": [torch.where(a <= d, 0.5 * r * r, d * (a - 0.5 * d))],
            "Residual": [r]}


@register_op("smooth_l1_loss")
def smooth_l1_loss(ctx, ins, attrs):
    """Per row the sum of 0.5·(σd)² where |d| < 1/σ², else |d| − 0.5/σ²,
    d = (X − Y)·InsideWeight, each term times OutsideWeight; Diff is d."""
    x, y = ins["X"][0], ins["Y"][0]
    sigma = float(attrs.get("sigma", 1.0))
    s2 = sigma * sigma
    d = x - y
    if ins.get("InsideWeight") and ins["InsideWeight"][0] is not None:
        d = d * ins["InsideWeight"][0]
    a = _Abs.apply(d)
    per = torch.where(a < 1.0 / s2, 0.5 * d * d * s2, a - 0.5 / s2)
    if ins.get("OutsideWeight") and ins["OutsideWeight"][0] is not None:
        per = per * ins["OutsideWeight"][0]
    out = torch.sum(per.reshape(per.shape[0], -1), dim=1, keepdim=True)
    return {"Out": [out], "Diff": [d]}


@register_op("rank_loss", non_diff_inputs=("Label",))
def rank_loss(ctx, ins, attrs):
    """RankNet's pairwise cost softplus(L − R) − Label·(L − R)."""
    d = ins["Left"][0] - ins["Right"][0]
    return {"Out": [_softplus(d) - ins["Label"][0] * d]}


@register_op("margin_rank_loss", non_diff_inputs=("Label",))
def margin_rank_loss(ctx, ins, attrs):
    label = ins["Label"][0]
    x1, x2 = ins["X1"][0], ins["X2"][0]
    margin = float(attrs.get("margin", 0.0))
    out = torch.maximum(_zero(x1), -label * (x1 - x2) + margin)
    return {"Out": [out], "Activated": [(out > 0).to(x1.dtype)]}


@register_op("modified_huber_loss", non_diff_inputs=("Y",))
def modified_huber_loss(ctx, ins, attrs):
    x = ins["X"][0]
    z = (2 * ins["Y"][0].to(x.dtype) - 1) * x
    loss = torch.where(z < -1, -4 * z, torch.maximum(_zero(z), 1 - z) ** 2)
    return {"Out": [loss], "IntermediateVal": [z]}


@register_op("hsigmoid", non_diff_inputs=("Label",))
def hsigmoid(ctx, ins, attrs):
    """Hierarchical sigmoid over a complete binary tree of `num_classes`
    leaves: the label's leaf is heap position label + num_classes, each
    of its ancestors (node >> k, 1-based) an internal node with a row of
    W [C−1, D] (and of Bias); the cost is the sum over the path of
    softplus(−t·z), t = +1 for a right child (bit 1), −1 for a left one,
    z = X·W[node] (+ Bias[node]), over the static depth ceil(log2 C) with
    the ancestors past the root masked."""
    x = ins["X"][0]
    w = ins["W"][0]
    label = ins["Label"][0].reshape(-1).long()
    bias = ins["Bias"][0] if ins.get("Bias") and ins["Bias"][0] is not None \
        else None
    num_classes = int(attrs["num_classes"])
    depth = max(int(math.ceil(math.log2(num_classes))), 1)
    code = label + num_classes
    losses = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for k in range(1, depth + 1):
        node = code >> k
        valid = node >= 1
        idx = torch.clamp(node - 1, 0, num_classes - 2)
        bit = (code >> (k - 1)) & 1
        z = torch.sum(x * w[idx], dim=1)
        if bias is not None:
            z = z + bias.reshape(-1)[idx]
        t = 2.0 * bit.to(x.dtype) - 1.0
        losses = losses + torch.where(valid, _softplus(-t * z), _zero(z))
    return {"Out": [losses[:, None]]}


@register_op("huber_classification", non_diff_inputs=("Label",))
def huber_classification(ctx, ins, attrs):
    """The two-class Huber cost of labels {0, 1} as y = ±1 and m = y·f:
    −4m below −1, (1 − m)² up to 1, 0 above."""
    f = ins["X"][0].reshape(-1)
    y = ins["Label"][0].reshape(-1).to(torch.float32) * 2.0 - 1.0
    m = y * f
    loss = torch.where(m < -1.0, -4.0 * m,
                       torch.where(m < 1.0, (1.0 - m) ** 2, _zero(m)))
    return {"Out": [loss.reshape(-1, 1)]}


@register_op("cross_entropy_selfnorm", non_diff_inputs=("Label",))
def cross_entropy_selfnorm(ctx, ins, attrs):
    """−log(X[label] / Z) + alpha·log(Z)² over positive unnormalized rows,
    Z the row sum."""
    x = ins["X"][0]
    label = ins["Label"][0].reshape(-1).long()
    alpha = float(attrs.get("softmax_selfnorm_alpha", 0.1))
    eps = 1e-8
    z = torch.sum(x, dim=-1)
    picked = x.gather(1, label[:, None])[:, 0]
    ce = -torch.log(picked / (z + eps) + eps)
    return {"Out": [(ce + alpha * torch.log(z + eps) ** 2).reshape(-1, 1)]}


@register_op("lambda_rank", non_diff_inputs=("Score", "Length"))
def lambda_rank(ctx, ins, attrs):
    """LambdaRank over padded queries: X scores and Score relevances [B,
    T] (or [B, T, 1]), Length valid counts.  Each pair of valid documents
    with rel_i > rel_j costs log(1 + exp(−(s_i − s_j))) times |ΔNDCG| of
    swapping them: gains 2^rel − 1, discounts 1/log2(rank + 2) by the
    rank in a stable descending sort of the scores, over the ideal DCG of
    the top min(NDCG_num, T) relevances (at least 1e-6)."""
    s = ins["X"][0]
    rel = ins["Score"][0]
    if s.ndim == 3:
        s = s[..., 0]
    if rel.ndim == 3:
        rel = rel[..., 0]
    lengths = ins["Length"][0].reshape(-1).long()
    ndcg_num = int(attrs.get("NDCG_num", 5))
    B, T = s.shape
    k = min(ndcg_num, T)
    dev = s.device
    valid = torch.arange(T, device=dev)[None, :] < lengths[:, None]
    relf = rel.to(torch.float32)
    gain = 2.0 ** relf - 1.0
    inf = torch.tensor(math.inf, device=dev)
    topk = torch.sort(torch.where(valid, relf, -inf), dim=1,
                      descending=True).values[:, :k]
    disc = 1.0 / torch.log2(torch.arange(k, device=dev,
                                         dtype=torch.float32) + 2.0)
    idcg = torch.sum(torch.where(torch.isfinite(topk),
                                 (2.0 ** topk - 1.0) * disc[None, :],
                                 torch.zeros((), device=dev)), dim=1)
    idcg = torch.clamp(idcg, min=1e-6)
    sf = s.to(torch.float32)
    order = torch.argsort(torch.argsort(
        torch.where(valid, -sf.detach(), inf), dim=1, stable=True),
        dim=1, stable=True)
    dr = 1.0 / torch.log2(order.to(torch.float32) + 2.0)
    pair_valid = (valid[:, :, None] & valid[:, None, :]
                  & (relf[:, :, None] > relf[:, None, :]))
    delta_ndcg = torch.abs((gain[:, :, None] - gain[:, None, :])
                           * (dr[:, :, None] - dr[:, None, :])) \
        / idcg[:, None, None]
    sdiff = sf[:, :, None] - sf[:, None, :]
    pair_loss = torch.logaddexp(torch.zeros_like(sdiff), -sdiff)
    loss = torch.sum(torch.where(pair_valid, delta_ndcg * pair_loss,
                                 torch.zeros((), device=dev)), dim=(1, 2))
    return {"Out": [loss.reshape(-1, 1)]}


@register_op("cross_entropy_over_beam",
             non_diff_inputs=("Ids", "Label", "Length"))
def cross_entropy_over_beam(ctx, ins, attrs):
    """The negative log-likelihood of the gold candidate under a softmax
    over the beam's candidates: X [B, T] (or [B, T, 1]) raw scores, Ids
    [B, K] the selected positions, Label [B, 1] the gold position, an
    optional Length [B] of valid candidates (a padded slot, id ≥ length,
    leaves the softmax).  A gold outside the beam costs −log(1e-10) with
    no gradient."""
    x = ins["X"][0]
    if x.ndim == 3:
        x = x[..., 0]
    ids = ins["Ids"][0].long()
    gold = ins["Label"][0].reshape(-1).long()
    fdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    sel = x.to(fdt).gather(1, ids)
    valid = torch.ones(ids.shape, dtype=torch.bool, device=x.device)
    if ins.get("Length") and ins["Length"][0] is not None:
        valid = ids < ins["Length"][0].reshape(-1).long()[:, None]
    ninf = torch.tensor(-math.inf, dtype=fdt, device=x.device)
    sel = torch.where(valid, sel, ninf)
    logp = sel - torch.amax(sel, dim=1, keepdim=True)
    logp = logp - torch.log(torch.sum(
        torch.where(valid, torch.exp(logp), _zero(logp)), dim=1,
        keepdim=True))
    hit = (ids == gold[:, None]) & valid
    in_beam = hit.any(dim=1)
    gold_logp = torch.sum(torch.where(hit, logp, _zero(logp)), dim=1)
    floor = torch.log(torch.tensor(1e-10, dtype=fdt, device=x.device))
    loss = torch.where(in_beam, -gold_logp, -floor)
    return {"Out": [loss.reshape(-1, 1)]}


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
