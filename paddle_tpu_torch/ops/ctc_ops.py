"""CTC ops: ``warpctc``, ``ctc_align``, ``edit_distance`` and ``nce``, the
port of ``paddle_tpu/ops/ctc_ops.py`` (reference operators/warpctc_op.cc,
ctc_align_op.cc, edit_distance_op.cc, nce_op.cc).

``warpctc`` is one ATen ``ctc_loss`` call each way (the forward and its
analytic backward), where the JAX emitter runs the log-space alpha
recursion as one ``lax.scan``: a T-step loop here would cost ~10 launches
a frame.  Around the call the op gives the JAX emitter's answer where the
two differ:

- an infeasible alignment (a label longer than its frames allow) costs
  ``-NEG_INF`` = 1e30, the JAX emitter's floor, where ATen gives ``inf``;
  its gradient is zero (``zero_infinity``), where JAX's is whatever its
  rounded -1e30 terms give;
- a logit length of 0 reads the first frame, as the JAX recursion starts
  from it (ATen would give ``inf``);
- [B, L, 1] labels lose their last axis, and logits that are neither f32
  nor f64 are computed in f32.

``norm_by_times`` is recorded by the layers and not read, as in JAX.  The
op declares the reference's ``WarpCTCGrad`` output (dLoss/dLogits at the
forward), which no emitter writes: the registry lists it in
``unwritten_outputs`` and the executor binds nothing to it.

``ctc_align`` left-packs the kept tokens with one scatter into a scratch
column; ``edit_distance`` runs the Levenshtein DP one hypothesis step at a
time, each step's row a prefix minimum (one ``torch.cummin``), with no
length read on the host; ``nce`` draws its negatives from the op's
generator (``draws_rng``)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .registry import register_op

NEG_INF = -1e30


@register_op("warpctc", non_diff_inputs=("Label", "LogitsLength",
                                         "LabelLength"),
             unwritten_outputs=("WarpCTCGrad",))
def warpctc(ctx, ins, attrs):
    """Logits [B, T, C] (unnormalized), Label [B, L] int (padded),
    LogitsLength [B], LabelLength [B]; attr blank (default 0).  Loss
    [B, 1] = -log p(label | logits) per sequence."""
    logits = ins["Logits"][0]
    if logits.dtype not in (torch.float32, torch.float64):
        logits = logits.float()
    labels = ins["Label"][0]
    if labels.ndim == 3 and labels.shape[-1] == 1:
        labels = labels[..., 0]
    labels = labels.long()
    logit_lens = torch.clamp(ins["LogitsLength"][0].reshape(-1).long(),
                             min=1)
    label_lens = ins["LabelLength"][0].reshape(-1).long()
    blank = int(attrs.get("blank", 0))
    logp = torch.log_softmax(logits, dim=-1).transpose(0, 1)  # [T, B, C]
    loss = F.ctc_loss(logp, labels, logit_lens, label_lens, blank=blank,
                      reduction="none", zero_infinity=True)
    # zero_infinity gives the infeasible rows 0 and a zero gradient; their
    # loss becomes JAX's floor
    infeasible = _infeasible(labels, logit_lens, label_lens)
    loss = torch.where(infeasible, loss.new_tensor(-NEG_INF), loss)
    return {"Loss": [loss[:, None]]}


def _infeasible(labels, logit_lens, label_lens):
    """Rows whose label needs more frames than they have: one per token
    plus one blank between each pair of equal neighbours."""
    l = labels.shape[1]
    pos = torch.arange(l, device=labels.device)
    live = pos[None, :] < label_lens[:, None]
    repeats = torch.zeros_like(labels, dtype=torch.bool)
    if l > 1:
        repeats[:, 1:] = (labels[:, 1:] == labels[:, :-1]) & live[:, 1:]
    need = label_lens + repeats.sum(1)
    return need > logit_lens


@register_op("ctc_align", grad=None)
def ctc_align(ctx, ins, attrs):
    """Greedy CTC post-processing: collapse repeats, drop blanks, Output
    [B, T] int32 left-packed and zero past OutputLength [B]."""
    ids = ins["Input"][0].to(torch.int32)
    lengths = ins["Length"][0].reshape(-1)
    blank = int(attrs.get("blank", 0))
    b, t = ids.shape
    prev = torch.cat([ids.new_full((b, 1), -1), ids[:, :-1]], dim=1)
    valid = torch.arange(t, device=ids.device)[None, :] < lengths[:, None]
    keep = (ids != blank) & (ids != prev) & valid
    pos = torch.cumsum(keep, dim=1) - 1
    # dropped slots all write 0 into the scratch column t
    out = ids.new_zeros((b, t + 1))
    out.scatter_(1, torch.where(keep, pos, t),
                 torch.where(keep, ids, torch.zeros_like(ids)))
    return {"Output": [out[:, :t].contiguous()],
            "OutputLength": [keep.sum(1).to(torch.int32)]}


@register_op("edit_distance", grad=None)
def edit_distance(ctx, ins, attrs):
    """Levenshtein distance per pair: Hyps [B, Lh], Refs [B, Lr] with
    their lengths; attr normalized (default True) divides by the reference
    length.  Out [B, 1] f32, SequenceNum [1] int64 = B.

    The DP walks the hypothesis steps; within a step the left-to-right
    recurrence ``col_j = min(rest_j, col_{j-1} + 1)`` from ``col_-1 =
    first`` is ``j + min(cummin(rest_k - k)_j, first + 1)``."""
    hyp = ins["Hyps"][0].to(torch.int32)
    ref = ins["Refs"][0].to(torch.int32)
    hyp_len = ins["HypsLength"][0].reshape(-1)
    ref_len = ins["RefsLength"][0].reshape(-1).long()
    b, lh = hyp.shape
    lr = ref.shape[1]
    j = torch.arange(lr, dtype=torch.float32, device=hyp.device)
    row = torch.arange(lr + 1, dtype=torch.float32,
                       device=hyp.device)[None, :].expand(b, lr + 1)
    for i in range(lh):
        sub = (ref != hyp[:, i:i + 1]).to(torch.float32)
        rest = torch.minimum(row[:, :-1] + sub, row[:, 1:] + 1.0)
        first = row[:, :1] + 1.0
        cols = j + torch.minimum(torch.cummin(rest - j, dim=1).values,
                                 first + 1.0)
        new = torch.cat([first, cols], dim=1)
        row = torch.where((i < hyp_len)[:, None], new, row)
    dist = row.gather(1, ref_len[:, None])[:, 0]
    if attrs.get("normalized", True):
        dist = dist / torch.clamp(ref_len.to(torch.float32), min=1.0)
    return {"Out": [dist[:, None]],
            "SequenceNum": [torch.tensor([b], dtype=torch.int64,
                                         device=hyp.device)]}


@register_op("nce", non_diff_inputs=("Label",), draws_rng=True)
def nce(ctx, ins, attrs):
    """Noise-contrastive estimation: Input [B, D], Weight [C, D], Bias
    [C], Label [B, 1]; num_neg_samples negatives a row drawn uniformly
    from [0, C) with the op's generator (the grad op's re-run draws the
    same ones).  Cost [B, 1], SampleLogits [B, k], SampleLabels [B, k]
    int32."""
    x = ins["Input"][0]
    w = ins["Weight"][0]
    bias = ins["Bias"][0] if ins.get("Bias") and ins["Bias"][0] is not None \
        else None
    label = ins["Label"][0].reshape(-1).long()
    k = int(attrs.get("num_neg_samples", 10))
    c = w.shape[0]
    b = x.shape[0]
    neg = torch.randint(0, c, (b, k), generator=ctx.generator(attrs),
                        device=x.device)
    pos_logit = (w[label] * x).sum(-1)
    neg_logit = (w[neg] * x[:, None, :]).sum(-1)
    if bias is not None:
        pos_logit = pos_logit + bias[label]
        neg_logit = neg_logit + bias[neg]
    log_q = -math.log(float(c))  # uniform noise
    cost = -(F.logsigmoid(pos_logit - log_q)
             + F.logsigmoid(-(neg_logit - log_q)).sum(1))
    return {"Cost": [cost[:, None]], "SampleLogits": [neg_logit],
            "SampleLabels": [neg.to(torch.int32)]}
