"""Object-detection ops: ``iou_similarity``, ``box_coder``, ``prior_box``,
``roi_pool``, ``multibox_loss`` and ``detection_output``, the port of
``paddle_tpu/ops/detection_ops.py`` (reference gserver/layers/{PriorBox,
MultiBoxLossLayer,DetectionOutputLayer,ROIPoolLayer}.cpp,
operators/detection_output_op.cc, roi_pool_op.cc, math/detection_util.h).

Every shape is static, as in the JAX package: ground truth arrives padded
with a per-image count, NMS keeps a fixed ``keep_top_k`` slate padded
with -1 labels, and ROI bins are masked maxima.  Ties break as XLA breaks
them, at the lowest index: ``argmax`` takes the first maximum, and every
sort that ranks (the hard negatives, ``top_k``) is a stable one.
``roi_pool``'s gradient goes through ``amax``, which splits it among tied
maxima as ``jnp.max``'s does.  Greedy NMS loops over its ``nms_top_k``
candidates only, vectorised over images and classes."""

from __future__ import annotations

import torch

from .registry import register_op


def _iou_matrix(a, b):
    """a [.., N, 4], b [.., M, 4] (xmin, ymin, xmax, ymax) → [.., N, M]."""
    ax1, ay1, ax2, ay2 = (a[..., :, None, i] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, i] for i in range(4))
    iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1),
                     min=0.0)
    ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                     min=0.0)
    inter = iw * ih
    area_a = torch.clamp(ax2 - ax1, min=0.0) * torch.clamp(ay2 - ay1, min=0.0)
    area_b = torch.clamp(bx2 - bx1, min=0.0) * torch.clamp(by2 - by1, min=0.0)
    return inter / torch.clamp(area_a + area_b - inter, min=1e-10)


def _center_size(box):
    """Corner boxes [.., 4] → (width, height, centre x, centre y)."""
    return (box[..., 2] - box[..., 0], box[..., 3] - box[..., 1],
            (box[..., 0] + box[..., 2]) / 2, (box[..., 1] + box[..., 3]) / 2)


def _encode(gt, prior, pvar):
    """Center-size offsets of boxes `gt` [.., P, 4] against `prior` [P, 4]
    with variances `pvar` [P, 4]."""
    gw, gh, gcx, gcy = _center_size(gt)
    pw, ph, pcx, pcy = _center_size(prior)
    return torch.stack([
        (gcx - pcx) / pw / pvar[:, 0],
        (gcy - pcy) / ph / pvar[:, 1],
        torch.log(torch.clamp(gw / pw, min=1e-10)) / pvar[:, 2],
        torch.log(torch.clamp(gh / ph, min=1e-10)) / pvar[:, 3],
    ], dim=-1)


def _decode(loc, prior, pvar):
    """Corner boxes from offsets `loc` [.., P, 4] against `prior` [P, 4]."""
    pw, ph, pcx, pcy = _center_size(prior)
    cx = loc[..., 0] * pvar[:, 0] * pw + pcx
    cy = loc[..., 1] * pvar[:, 1] * ph + pcy
    w = torch.exp(loc[..., 2] * pvar[:, 2]) * pw
    h = torch.exp(loc[..., 3] * pvar[:, 3]) * ph
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def _top_k(x, k):
    """``lax.top_k`` along the last axis: the k largest, descending, ties
    in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@register_op("iou_similarity", grad=None)
def iou_similarity(ctx, ins, attrs):
    """Pairwise IoU: X [N, 4] against Y [M, 4] → [N, M]."""
    return {"Out": [_iou_matrix(ins["X"][0], ins["Y"][0])]}


@register_op("box_coder", grad=None,
             non_diff_inputs=("PriorBox", "PriorBoxVar"))
def box_coder(ctx, ins, attrs):
    """``encode_center_size``: TargetBox [G, 4] corners → offsets
    [G, P, 4]; ``decode_center_size``: offsets [.., P, 4] → corners."""
    prior = ins["PriorBox"][0]
    pvar = ins["PriorBoxVar"][0]
    tb = ins["TargetBox"][0]
    if attrs.get("code_type", "encode_center_size") == "encode_center_size":
        out = _encode(tb[:, None, :], prior, pvar)
    else:
        out = _decode(tb, prior, pvar)
    return {"OutputBox": [out]}


@register_op("prior_box", grad=None)
def prior_box(ctx, ins, attrs):
    """SSD prior boxes for one feature map: per cell one box per
    min_size, one sqrt(min·max) box per max_size and one per extra aspect
    ratio (and its flip), normalised to [0, 1] and optionally clipped.
    Boxes and Variances [H, W, num_priors, 4] f32."""
    feat = ins["Input"][0]
    img = ins["Image"][0]
    h, w = feat.shape[2], feat.shape[3]
    ih, iw = img.shape[2], img.shape[3]
    min_sizes = [float(s) for s in attrs["min_sizes"]]
    max_sizes = [float(s) for s in attrs.get("max_sizes", [])]
    if max_sizes and len(max_sizes) != len(min_sizes):
        raise ValueError(
            f"prior_box: max_sizes (len {len(max_sizes)}) must be empty or "
            f"match min_sizes (len {len(min_sizes)})")
    ars = [1.0]
    for ar in attrs.get("aspect_ratios", []):
        ar = float(ar)
        if all(abs(ar - a) > 1e-6 for a in ars):
            ars.append(ar)
            if attrs.get("flip", True):
                ars.append(1.0 / ar)
    variances = [float(v) for v in attrs.get("variances",
                                             [0.1, 0.1, 0.2, 0.2])]
    step_w = float(attrs.get("step_w", 0.0)) or iw / w
    step_h = float(attrs.get("step_h", 0.0)) or ih / h
    offset = float(attrs.get("offset", 0.5))
    dev = ctx.device
    f32 = torch.float32
    cx = (torch.arange(w, dtype=f32, device=dev) + offset) * step_w
    cy = (torch.arange(h, dtype=f32, device=dev) + offset) * step_h
    ws, hs = [], []
    for i, ms in enumerate(min_sizes):
        ws.append(ms)
        hs.append(ms)
        if max_sizes:
            s = (ms * max_sizes[i]) ** 0.5
            ws.append(s)
            hs.append(s)
        for ar in ars:
            if abs(ar - 1.0) < 1e-6:
                continue
            ws.append(ms * ar ** 0.5)
            hs.append(ms / ar ** 0.5)
    bw = torch.tensor(ws, dtype=f32, device=dev)[None, None, :]
    bh = torch.tensor(hs, dtype=f32, device=dev)[None, None, :]
    full = (h, w, bw.shape[-1])
    ccx = cx[None, :, None].expand(full)
    ccy = cy[:, None, None].expand(full)
    bw, bh = bw.expand(full), bh.expand(full)
    boxes = torch.stack([(ccx - bw / 2) / iw, (ccy - bh / 2) / ih,
                         (ccx + bw / 2) / iw, (ccy + bh / 2) / ih], dim=-1)
    if attrs.get("clip", True):
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = torch.tensor(variances, dtype=f32, device=dev).expand(
        boxes.shape).contiguous()
    return {"Boxes": [boxes], "Variances": [var]}


@register_op("roi_pool", non_diff_inputs=("ROIs",),
             unwritten_outputs=("Argmax",))
def roi_pool(ctx, ins, attrs):
    """ROI max pooling: each ROI (batch index, x1, y1, x2, y2) split into
    pooled_height × pooled_width bins, the max over each; an empty bin
    gives 0.  Bins are [R, bins, H] and [R, bins, W] membership masks and
    two masked maxima.  The v1 layer declares the reference's ``Argmax``
    output, which no emitter writes (``unwritten_outputs``)."""
    x = ins["X"][0]
    rois = ins["ROIs"][0]
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    scale = float(attrs.get("spatial_scale", 1.0))
    _, _, h, w = x.shape
    batch_idx = rois[:, 0].long()
    x1 = torch.round(rois[:, 1] * scale)
    y1 = torch.round(rois[:, 2] * scale)
    x2 = torch.round(rois[:, 3] * scale)
    y2 = torch.round(rois[:, 4] * scale)
    roi_w = torch.clamp(x2 - x1 + 1, min=1.0)
    roi_h = torch.clamp(y2 - y1 + 1, min=1.0)

    def bin_mask(start, extent, bins, size):
        i = torch.arange(bins, dtype=start.dtype, device=start.device)[None]
        lo = torch.floor(start[:, None] + i * extent[:, None] / bins)
        hi = torch.ceil(start[:, None] + (i + 1) * extent[:, None] / bins)
        c = torch.arange(size, dtype=start.dtype,
                         device=start.device)[None, None, :]
        return (c >= lo[..., None]) & (c < hi[..., None])

    mh = bin_mask(y1, roi_h, ph, h)  # [R, ph, H]
    mw = bin_mask(x1, roi_w, pw, w)  # [R, pw, W]
    xg = x[batch_idx]  # [R, C, H, W]
    neg = torch.finfo(x.dtype).min
    fill = x.new_tensor(neg)
    t = torch.where(mw[:, None, None], xg[:, :, :, None, :], fill).amax(-1)
    out = torch.where(mh[:, None, :, None, :],
                      t.movedim(2, -1)[:, :, None], fill).amax(-1)
    any_h = mh.any(-1)[:, None, :, None]
    any_w = mw.any(-1)[:, None, None, :]
    return {"Out": [torch.where(any_h & any_w, out, x.new_zeros(()))]}


@register_op("multibox_loss", non_diff_inputs=("PriorBox", "PriorBoxVar",
                                               "GtBox", "GtLabel", "GtCount"))
def multibox_loss(ctx, ins, attrs):
    """SSD training loss: priors matched to padded ground truth by IoU
    (each valid ground truth first claims its best prior), smooth-L1 on
    the matched priors' offsets, softmax cross-entropy with hard-negative
    mining at ``neg_pos_ratio``; Loss [N] over the matched count.  Two
    ground truths claiming one prior land in an undefined order, as in
    JAX."""
    loc = ins["Loc"][0]  # [N, P, 4]
    conf = ins["Conf"][0]  # [N, P, K]
    prior = ins["PriorBox"][0]  # [P, 4]
    pvar = ins["PriorBoxVar"][0]
    gt = ins["GtBox"][0]  # [N, G, 4]
    gt_label = ins["GtLabel"][0].long()  # [N, G]
    gt_count = ins["GtCount"][0].reshape(-1).long()  # [N]
    thresh = float(attrs.get("overlap_threshold", 0.5))
    neg_ratio = float(attrs.get("neg_pos_ratio", 3.0))
    bg = int(attrs.get("background_label", 0))
    n, p, _ = conf.shape
    g = gt.shape[1]
    dev = conf.device

    valid_gt = torch.arange(g, device=dev)[None, :] < gt_count[:, None]
    iou = _iou_matrix(prior, gt)  # [N, P, G]
    iou = torch.where(valid_gt[:, None, :], iou, iou.new_tensor(-1.0))
    best_iou, best_gt = iou.max(dim=2)  # first maximum, as XLA's argmax
    best_prior = iou.argmax(dim=1)  # [N, G]
    # padded ground truths claim the scratch slot p
    safe_prior = torch.where(valid_gt, best_prior, p)
    claimed = torch.zeros((n, p + 1), dtype=torch.bool, device=dev)
    claimed.scatter_(1, safe_prior, True)
    claimed = claimed[:, :p]
    matched = claimed | (best_iou >= thresh)
    gt_of_claim = torch.full((n, p + 1), -1, dtype=torch.long, device=dev)
    gt_of_claim.scatter_(1, safe_prior,
                         torch.arange(g, device=dev)[None, :].expand(n, g))
    gt_of_claim = gt_of_claim[:, :p]
    match_gt = torch.where(gt_of_claim >= 0, gt_of_claim, best_gt)

    mg = gt.gather(1, match_gt[..., None].expand(n, p, 4))  # [N, P, 4]
    d = loc - _encode(mg, prior, pvar).detach()
    ad = d.abs()
    sl1 = torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5)
    loc_loss = (sl1.sum(-1) * matched).sum(1)

    tgt_label = torch.where(matched, gt_label.gather(1, match_gt),
                            torch.full_like(match_gt, bg))
    logp = torch.log_softmax(conf, dim=-1)
    ce = -logp.gather(2, tgt_label[..., None])[..., 0]
    npos = matched.sum(1)
    nneg = torch.clamp((neg_ratio * npos.to(torch.float32)).to(torch.int64),
                       max=p)
    neg_score = torch.where(matched, ce.new_tensor(-float("inf")),
                            ce.detach())
    order = torch.argsort(-neg_score, dim=1, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(p, device=dev)[None, :].expand(n, p))
    selected_neg = (rank < nneg[:, None]) & ~matched
    conf_loss = (ce * (matched | selected_neg)).sum(1)
    denom = torch.clamp(npos.to(conf.dtype), min=1.0)
    return {"Loss": [(loc_loss + conf_loss) / denom]}


@register_op("detection_output", grad=None)
def detection_output(ctx, ins, attrs):
    """Inference head: decode the offsets against the priors, softmax the
    class scores, greedy NMS per foreground class over its ``nms_top_k``
    best, then the ``keep_top_k`` best of all classes per image: Out
    [N, keep_top_k, 6] rows (label, score, x1, y1, x2, y2), label -1 for
    padding."""
    loc = ins["Loc"][0]  # [N, P, 4]
    conf = ins["Conf"][0]  # [N, P, K]
    prior = ins["PriorBox"][0]
    pvar = ins["PriorBoxVar"][0]
    n, p, k_cls = conf.shape
    score_thresh = float(attrs.get("score_threshold", 0.01))
    nms_thresh = float(attrs.get("nms_threshold", 0.45))
    nms_top_k = int(attrs.get("nms_top_k", 64))
    keep_top_k = int(attrs.get("keep_top_k", 16))
    bg = int(attrs.get("background_label", 0))
    dev = conf.device

    scores = torch.softmax(conf, dim=-1)
    boxes = _decode(loc, prior, pvar)  # [N, P, 4]
    fg = [c for c in range(k_cls) if c != bg]
    sc = scores[:, :, fg].transpose(1, 2)  # [N, F, P]
    k = min(nms_top_k, p)
    top_s, top_i = _top_k(sc, k)  # [N, F, k]
    nf = len(fg)
    top_b = boxes[:, None].expand(n, nf, p, 4).gather(
        2, top_i[..., None].expand(n, nf, k, 4))  # [N, F, k, 4]
    over = _iou_matrix(top_b, top_b) > nms_thresh  # [N, F, k, k]
    keep = top_s > score_thresh
    pos = torch.arange(k, device=dev)
    for i in range(k):
        earlier = (pos < i) & keep
        sup = (over[..., i, :] & earlier).any(-1)
        keep[..., i] &= ~sup
    s = (top_s * keep).reshape(n, nf * k)
    b = top_b.reshape(n, nf * k, 4)
    lbl = torch.tensor(fg, dtype=s.dtype, device=dev)[None, :, None].expand(
        n, nf, k).reshape(n, nf * k)
    k2 = min(keep_top_k, nf * k)
    top_s2, top_i2 = _top_k(s, k2)
    out = torch.cat([
        torch.where(top_s2 > 0, lbl.gather(1, top_i2),
                    s.new_tensor(-1.0))[..., None],
        top_s2[..., None],
        b.gather(1, top_i2[..., None].expand(n, k2, 4)),
    ], dim=-1)
    return {"Out": [out]}
