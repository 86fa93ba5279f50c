"""NN layer ops, the port of ``paddle_tpu/ops/nn_ops.py``: ``layer_norm``,
``conv2d``, ``depthwise_conv2d``, ``conv2d_transpose``, ``conv3d``,
``conv3d_transpose``, ``pool2d``, ``pool3d``, ``max_pool2d_with_index``,
``max_pool3d_with_index``, ``unpool``, ``spp``, ``batch_norm``,
``dropout``, ``lrn``, ``im2sequence``, ``row_conv``, the v1 layers'
``bilinear_interp``, ``scale_sub_region``, ``conv_shift``,
``bilinear_tensor_product``, ``factorization_machine`` and
``selective_fc``, and the fused ``bn_act_conv1x1`` / ``bn_act_conv3x3``.

The convolutions and poolings are stock ATen (cuDNN on the card), as the
JAX package leaves them to stock XLA; an NHWC tensor
goes through them as a channels-last view, so nothing is copied around
the call.  The fused ops
run the hand-written kernels of ``cuda_kernels/bn_matmul.py`` (K11, K12)
and ``cuda_kernels/bn_conv.py`` (K13-K15) through their autograd
Functions, so each op's ``generic_grad`` runs the backward kernel.  The
variance is the population variance, as ``jnp.var`` computes it."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..autotune import knobs
from .cuda_kernels import bn_conv, bn_matmul
from .registry import register_op


def _pair(v):
    if isinstance(v, (list, tuple)):
        return [int(x) for x in v]
    return [int(v), int(v)]


def _triple(v):
    if isinstance(v, (list, tuple)):
        return [int(x) for x in v]
    return [int(v)] * 3


@register_op("layer_norm")
def layer_norm(ctx, ins, attrs):
    x = ins["X"][0]
    eps = float(attrs.get("epsilon", 1e-5))
    begin = int(attrs.get("begin_norm_axis", 1))
    axes = tuple(range(begin, x.ndim))
    var, mean = torch.var_mean(x, dim=axes, correction=0, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    if ins.get("Scale") and ins["Scale"][0] is not None:
        y = y * ins["Scale"][0]
    if ins.get("Bias") and ins["Bias"][0] is not None:
        y = y + ins["Bias"][0]
    return {"Y": [y], "Mean": [mean.reshape(-1)],
            "Variance": [var.reshape(-1)]}


def _nchw(x, nhwc):
    return x.permute(0, 3, 1, 2) if nhwc else x


def _back(y, nhwc):
    return y.permute(0, 2, 3, 1) if nhwc else y


@register_op("conv2d")
def conv2d(ctx, ins, attrs):
    """data_format NCHW or NHWC; the filter is OIHW in both."""
    x = ins["Input"][0]
    w = ins["Filter"][0]
    nhwc = str(attrs.get("data_format", "NCHW")) == "NHWC"
    groups = int(attrs.get("groups", 1))
    if groups == -1:
        # one group per sample, the batch packed into channels
        groups = x.shape[3 if nhwc else 1] // w.shape[1]
    out = F.conv2d(_nchw(x, nhwc), w,
                   stride=_pair(attrs.get("strides", [1, 1])),
                   padding=_pair(attrs.get("paddings", [0, 0])),
                   dilation=_pair(attrs.get("dilations", [1, 1])),
                   groups=groups)
    return {"Output": [_back(out, nhwc)]}


@register_op("depthwise_conv2d")
def depthwise_conv2d(ctx, ins, attrs):
    """``conv2d`` with one group a channel."""
    attrs = dict(attrs)
    nhwc = str(attrs.get("data_format", "NCHW")) == "NHWC"
    attrs["groups"] = ins["Input"][0].shape[3 if nhwc else 1]
    return conv2d(ctx, ins, attrs)


@register_op("conv3d")
def conv3d(ctx, ins, attrs):
    """Volumetric convolution, NCDHW, filter OIDHW."""
    out = F.conv3d(ins["Input"][0], ins["Filter"][0],
                   stride=_triple(attrs.get("strides", [1, 1, 1])),
                   padding=_triple(attrs.get("paddings", [0, 0, 0])),
                   dilation=_triple(attrs.get("dilations", [1, 1, 1])),
                   groups=int(attrs.get("groups", 1)))
    return {"Output": [out]}


@register_op("conv3d_transpose")
def conv3d_transpose(ctx, ins, attrs):
    """The transposed volumetric convolution, NCDHW, filter [C_in, C_out,
    kd, kh, kw]: out = (in − 1)·s − 2p + d·(k − 1) + 1 on each axis, as
    ``conv2d_transpose``."""
    out = F.conv_transpose3d(
        ins["Input"][0], ins["Filter"][0],
        stride=_triple(attrs.get("strides", [1, 1, 1])),
        padding=_triple(attrs.get("paddings", [0, 0, 0])),
        dilation=_triple(attrs.get("dilations", [1, 1, 1])))
    return {"Output": [out]}


@register_op("conv2d_transpose")
def conv2d_transpose(ctx, ins, attrs):
    """The transposed convolution, NCHW, filter [C_in, C_out, kh, kw]:
    out = (in − 1)·s − 2p + d·(k − 1) + 1 (conv_transpose_op.h).  The
    JAX emitter pads its dilated input by d·(k − 1) − p a side, which is
    the output ``F.conv_transpose2d`` gives for padding p."""
    out = F.conv_transpose2d(
        ins["Input"][0], ins["Filter"][0],
        stride=_pair(attrs.get("strides", [1, 1])),
        padding=_pair(attrs.get("paddings", [0, 0])),
        dilation=_pair(attrs.get("dilations", [1, 1])))
    return {"Output": [out]}


def _pool_nd(x, attrs, nd):
    """Max or average pooling over the `nd` trailing spatial axes
    (channels second, or last for NHWC / NDHWC), ``_pool_nd`` of the JAX
    package: windows padded with -inf for max; average over the window,
    or over its unpadded part when ``exclusive`` (the default) and there
    is padding; ``global_pooling`` takes the whole map.  The padding is
    explicit and the pooling unpadded, since torch's pooling refuses a
    pad over half the window, which ``reduce_window`` takes: a window
    wholly in the padding gives -inf (max) or 0/0 (exclusive average), as
    there."""
    tup = _pair if nd == 2 else _triple
    last = str(attrs.get("data_format", "NCHW")) in ("NHWC", "NDHWC")
    ksize = tup(attrs.get("ksize", [2] * nd))
    strides = tup(attrs.get("strides", ksize))
    pads = tup(attrs.get("paddings", [0] * nd))
    if attrs.get("global_pooling", False):
        ksize = list(x.shape[1:-1] if last else x.shape[2:])
        strides, pads = ksize, [0] * nd
    xc = x.movedim(-1, 1) if last else x
    width = []  # F.pad: the last axis first
    for p in reversed(pads):
        width += [p, p]
    max_pool = F.max_pool2d if nd == 2 else F.max_pool3d
    avg_pool = F.avg_pool2d if nd == 2 else F.avg_pool3d
    if attrs.get("pooling_type", "max") == "max":
        out = max_pool(F.pad(xc, width, value=-math.inf), ksize, strides)
    elif attrs.get("exclusive", True) and any(pads):
        # each window's sum over its count of unpadded elements
        ones = F.pad(torch.ones_like(xc[:1, :1]), width)
        out = (avg_pool(F.pad(xc, width), ksize, strides,
                        divisor_override=1)
               / avg_pool(ones, ksize, strides, divisor_override=1))
    else:
        out = avg_pool(F.pad(xc, width), ksize, strides)
    return out.movedim(1, -1) if last else out


@register_op("pool2d")
def pool2d(ctx, ins, attrs):
    """``_pool_nd`` over H and W."""
    return {"Out": [_pool_nd(ins["X"][0], attrs, 2)]}


@register_op("pool3d")
def pool3d(ctx, ins, attrs):
    """``_pool_nd`` over D, H and W."""
    return {"Out": [_pool_nd(ins["X"][0], attrs, 3)]}


@register_op("batch_norm", non_diff_outputs=("MeanOut", "VarianceOut"))
def batch_norm(ctx, ins, attrs):
    """Train mode: batch statistics and the running update, MeanOut and
    VarianceOut written back to the Mean and Variance state.  SavedMean and
    SavedVariance are the batch statistics in the stats dtype (f32 for a
    bf16 input: neither executor casts an output to its declared dtype) and
    stay functions of X under autograd: the fused ops' mean and variance
    cotangents reach dX through this op's ``generic_grad``.  Test mode:
    the running statistics."""
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = float(attrs.get("epsilon", 1e-5))
    momentum = float(attrs.get("momentum", 0.9))
    is_test = bool(attrs.get("is_test", False)) or ctx.is_test
    fmt = str(attrs.get("data_layout", attrs.get("data_format", "NCHW")))
    ch = x.ndim - 1 if fmt in ("NHWC", "NDHWC", "NLC") else 1
    axes = tuple(i for i in range(x.ndim) if i != ch)
    shape = [1] * x.ndim
    shape[ch] = x.shape[ch]
    # statistics in f32 (f64 for an f64 input), as in the JAX emitter
    sdt = bn_matmul.compute_dtype(x)
    if is_test:
        use_mean, use_var = mean, var
        mean_out, var_out = mean, var
    else:
        use_var, use_mean = torch.var_mean(x.to(sdt), dim=axes,
                                           correction=0)
        mean_out = momentum * mean + (1 - momentum) * use_mean.to(mean.dtype)
        var_out = momentum * var + (1 - momentum) * use_var.to(var.dtype)
    inv = 1.0 / torch.sqrt(use_var.to(sdt) + eps)
    xhat = (x.to(sdt) - use_mean.reshape(shape)) * inv.reshape(shape)
    y = (xhat * scale.reshape(shape) + bias.reshape(shape)).to(x.dtype)
    return {"Y": [y], "MeanOut": [mean_out], "VarianceOut": [var_out],
            "SavedMean": [use_mean], "SavedVariance": [use_var]}


@register_op("dropout", non_diff_outputs=("Mask",), draws_rng=True)
def dropout(ctx, ins, attrs):
    """Train mode: Mask = (u >= p) for u uniform in [0, 1) from the op's
    generator (seeded by program seed, run step and ``__uid__``, so the
    ``generic_grad`` re-run draws the same mask), Out = X·Mask
    (``downgrade_in_infer``) or X·Mask/(1 − p) (``upscale_in_train``).
    Test mode and p = 0 draw nothing and give a Mask of ones: Out = X·(1 −
    p) for ``downgrade_in_infer``, X for ``upscale_in_train`` (reference
    dropout_op.h:60)."""
    x = ins["X"][0]
    p = float(attrs.get("dropout_prob", 0.5))
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if bool(attrs.get("is_test", False)) or ctx.is_test or p == 0.0:
        out = x if (impl == "upscale_in_train" or p == 0.0) else x * (1.0 - p)
        return {"Out": [out], "Mask": [torch.ones_like(x)]}
    u = torch.rand(x.shape, generator=ctx.generator(attrs), device=x.device)
    mask = (u >= p).to(x.dtype)
    if impl == "upscale_in_train":
        out = x * mask / (1.0 - p)
    else:
        out = x * mask
    return {"Out": [out], "Mask": [mask]}


def _fused_ins(ins, attrs):
    x = ins["X"][0]  # the raw conv output, NHWC
    sdt = bn_matmul.compute_dtype(x)
    params = [ins[s][0].to(sdt) for s in ("Scale", "Bias", "SavedMean",
                                          "SavedVariance")]
    res = ins["Residual"][0] if ins.get("Residual") else None
    return (x, params, ins["Filter"][0], res,
            float(attrs.get("epsilon", 1e-5)), attrs.get("act") or None,
            _pair(attrs.get("strides", [1, 1])))


@register_op("bn_act_conv1x1")
def bn_act_conv1x1(ctx, ins, attrs):
    """act(batch_norm(X) [+ Residual]) → 1x1 convolution (NHWC), made by
    ``training_fusion.fuse_bn_matmul`` from the statistics of the kept
    batch_norm op.  A stride-2 op reads every other pixel of X and R (a
    strided view, made contiguous for the kernel; the gradient scatters
    back through autograd).  K11 forward, K12 backward."""
    x, params, w, res, eps, act, strides = _fused_ins(ins, attrs)
    if strides != [1, 1]:
        x = x[:, ::strides[0], ::strides[1], :]
        if res is not None:
            res = res[:, ::strides[0], ::strides[1], :]
    n, h, ww, k = x.shape
    o = w.shape[0]
    r2 = res.reshape(n * h * ww, k) if res is not None else None
    out = bn_matmul.BNMatmulTrain.apply(
        x.reshape(n * h * ww, k), *params, w.reshape(o, k).t(), r2, act, eps)
    return {"Output": [out.reshape(n, h, ww, o)]}


@register_op("bn_act_conv3x3")
def bn_act_conv3x3(ctx, ins, attrs):
    """act(batch_norm(X) [+ Residual]) → 3x3 convolution (NHWC, pad 1,
    stride 1 or 2), made by ``training_fusion.fuse_bn_matmul``.  The
    forward is K13, or K14 with ``PADDLE_TPU_BNCONV_VARIANT=v2``; the
    backward K15.  The "reference" variant and a non-square stride (which
    the pass never makes) take the unfused composition under autograd, as
    the JAX emitter does."""
    x, params, w, res, eps, act, strides = _fused_ins(ins, attrs)
    variant = knobs.bnconv_variant()
    if variant == "reference" or strides[0] != strides[1]:
        stride = strides[0] if strides[0] == strides[1] else tuple(strides)
        out = bn_conv.bn_conv3x3_fwd_ref(x, *params, bn_conv.w_hwio(w),
                                         res, act, eps, stride)
    else:
        out = bn_conv.BNConv3x3Train.apply(x, *params, bn_conv.w_hwio(w),
                                           res, act, eps, strides[0],
                                           variant)
    return {"Output": [out]}


@register_op("lrn")
def lrn(ctx, ins, attrs):
    """Cross-channel local response normalization over NCHW: X / MidOut **
    beta, MidOut = k + alpha * the sum of squares over the n channels
    centred on each one (zeros past the edges)."""
    x = ins["X"][0]
    n = int(attrs.get("n", 5))
    k = float(attrs.get("k", 2.0))
    alpha = float(attrs.get("alpha", 1e-4))
    beta = float(attrs.get("beta", 0.75))
    half = n // 2
    pad = F.pad(x * x, (0, 0, 0, 0, half, half))
    c = x.shape[1]
    acc = sum(pad[:, i:i + c] for i in range(n))
    mid = k + alpha * acc
    return {"Out": [x / mid ** beta], "MidOut": [mid]}


@register_op("im2sequence")
def im2sequence(ctx, ins, attrs):
    """Every kernel-sized patch of an NCHW image as one row, [N·oh·ow,
    C·kh·kw] in (C, kh, kw) order (``F.unfold``'s, as the JAX emitter's
    ``conv_general_dilated_patches``).  ``paddings`` is [up, left, down,
    right] (two values: up = down, left = right), applied with ``F.pad``
    first because ``F.unfold`` pads symmetrically only."""
    x = ins["X"][0]
    kernels = _pair(attrs["kernels"])
    strides = _pair(attrs.get("strides", [1, 1]))
    pads = list(attrs.get("paddings", [0, 0, 0, 0]))
    up, left = int(pads[0]), int(pads[1])
    down = int(pads[2]) if len(pads) > 2 else up
    right = int(pads[3]) if len(pads) > 3 else left
    xp = F.pad(x, (left, right, up, down))
    cols = F.unfold(xp, kernel_size=kernels, stride=strides)  # [N, ck, L]
    n, ck, _ = cols.shape
    return {"Out": [cols.transpose(1, 2).reshape(-1, ck)]}


@register_op("row_conv")
def row_conv(ctx, ins, attrs):
    """Lookahead row convolution over [batch, time, dim]: out[t] = sum_i
    x[t + i] * Filter[i], steps past T read as zeros.  Like the JAX
    emitter it reads a sequence's padded steps past its length (ROADMAP
    Queue C)."""
    x = ins["X"][0]
    w = ins["Filter"][0]
    ctx_len = w.shape[0]
    t = x.shape[1]
    pad = F.pad(x, (0, 0, 0, ctx_len - 1))
    out = sum(pad[:, i:i + t] * w[i] for i in range(ctx_len))
    return {"Out": [out]}

def _windows(a, ksize, strides):
    """[N, C, *spatial] → [N, C, *out, prod(ksize)]: every window, its
    elements in row-major order (``conv_general_dilated_patches``')."""
    nd = len(ksize)
    for i, (k, st) in enumerate(zip(ksize, strides)):
        a = a.unfold(2 + i, k, st)
    return a.reshape(a.shape[:2 + nd] + (-1,))


def _max_pool_with_index(x, attrs, nd):
    """Max pool over the `nd` spatial axes of [N, C, *spatial] and the
    flat index (over the unpadded spatial axes) of each window's maximum:
    padding holds the dtype's lowest finite value and index −1, and among
    equal maxima the first in the window wins, as ``jnp.argmax`` takes
    it.  The output's gradient splits among equal maxima (``amax``)."""
    tup = _pair if nd == 2 else _triple
    ksize = tup(attrs.get("ksize", [2] * nd))
    strides = tup(attrs.get("strides", ksize))
    pads = tup(attrs.get("paddings", [0] * nd))
    spatial = tuple(x.shape[2:])
    width = []
    for p in reversed(pads):
        width += [p, p]
    neg = torch.finfo(x.dtype).min
    xp = _windows(F.pad(x, width, value=neg), ksize, strides)
    flat = torch.arange(math.prod(spatial), device=x.device).reshape(
        (1, 1) + spatial)
    ip = _windows(F.pad(flat, width, value=-1), ksize, strides)
    arg = torch.argmax(xp, dim=-1, keepdim=True)
    idx = torch.gather(ip.expand(xp.shape[:2] + ip.shape[2:]), -1, arg)
    return {"Out": [torch.amax(xp, dim=-1)],
            "Mask": [idx[..., 0].to(torch.int32)]}


@register_op("max_pool2d_with_index", non_diff_outputs=("Mask",))
def max_pool2d_with_index(ctx, ins, attrs):
    """NCHW max pool with the flat h·W + w position of each maximum (the
    Indices input of ``unpool``)."""
    return _max_pool_with_index(ins["X"][0], attrs, 2)


@register_op("max_pool3d_with_index", non_diff_outputs=("Mask",))
def max_pool3d_with_index(ctx, ins, attrs):
    """NCDHW max pool with the flat d·H·W + h·W + w position of each
    maximum."""
    return _max_pool_with_index(ins["X"][0], attrs, 3)


@register_op("unpool", non_diff_inputs=("Indices",))
def unpool(ctx, ins, attrs):
    """Max unpooling: each pooled value of X [N, C, h, w] goes to the flat
    position its Indices name in a zero [N, C, OH, OW] (`output_size`,
    else (h − 1)·s + k); a position outside it (the −1 of a window wholly
    in padding) is dropped."""
    x = ins["X"][0]
    ksize = _pair(attrs.get("ksize", [2, 2]))
    strides = _pair(attrs.get("strides", ksize))
    n, c, h, w = x.shape
    if attrs.get("output_size"):
        oh, ow = _pair(attrs["output_size"])
    else:
        oh = (h - 1) * strides[0] + ksize[0]
        ow = (w - 1) * strides[1] + ksize[1]
    vals = x.reshape(n * c, h * w)
    idx = ins["Indices"][0].reshape(n * c, h * w).long()
    # an extra last column takes the dropped positions
    idx = torch.where((idx < 0) | (idx >= oh * ow), oh * ow, idx)
    out = torch.zeros(n * c, oh * ow + 1, dtype=x.dtype,
                      device=x.device).scatter(1, idx, vals)
    return {"Out": [out[:, :-1].reshape(n, c, oh, ow)]}


@register_op("spp")
def spp(ctx, ins, attrs):
    """Spatial pyramid pooling: for each level l < pyramid_height a 2^l ×
    2^l grid of max or average pools over NCHW, flattened and joined."""
    x = ins["X"][0]
    levels = int(attrs.get("pyramid_height", 2))
    ptype = attrs.get("pooling_type", "max").lower()
    n, c, hh, ww = x.shape
    outs = []
    for lvl in range(levels):
        bins = 2 ** lvl
        rows = []
        for bi in range(bins):
            h0 = (bi * hh) // bins
            h1 = max(((bi + 1) * hh + bins - 1) // bins, h0 + 1)
            cols = []
            for bj in range(bins):
                w0 = (bj * ww) // bins
                w1 = max(((bj + 1) * ww + bins - 1) // bins, w0 + 1)
                cell = x[:, :, h0:h1, w0:w1]
                cols.append(torch.amax(cell, dim=(2, 3)) if ptype == "max"
                            else torch.mean(cell, dim=(2, 3)))
            rows.append(torch.stack(cols, dim=-1))
        outs.append(torch.stack(rows, dim=-2).reshape(n, c * bins * bins))
    return {"Out": [torch.cat(outs, dim=1)]}


@register_op("bilinear_interp")
def bilinear_interp(ctx, ins, attrs):
    """Bilinear resampling of NCHW maps to out_h × out_w with
    align-corners ratios (in − 1)/(out − 1), computed in f32."""
    x = ins["X"][0]
    out_h, out_w = int(attrs["out_h"]), int(attrs["out_w"])
    _, _, hh, ww = x.shape

    def axis_coords(out_n, in_n):
        r = (in_n - 1) / (out_n - 1) if out_n > 1 else 0.0
        pos = torch.arange(out_n, dtype=torch.float32, device=x.device) * r
        lo = torch.floor(pos).long()
        hi = torch.clamp(lo + 1, max=in_n - 1)
        return lo, hi, pos - lo.to(torch.float32)

    h0, h1, fh = axis_coords(out_h, hh)
    w0, w1, fw = axis_coords(out_w, ww)
    f32 = x.to(torch.float32)
    row = (f32[:, :, h0, :] * (1 - fh)[None, None, :, None]
           + f32[:, :, h1, :] * fh[None, None, :, None])
    out = (row[:, :, :, w0] * (1 - fw)[None, None, None, :]
           + row[:, :, :, w1] * fw[None, None, None, :])
    return {"Out": [out.to(x.dtype)]}


@register_op("scale_sub_region", non_diff_inputs=("Indices",))
def scale_sub_region(ctx, ins, attrs):
    """X [N, C, H, W] with a box of each sample times `value`: Indices [N,
    6] holds its 1-based inclusive [c0, c1, h0, h1, w0, w1]."""
    x = ins["X"][0]
    idx = ins["Indices"][0].long()
    value = float(attrs.get("value", 1.0))
    _, c, hh, ww = x.shape

    def in_range(n, lo, hi):
        pos = torch.arange(n, device=x.device)[None, :]
        return (pos >= (lo - 1)[:, None]) & (pos <= (hi - 1)[:, None])

    m = (in_range(c, idx[:, 0], idx[:, 1])[:, :, None, None]
         & in_range(hh, idx[:, 2], idx[:, 3])[:, None, :, None]
         & in_range(ww, idx[:, 4], idx[:, 5])[:, None, None, :])
    return {"Out": [torch.where(m, x * value, x)]}


@register_op("conv_shift")
def conv_shift(ctx, ins, attrs):
    """Circular convolution: Out[b, i] = sum_j X[b, (i + j − N//2) mod M]
    · Y[b, j] for X [B, M], Y [B, N]."""
    x, y = ins["X"][0], ins["Y"][0]
    n = y.shape[1]
    half = n // 2
    return {"Out": [sum(torch.roll(x, half - j, dims=1) * y[:, j:j + 1]
                        for j in range(n))]}


@register_op("bilinear_tensor_product")
def bilinear_tensor_product(ctx, ins, attrs):
    """Out[b, o] = X[b] · Weight[o] · Y[b] (+ Bias[o])."""
    x, y, w = ins["X"][0], ins["Y"][0], ins["Weight"][0]
    out = torch.einsum("bi,oij,bj->bo", x, w, y)
    if ins.get("Bias") and ins["Bias"][0] is not None:
        out = out + ins["Bias"][0]
    return {"Out": [out]}


@register_op("factorization_machine")
def factorization_machine(ctx, ins, attrs):
    """The second-order interaction term 0.5·sum_k [(X·V_k)² − X²·V_k²] of
    Input [B, D] and Factors [D, K], as [B, 1]."""
    x, v = ins["Input"][0], ins["Factors"][0]
    xv = x @ v
    x2v2 = (x * x) @ (v * v)
    return {"Out": [0.5 * torch.sum(xv * xv - x2v2, dim=1, keepdim=True)]}


@register_op("selective_fc", non_diff_inputs=("Mask",))
def selective_fc(ctx, ins, attrs):
    """X·W (+ Bias) with the columns a nonzero Mask does not select set to
    0 (the full product, then the mask, as the JAX emitter)."""
    out = ins["X"][0] @ ins["W"][0]
    if ins.get("Bias") and ins["Bias"][0] is not None:
        out = out + ins["Bias"][0].reshape(1, -1)
    if ins.get("Mask") and ins["Mask"][0] is not None:
        out = out * (ins["Mask"][0] != 0)
    return {"Out": [out]}

# analytic cost formulas (analysis/cost.py; mechanism in registry.py)

from .registry import register_cost  # noqa: E402


def _conv_cost(ins, outs, attrs):
    """2 * out_elements * (kernel_spatial * C_in / groups) MACs-as-flops —
    the standard conv roofline numerator, any spatial rank.  Filter layout
    is OIHW(D) (transpose convs keep I first; the product is the same)."""
    w = ins.get("Filter", [None])[0]
    out = outs.get("Output", outs.get("Out", [None]))[0]
    if w is None or out is None or len(w.shape) < 3:
        return {}
    k_spatial = 1
    for s in w.shape[2:]:
        k_spatial *= s
    cin_per_group = w.shape[1]  # OIHW: dim 1 is already C_in/groups
    return {"flops": 2 * out.size * k_spatial * cin_per_group}


for _t in ("conv2d", "depthwise_conv2d", "conv2d_transpose", "conv3d",
           "conv3d_transpose"):
    register_cost(_t, _conv_cost)

# ---------------------------------------------------------------------------
# sharding-propagation rule (analysis/sharding.py; mechanism in registry),
# as the JAX package's

from .registry import register_sharding  # noqa: E402


def _batch_norm_sharding(ctx, ins, outs, attrs):
    """Training-mode batch statistics are means over the (sharded)
    batch: GSPMD all-reduces the per-channel mean and variance over the
    batch axes.  Channel-shaped buffers stay replicated."""
    from ..analysis.sharding import entry_axes

    x = ins.get("X", [None])[0]
    y = outs.get("Y", [None])[0]
    if x is None or not x.spec:
        return {}
    batch_axes = tuple(a for a in entry_axes(x.spec[0])
                       if ctx.axis_size(a) > 1)
    mean = outs.get("SavedMean", [None])[0]
    if batch_axes and mean is not None and not attrs.get("is_test"):
        ctx.collective(
            "all-reduce", batch_axes, 2 * mean.global_bytes,
            var=mean.name,
            why="batch mean+variance over the sharded batch")
    out = {}
    if y is not None:
        out["Y"] = [tuple(x.spec)]
    return out


register_sharding("batch_norm", _batch_norm_sharding)
