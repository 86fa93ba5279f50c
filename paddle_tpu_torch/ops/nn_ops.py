"""NN layer ops, the port of the part of ``paddle_tpu/ops/nn_ops.py`` that
the LM tower, ResNet and the model zoo use: ``layer_norm``, ``conv2d``,
``conv2d_transpose``, ``pool2d``, ``batch_norm``, ``dropout`` and the
fused ``bn_act_conv1x1`` / ``bn_act_conv3x3``.

``conv2d``, ``conv2d_transpose`` and ``pool2d`` are stock ATen (cuDNN on
the card), as the JAX package leaves them to stock XLA; an NHWC tensor
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


@register_op("pool2d")
def pool2d(ctx, ins, attrs):
    """Max or average pooling (``_pool_nd`` of the JAX package): windows
    padded with -inf for max; average over the window, or over its
    unpadded part when ``exclusive`` (the default) and there is padding;
    ``global_pooling`` takes the whole map.  The padding is explicit and
    the pooling unpadded, since torch's pooling refuses a pad over half
    the window, which ``reduce_window`` takes: a window wholly in the
    padding gives -inf (max) or 0/0 (exclusive average), as there."""
    x = ins["X"][0]
    nhwc = str(attrs.get("data_format", "NCHW")) == "NHWC"
    ksize = _pair(attrs.get("ksize", [2, 2]))
    strides = _pair(attrs.get("strides", ksize))
    pads = _pair(attrs.get("paddings", [0, 0]))
    if attrs.get("global_pooling", False):
        ksize = list(x.shape[1:3] if nhwc else x.shape[2:])
        strides, pads = ksize, [0, 0]
    xc = _nchw(x, nhwc)
    width = (pads[1], pads[1], pads[0], pads[0])  # F.pad: W first, then H
    if attrs.get("pooling_type", "max") == "max":
        out = F.max_pool2d(F.pad(xc, width, value=-math.inf), ksize,
                           strides)
    elif attrs.get("exclusive", True) and any(pads):
        # each window's sum over its count of unpadded elements
        ones = F.pad(torch.ones_like(xc[:1, :1]), width)
        out = (F.avg_pool2d(F.pad(xc, width), ksize, strides,
                            divisor_override=1)
               / F.avg_pool2d(ones, ksize, strides, divisor_override=1))
    else:
        out = F.avg_pool2d(F.pad(xc, width), ksize, strides)
    return {"Out": [_back(out, nhwc)]}


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
