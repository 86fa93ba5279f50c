"""The fused BatchNorm(+residual)+act -> 3x3 convolution (pad 1, stride 1
or 2, NHWC): the CUDA kernels and their plain PyTorch versions.

- K13 ``bn_conv3x3_fwd``, K14 ``bn_conv3x3_fwd_v2`` and K15
  ``bn_conv3x3_bwd`` (``csrc/bn_conv.cu``) replace the Pallas kernels of
  the same names in ``paddle_tpu/ops/pallas_kernels/bn_conv.py``.
- ``BNConv3x3Train`` is the counterpart of ``make_bn_conv3x3_train``: a
  ``torch.autograd.Function`` whose forward runs K13 (or K14 for variant
  "v2") and whose backward runs K15.  The "reference" variant is the
  plain forward ``bn_conv3x3_fwd_ref`` (the unfused composition) under
  autograd, chosen by the op emitter.

Contract: x, r [N,H,W,K], w HWIO [3,3,K,O] (``w_hwio`` of an OIHW
filter), gamma, beta, mean, var [K] → [N,Ho,Wo,O] in x's dtype with
Ho = (H − 1)//s + 1 (the convolution's own formula: odd H and W work at
stride 2).  The prologue, rounding points, mask and closed forms are those
of ``bn_matmul`` (its module docstring); the zero padding is applied to
the activation, after the prologue.  K14 computes exactly what K13
computes.  A CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _common
from .bn_matmul import (act_code, backward_terms, cdiv, check_inputs,
                        closed_forms, compute_dtype, device_params,
                        prologue_ref, splits, stats)


def w_hwio(w):
    """OIHW [O,K,3,3] → HWIO [3,3,K,O] (the kernels' tap layout), a view."""
    return w.permute(2, 3, 1, 0)


def _v2_block_o(O: int) -> int:
    """K14's O block: O when O is not a multiple of 128, else 256 when
    O ≥ 512 splits into such blocks, else 128 — the JAX package's rule
    without its override."""
    if O % 128:
        return O
    if O >= 512 and O % 256 == 0:
        return 256
    return 128


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).contiguous()


def bn_conv3x3_fwd_ref(x, gamma, beta, mean, var, w_hwio, r=None,
                       act="relu", eps=1e-5, stride=1):
    """Plain version of K13 and K14: the prologue, then one convolution of
    the rounded activation (stride an int or an (sh, sw) pair)."""
    cdt = compute_dtype(x)
    mu, _, _, b, gi = stats(gamma, beta, mean, var, eps, cdt)
    a = prologue_ref(x, r, mu, gi, b, act).to(w_hwio.dtype).to(cdt)
    out = F.conv2d(_nchw(a), w_hwio.to(cdt).permute(3, 2, 0, 1),
                   stride=stride, padding=1)
    return _nhwc(out).to(x.dtype)


def bn_conv3x3_bwd_ref(x, gamma, beta, mean, var, w_hwio, do, r=None,
                       act="relu", eps=1e-5, stride=1):
    """Plain version of K15: (dx, dγ, dβ, dmean, dvar, dw HWIO[, dr])."""
    cdt = compute_dtype(x)
    wdt = w_hwio.dtype
    mu, inv, g, b, gi = stats(gamma, beta, mean, var, eps, cdt)
    a = _nchw(prologue_ref(x, r, mu, gi, b, act).to(wdt).to(cdt))
    w_oihw = w_hwio.to(cdt).permute(3, 2, 0, 1)
    doc = _nchw(do.to(wdt).to(cdt))
    dA = torch.nn.grad.conv2d_input(a.shape, w_oihw, doc, stride=stride,
                                    padding=1)
    dw = torch.nn.grad.conv2d_weight(a, w_oihw.shape, doc, stride=stride,
                                     padding=1)
    dpre, xhat = backward_terms(x, r, mu, inv, gi, b, act, _nhwc(dA))
    dgamma, dbeta = (dpre * xhat).sum((0, 1, 2)), dpre.sum((0, 1, 2))
    dmean, dvar = closed_forms(inv, g, dgamma, dbeta)
    out = ((dpre * gi).to(x.dtype), dgamma, dbeta, dmean, dvar,
           dw.permute(2, 3, 1, 0).contiguous().to(wdt))
    return out + ((dpre.to(r.dtype),) if r is not None else ())


def _geometry(name, x, w_hwio, stride):
    N, H, W, K = x.shape
    if tuple(w_hwio.shape[:3]) != (3, 3, K):
        raise ValueError(f"{name}: w {tuple(w_hwio.shape)} is not HWIO "
                         f"[3, 3, {K}, O]")
    if stride not in (1, 2):
        raise ValueError(f"{name}: stride {stride!r}: the kernels take 1 "
                         f"or 2")
    return N, H, W, K, w_hwio.shape[3], (H - 1) // stride + 1, \
        (W - 1) // stride + 1


def _check(name, x, w_hwio, r, params, N, H, W, K):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    check_inputs(name, x, w_hwio, r, params, N * (H + 2) * (W + 2), K)


def bn_conv3x3_fwd(x, gamma, beta, mean, var, w_hwio, r=None, act="relu",
                   eps=1e-5, stride=1):
    """K13: x [N,H,W,K] → [N,Ho,Wo,O]."""
    N, H, W, K, O, Ho, Wo = _geometry("bn_conv3x3_fwd", x, w_hwio, stride)
    if x.device.type == "cpu":
        return bn_conv3x3_fwd_ref(x, gamma, beta, mean, var, w_hwio, r, act,
                                  eps, stride)
    _check("bn_conv3x3_fwd", x, w_hwio, r, (gamma, beta, mean, var), N, H,
           W, K)
    code = act_code(act)
    out = torch.empty(N, Ho, Wo, O, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    prm = device_params(gamma, beta, mean, var, eps)[0]
    # the normalized, padded activation the prep pass writes and the taps
    # read (f32: 110 MB at ResNet-50's stage 1, batch 128)
    apad = torch.empty(N, H + 2, W + 2, K, dtype=x.dtype, device=x.device)
    _common.launch("ptt_bn_conv3x3_fwd", x.contiguous(),
                   None if r is None else r.contiguous(), prm,
                   w_hwio.contiguous(), apad, out, N, H, W, K, O, stride,
                   code, _common.dtype_code(x), device=x.device)
    bn_conv3x3_fwd.launches += 1
    return out


def bn_conv3x3_fwd_v2(x, gamma, beta, mean, var, w_hwio, r=None, act="relu",
                      eps=1e-5, stride=1):
    """K14: the same function as K13, a block owning ``_v2_block_o(O)``
    output channels (walked 128 at a time; 64 when O is 64)."""
    N, H, W, K, O, Ho, Wo = _geometry("bn_conv3x3_fwd_v2", x, w_hwio,
                                      stride)
    if x.device.type == "cpu":
        return bn_conv3x3_fwd_ref(x, gamma, beta, mean, var, w_hwio, r, act,
                                  eps, stride)
    _check("bn_conv3x3_fwd_v2", x, w_hwio, r, (gamma, beta, mean, var), N,
           H, W, K)
    code = act_code(act)
    out = torch.empty(N, Ho, Wo, O, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    prm = device_params(gamma, beta, mean, var, eps)[0]
    apad = torch.empty(N, H + 2, W + 2, K, dtype=w_hwio.dtype,
                       device=x.device)
    _common.launch("ptt_bn_conv3x3_fwd_v2", x.contiguous(),
                   None if r is None else r.contiguous(), prm,
                   w_hwio.contiguous(), apad, out, N, H, W, K, O, stride,
                   _v2_block_o(O), code, _common.dtype_code(x),
                   device=x.device)
    bn_conv3x3_fwd_v2.launches += 1
    return out


def bn_conv3x3_bwd(x, gamma, beta, mean, var, w_hwio, do, r=None,
                   act="relu", eps=1e-5, stride=1):
    """K15: (dx, dγ, dβ, dmean, dvar, dw HWIO[, dr])."""
    N, H, W, K, O, Ho, Wo = _geometry("bn_conv3x3_bwd", x, w_hwio, stride)
    if tuple(do.shape) != (N, Ho, Wo, O):
        raise ValueError(f"bn_conv3x3_bwd: dO {tuple(do.shape)} is not "
                         f"[{N}, {Ho}, {Wo}, {O}]")
    if x.device.type == "cpu":
        return bn_conv3x3_bwd_ref(x, gamma, beta, mean, var, w_hwio, do, r,
                                  act, eps, stride)
    _check("bn_conv3x3_bwd", x, w_hwio, r, (gamma, beta, mean, var), N, H,
           W, K)
    code = act_code(act)
    dev = x.device
    prm, prm4, inv, g = device_params(gamma, beta, mean, var, eps)
    # the kernel writes every element; with nothing to launch, zeros
    new = torch.empty if N * H * W and O else torch.zeros
    dx = new(N, H, W, K, dtype=x.dtype, device=dev)
    dr = None if r is None else new(N, H, W, K, dtype=r.dtype, device=dev)
    dw = new(3, 3, K, O, dtype=w_hwio.dtype, device=dev)
    dgb = new(2, K, dtype=torch.float32, device=dev)
    if N * H * W and O:
        tiles_m = cdiv(N * H * W, 64)
        s, chunk = splits(9 * cdiv(K, 64) * cdiv(O, 64), N * Ho * Wo,
                          x.dtype)
        dw_part = torch.empty(9, s, K, O, dtype=torch.float32, device=dev)
        gb_part = torch.empty(tiles_m, 2, K, dtype=torch.float32, device=dev)
        # the normalized, padded activation the prep pass writes and dW
        # reads (f32: 110 MB at ResNet-50's stage 1, batch 128)
        apad = torch.empty(N, H + 2, W + 2, K, dtype=x.dtype, device=dev)
        _common.launch("ptt_bn_conv3x3_bwd", x.contiguous(),
                       None if r is None else r.contiguous(), prm, prm4,
                       w_hwio.contiguous(), do.to(w_hwio.dtype).contiguous(),
                       dx, dr, dw, dw_part, gb_part, dgb, apad, N, H, W, K, O,
                       stride, s, chunk, code, _common.dtype_code(x),
                       device=dev)
        bn_conv3x3_bwd.launches += 1
    dgamma, dbeta = dgb[0], dgb[1]
    dmean, dvar = closed_forms(inv, g, dgamma, dbeta)
    out = (dx, dgamma, dbeta, dmean, dvar, dw)
    return out + ((dr,) if r is not None else ())


bn_conv3x3_fwd.launches = 0
bn_conv3x3_fwd_v2.launches = 0
bn_conv3x3_bwd.launches = 0


class BNConv3x3Train(torch.autograd.Function):
    """The fused 3x3 for training, the counterpart of JAX
    ``make_bn_conv3x3_train``: (x, γ, β, mean, var, w_hwio, r, act, eps,
    stride, variant) → out.  The forward runs K13 (variant "v1") or K14
    ("v2"); the backward runs K15.  On CPU tensors all take the plain
    versions."""

    @staticmethod
    def forward(ctx, x, gamma, beta, mean, var, w_hwio, r, act, eps, stride,
                variant):
        if variant not in ("v1", "v2"):
            raise ValueError(f"BNConv3x3Train: variant {variant!r}")
        ctx.act, ctx.eps, ctx.stride = act, eps, stride
        ctx.save_for_backward(x, gamma, beta, mean, var, w_hwio, r)
        fwd = bn_conv3x3_fwd_v2 if variant == "v2" else bn_conv3x3_fwd
        return fwd(x, gamma, beta, mean, var, w_hwio, r, act, eps, stride)

    @staticmethod
    def backward(ctx, do):
        x, gamma, beta, mean, var, w_hwio, r = ctx.saved_tensors
        grads = bn_conv3x3_bwd(x, gamma, beta, mean, var, w_hwio, do, r,
                               ctx.act, ctx.eps, ctx.stride)
        dr = grads[6] if r is not None else None
        return (*grads[:6], dr, None, None, None, None)
