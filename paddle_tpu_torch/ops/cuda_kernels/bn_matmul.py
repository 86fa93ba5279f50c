"""The fused BatchNorm(+residual)+act -> 1x1 convolution, forward and
backward: the CUDA kernels and their plain PyTorch versions.

- K11 ``bn_matmul_fwd`` and K12 ``bn_matmul_bwd`` (``csrc/bn_matmul.cu``)
  replace the Pallas kernels ``bn_matmul_fwd`` and ``bn_matmul_bwd`` of
  ``paddle_tpu/ops/pallas_kernels/bn_matmul.py``.
- ``BNMatmulTrain`` is the counterpart of ``make_bn_matmul_train``: a
  ``torch.autograd.Function`` whose forward runs K11 and whose backward
  runs K12.

Contract: x, r [M,K], w [K,N], gamma, beta, mean, var [K] →
``act((x − mean)·γ·rsqrt(var + eps) + β [+ r]) @ w`` [M,N] in x's dtype.
The prologue runs in f32 (f64 for f64 inputs, plain version only) as the
chain ``(x − mean)·gi + β`` with ``gi = rsqrt(var + eps)·γ`` computed once
per channel, each step rounded on its own, so kernel and plain version
agree on the ReLU mask bit for bit; the activation is rounded to w's dtype
as the product's operand and the sums are f32.  The backward returns
(dx, dγ, dβ, dmean, dvar, dw[, dr]): dA = dO·wᵀ with dO rounded to w's
dtype, the mask ``pre > 0`` taken after the residual, dx = dpre·gi,
dr = dpre, dw = Aᵀ·dO summed in f32 and cast once, dγ = Σ dpre·x̂ and
dβ = Σ dpre with x̂ = (x − mean)·rsqrt(var + eps), and the closed forms
dmean = −inv·γ·dβ, dvar = −½·inv²·γ·dγ, as in the JAX wrapper.  A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or
raises (float32 or bfloat16, x, r and w of one dtype, f32 statistics).
"""

from __future__ import annotations

import torch

from . import _common

ACTS = {None: 0, "": 0, "relu": 1}
# rows of a product the kernels index with 32-bit integers
_MAX_ROWS = 2 ** 31 - 1


def compute_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def act_code(act) -> int:
    if act not in ACTS:
        raise ValueError(f"act {act!r}: the fused kernels take relu or none")
    return ACTS[act]


def stats(gamma, beta, mean, var, eps, dtype):
    """(mean, inv, gamma, beta, gi) in `dtype`: inv = rsqrt(var + eps) and
    gi = inv·gamma, computed once per channel for kernel and plain version
    alike."""
    g, b, mu = gamma.to(dtype), beta.to(dtype), mean.to(dtype)
    inv = torch.rsqrt(var.to(dtype) + eps)
    return mu, inv, g, b, inv * g


def prologue_ref(x, r, mu, gi, b, act):
    """act((x − mu)·gi + b [+ r]) in mu's dtype: the kernels' prologue."""
    pre = (x.to(mu.dtype) - mu) * gi + b
    if r is not None:
        pre = pre + r.to(mu.dtype)
    return torch.relu(pre) if act == "relu" else pre


def backward_terms(x, r, mu, inv, gi, b, act, dA):
    """The epilogue of the dA products: (dpre, x̂) with the mask taken on
    the forward's pre."""
    xd = x.to(mu.dtype) - mu
    pre = xd * gi + b
    if r is not None:
        pre = pre + r.to(mu.dtype)
    dpre = torch.where(pre > 0, dA, torch.zeros_like(dA)) \
        if act == "relu" else dA
    return dpre, xd * inv


def closed_forms(inv, g, dgamma, dbeta):
    """(dmean, dvar) from dγ, dβ — the mean/var cotangents."""
    return -inv * g * dbeta, -0.5 * inv * inv * g * dgamma


def splits(tiles: int, red: int, dtype=torch.float32):
    """(splits, chunk) of a reduction of length `red` for a weight-gradient
    product of `tiles` output tiles: enough splits for about eight blocks
    an SM of the card (132), each at least 256 long, the chunk a multiple
    of the products' reduction step (bf16 64: K15's, a multiple of K12's
    32; f32 32: K15's, a multiple of K12's 16).  Both dtypes run
    128-thread tensor-core blocks; in f32 (four resident an SM) eight
    took an f32 ResNet-50 step's K12 + K15 to 45.2 ms on an H100 (700 W),
    from 47.0 at four and 50.5 at two, level with sixteen.  Depends on
    the shapes only, so reruns sum in the same order."""
    step = 64 if dtype == torch.bfloat16 else 32
    s = max(1, min(cdiv(132 * 8, tiles), cdiv(red, 256)))
    chunk = cdiv(cdiv(red, s), step) * step
    return cdiv(red, chunk), chunk


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def bn_matmul_fwd_ref(x, gamma, beta, mean, var, w, r=None, act="relu",
                      eps=1e-5):
    """Plain version of K11."""
    cdt = compute_dtype(x)
    mu, _, _, b, gi = stats(gamma, beta, mean, var, eps, cdt)
    a = prologue_ref(x, r, mu, gi, b, act)
    out = torch.matmul(a.to(w.dtype).to(cdt), w.to(cdt))
    return out.to(x.dtype)


def bn_matmul_bwd_ref(x, gamma, beta, mean, var, w, do, r=None, act="relu",
                      eps=1e-5):
    """Plain version of K12: (dx, dγ, dβ, dmean, dvar, dw[, dr])."""
    cdt = compute_dtype(x)
    mu, inv, g, b, gi = stats(gamma, beta, mean, var, eps, cdt)
    doc = do.to(w.dtype).to(cdt)
    dA = torch.matmul(doc, w.to(cdt).t())
    dpre, xhat = backward_terms(x, r, mu, inv, gi, b, act, dA)
    a = prologue_ref(x, r, mu, gi, b, act)
    dw = torch.matmul(a.to(w.dtype).to(cdt).t(), doc).to(w.dtype)
    dgamma, dbeta = (dpre * xhat).sum(0), dpre.sum(0)
    dmean, dvar = closed_forms(inv, g, dgamma, dbeta)
    out = ((dpre * gi).to(x.dtype), dgamma, dbeta, dmean, dvar, dw)
    return out + ((dpre.to(r.dtype),) if r is not None else ())


def check_inputs(name, x, w, r, params, rows, k):
    """The kernels' contract on CUDA tensors; raises on what they do not
    take."""
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"{name}: x and w must both be float32 or bfloat16, "
                        f"got {x.dtype} and {w.dtype}")
    if r is not None and (r.shape != x.shape or r.dtype != x.dtype):
        raise ValueError(f"{name}: r {tuple(r.shape)} {r.dtype} must match "
                         f"x {tuple(x.shape)} {x.dtype}")
    for p in params:
        if p.dtype != torch.float32 or tuple(p.shape) != (k,):
            raise ValueError(f"{name}: the statistics must be float32 [{k}], "
                             f"got {p.dtype} {tuple(p.shape)}")
        if p.device != x.device or w.device != x.device:
            raise ValueError(f"{name}: every input must be on {x.device}")
    if rows > _MAX_ROWS:
        raise ValueError(f"{name}: {rows} rows exceed the kernels' 32-bit "
                         f"row index")
    if k == 0:
        raise ValueError(f"{name}: K = 0")


def device_params(gamma, beta, mean, var, eps):
    """(prm [3,K], prm4 [4,K], inv, gamma) in f32 on the device: the
    forward prologue's (mean, gi, beta) and the backward's (mean, inv,
    gamma, beta)."""
    mu, inv, g, b, gi = stats(gamma, beta, mean, var, eps, torch.float32)
    return (torch.stack([mu, gi, b]).contiguous(),
            torch.stack([mu, inv, g, b]).contiguous(), inv, g)


def _contig(t):
    return None if t is None else t.contiguous()


def bn_matmul_fwd(x, gamma, beta, mean, var, w, r=None, act="relu",
                  eps=1e-5):
    """K11: x [M,K] → [M,N]."""
    M, K = x.shape
    N = w.shape[1]
    if tuple(w.shape) != (K, N):
        raise ValueError(f"bn_matmul_fwd: w {tuple(w.shape)} is not [{K}, N]")
    if x.device.type in _common.PLAIN_DEVICES:
        return bn_matmul_fwd_ref(x, gamma, beta, mean, var, w, r, act, eps)
    if x.device.type != "cuda":
        raise ValueError(f"bn_matmul_fwd: no kernel for {x.device}")
    check_inputs("bn_matmul_fwd", x, w, r, (gamma, beta, mean, var), M, K)
    code = act_code(act)
    out = torch.empty(M, N, dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    prm = device_params(gamma, beta, mean, var, eps)[0]
    _common.launch("ptt_bn_matmul_fwd", x.contiguous(), _contig(r), prm,
                   w.contiguous(), out, M, K, N, code,
                   _common.dtype_code(x), device=x.device)
    bn_matmul_fwd.launches += 1
    return out


def bn_matmul_bwd(x, gamma, beta, mean, var, w, do, r=None, act="relu",
                  eps=1e-5):
    """K12: (dx, dγ, dβ, dmean, dvar, dw[, dr])."""
    M, K = x.shape
    N = w.shape[1]
    if tuple(w.shape) != (K, N) or tuple(do.shape) != (M, N):
        raise ValueError(f"bn_matmul_bwd: w {tuple(w.shape)}, dO "
                         f"{tuple(do.shape)} do not fit x [{M}, {K}]")
    if x.device.type in _common.PLAIN_DEVICES:
        return bn_matmul_bwd_ref(x, gamma, beta, mean, var, w, do, r, act,
                                 eps)
    if x.device.type != "cuda":
        raise ValueError(f"bn_matmul_bwd: no kernel for {x.device}")
    check_inputs("bn_matmul_bwd", x, w, r, (gamma, beta, mean, var), M, K)
    code = act_code(act)
    dev = x.device
    prm, prm4, inv, g = device_params(gamma, beta, mean, var, eps)
    # the kernel writes every element; with nothing to launch, zeros
    new = torch.empty if M and N else torch.zeros
    dx = new(M, K, dtype=x.dtype, device=dev)
    dr = None if r is None else new(M, K, dtype=r.dtype, device=dev)
    dw = new(K, N, dtype=w.dtype, device=dev)
    dgb = new(2, K, dtype=torch.float32, device=dev)
    if M and N:
        s, chunk = splits(cdiv(K, 64) * cdiv(N, 64), M, x.dtype)
        dw_part = torch.empty(s, K, N, dtype=torch.float32, device=dev)
        gb_part = torch.empty(cdiv(M, 64), 2, K, dtype=torch.float32,
                              device=dev)
        _common.launch("ptt_bn_matmul_bwd", x.contiguous(), _contig(r), prm,
                       prm4, w.contiguous(), do.to(w.dtype).contiguous(), dx,
                       dr, dw, dw_part, gb_part, dgb, M, K, N, s, chunk, code,
                       _common.dtype_code(x), device=dev)
        bn_matmul_bwd.launches += 1
    dgamma, dbeta = dgb[0], dgb[1]
    dmean, dvar = closed_forms(inv, g, dgamma, dbeta)
    out = (dx, dgamma, dbeta, dmean, dvar, dw)
    return out + ((dr,) if r is not None else ())


bn_matmul_fwd.launches = 0
bn_matmul_bwd.launches = 0


class BNMatmulTrain(torch.autograd.Function):
    """The fused 1x1 for training, the counterpart of JAX
    ``make_bn_matmul_train``: (x, γ, β, mean, var, w, r, act, eps) → out.
    The forward runs K11 and saves its inputs; the backward runs K12 and
    returns every input's gradient (r's when r is given).  On CPU tensors
    both take the plain versions."""

    @staticmethod
    def forward(ctx, x, gamma, beta, mean, var, w, r, act, eps):
        ctx.act, ctx.eps = act, eps
        ctx.save_for_backward(x, gamma, beta, mean, var, w, r)
        return bn_matmul_fwd(x, gamma, beta, mean, var, w, r, act, eps)

    @staticmethod
    def backward(ctx, do):
        x, gamma, beta, mean, var, w, r = ctx.saved_tensors
        grads = bn_matmul_bwd(x, gamma, beta, mean, var, w, do, r, ctx.act,
                              ctx.eps)
        dr = grads[6] if r is not None else None
        return (*grads[:6], dr, None, None)
