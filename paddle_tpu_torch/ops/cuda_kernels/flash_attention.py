"""Flash attention, forward and backward: the CUDA kernels and their plain
PyTorch versions.

- K1 ``flash_attention`` and K4 ``flash_attention_fwd`` — one kernel
  (``csrc/flash_attention.cu``), K4 its instance that also writes the
  per-row logsumexp.  They replace the Pallas kernels ``flash_attention``
  and ``flash_attention_fwd`` of
  ``paddle_tpu/ops/pallas_kernels/flash_attention.py``.
- K5 ``flash_attention_dq`` and K6 ``flash_attention_dkv``
  (``csrc/flash_attention_bwd.cu``) replace the two sweeps of its
  ``flash_attention_bwd``: ``_dq_kernel`` and ``_dkv_kernel``.
- ``FlashAttentionTrain`` is the counterpart of ``make_flash_train``: a
  ``torch.autograd.Function`` whose forward runs K4 and whose backward
  runs K5 and K6 (``flash_attention_bwd``).

Each kernel has two bodies, both on the tensor cores (``mma.sync``,
``csrc/mma.cuh``): bf16 in m16n8k16, f32 in 3xTF32 (each f32 product as
three TF32 products of split operands, near f32 accuracy).

Contract: q, k, v [B, H, T, D] of one dtype → out [B, H, T, D],
softmax(Q Kᵀ·scale [+ causal mask]) V with f32 scores and P cast to the
value dtype before P·V; lse [B·H, T] f32.  The backward keeps the JAX
kernels' rounding points: dP from dO at V's dtype, dS cast to K's dtype
before dS·K, dV from P and dO in f32, dS cast to Q's dtype before dSᵀ·Q.
The kernels take float32 or bfloat16 and D ≤ 128; any T (the ragged edge
is masked in the kernels).  A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _common


def _scale(q, scale):
    return scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)


def _causal_keep(T, device):
    return torch.ones(T, T, dtype=torch.bool, device=device).tril()


def flash_attention_ref(q, k, v, causal: bool = True, scale=None):
    """Plain PyTorch version: dense scores, a -1e30 causal mask, softmax,
    cast to the value dtype (the JAX dense branch of paged_prefill)."""
    T = q.shape[2]
    s = _scale(q, scale)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * s
    if causal:
        scores = scores.masked_fill(~_causal_keep(T, q.device), -1e30)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def _scores_f32(q, k, causal, scale):
    """f32 scores Q Kᵀ·scale from f32 products, masked with -1e30."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(q.shape[2], q.device), -1e30)
    return s


def flash_attention_fwd_ref(q, k, v, causal: bool = True, scale=None):
    """Plain version of K4: (out [B,H,T,D], lse [B·H, T] f32)."""
    B, H, T, _ = q.shape
    s = _scores_f32(q, k, causal, _scale(q, scale))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", p.float(), v.float()).to(q.dtype)
    return out, lse.reshape(B * H, T)


def _probs_and_ds(q, k, v, do, lse, delta, causal, scale):
    """P = exp(S·scale − lse) (zero where masked) and dS = P∘(dP − δ)·scale
    with dP from dO at V's dtype, all f32 [B,H,T,T]."""
    B, H, T, _ = q.shape
    s = _scores_f32(q, k, causal, scale)
    p = torch.exp(s - lse.reshape(B, H, T, 1).float())
    dp = torch.einsum("bhqd,bhkd->bhqk", do.to(v.dtype).float(), v.float())
    ds = p * (dp - delta.reshape(B, H, T, 1)) * scale
    return p, ds


def _delta(o, do):
    """δ = rowsum(O∘dO) in f32, [B·H, T]."""
    B, H, T, _ = o.shape
    return (o.float() * do.float()).sum(-1).reshape(B * H, T)


def flash_attention_dq_ref(q, k, v, do, lse, delta, causal=True,
                           scale=None):
    """Plain version of K5: dQ = (dS cast to K's dtype)·K."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, _scale(q, scale))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


def flash_attention_dkv_ref(q, k, v, do, lse, delta, causal=True,
                            scale=None):
    """Plain version of K6: dV = Pᵀ·dO in f32 and dK = (dS cast to Q's
    dtype)ᵀ·Q."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, _scale(q, scale))
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal: bool = True,
                            scale=None):
    """Plain version of the whole backward: (dq, dk, dv), the FA-2
    formulas from the saved lse (not autograd)."""
    delta = _delta(o, do)
    dq = flash_attention_dq_ref(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_attention_dkv_ref(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


def _check(name, q, *others):
    """The kernels' contract on CUDA tensors: one [B,H,T,D] shape and one
    dtype on one device, D ≤ 128, B·H ≤ 65535 (grid.y); returns the
    tensors made contiguous."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if q.ndim != 4 or any(t.shape != q.shape for t in others):
        raise ValueError(f"{name}: q, k, v (and dO) must share one "
                         f"[B,H,T,D] shape, got {tuple(q.shape)}, "
                         f"{[tuple(t.shape) for t in others]}")
    if any(t.dtype != q.dtype for t in others):
        raise TypeError(f"{name}: inputs must share one dtype")
    if any(t.device != q.device for t in others):
        raise ValueError(f"{name}: inputs must share one device")
    B, H, _, D = q.shape
    if D > 128:
        raise ValueError(f"{name}: head dim {D} > 128")
    if B * H > 65535:
        raise ValueError(f"{name}: B*H = {B * H} > 65535 (grid.y)")
    return [t.contiguous() for t in (q, *others)]


def _rows(name, t, q):
    """A [B·H, T] f32 row vector (lse, δ) on q's device."""
    B, H, T, _ = q.shape
    if t.numel() != B * H * T or t.device != q.device:
        raise ValueError(f"{name}: expected [B*H, T] = [{B * H}, {T}] on "
                         f"{q.device}, got {tuple(t.shape)} on {t.device}")
    return t.reshape(B * H, T).float().contiguous()


def _fwd_launch(name, q, k, v, causal, scale, with_lse):
    q, k, v = _check(name, q, k, v)
    B, H, T, D = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty(B * H, T, dtype=torch.float32, device=q.device)
           if with_lse else None)
    _common.launch("ptt_flash_attention_fwd", q, k, v, out, lse, B * H, T,
                   D, int(bool(causal)), float(_scale(q, scale)),
                   _common.dtype_code(q), device=q.device)
    return out, lse


def flash_attention(q, k, v, causal: bool = True, scale=None):
    """K1: q, k, v [B, H, T, D] → [B, H, T, D]."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, scale)
    out, _ = _fwd_launch("flash_attention", q, k, v, causal, scale, False)
    flash_attention.launches += 1
    return out


def flash_attention_fwd(q, k, v, causal: bool = True, scale=None):
    """K4: (out [B,H,T,D], lse [B·H, T] f32), the training forward."""
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, causal, scale)
    out, lse = _fwd_launch("flash_attention_fwd", q, k, v, causal, scale,
                           True)
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_dq(q, k, v, do, lse, delta, causal=True, scale=None):
    """K5: dQ [B,H,T,D] in q's dtype from the saved lse and δ."""
    if q.device.type == "cpu":
        return flash_attention_dq_ref(q, k, v, do, lse, delta, causal, scale)
    q, k, v, do = _check("flash_attention_dq", q, k, v, do)
    B, H, T, D = q.shape
    lse = _rows("flash_attention_dq: lse", lse, q)
    delta = _rows("flash_attention_dq: delta", delta, q)
    dq = torch.empty_like(q)
    _common.launch("ptt_flash_attention_dq", q, k, v, do, lse, delta, dq,
                   B * H, T, D, int(bool(causal)), float(_scale(q, scale)),
                   _common.dtype_code(q), device=q.device)
    flash_attention_dq.launches += 1
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, causal=True, scale=None):
    """K6: (dK, dV) [B,H,T,D] from the saved lse and δ."""
    if q.device.type == "cpu":
        return flash_attention_dkv_ref(q, k, v, do, lse, delta, causal,
                                       scale)
    q, k, v, do = _check("flash_attention_dkv", q, k, v, do)
    B, H, T, D = q.shape
    lse = _rows("flash_attention_dkv: lse", lse, q)
    delta = _rows("flash_attention_dkv: delta", delta, q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _common.launch("ptt_flash_attention_dkv", q, k, v, do, lse, delta, dk,
                   dv, B * H, T, D, int(bool(causal)),
                   float(_scale(q, scale)), _common.dtype_code(q),
                   device=q.device)
    flash_attention_dkv.launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        scale=None):
    """(dq, dk, dv): δ = rowsum(O∘dO) in f32 (a torch op, as the JAX
    package computes it outside its kernels), then K5 and K6."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal, scale)
    do = do.to(q.dtype)
    delta = _delta(o, do)
    dq = flash_attention_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


for _fn in (flash_attention, flash_attention_fwd, flash_attention_dq,
            flash_attention_dkv):
    _fn.launches = 0


class FlashAttentionTrain(torch.autograd.Function):
    """Attention for training, the counterpart of JAX ``make_flash_train``:
    the forward runs K4 and saves (q, k, v, out, lse); the backward runs
    K5 and K6.  On CPU tensors both take the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None
