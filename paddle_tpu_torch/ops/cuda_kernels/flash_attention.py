"""Causal flash attention forward: the CUDA kernel
(``csrc/flash_attention.cu``, replacing the Pallas kernel
``paddle_tpu/ops/pallas_kernels/flash_attention.py: flash_attention``) and
its plain PyTorch version.

Contract: q, k, v [B, H, T, D] → [B, H, T, D], softmax(Q Kᵀ·scale
[+ causal mask]) V with f32 scores and P cast to the value dtype before
P·V.  The kernel takes float32 or bfloat16 and D ≤ 128; any T (the ragged
edge is masked in the kernel).
"""

from __future__ import annotations

import torch

from . import _common


def flash_attention_ref(q, k, v, causal: bool = True, scale=None):
    """Plain PyTorch version: dense scores, a -1e30 causal mask, softmax,
    cast to the value dtype (the JAX dense branch of paged_prefill)."""
    T, D = q.shape[2], q.shape[3]
    s = scale if scale is not None else 1.0 / (D ** 0.5)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * s
    if causal:
        keep = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, -1e30)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def flash_attention(q, k, v, causal: bool = True, scale=None):
    """q, k, v [B, H, T, D] → [B, H, T, D].  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q, k, v must share one "
                         f"[B,H,T,D] shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must share one dtype")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v must share one device")
    B, H, T, D = q.shape
    if D > 128:
        raise ValueError(f"flash_attention: head dim {D} > 128")
    code = _common.dtype_code(q)
    s = scale if scale is not None else 1.0 / (D ** 0.5)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    _common.launch("ptt_flash_attention_fwd", q, k, v, out, B * H, T, D,
                   int(bool(causal)), float(s), code, device=q.device)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
