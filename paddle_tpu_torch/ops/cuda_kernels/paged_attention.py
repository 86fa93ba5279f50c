"""Paged (ragged) KV-cache decode attention: the CUDA kernel
(``csrc/paged_attention.cu``, replacing the Pallas kernel
``paddle_tpu/ops/pallas_kernels/paged_attention.py: paged_attention``) and
its plain PyTorch version.

Contract:
  q          [N, nh, dh]      one query token per sequence slot
  k_pages    [P, nh, ps, dh]  shared K pool (page 0 = reserved null page)
  v_pages    [P, nh, ps, dh]  shared V pool
  page_table [N, maxp]        logical block -> physical page; entries
                              beyond a sequence's pages must still be
                              valid pool indices (the allocator keeps
                              them 0, the null page)
  ctx_lens   [N]              valid context length per slot, >= 1
  -> [N, nh, dh]
Positions ``j*ps + t >= ctx_lens[n]`` are masked out.  The kernel takes
float32 or bfloat16 pools and dh ≤ 128.  Its precondition ``ctx_lens >= 1``
is not checked on the host: checking would synchronise.
"""

from __future__ import annotations

import torch

from . import _common


def paged_attention_ref(q, k_pages, v_pages, page_table, ctx_lens,
                        scale=None):
    """Plain PyTorch version: gather the page table into a dense
    [N, nh, maxp*ps, dh] view, f32 scores, a -1e30 mask, softmax, cast to
    the value dtype (the JAX ``paged_attention_ref`` oracle)."""
    N, nh, dh = q.shape
    ps = k_pages.shape[2]
    maxp = page_table.shape[1]
    s = scale if scale is not None else 1.0 / (dh ** 0.5)
    pt = page_table.to(device=q.device, dtype=torch.int64)

    def dense(pages):  # [P,nh,ps,dh] -> [N,nh,maxp*ps,dh]
        g = pages[pt]  # [N,maxp,nh,ps,dh]
        return g.permute(0, 2, 1, 3, 4).reshape(N, nh, maxp * ps, dh)

    k = dense(k_pages)
    v = dense(v_pages)
    scores = torch.einsum("bhd,bhkd->bhk", q, k).float() * s
    pos = torch.arange(maxp * ps, device=q.device)[None, None, :]
    keep = pos < ctx_lens.to(q.device)[:, None, None]
    scores = scores.masked_fill(~keep, -1e30)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhk,bhkd->bhd", p, v)


def paged_attention(q, k_pages, v_pages, page_table, ctx_lens, scale=None):
    """See the module docstring.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_table, ctx_lens,
                                   scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {q.device}")
    N, nh, dh = q.shape
    if k_pages.ndim != 4 or k_pages.shape != v_pages.shape \
            or k_pages.shape[1] != nh or k_pages.shape[3] != dh:
        raise ValueError(f"paged_attention: pools {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged_attention: q and the pools must share one "
                        "dtype")
    if k_pages.device != q.device or v_pages.device != q.device:
        raise ValueError("paged_attention: q and the pools must share one "
                         "device")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("paged_attention: the pools must be contiguous")
    if page_table.ndim != 2 or page_table.shape[0] != N \
            or tuple(ctx_lens.shape) != (N,):
        raise ValueError(f"paged_attention: page_table "
                         f"{tuple(page_table.shape)} / ctx_lens "
                         f"{tuple(ctx_lens.shape)} do not match N={N}")
    if dh > 128:
        raise ValueError(f"paged_attention: head dim {dh} > 128")
    code = _common.dtype_code(q)
    ps = k_pages.shape[2]
    maxp = page_table.shape[1]
    s = scale if scale is not None else 1.0 / (dh ** 0.5)
    q = q.contiguous()
    pt = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    cl = ctx_lens.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    _common.launch("ptt_paged_attention_fwd", q, k_pages, v_pages, pt, cl,
                   out, N, nh, dh, ps, maxp, float(s), code, device=q.device)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
