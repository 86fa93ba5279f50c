"""Serving ops over the paged KV cache: ``paged_prefill`` (whole-prompt
prefill + first greedy token) and ``paged_decode_step`` (one
continuous-batching decode step) — the port of the two ops of
``paddle_tpu/ops/attention_ops.py`` the fifo engine runs.

The K/V pools ride the executor's read-then-written state idiom (input
slot KPool and output slot KPoolOut name the SAME variable).  Where the
JAX ops update the pools functionally, these write them IN PLACE on the
scope's tensor and hand the same tensor back, so a pool is never copied.
Attention goes through the kernel wrappers, which take the plain version
for a CPU tensor and the CUDA kernel for a CUDA tensor.
"""

from __future__ import annotations

import torch

from .cuda_kernels.flash_attention import flash_attention
from .cuda_kernels.paged_attention import paged_attention
from .registry import register_op
from .transformer_ops import _lm_fns, _prompt_2d, stable_argmax


def _squeeze_feed(x, dtype):
    """[N,1] or [N] feed -> [N] in `dtype` (layers.data always carries a
    trailing payload dim; emitters want flat vectors)."""
    if x.ndim == 2:
        x = x[:, 0]
    return x.to(dtype)


def _paged_pools_write(pool, layer, pages, offsets, values):
    """Scatter per-position K or V rows into the paged pool, in place.

    pool [L,P,nh,ps,dh]; pages/offsets [M] int64 (physical page and
    in-page slot per position); values [M,nh,dh].  The JAX op writes
    ``pool[layer, pages, :, offsets, :]``, where numpy's mixed advanced
    indexing moves the indexed axes to the front; here the layer's pool is
    viewed as [P,ps,nh,dh] so (page, slot) pairs index rows of `values`
    directly.  Duplicate (page, offset) pairs only ever target the reserved
    null page 0 (prompt pad tail, inactive slots), where any winner is
    fine."""
    pool[layer].permute(0, 2, 1, 3).index_put_((pages, offsets), values)
    return pool


@register_op("paged_prefill", grad=None,
             non_diff_inputs=("Tokens", "PromptLen", "PageTable"))
def paged_prefill(ctx, ins, attrs):
    """Prompt prefill into the paged KV pools + first greedy token.

    Inputs: Tokens [N,P,1] (bucket-padded prompts), PromptLen [N,1],
    PageTable [N,maxp] (unallocated entries 0, the null page), KPool/VPool
    [L,num_pages,nh,ps,dh], plus the decode parameter slots.  Attrs:
    n_heads, page_size, eps.  Outputs: NextToken [N] int64 (greedy pick
    at each row's last prompt position), KPoolOut/VPoolOut (the input
    pools, written through).  Pad positions write K/V into the request's
    own pages or the null page; decode masks context to ctx_len and
    rewrites slot ctx_len before attending to it."""
    nh = int(attrs["n_heads"])
    ps = int(attrs["page_size"])
    eps = float(attrs.get("eps", 1e-5))

    tokens = _prompt_2d(ins)  # [N,P] int64
    plen = _squeeze_feed(ins["PromptLen"][0], torch.int64)
    pt = ins["PageTable"][0].long()  # [N,maxp]
    kpool, vpool = ins["KPool"][0], ins["VPool"][0]

    fns = _lm_fns(ins, nh, eps)
    emb = ins["Emb"][0]
    cdt = emb.dtype
    scale = 1.0 / (fns.dh ** 0.5)
    N, P = tokens.shape

    # position p -> physical page pt[n, p // ps], in-page slot p % ps
    p_idx = torch.arange(P, device=tokens.device)
    pages = pt[:, p_idx // ps].reshape(-1)  # [N*P]
    offs = (p_idx % ps).expand(N, P).reshape(-1)

    def rows(a):  # [N,nh,P,dh] -> [N*P,nh,dh]
        return a.transpose(1, 2).reshape(N * P, nh, fns.dh)

    def attend(i, q, k, v):
        _paged_pools_write(kpool, i, pages, offs, rows(k))
        _paged_pools_write(vpool, i, pages, offs, rows(v))
        # [N,nh,P,dh] is the kernel's [B,H,T,D] layout already
        return flash_attention(q, k, v, causal=True, scale=scale)

    x = emb[tokens] + fns.pos[:P].to(cdt)
    for i in range(fns.L):
        x = fns.block(i, x, attend)

    # each row's last REAL position (head_logits reads position -1)
    last = x[torch.arange(N, device=x.device), plen - 1][:, None, :]
    first = stable_argmax(fns.head_logits(last), torch.int64)
    return {"NextToken": [first], "KPoolOut": [kpool], "VPoolOut": [vpool]}


@register_op("paged_decode_step", grad=None,
             non_diff_inputs=("Tokens", "CtxLen", "Active", "PageTable"))
def paged_decode_step(ctx, ins, attrs):
    """ONE continuous-batching decode step over the paged KV cache.

    Inputs: Tokens [N,1] (the token each slot feeds this step — not yet
    in the cache; this op writes its K/V at position CtxLen), CtxLen [N,1]
    (tokens already cached per slot), Active [N,1] (0/1 — inactive slots
    write to the null page and emit token 0), PageTable [N,maxp],
    KPool/VPool, plus the decode parameter slots.  Attrs: n_heads,
    page_size, eps.  Outputs: NextToken [N] int64, KPoolOut/VPoolOut."""
    nh = int(attrs["n_heads"])
    ps = int(attrs["page_size"])
    eps = float(attrs.get("eps", 1e-5))

    tok = _squeeze_feed(ins["Tokens"][0], torch.int64)
    ctxl = _squeeze_feed(ins["CtxLen"][0], torch.int64)
    act = _squeeze_feed(ins["Active"][0], torch.int64) > 0
    pt = ins["PageTable"][0].long()
    kpool, vpool = ins["KPool"][0], ins["VPool"][0]

    fns = _lm_fns(ins, nh, eps)
    emb = ins["Emb"][0]
    cdt = emb.dtype
    scale = 1.0 / (fns.dh ** 0.5)

    # the new token's physical write slot; inactive lanes land in the
    # reserved null page 0
    page = pt.gather(1, (ctxl // ps)[:, None])[:, 0]
    page = torch.where(act, page, torch.zeros_like(page))
    off = ctxl % ps
    attend_len = ctxl + 1  # context including the token written this step
    pt32 = pt.to(torch.int32)
    len32 = attend_len.to(torch.int32)

    xt = emb[tok][:, None, :] + fns.pos[ctxl].to(cdt)[:, None, :]  # [N,1,D]

    def attend(i, q, k, v):
        _paged_pools_write(kpool, i, page, off, k[:, :, 0])
        _paged_pools_write(vpool, i, page, off, v[:, :, 0])
        out = paged_attention(q[:, :, 0], kpool[i], vpool[i], pt32, len32,
                              scale=scale)
        return out[:, :, None, :]

    x = xt
    for i in range(fns.L):
        x = fns.block(i, x, attend)
    nxt = stable_argmax(fns.head_logits(x), torch.int64)
    nxt = torch.where(act, nxt, torch.zeros_like(nxt))
    return {"NextToken": [nxt], "KPoolOut": [kpool], "VPoolOut": [vpool]}
