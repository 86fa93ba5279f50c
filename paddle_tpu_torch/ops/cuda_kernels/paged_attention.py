"""Paged (ragged) KV-cache attention: two CUDA kernels and their plain
PyTorch versions.

* ``paged_attention`` (``csrc/paged_attention.cu``, replacing the Pallas
  kernel ``paddle_tpu/ops/pallas_kernels/paged_attention.py:
  paged_attention``): one query token per slot, the decode step.
* ``paged_attention_mq`` (``csrc/paged_attention_mq.cu``, replacing
  ``paged_attention_mq`` of the same Pallas module): C query rows per
  slot, the chunked-prefill and speculative-verify step.

Decode contract:
  q          [N, nh, dh]      one query token per sequence slot
  k_pages    [P, nh, ps, dh]  shared K pool (page 0 = reserved null page)
  v_pages    [P, nh, ps, dh]  shared V pool
  page_table [N, maxp]        logical block -> physical page; entries
                              beyond a sequence's pages must still be
                              valid pool indices (the allocator keeps
                              them 0, the null page)
  ctx_lens   [N]              valid context length per slot, >= 1
  -> [N, nh, dh]
Positions ``j*ps + t >= ctx_lens[n]`` are masked out.

Multi-query contract: q [N, nh, C, dh] (C positions per slot, the head
layout ``_lm_fns.block`` hands ``attend``), the same pools and table,
ctx_lens [N] (TOTAL attended length, >= 1) and q_starts [N] (absolute
position of query row 0); row c of slot n sees the keys
``{p : p <= q_starts[n] + c and p < ctx_lens[n]}`` -> [N, nh, C, dh].
Position 0 is always visible, so rows past a lane's valid chunk are
finite garbage that callers mask.

The kernels take float32 or bfloat16 pools and dh ≤ 128.  The
preconditions ``ctx_lens >= 1`` and ``q_starts >= 0`` are not checked on
the host: checking would synchronise.

Both kernels split a slot's page walk across blocks (``csrc/
paged_split.cuh``): ``PAGES_PER_SPLIT`` pages a block, ``MQ_ROWS`` query
rows a K3 block.  Each block writes a partial softmax per row, f32
(m, l) pairs and unnormalized accumulators, which the wrapper allocates
and a second kernel merges into the output.  The constants mirror the CUDA sources' ``kPagesPerSplit``
and ``kMqRows`` (``tests/test_torch_paged_split.py`` reads them there).
"""

from __future__ import annotations

import torch

from . import _common

PAGES_PER_SPLIT = 8  # csrc/paged_split.cuh kPagesPerSplit
MQ_ROWS = 64         # csrc/paged_attention_mq.cu kMqRows


def n_splits(maxp):
    """Blocks the walk of one (slot, head[, row tile]) is cut into."""
    return -(-maxp // PAGES_PER_SPLIT)


def _partials(rows, maxp, dh, device):
    """The split partials of `rows` output rows in one f32 allocation:
    (the buffer, which the caller holds through the launch, the address of
    its (m, l) pairs, of its accumulators)."""
    S = n_splits(maxp)
    buf = torch.empty(rows * S * (2 + dh), dtype=torch.float32,
                      device=device)
    return buf, buf.data_ptr(), buf.data_ptr() + rows * S * 2 * 4


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


def paged_attention_mq_ref(q, k_pages, v_pages, page_table, ctx_lens,
                           q_starts, scale=None):
    """Plain PyTorch version of the multi-query walk: the dense gather of
    ``paged_attention_ref`` with a per-row causal bound (the JAX
    ``paged_attention_mq_ref`` oracle)."""
    N, nh, C, dh = q.shape
    ps = k_pages.shape[2]
    maxp = page_table.shape[1]
    s = scale if scale is not None else 1.0 / (dh ** 0.5)
    pt = page_table.to(device=q.device, dtype=torch.int64)

    def dense(pages):  # [P,nh,ps,dh] -> [N,nh,maxp*ps,dh]
        g = pages[pt]  # [N,maxp,nh,ps,dh]
        return g.permute(0, 2, 1, 3, 4).reshape(N, nh, maxp * ps, dh)

    k = dense(k_pages)
    v = dense(v_pages)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * s
    kp = torch.arange(maxp * ps, device=q.device)[None, None, None, :]
    qp = (q_starts.to(q.device, torch.int64)[:, None]
          + torch.arange(C, device=q.device)[None, :])[:, None, :, None]
    cl = ctx_lens.to(q.device, torch.int64)[:, None, None, None]
    scores = scores.masked_fill(~((kp <= qp) & (kp < cl)), -1e30)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def _check_paged(name, q, k_pages, v_pages, page_table, lens):
    """The checks both kernels' wrappers share: q [N, nh, ..., dh]
    against the pools [P, nh, ps, dh], the table and the per-slot
    vectors in `lens`."""
    N, nh, dh = q.shape[0], q.shape[1], q.shape[-1]
    if k_pages.ndim != 4 or k_pages.shape != v_pages.shape \
            or k_pages.shape[1] != nh or k_pages.shape[3] != dh:
        raise ValueError(f"{name}: pools {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"{name}: q and the pools must share one dtype")
    if k_pages.device != q.device or v_pages.device != q.device:
        raise ValueError(f"{name}: q and the pools must share one device")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError(f"{name}: the pools must be contiguous")
    if page_table.ndim != 2 or page_table.shape[0] != N \
            or any(tuple(t.shape) != (N,) for t in lens):
        raise ValueError(f"{name}: page_table {tuple(page_table.shape)} / "
                         f"{[tuple(t.shape) for t in lens]} do not match "
                         f"N={N}")
    if dh > 128:
        raise ValueError(f"{name}: head dim {dh} > 128")


def _i32(t, device):
    """An index tensor as contiguous int32 on `device` (torch indexes
    with int64; the kernels take int32)."""
    return t.to(device=device, dtype=torch.int32).contiguous()


def paged_attention(q, k_pages, v_pages, page_table, ctx_lens, scale=None):
    """See the module docstring.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_table, ctx_lens,
                                   scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {q.device}")
    _check_paged("paged_attention", q, k_pages, v_pages, page_table,
                 [ctx_lens])
    N, nh, dh = q.shape
    code = _common.dtype_code(q)
    ps = k_pages.shape[2]
    maxp = page_table.shape[1]
    s = scale if scale is not None else 1.0 / (dh ** 0.5)
    q = q.contiguous()
    out = torch.empty_like(q)
    buf, ml, acc = _partials(N * nh, maxp, dh, q.device)
    _common.launch("ptt_paged_attention_fwd", q, k_pages, v_pages,
                   _i32(page_table, q.device), _i32(ctx_lens, q.device),
                   out, ml, acc, N, nh, dh, ps, maxp, float(s), code,
                   device=q.device)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_attention_mq(q, k_pages, v_pages, page_table, ctx_lens, q_starts,
                       scale=None):
    """See the module docstring.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    if q.device.type == "cpu":
        return paged_attention_mq_ref(q, k_pages, v_pages, page_table,
                                      ctx_lens, q_starts, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_mq: no kernel for device "
                         f"{q.device}")
    if q.ndim != 4:
        raise ValueError(f"paged_attention_mq: q {tuple(q.shape)} is not "
                         f"[N, nh, C, dh]")
    _check_paged("paged_attention_mq", q, k_pages, v_pages, page_table,
                 [ctx_lens, q_starts])
    N, nh, C, dh = q.shape
    code = _common.dtype_code(q)
    ps = k_pages.shape[2]
    maxp = page_table.shape[1]
    s = scale if scale is not None else 1.0 / (dh ** 0.5)
    q = q.contiguous()
    out = torch.empty_like(q)
    buf, ml, acc = _partials(N * nh * C, maxp, dh, q.device)
    _common.launch("ptt_paged_attention_mq_fwd", q, k_pages, v_pages,
                   _i32(page_table, q.device), _i32(ctx_lens, q.device),
                   _i32(q_starts, q.device), out, ml, acc, N, nh, C, dh, ps,
                   maxp, float(s), code, device=q.device)
    paged_attention_mq.launches += 1
    return out


paged_attention_mq.launches = 0
