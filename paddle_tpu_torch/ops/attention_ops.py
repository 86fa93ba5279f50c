"""Attention ops — the port of ``scaled_dot_product_attention`` and the
serving ops of ``paddle_tpu/ops/attention_ops.py``.

``scaled_dot_product_attention`` is the tower's attention core: K1 in
eval mode (``is_test``), ``FlashAttentionTrain`` (K4 forward, K5/K6
backward) in a training program.

The serving ops run over the paged KV cache: ``paged_prefill`` (whole-prompt
prefill + first greedy token), ``paged_decode_step`` (one
continuous-batching decode step), ``paged_prefill_chunk`` (one prefill
chunk at a context offset; with ``all_tokens`` the speculative verify),
``paged_spec_draft`` (K chained draft decode steps) and
``paged_page_copy`` (the prefix cache's copy-on-write).

The K/V pools ride the executor's read-then-written state idiom (input
slot KPool and output slot KPoolOut name the SAME variable).  Where the
JAX ops update the pools functionally, these write them IN PLACE on the
scope's tensor and hand the same tensor back, so a pool is never copied.
Attention goes through the kernel wrappers, which take the plain version
for a CPU tensor and the CUDA kernel for a CUDA tensor.

``attention_gru_decoder`` is the attention-NMT model's teacher-forced
decoder (Bahdanau additive attention, ``score = v·tanh(W_q h + W_m
enc)``, feeding a GRU cell).  The JAX package computes it outside any
Pallas kernel, as a ``lax.scan`` that XLA compiles; here it is a Python
loop over the target steps of stock PyTorch ops, and its gradient comes
through ``generic_grad``.  Generation runs the same cell over beam lanes:
``attention_gru_cell`` is one step of it (the user decoder inside a
``While`` block of the composable loop), ``beam_search_generate`` the
whole beam search in one op, in plain PyTorch as in the JAX package; its
top-k is ``stable_topk`` and its loop never reads the device on the
host.
"""

from __future__ import annotations

import torch

from .cuda_kernels.flash_attention import FlashAttentionTrain, flash_attention
from .cuda_kernels.paged_attention import paged_attention, paged_attention_mq
from .registry import register_op
from .tensor_ops import stable_topk
from .transformer_ops import _lm_fns, _prompt_2d, stable_argmax


@register_op("scaled_dot_product_attention")
def scaled_dot_product_attention(ctx, ins, attrs):
    """Multi-head attention core: Q, K, V [B,H,T,D] → [B,H,T,D].  One
    device, so the sequence-parallel modes (``sp_mode`` 'ring' or
    'alltoall', ``sp_schedule`` 'plain' or 'zigzag') take the single-card
    kernels, as the JAX package does without an 'sp' mesh axis; a desc
    carried in with another mode raises: sequence parallelism is not
    ported.  CPU tensors take the plain versions; CUDA tensors launch the
    kernels or raise (no shape gate: the kernels take any T and D ≤
    128)."""
    sp = (attrs.get("sp_mode", "ring"), attrs.get("sp_schedule", "plain"))
    if sp[0] not in ("ring", "alltoall") or sp[1] not in ("plain", "zigzag"):
        raise ValueError(
            f"scaled_dot_product_attention: sp_mode={sp[0]!r}, "
            f"sp_schedule={sp[1]!r} asks for sequence parallelism, which "
            f"is not ported (ROADMAP.md Queue A item 11)")
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    causal = bool(attrs.get("causal", False))
    if ctx.is_test:
        out = flash_attention(q, k, v, causal=causal)
    else:
        out = FlashAttentionTrain.apply(q, k, v, causal, None)
    return {"Out": [out]}


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
    # the kernels take int32: cast once here, not in every layer's call
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


@register_op("paged_prefill_chunk", grad=None,
             non_diff_inputs=("Tokens", "CtxLen", "ChunkLen", "PageTable"))
def paged_prefill_chunk(ctx, ins, attrs):
    """CHUNKED prefill: one fixed-size slice of a prompt, at a context
    offset, into the paged KV pools — the v2 engine's prefill quantum.
    Positions [ctx, ctx+chunk) are embedded, written through the page
    table, and attend over the WHOLE paged context so far (prefix-cache
    hits + earlier chunks + this chunk causally).

    Inputs: Tokens [K,C,1] int64 (chunk tokens, 0-padded), CtxLen [K,1]
    (positions already materialized), ChunkLen [K,1] (valid tokens this
    chunk; 0 = idle lane, all writes land in the null page), PageTable
    [K,maxp], KPool/VPool, plus the decode parameter slots.  Attrs:
    n_heads, page_size, eps, all_tokens.  Outputs: NextToken [K] int64
    (greedy pick at each lane's LAST valid chunk position; idle lanes
    emit 0), KPoolOut/VPoolOut, and with ``all_tokens=1`` ChunkTokens
    [K,C] int64 — the greedy pick after EVERY chunk position (0 past
    ChunkLen), the speculative verify read.

    Attention is the multi-query page walk (``paged_attention_mq``) with
    the key bound ``max(ctx + chunk, 1)``.  The JAX op's CPU path is a
    dense gather masked only by ``key <= query``; the two agree on every
    valid row and differ only in the garbage rows past ChunkLen."""
    nh = int(attrs["n_heads"])
    ps = int(attrs["page_size"])
    eps = float(attrs.get("eps", 1e-5))

    tokens = _prompt_2d(ins)  # [K,C] int64
    ctx0 = _squeeze_feed(ins["CtxLen"][0], torch.int64)
    clen = _squeeze_feed(ins["ChunkLen"][0], torch.int64)
    pt = ins["PageTable"][0].long()  # [K,maxp]
    kpool, vpool = ins["KPool"][0], ins["VPool"][0]

    fns = _lm_fns(ins, nh, eps)
    emb = ins["Emb"][0]
    cdt = emb.dtype
    scale = 1.0 / (fns.dh ** 0.5)
    K, C = tokens.shape
    maxp = pt.shape[1]

    i_idx = torch.arange(C, device=tokens.device)
    pos = ctx0[:, None] + i_idx[None, :]  # [K,C] absolute
    valid = i_idx[None, :] < clen[:, None]
    # pad/idle writes land in the null page; the pos-table gather clamps
    # so a pad tail running past max_len stays in range
    blk = torch.clamp(pos // ps, max=maxp - 1)
    page = torch.where(valid, pt.gather(1, blk), torch.zeros_like(blk))
    pages_f, offs_f = page.reshape(-1), (pos % ps).reshape(-1)
    pos_c = torch.clamp(pos, max=fns.pos.shape[0] - 1)
    # rows past ChunkLen attend through the key bound (kp < attend_len);
    # >= 1 keeps every row's normalizer positive
    attend_len = torch.clamp(ctx0 + clen, min=1)
    pt32, len32, q032 = (t.to(torch.int32) for t in (pt, attend_len, ctx0))

    def rows(a):  # [K,nh,C,dh] -> [K*C,nh,dh]
        return a.transpose(1, 2).reshape(K * C, nh, fns.dh)

    def attend(i, q, k, v):
        _paged_pools_write(kpool, i, pages_f, offs_f, rows(k))
        _paged_pools_write(vpool, i, pages_f, offs_f, rows(v))
        return paged_attention_mq(q, kpool[i], vpool[i], pt32, len32, q032,
                                  scale=scale)

    x = emb[tokens] + fns.pos[pos_c].to(cdt)  # [K,C,D]
    for i in range(fns.L):
        x = fns.block(i, x, attend)

    last_i = torch.clamp(clen - 1, min=0)
    last = x[torch.arange(K, device=x.device), last_i][:, None, :]
    nxt = stable_argmax(fns.head_logits(last), torch.int64)
    nxt = torch.where(clen > 0, nxt, torch.zeros_like(nxt))
    out = {"NextToken": [nxt], "KPoolOut": [kpool], "VPoolOut": [vpool]}
    if int(attrs.get("all_tokens", 0)):
        ctoks = stable_argmax(fns.head_logits_all(x), torch.int64)  # [K,C]
        out["ChunkTokens"] = [torch.where(valid, ctoks,
                                          torch.zeros_like(ctoks))]
    return out


@register_op("paged_spec_draft", grad=None,
             non_diff_inputs=("Tokens", "CtxLen", "SpecLen", "PageTable"))
def paged_spec_draft(ctx, ins, attrs):
    """K chained DRAFT decode steps in ONE op — the proposal half of
    speculative decoding.

    The parameter slots carry the DRAFT tower: a depth-truncated prefix of
    the target (``DecoderLM.truncated``), so draft layer i IS target
    layer i and the K/V the draft writes at pool layer i are the values
    the target would write there.  The pools are the TARGET's; layers at
    or past the draft depth are never touched.

    Inputs: Tokens [N,1] int64 (each slot's last emitted token — not yet
    in the cache), CtxLen [N,1], SpecLen [N,1] (tokens to draft; 0 idles
    the slot: its writes land in the null page and it emits 0s),
    PageTable [N,maxp], KPool/VPool, plus the draft parameter slots.
    Attrs: n_heads, page_size, eps, k_steps.  Outputs: Drafted
    [N, k_steps] int64 (column k is garbage where k >= SpecLen),
    KPoolOut/VPoolOut."""
    nh = int(attrs["n_heads"])
    ps = int(attrs["page_size"])
    eps = float(attrs.get("eps", 1e-5))
    K = int(attrs["k_steps"])

    tok = _squeeze_feed(ins["Tokens"][0], torch.int64)
    ctxl = _squeeze_feed(ins["CtxLen"][0], torch.int64)
    slen = _squeeze_feed(ins["SpecLen"][0], torch.int64)
    pt = ins["PageTable"][0].long()
    kpool, vpool = ins["KPool"][0], ins["VPool"][0]

    fns = _lm_fns(ins, nh, eps)
    emb = ins["Emb"][0]
    cdt = emb.dtype
    scale = 1.0 / (fns.dh ** 0.5)
    maxp = pt.shape[1]
    pt32 = pt.to(torch.int32)

    drafted = []
    for k in range(K):
        act = k < slen
        p_abs = ctxl + k
        page = pt.gather(1, torch.clamp(p_abs // ps, max=maxp - 1)[:, None])
        page = torch.where(act, page[:, 0], torch.zeros_like(p_abs))
        off = p_abs % ps
        attend_len = torch.where(act, p_abs + 1,
                                 torch.ones_like(p_abs)).to(torch.int32)
        p_row = torch.clamp(p_abs, max=fns.pos.shape[0] - 1)
        x = emb[tok][:, None, :] + fns.pos[p_row].to(cdt)[:, None, :]

        def attend(i, q, k_, v_, page=page, off=off, attend_len=attend_len):
            _paged_pools_write(kpool, i, page, off, k_[:, :, 0])
            _paged_pools_write(vpool, i, page, off, v_[:, :, 0])
            out = paged_attention(q[:, :, 0], kpool[i], vpool[i], pt32,
                                  attend_len, scale=scale)
            return out[:, :, None, :]

        for i in range(fns.L):
            x = fns.block(i, x, attend)
        nxt = stable_argmax(fns.head_logits(x), torch.int64)
        tok = torch.where(act, nxt, torch.zeros_like(nxt))
        drafted.append(tok)

    return {"Drafted": [torch.stack(drafted, dim=1)], "KPoolOut": [kpool],
            "VPoolOut": [vpool]}


@register_op("paged_page_copy", grad=None, non_diff_inputs=("Src", "Dst"))
def paged_page_copy(ctx, ins, attrs):
    """Device-side page copy for prefix-cache COPY-ON-WRITE: duplicate
    physical page Src into Dst across every layer of both pools, in place.

    Inputs: Src/Dst [M,1] int64 page ids (unused lanes pass src=dst=0, a
    null-page no-op), KPool/VPool.  Outputs: Out [M] int64 (the dst ids),
    KPoolOut/VPoolOut.  The right-hand side is gathered before the
    write, so a copy never reads a page it has already written."""
    src = _squeeze_feed(ins["Src"][0], torch.int64)
    dst = _squeeze_feed(ins["Dst"][0], torch.int64)
    kpool, vpool = ins["KPool"][0], ins["VPool"][0]
    kpool[:, dst] = kpool[:, src]
    vpool[:, dst] = vpool[:, src]
    return {"Out": [dst], "KPoolOut": [kpool], "VPoolOut": [vpool]}


# ---------------------------------------------------------------------------
# The attention-NMT decoder (training)


def _attend(h, enc_proj, enc_out, enc_mask, w_q, v):
    """h [B,H] or [B,K,H] (beam lanes); enc_proj [B,Ts,A]; enc_out
    [B,Ts,E]; enc_mask [B,Ts] → (context [B,(K,)E], weights [B,(K,)Ts])."""
    q = h @ w_q
    if h.ndim == 2:
        e = torch.tanh(enc_proj + q[:, None, :]) @ v
        e = torch.where(enc_mask > 0, e, -1e9)
        a = torch.softmax(e, dim=-1)
        return torch.einsum("bt,bte->be", a, enc_out), a
    e = torch.tanh(enc_proj[:, None] + q[:, :, None, :]) @ v  # [B,K,Ts]
    e = torch.where(enc_mask[:, None] > 0, e, -1e9)
    a = torch.softmax(e, dim=-1)
    return torch.einsum("bkt,bte->bke", a, enc_out), a


def _mask(lengths, T):
    """[B, T] f32: 1 where t < lengths[b]."""
    return (torch.arange(T, device=lengths.device)[None, :]
            < lengths[:, None]).float()


def _gru_cell(xc, h, w_in, b_in, w_h):
    """xc [B,Din] (input ++ context), h [B,H]; w_in [Din,3H], w_h [H,3H]."""
    H = h.shape[-1]
    g_in = xc @ w_in + b_in
    g = g_in[..., :2 * H] + h @ w_h[:, :2 * H]
    u = torch.sigmoid(g[..., :H])
    r = torch.sigmoid(g[..., H:])
    c = torch.tanh(g_in[..., 2 * H:] + (r * h) @ w_h[:, 2 * H:])
    return u * h + (1 - u) * c


@register_op("attention_gru_decoder",
             non_diff_inputs=("EncLength", "TgtLength"))
def attention_gru_decoder(ctx, ins, attrs):
    """Teacher-forced attention decoder.

    Inputs: EncOut [B,Ts,E], EncLength [B], TgtEmb [B,Tt,D], TgtLength [B],
    H0 [B,H], WIn [D+E,3H], BIn [3H], WH [H,3H], WQuery [H,A], WMem [E,A],
    V [A].  Outputs: Hidden [B,Tt,H], Context [B,Tt,E].  Every target step
    is computed, padded ones too: the loss masks them."""
    enc_out = ins["EncOut"][0]
    enc_len = ins["EncLength"][0]
    tgt = ins["TgtEmb"][0]
    h = ins["H0"][0]
    w_in, b_in = ins["WIn"][0], ins["BIn"][0]
    w_h = ins["WH"][0]
    w_q, w_m, v = ins["WQuery"][0], ins["WMem"][0], ins["V"][0]

    enc_mask = _mask(enc_len, enc_out.shape[1])
    enc_proj = enc_out @ w_m  # [B,Ts,A], hoisted out of the loop
    hs, ctxs = [], []
    for t in range(tgt.shape[1]):
        ctx_vec, _ = _attend(h, enc_proj, enc_out, enc_mask, w_q, v)
        h = _gru_cell(torch.cat([tgt[:, t], ctx_vec], dim=-1), h, w_in,
                      b_in, w_h)
        hs.append(h)
        ctxs.append(ctx_vec)
    return {"Hidden": [torch.stack(hs, 1)], "Context": [torch.stack(ctxs, 1)]}


def _dec_weights(ins):
    return (ins["WIn"][0], ins["BIn"][0], ins["WH"][0], ins["WQuery"][0],
            ins["WMem"][0], ins["V"][0], ins["WOut"][0], ins["BOut"][0])


@register_op("attention_gru_cell", grad=None,
             non_diff_inputs=("EncLength", "Tokens"))
def attention_gru_cell(ctx, ins, attrs):
    """ONE decoder step over beam lanes, the user decoder of the
    composable generation loop.  Inputs: EncOut [B,Ts,E], EncLength [B],
    H [B,K,H], Tokens [B,K] int, Embedding [V,D], WIn/BIn/WH/WQuery/WMem/V
    as attention_gru_decoder's, WOut [H,Vo], BOut [Vo].  Outputs: HNew
    [B,K,H], Logp [B,K,Vo] (log-softmax)."""
    enc_out, h = ins["EncOut"][0], ins["H"][0]
    w_in, b_in, w_h, w_q, w_m, v, w_out, b_out = _dec_weights(ins)
    enc_mask = _mask(ins["EncLength"][0], enc_out.shape[1])
    x = ins["Embedding"][0][ins["Tokens"][0].long()]  # [B,K,D]
    ctx_vec, _ = _attend(h, enc_out @ w_m, enc_out, enc_mask, w_q, v)
    h_new = _gru_cell(torch.cat([x, ctx_vec], dim=-1), h, w_in, b_in, w_h)
    logits = h_new @ w_out + b_out
    return {"HNew": [h_new], "Logp": [torch.log_softmax(logits, dim=-1)]}


@register_op("beam_search_generate", grad=None)
def beam_search_generate(ctx, ins, attrs):
    """Beam-search decoding in one op.

    Inputs: EncOut [B,Ts,E], EncLength [B], Embedding [V,D], H0 [B,H], the
    decoder cell's weights and WOut/BOut.  Attrs: beam_size, max_len,
    bos_id, eos_id.  Outputs: Ids [B,K,max_len] int32, Scores [B,K]
    (total log-prob), Lengths [B,K] int32.  Lane 0 starts live and the
    others dead (identical lanes would divide the search); a finished
    lane extends with eos at zero cost."""
    enc_out, emb, h0 = ins["EncOut"][0], ins["Embedding"][0], ins["H0"][0]
    w_in, b_in, w_h, w_q, w_m, v, w_out, b_out = _dec_weights(ins)
    K = int(attrs.get("beam_size", 4))
    L = int(attrs.get("max_len", 32))
    bos = int(attrs.get("bos_id", 0))
    eos = int(attrs.get("eos_id", 1))

    B, Ts, _ = enc_out.shape
    H = h0.shape[-1]
    Vo = w_out.shape[-1]
    dev = enc_out.device
    enc_mask = _mask(ins["EncLength"][0], Ts)
    enc_proj = enc_out @ w_m

    h = h0[:, None].expand(B, K, H)
    tokens = torch.full((B, K), bos, dtype=torch.int64, device=dev)
    lane = torch.arange(K, device=dev)[None, :]
    scores = torch.where(lane == 0, 0.0, -1e9).expand(B, K)
    finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
    ids = torch.zeros((B, K, L), dtype=torch.int32, device=dev)
    lengths = torch.zeros((B, K), dtype=torch.int32, device=dev)
    eos_only = torch.full((Vo,), -1e9, device=dev)
    eos_only[eos] = 0.0
    for t in range(L):
        ctx_vec, _ = _attend(h, enc_proj, enc_out, enc_mask, w_q, v)
        h_new = _gru_cell(torch.cat([emb[tokens], ctx_vec], dim=-1), h,
                          w_in, b_in, w_h)
        logp = torch.log_softmax(h_new @ w_out + b_out, dim=-1)  # [B,K,Vo]
        logp = torch.where(finished[..., None], eos_only, logp)
        scores, top = stable_topk(
            (scores[..., None] + logp).reshape(B, K * Vo), K)
        beam = top // Vo
        tokens = top % Vo
        h = torch.gather(h_new, 1, beam[..., None].expand(B, K, H))
        fin = torch.gather(finished, 1, beam)
        ids = torch.gather(ids, 1, beam[..., None].expand(B, K, L))
        ids[:, :, t] = torch.where(fin, eos, tokens).to(torch.int32)
        lengths = torch.gather(lengths, 1, beam) + (~fin).to(torch.int32)
        finished = fin | (tokens == eos)
    return {"Ids": [ids], "Scores": [scores], "Lengths": [lengths]}
