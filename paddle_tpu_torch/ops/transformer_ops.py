"""Decoder-LM forward machinery and the generation ops, the port of
``paddle_tpu/ops/transformer_ops.py``: ``_lm_fns`` (layer norm, heads,
one decoder block, the f32 LM head, the prompt ``prefill`` and one
cached ``decode_step``), ``_prompt_2d`` and ``stable_argmax``, which the
paged serving ops walk too, and the ops ``gpt_decode`` (greedy,
temperature and top-k sampling) and ``gpt_beam_decode`` (beam search).

Each generation op runs its whole loop: the prefill launches K1
(``flash_attention``, causal) once a layer, then G-1 cached decode steps
attend over a contiguous [L, N, nh, T, dh] cache in plain PyTorch.  The
loop never reads the device on the host: every step runs, and tokens
after an eos are masked to eos, as the JAX package's ``fori_loop``
does."""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F

from .cuda_kernels.flash_attention import flash_attention
from .registry import register_op
from .tensor_ops import stable_topk


def _lm_fns(ins, nh: int, eps: float):
    """Forward pieces over the decode-op parameter slots: layer norm,
    head split/merge, one pre-LN decoder block and the f32 LM head.  The
    batch dimension is whatever `x` carries."""
    emb = ins["Emb"][0]
    pos = ins["Pos"][0]
    L = len(ins["WQ"])
    D = emb.shape[1]
    dh = D // nh

    def ln(x, s, b):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + eps) * s + b

    def heads(x):  # [N,t,D] -> [N,nh,t,dh]
        return x.reshape(x.shape[0], -1, nh, dh).transpose(1, 2)

    def merge(x):  # [N,nh,t,dh] -> [N,t,D]
        return x.transpose(1, 2).reshape(x.shape[0], -1, D)

    def block(i, x, attend):
        """One decoder block; `attend(i, q, k, v)` maps heads to context."""
        h = ln(x, ins["Ln1S"][i], ins["Ln1B"][i])
        q = heads(h @ ins["WQ"][i])
        k = heads(h @ ins["WK"][i])
        v = heads(h @ ins["WV"][i])
        a = merge(attend(i, q, k, v)) @ ins["WO"][i]
        x = x + a
        h = ln(x, ins["Ln2S"][i], ins["Ln2B"][i])
        # jax.nn.gelu defaults to the tanh approximation; erf would split
        # greedy tokens against the reference
        m = F.gelu(h @ ins["W1"][i] + ins["B1"][i], approximate="tanh")
        return x + (m @ ins["W2"][i] + ins["B2"][i])

    def head_logits(x):
        """Final LN + LM head on the LAST position, in f32: [N,t,D] ->
        [N,V]."""
        x = ln(x, ins["LnfS"][0], ins["LnfB"][0])
        return x[:, -1].float() @ ins["WHead"][0].float()

    def head_logits_all(x):
        """Final LN + LM head on EVERY position, in f32: [N,t,D] ->
        [N,t,V] — the speculative-verify read of the chunk op.  LN and
        the head are position-wise, so row t equals head_logits() of the
        length-(t+1) slice."""
        x = ln(x, ins["LnfS"][0], ins["LnfB"][0])
        return x.float() @ ins["WHead"][0].float()

    cdt = emb.dtype  # compute dtype follows the parameters
    scale = 1.0 / (dh ** 0.5)

    def prefill(tokens, T):
        """Causal self-attention over the prompt tokens [N, P] through K1
        (its plain version on the CPU), caching K/V into the first P
        slots of [L, N, nh, T, dh] buffers.  Returns (last-position f32
        logits [N, V], kcache, vcache)."""
        N, P = tokens.shape
        kc = torch.zeros((L, N, nh, T, dh), dtype=cdt, device=emb.device)
        vc = torch.zeros_like(kc)

        def attend(i, q, k, v):
            kc[i, :, :, :P] = k
            vc[i, :, :, :P] = v
            # [N, nh, P, dh] is the kernel's [B, H, T, D] layout already
            return flash_attention(q, k, v, causal=True, scale=scale)

        x = emb[tokens] + pos[:P].to(cdt)
        for i in range(L):
            x = block(i, x, attend)
        return head_logits(x), kc, vc

    def decode_step(cur, kc, vc, write_at):
        """One cached step: embed `cur` [N] at position `write_at` (a host
        int), write its K/V into the caches there in place, attend over
        slots 0..write_at (f32 scores, the value dtype for P·V, as the
        JAX dense step; the masked slots past write_at add exact zeros
        there, so they are left out here).  Returns f32 logits [N, V]."""
        x = emb[cur][:, None, :] + pos[write_at:write_at + 1].to(cdt)
        n = write_at + 1

        def attend(i, q, k, v):
            kc[i, :, :, write_at] = k[:, :, 0]
            vc[i, :, :, write_at] = v[:, :, 0]
            s = torch.einsum("bhqd,bhkd->bhqk", q, kc[i, :, :, :n]).float() \
                * scale
            p = torch.softmax(s, dim=-1).to(v.dtype)
            return torch.einsum("bhqk,bhkd->bhqd", p, vc[i, :, :, :n])

        for i in range(L):
            x = block(i, x, attend)
        return head_logits(x)

    return SimpleNamespace(ln=ln, heads=heads, merge=merge, block=block,
                           head_logits=head_logits,
                           head_logits_all=head_logits_all, prefill=prefill,
                           decode_step=decode_step, L=L, D=D, dh=dh,
                           pos=pos)


def _prompt_2d(ins):
    """Tokens [N,P,1] or [N,P] -> [N,P] int64 (torch indexes with int64)."""
    tokens = ins["Tokens"][0]
    if tokens.ndim == 3:
        tokens = tokens[:, :, 0]
    return tokens.long()


def stable_argmax(logits, dtype):
    """Greedy pick, stable under tie-adjacent float wobble: compare in f32
    against the row max with a 1e-4 slack and take the LOWEST index at or
    above it, the rule every decode path of the reference shares.  torch's
    argmax takes no bool, hence the int8 cast (argmax returns the first
    maximal index)."""
    z = logits.float()
    m = z.max(dim=-1, keepdim=True).values
    return torch.argmax((z >= m - 1e-4).to(torch.int8), dim=-1).to(dtype)


def _check_len(fns, T):
    if fns.pos.shape[0] < T:
        raise ValueError(f"prompt + max_gen = {T} exceeds the position "
                         f"table's {fns.pos.shape[0]} rows")


@register_op("gpt_decode", grad=None, draws_rng=True)
def gpt_decode(ctx, ins, attrs):
    """Greedy or sampled KV-cached generation.

    Inputs: Tokens [B, P, 1] int64 prompt; Emb [V, D]; Pos [max_len, D];
    per-layer lists (length L): Ln1S/Ln1B, WQ/WK/WV/WO, Ln2S/Ln2B, W1, B1,
    W2, B2; LnfS/LnfB; WHead [D, V].  Attrs: n_heads, max_gen, eos_id (-1:
    no eos masking), eps, temperature (0: ``stable_argmax``; > 0: sample
    softmax(logits / temperature)), top_k (with sampling, keep the k most
    likely tokens; 0: the whole vocab).  Output: Ids [B, max_gen] int64
    (eos after an emitted eos).

    Sampling draws Gumbel noise from ``ctx.generator(attrs, t)``: the
    run's (seed, step, uid) stream with the step t folded in (the first
    token takes t = max_gen, as the JAX package folds its key), and adds
    it to the logits before an argmax — the Gumbel-max rule that
    ``jax.random.categorical`` samples by, from torch's bits."""
    nh = int(attrs["n_heads"])
    G = int(attrs["max_gen"])
    eos = int(attrs.get("eos_id", -1))
    temp = float(attrs.get("temperature", 0.0))
    top_k = int(attrs.get("top_k", 0))

    def pick(logits, t):
        if temp <= 0.0:
            return stable_argmax(logits, torch.int64)
        z = logits / temp
        if top_k > 0:
            kth = torch.topk(z, min(top_k, z.shape[-1]), dim=-1).values
            z = torch.where(z < kth[:, -1:], -1e30, z)
        u = torch.rand(z.shape, generator=ctx.generator(attrs, t),
                       device=z.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(
            torch.finfo(torch.float32).tiny)))
        return torch.argmax(z + gumbel, dim=-1)

    tokens = _prompt_2d(ins)
    B, P = tokens.shape
    fns = _lm_fns(ins, nh, float(attrs.get("eps", 1e-5)))
    _check_len(fns, P + G)
    logits, kc, vc = fns.prefill(tokens, P + G)
    cur = pick(logits, G)
    out = torch.empty((B, G), dtype=torch.int64, device=tokens.device)
    out[:, 0] = cur
    done = torch.zeros(B, dtype=torch.bool, device=tokens.device)
    for t in range(G - 1):
        nxt = pick(fns.decode_step(cur, kc, vc, P + t), t)
        if eos >= 0:
            # the done update precedes the masking, or one token after an
            # eos would leak through
            done = done | (cur == eos)
            nxt = torch.where(done, eos, nxt)
        out[:, t + 1] = nxt
        cur = nxt
    return {"Ids": [out]}


@register_op("gpt_beam_decode", grad=None)
def gpt_beam_decode(ctx, ins, attrs):
    """Beam-search KV-cached generation (RecurrentGradientMachine.h:309's
    beamSearch over this model family).

    Inputs as gpt_decode.  Attrs: n_heads, max_gen, beam_size, eos_id (-1:
    no early finish; else a finished lane continues with eos at zero
    added log-prob, freezing its score), eps.  Outputs: Ids [B, K,
    max_gen] int64, lanes best first, and Scores [B, K] f32 (accumulated
    log-probs).  The lanes are flattened into the batch (N = B·K); after
    each step's ``stable_topk`` the caches are gathered by parent into a
    second buffer, and the two buffers swap."""
    nh = int(attrs["n_heads"])
    G = int(attrs["max_gen"])
    K = int(attrs["beam_size"])
    eos = int(attrs.get("eos_id", -1))

    tokens = _prompt_2d(ins)
    B, P = tokens.shape
    dev = tokens.device
    fns = _lm_fns(ins, nh, float(attrs.get("eps", 1e-5)))
    _check_len(fns, P + G)
    V = ins["WHead"][0].shape[1]

    logits, kc, vc = fns.prefill(tokens, P + G)
    scores, cur = stable_topk(torch.log_softmax(logits, dim=-1), K)
    # lane-replicate the caches, lane-major within a batch row
    kc = kc.repeat_interleave(K, dim=1)
    vc = vc.repeat_interleave(K, dim=1)
    kc_next, vc_next = torch.empty_like(kc), torch.empty_like(vc)
    out = torch.zeros((B, K, G), dtype=torch.int64, device=dev)
    out[:, :, 0] = cur
    done = torch.zeros((B, K), dtype=torch.bool, device=dev)
    if eos >= 0:
        eos_only = torch.full((V,), -torch.inf, device=dev)
        eos_only[eos] = 0.0
    rows = torch.arange(B, device=dev)[:, None] * K
    for t in range(G - 1):
        logit = fns.decode_step(cur.reshape(B * K), kc, vc, P + t)
        logp = torch.log_softmax(logit, dim=-1).reshape(B, K, V)
        if eos >= 0:
            done = done | (cur == eos)
            logp = torch.where(done[:, :, None], eos_only, logp)
        cand = scores[:, :, None] + logp
        scores, idx = stable_topk(cand.reshape(B, K * V), K)
        parent = idx // V
        cur = idx % V
        # child lanes inherit the parent's history, state and cache rows
        out = torch.gather(out, 1, parent[:, :, None].expand(B, K, G))
        out[:, :, t + 1] = cur
        done = torch.gather(done, 1, parent)
        flat = (rows + parent).reshape(-1)
        torch.index_select(kc, 1, flat, out=kc_next)
        torch.index_select(vc, 1, flat, out=vc_next)
        kc, kc_next = kc_next, kc
        vc, vc_next = vc_next, vc
    return {"Ids": [out], "Scores": [scores.float()]}
