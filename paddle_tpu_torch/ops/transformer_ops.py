"""Decoder-LM forward machinery shared by the serving ops — the part of
``paddle_tpu/ops/transformer_ops.py`` (``_lm_fns``, ``_prompt_2d``,
``stable_argmax``) that the paged prefill, decode, chunk and draft ops
walk."""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F


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

    return SimpleNamespace(ln=ln, heads=heads, merge=merge, block=block,
                           head_logits=head_logits,
                           head_logits_all=head_logits_all, L=L, D=D, dh=dh,
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
