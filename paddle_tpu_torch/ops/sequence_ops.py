"""Sequence ops on (padded, lengths) pairs and the recurrences — the port
of the part of ``paddle_tpu/ops/sequence_ops.py`` that the stacked-LSTM
classifier, the attention-NMT program and ``nets.sequence_conv_pool``
run: ``sequence_pool``, ``sequence_reverse``, ``masked_seq_mean``,
``sequence_softmax``, ``sequence_conv``, ``lstm`` and ``gru``.

Every op takes the padded tensor plus an int32 ``Length`` input and masks.
``lstm`` and ``gru`` go through the time-loop kernels' wrappers
(``cuda_kernels/lstm.py``, ``gru.py``: K7–K10) where the kernels' contract
holds — default activations, no peepholes — and through the plain loops
``_lstm_scan`` / ``_gru_scan`` otherwise.  A wrapper takes its plain
version for a CPU tensor and launches its kernel for a CUDA tensor.
"""

from __future__ import annotations

import torch

from .cuda_kernels._recurrent import reverse_within_length, step_mask
from .cuda_kernels.gru import GRUTrain, gru_forward
from .cuda_kernels.lstm import LSTMTrain, lstm_forward
from .registry import register_op


def _mask_like(lengths, x):
    """[B,T] {0,1} mask in x's dtype, with trailing 1-dims up to x's rank."""
    m = step_mask(lengths, x.shape[1], x.dtype)
    return m.reshape(m.shape + (1,) * (x.ndim - 2))


@register_op("sequence_pool", non_diff_inputs=("Length",))
def sequence_pool(ctx, ins, attrs):
    """[B,T,D]+len → [B,D]; pooltype sum|average|sqrt|max|last|first."""
    x = ins["X"][0]
    lengths = ins["Length"][0]
    ptype = attrs.get("pooltype", "average").lower()
    m = _mask_like(lengths, x)
    if ptype in ("sum", "average", "sqrt"):
        out = torch.sum(x * m, dim=1)
        if ptype != "sum":
            n = lengths.to(x.dtype).clamp(min=1)
            n = n.reshape((-1,) + (1,) * (out.ndim - 1))
            out = out / (torch.sqrt(n) if ptype == "sqrt" else n)
    elif ptype == "max":
        neg = torch.finfo(x.dtype).min
        out = torch.where(m > 0, x, neg).amax(dim=1)
    elif ptype == "last":
        idx = (lengths.long() - 1).clamp(min=0)
        idx = idx.reshape((-1, 1) + (1,) * (x.ndim - 2))
        out = torch.gather(x, 1, idx.expand((-1, 1) + x.shape[2:]))[:, 0]
    elif ptype == "first":
        out = x[:, 0]
    else:
        raise ValueError(f"unknown pooltype {ptype}")
    return {"Out": [out]}


@register_op("sequence_reverse", non_diff_inputs=("Length",))
def sequence_reverse(ctx, ins, attrs):
    """Reverse each sequence within its true length (for bi-RNNs)."""
    return {"Y": [reverse_within_length(ins["X"][0], ins["Length"][0])]}


@register_op("masked_seq_mean", non_diff_inputs=("Length",))
def masked_seq_mean(ctx, ins, attrs):
    """Mean of per-token values [B,T,...] over true (unpadded) tokens →
    scalar [1] (the masked-loss reduction for seq2seq training)."""
    x = ins["X"][0]
    lengths = ins["Length"][0]
    total = torch.sum(x * _mask_like(lengths, x))
    count = lengths.sum().to(x.dtype).clamp(min=1.0)
    return {"Out": [(total / count).reshape(1)]}


@register_op("sequence_softmax", non_diff_inputs=("Length",))
def sequence_softmax(ctx, ins, attrs):
    """Softmax over each row's first `Length` steps of X [B, T], in at
    least f32 (a float64 X stays float64), padding 0."""
    x = ins["X"][0]
    m = step_mask(ins["Length"][0], x.shape[1], torch.float32)
    ft = torch.promote_types(x.dtype, torch.float32)
    logits = torch.where(m > 0, x.to(ft), torch.full((), -1e9, dtype=ft,
                                                      device=x.device))
    return {"Out": [torch.softmax(logits, dim=-1).to(x.dtype)
                    * m.to(x.dtype)]}


def _shift_steps(x, shift):
    """x [B, T, D] moved `shift` steps earlier along T (out[:, t] =
    x[:, t + shift]), zeros where t + shift falls outside [0, T)."""
    T = x.shape[1]
    if abs(shift) >= T:
        return torch.zeros_like(x)
    pad = x.new_zeros((x.shape[0], abs(shift)) + tuple(x.shape[2:]))
    if shift > 0:
        return torch.cat([x[:, shift:], pad], dim=1)
    if shift < 0:
        return torch.cat([pad, x[:, :T + shift]], dim=1)
    return x


@register_op("sequence_conv", non_diff_inputs=("Length",))
def sequence_conv(ctx, ins, attrs):
    """Context-window projection over time: each step's window of
    `contextLength` steps from `contextStart` (padding steps read as 0)
    concatenated, times Filter [contextLength·D, M], padding steps 0."""
    x = ins["X"][0]
    w = ins["Filter"][0]
    ctx_len = int(attrs.get("contextLength", 3))
    ctx_start = int(attrs.get("contextStart", -(ctx_len // 2)))
    B, T, _ = x.shape
    m = _mask_like(ins["Length"][0], x)
    xm = x * m
    col = torch.cat([_shift_steps(xm, ctx_start + k)
                     for k in range(ctx_len)], dim=-1)
    out = torch.matmul(col.reshape(B * T, -1), w)
    return {"Out": [out.reshape(B, T, -1) * m]}


# ---------------------------------------------------------------------------
# Recurrences

_ACTS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
         "identity": lambda v: v}


def _lstm_scan(x_proj, h0, c0, w_h, lengths, gate_act, cell_act, cand_act,
               reverse=False, peep=None):
    """The plain LSTM loop for what the kernels' contract excludes:
    x_proj [B,T,4H] (input already projected), w_h [H,4H], gate layout i,
    f, c̃, o.  `peep` = (W_ic, W_fc, W_oc) adds the peephole terms: the i
    and f gates see c_{t-1}, the o gate sees c_t, all pre-activation."""
    B, T, H4 = x_proj.shape
    H = H4 // 4
    m = step_mask(lengths, T, x_proj.dtype)
    w_ic, w_fc, w_oc = peep if peep is not None else (None, None, None)
    h, c = h0, c0
    hs, cs = [None] * T, [None] * T
    for t in range(T):
        idx = T - 1 - t if reverse else t
        g = x_proj[:, idx] + h @ w_h
        gi = g[:, :H] + (c * w_ic if w_ic is not None else 0.0)
        gf = g[:, H:2 * H] + (c * w_fc if w_fc is not None else 0.0)
        i = gate_act(gi)
        f = gate_act(gf)
        ct = cand_act(g[:, 2 * H:3 * H])
        c_new = f * c + i * ct
        go = g[:, 3 * H:] + (c_new * w_oc if w_oc is not None else 0.0)
        h_new = gate_act(go) * cell_act(c_new)
        mt = m[:, idx, None]
        h = mt * h_new + (1 - mt) * h
        c = mt * c_new + (1 - mt) * c
        hs[idx], cs[idx] = h, c
    return torch.stack(hs, 1), torch.stack(cs, 1), h, c


@register_op("lstm", non_diff_inputs=("Length",),
             non_diff_outputs=("Cell",))
def lstm(ctx, ins, attrs):
    """dynamic_lstm: Input [B,T,4H] pre-projected, Weight [H,4H], Bias
    [4H] — or [7H] with use_peepholes (= [4H gate bias, W_ic, W_fc,
    W_oc]).  Outputs Hidden and Cell [B,T,H]."""
    x = ins["Input"][0]
    w = ins["Weight"][0]
    lengths = ins["Length"][0]
    bias = ins["Bias"][0] if ins.get("Bias") and ins["Bias"][0] is not None \
        else None
    B = x.shape[0]
    H = w.shape[0]
    peep = None
    if attrs.get("use_peepholes"):
        if bias is None or bias.shape[-1] < 7 * H:
            raise ValueError(
                f"lstm: use_peepholes needs a [7H]={7 * H} bias "
                f"([4H gate bias, W_ic, W_fc, W_oc]); got "
                f"{None if bias is None else tuple(bias.shape)} — a silent "
                f"fallback would compute a plain LSTM under peephole "
                f"semantics")
        peep = (bias[4 * H:5 * H], bias[5 * H:6 * H], bias[6 * H:7 * H])
    if bias is not None:
        x = x + bias[:4 * H][None, None, :]
    h0 = torch.zeros(B, H, dtype=x.dtype, device=x.device)
    c0 = torch.zeros(B, H, dtype=x.dtype, device=x.device)
    if ins.get("H0") and ins["H0"][0] is not None:
        h0 = ins["H0"][0]
    if ins.get("C0") and ins["C0"][0] is not None:
        c0 = ins["C0"][0]
    rev = bool(attrs.get("is_reverse", False))
    gate = attrs.get("gate_activation", "sigmoid")
    cell = attrs.get("cell_activation", "tanh")
    cand = attrs.get("candidate_activation", "tanh")
    if peep is None and (gate, cell, cand) == ("sigmoid", "tanh", "tanh"):
        # the kernels' contract.  is_reverse rides the same kernels through
        # reverse-within-length views of the input and the outputs
        xk = reverse_within_length(x, lengths) if rev else x
        if ctx.is_test:
            hs, cs, _, _ = lstm_forward(xk, h0, c0, w, lengths)
        else:
            hs, cs = LSTMTrain.apply(xk, h0, c0, w, lengths)
        if rev:
            # the pad steps of a reversed run carry the initial state
            hs = reverse_within_length(hs, lengths, pad_fill=h0)
            cs = reverse_within_length(cs, lengths, pad_fill=c0)
        return {"Hidden": [hs], "Cell": [cs]}
    hs, cs, _, _ = _lstm_scan(x, h0, c0, w, lengths, _ACTS[gate], _ACTS[cell],
                              _ACTS[cand], reverse=rev, peep=peep)
    return {"Hidden": [hs], "Cell": [cs]}


def _gru_scan(x_proj, h0, w_h, lengths, gate_act, cand_act, reverse=False):
    """The plain GRU loop for non-default activations: x_proj [B,T,3H],
    w_h [H,3H] split as [H,2H] gates (update u, reset r) + [H,H]
    candidate."""
    B, T, H3 = x_proj.shape
    H = H3 // 3
    w_gates, w_cand = w_h[:, :2 * H], w_h[:, 2 * H:]
    m = step_mask(lengths, T, x_proj.dtype)
    h = h0
    hs = [None] * T
    for t in range(T):
        idx = T - 1 - t if reverse else t
        xt = x_proj[:, idx]
        g = xt[:, :2 * H] + h @ w_gates
        u = gate_act(g[:, :H])
        r = gate_act(g[:, H:])
        c = cand_act(xt[:, 2 * H:] + (r * h) @ w_cand)
        h_new = u * h + (1 - u) * c
        mt = m[:, idx, None]
        h = mt * h_new + (1 - mt) * h
        hs[idx] = h
    return torch.stack(hs, 1), h


@register_op("gru", non_diff_inputs=("Length",))
def gru(ctx, ins, attrs):
    """dynamic_gru: Input [B,T,3H] pre-projected, Weight [H,3H], Bias
    [3H] → Hidden [B,T,H]."""
    x = ins["Input"][0]
    w = ins["Weight"][0]
    lengths = ins["Length"][0]
    H = w.shape[0]
    if ins.get("Bias") and ins["Bias"][0] is not None:
        x = x + ins["Bias"][0][None, None, :]
    B = x.shape[0]
    h0 = ins["H0"][0] if ins.get("H0") and ins["H0"][0] is not None else \
        torch.zeros(B, H, dtype=x.dtype, device=x.device)
    rev = bool(attrs.get("is_reverse", False))
    gate = attrs.get("gate_activation", "sigmoid")
    cand = attrs.get("activation", "tanh")
    if (gate, cand) == ("sigmoid", "tanh"):
        xk = reverse_within_length(x, lengths) if rev else x
        if ctx.is_test:
            hs, _ = gru_forward(xk, h0, w, lengths)
        else:
            hs = GRUTrain.apply(xk, h0, w, lengths)
        if rev:
            hs = reverse_within_length(hs, lengths, pad_fill=h0)
        return {"Hidden": [hs]}
    hs, _ = _gru_scan(x, h0, w, lengths, _ACTS[gate], _ACTS[cand],
                      reverse=rev)
    return {"Hidden": [hs]}
