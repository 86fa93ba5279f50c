"""Sequence ops on (padded, lengths) pairs and the recurrences — the port
of ``paddle_tpu/ops/sequence_ops.py``: ``sequence_pool``,
``sequence_reverse``, ``masked_seq_mean``, ``sequence_softmax``,
``sequence_conv``, ``lstm`` and ``gru``, then the single steps
``lstm_unit`` and ``gru_unit`` and the sequence API's
``sequence_expand``, ``sequence_concat``, ``sequence_erase``,
``sequence_slice``, ``sequence_reshape``, ``kmax_seq_score``,
``sequence_concat_time``, ``sub_nested_seq`` and ``lod_reset``.

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


# ---------------------------------------------------------------------------
# The rest of the sequence op types: expansion, concatenation, erasure,
# single recurrent steps, slicing and re-segmentation


@register_op("sequence_expand", non_diff_inputs=("Length", "Ref"))
def sequence_expand(ctx, ins, attrs):
    """One row per sequence broadcast across its steps: X [B, D...] +
    Length → [B, T, D...], padding steps 0.  T is the `max_len` attr, or
    Ref's dim 1 where that is -1."""
    x = ins["X"][0]
    T = int(attrs.get("max_len", -1))
    if T < 0:
        T = ins["Ref"][0].shape[1]
    out = x[:, None].expand((x.shape[0], T) + tuple(x.shape[1:]))
    return {"Out": [out * _mask_like(ins["Length"][0], out)]}


@register_op("sequence_concat")
def sequence_concat(ctx, ins, attrs):
    """Feature-wise concatenation of sequences of one segmentation."""
    return {"Out": [torch.cat(list(ins["X"]), dim=-1)]}


@register_op("sequence_erase", grad=None, non_diff_inputs=("Length",))
def sequence_erase(ctx, ins, attrs):
    """Tokens in the `tokens` attr become pad 0 in place (static shapes do
    not compact), and LengthOut counts each row's kept tokens."""
    x = ins["X"][0]
    tokens = torch.tensor(attrs.get("tokens", []), dtype=x.dtype,
                          device=x.device)
    keep = (x[..., None] != tokens).all(dim=-1)
    keep = keep & (step_mask(ins["Length"][0], x.shape[1], torch.int8) > 0)
    return {"Out": [torch.where(keep, x, torch.zeros_like(x))],
            "LengthOut": [keep.sum(dim=1).to(torch.int32)]}


@register_op("lstm_unit")
def lstm_unit(ctx, ins, attrs):
    """One LSTM step: X [B, 4H] (the input and recurrent products already
    summed; gates i, f, c̃, o), C_prev [B, H] → C, H; `forget_bias` is
    added to f's pre-activation."""
    x, c_prev = ins["X"][0], ins["C_prev"][0]
    H = c_prev.shape[-1]
    fb = float(attrs.get("forget_bias", 0.0))
    i = torch.sigmoid(x[:, :H])
    f = torch.sigmoid(x[:, H:2 * H] + fb)
    ct = torch.tanh(x[:, 2 * H:3 * H])
    o = torch.sigmoid(x[:, 3 * H:])
    c = f * c_prev + i * ct
    return {"C": [c], "H": [o * torch.tanh(c)]}


@register_op("gru_unit")
def gru_unit(ctx, ins, attrs):
    """One GRU step: Input [B, 3H] (+ Bias [3H]), HiddenPrev [B, H],
    Weight [H, 3H] (gates u, r, then the candidate) → Hidden, the gates'
    pre-activation Gate [B, 2H] and ResetHiddenPrev r·h."""
    x, h_prev, w = ins["Input"][0], ins["HiddenPrev"][0], ins["Weight"][0]
    H = h_prev.shape[-1]
    if ins.get("Bias") and ins["Bias"][0] is not None:
        x = x + ins["Bias"][0][None, :]
    g = x[:, :2 * H] + h_prev @ w[:, :2 * H]
    u = torch.sigmoid(g[:, :H])
    r = torch.sigmoid(g[:, H:])
    c = torch.tanh(x[:, 2 * H:] + (r * h_prev) @ w[:, 2 * H:])
    return {"Hidden": [u * h_prev + (1 - u) * c], "Gate": [g],
            "ResetHiddenPrev": [r * h_prev]}


def _take_steps(x, idx):
    """x [B, T, ...] gathered along T by idx [B, T'] (in range)."""
    idx = idx.long().reshape(idx.shape + (1,) * (x.ndim - 2))
    return torch.gather(x, 1, idx.expand(idx.shape[:2] + x.shape[2:]))


@register_op("sequence_slice", non_diff_inputs=("Offset", "SliceLength",
                                                "Length"))
def sequence_slice(ctx, ins, attrs):
    """Row b's SliceLength[b] steps from Offset[b], at the front of the
    same static T, the tail 0; LengthOut = SliceLength."""
    x = ins["X"][0]
    off = ins["Offset"][0].reshape(-1).to(torch.int32)
    slen = ins["SliceLength"][0].reshape(-1).to(torch.int32)
    T = x.shape[1]
    steps = torch.arange(T, device=x.device, dtype=torch.int32)
    out = _take_steps(x, (off[:, None] + steps[None, :]).clamp(0, T - 1))
    return {"Out": [out * _mask_like(slen, out)], "LengthOut": [slen]}


@register_op("sequence_reshape", non_diff_inputs=("Length",))
def sequence_reshape(ctx, ins, attrs):
    """Each row's payload re-chunked to `new_dim` features: [B, T, D] →
    [B, T·D/new_dim, new_dim], LengthOut = ceil(len·D/new_dim) (a row whose
    payload is no multiple of new_dim keeps its tail in a padded step)."""
    x = ins["X"][0]
    new_dim = int(attrs["new_dim"])
    B, T, D = x.shape
    if (T * D) % new_dim:
        raise ValueError(f"sequence_reshape: new_dim {new_dim} does not "
                         f"divide T*D = {T * D}")
    new_len = -(-(ins["Length"][0].long() * D) // new_dim)
    return {"Out": [x.reshape(B, (T * D) // new_dim, new_dim)],
            "LengthOut": [new_len.to(torch.int32)]}


@register_op("kmax_seq_score", grad=None, non_diff_inputs=("Length",))
def kmax_seq_score(ctx, ins, attrs):
    """Positions of each row's `beam_size` highest scores among its first
    Length steps (X [B, T] or [B, T, 1]) → int64 [B, min(k, T)]; ties
    and the steps past the end (scored -inf) go to the lowest index, as
    ``lax.top_k`` does."""
    x = ins["X"][0]
    if x.ndim == 3:
        x = x[..., 0]
    T = x.shape[1]
    k = min(int(attrs.get("beam_size", 1)), T)
    valid = step_mask(ins["Length"][0].reshape(-1), T, torch.int8) > 0
    masked = torch.where(valid, x.float(),
                         torch.full((), -float("inf"), device=x.device))
    order = torch.sort(masked, dim=1, descending=True, stable=True).indices
    return {"Out": [order[:, :k].to(torch.int64)]}


@register_op("sequence_concat_time", non_diff_inputs=("Length",))
def sequence_concat_time(ctx, ins, attrs):
    """Two sequences joined along time per row: a[b, :la[b]] ++
    b[b, :lb[b]], padded to Ta + Tb with 0; LengthOut = la + lb."""
    a, b = ins["X"][0], ins["X"][1]
    la = ins["Length"][0].reshape(-1).to(torch.int32)
    lb = ins["Length"][1].reshape(-1).to(torch.int32)
    Ta, Tb = a.shape[1], b.shape[1]
    t = torch.arange(Ta + Tb, device=a.device, dtype=torch.int32)[None, :]
    tail = (1,) * (a.ndim - 2)
    in_a = t < la[:, None]
    ga = _take_steps(a, t.clamp(0, Ta - 1).expand(a.shape[0], -1))
    gb = _take_steps(b, (t - la[:, None]).clamp(0, Tb - 1))
    out = torch.where(in_a.reshape(in_a.shape + tail), ga, gb)
    new_len = la + lb
    inside = (t < new_len[:, None]).reshape(in_a.shape + tail)
    return {"Out": [torch.where(inside, out, torch.zeros_like(out))],
            "LengthOut": [new_len]}


@register_op("sub_nested_seq", grad=None,
             non_diff_inputs=("SelectedIndices", "Length"))
def sub_nested_seq(ctx, ins, attrs):
    """Sub-sequences of a nested sequence picked per row: X [B, S, T, D],
    Length [B, S], SelectedIndices [B, K] → Out [B, K, T, D] and their
    lengths (0 for a negative index, an unused beam slot)."""
    x = ins["X"][0]
    sub_len = ins["Length"][0].to(torch.int32)
    sel = ins["SelectedIndices"][0].to(torch.int32)
    sel_c = sel.clamp(0, x.shape[1] - 1)
    new_len = torch.gather(sub_len, 1, sel_c.long())
    return {"Out": [_take_steps(x, sel_c)],
            "LengthOut": [torch.where(sel >= 0, new_len,
                                      torch.zeros_like(new_len))]}


@register_op("lod_reset", grad=None, non_diff_inputs=("Y", "Length"))
def lod_reset(ctx, ins, attrs):
    """A new segmentation for the same payload: LengthOut from Y's
    lengths, or from the `target_lengths` attr."""
    x = ins["X"][0]
    if ins.get("Y") and ins["Y"][0] is not None:
        new_len = ins["Y"][0].reshape(-1).to(torch.int32)
    else:
        new_len = torch.tensor(attrs["target_lengths"], dtype=torch.int32,
                               device=x.device)
    return {"Out": [x], "LengthOut": [new_len]}

# analytic cost formulas (analysis/cost.py; mechanism in registry.py)

from .registry import register_cost  # noqa: E402


def _lstm_cost(ins, outs, attrs):
    """Recurrent gate matmuls: T steps of [B,H]x[H,4H] = 8*B*T*H^2 (the
    input projection happened in the preceding fc/mul op)."""
    x = ins.get("Input", [None])[0]
    w = ins.get("Weight", [None])[0]
    if x is None or w is None or len(x.shape) != 3:
        return {}
    b, t, _ = x.shape
    h = w.shape[0]
    return {"flops": 8 * b * t * h * h}


register_cost("lstm", _lstm_cost)


def _gru_cost(ins, outs, attrs):
    """T steps of [B,H]x[H,3H] = 6*B*T*H^2."""
    x = ins.get("Input", [None])[0]
    w = ins.get("Weight", [None])[0]
    if x is None or w is None or len(x.shape) != 3:
        return {}
    b, t, _ = x.shape
    h = w.shape[0]
    return {"flops": 6 * b * t * h * h}


register_cost("gru", _gru_cost)
