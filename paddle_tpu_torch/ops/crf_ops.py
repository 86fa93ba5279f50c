"""Linear-chain CRF ops, the port of ``paddle_tpu/ops/crf_ops.py``:
``linear_chain_crf``, the negative log-likelihood of each row's label path
and the final forward variable, and ``crf_decoding``, the Viterbi path.

Transition is [(C+2), C]: row 0 the start weights, row 1 the end weights,
rows 2: the [from, to] matrix.  The forward algorithm, the gold path and
Viterbi are loops over the padded time axis, whose length is the
tensor's static T; a step past a row's length carries the previous value,
so no loop reads a length on the host and a captured step can replay
them.  ``linear_chain_crf`` computes in f32, a float64 input in float64
(the numeric-gradient checker's), and its gradient is the generic one:
autograd through the recomputed loop."""

from __future__ import annotations

import torch

from .cuda_kernels._recurrent import step_mask
from .registry import register_op


def _split_transition(transition):
    """(start [C], end [C], trans [C, C] from → to)."""
    return transition[0], transition[1], transition[2:]


@register_op("linear_chain_crf", non_diff_inputs=("Label", "Length"),
             non_diff_outputs=("Alpha",))
def linear_chain_crf(ctx, ins, attrs):
    """Emission [B,T,C], Transition [(C+2),C], Label [B,T,1] int, Length
    [B] → LogLikelihood [B,1] = log Z − score(label path), the loss of
    each row, and Alpha [B,C], the forward variable at each row's last
    step."""
    em = ins["Emission"][0]
    fdt = torch.float64 if em.dtype == torch.float64 else torch.float32
    emission = em.to(fdt)
    start_w, end_w, trans = _split_transition(ins["Transition"][0].to(fdt))
    lengths = ins["Length"][0]
    B, T, C = emission.shape
    lab = ins["Label"][0].reshape(B, T).long()
    tmask = step_mask(lengths, T, fdt)
    rows = torch.arange(B, device=emission.device)
    alpha = start_w[None, :] + emission[:, 0]
    path = start_w[lab[:, 0]] + emission[rows, 0, lab[:, 0]]
    for t in range(1, T):
        # alpha'[j] = logsumexp_i(alpha[i] + trans[i, j]) + emission[t, j]
        new = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) \
            + emission[:, t]
        mt = tmask[:, t, None]
        alpha = mt * new + (1 - mt) * alpha
        step = trans[lab[:, t - 1], lab[:, t]] + emission[rows, t, lab[:, t]]
        path = path + tmask[:, t] * step
    log_z = torch.logsumexp(alpha + end_w[None, :], dim=1)
    last = lab[rows, (lengths.long() - 1).clamp(min=0)]
    path = path + end_w[last]
    return {"LogLikelihood": [(log_z - path)[:, None]], "Alpha": [alpha]}


@register_op("crf_decoding", grad=None)
def crf_decoding(ctx, ins, attrs):
    """Viterbi: Emission [B,T,C] + Transition + Length → ViterbiPath
    [B,T] int32, 0 past each length.  Equal scores go to the lowest
    state, as ``jnp.argmax`` breaks them (``torch.argmax`` returns the
    first maximal index)."""
    emission = ins["Emission"][0].float()
    start_w, end_w, trans = _split_transition(
        ins["Transition"][0].float())
    lengths = ins["Length"][0].long()
    B, T, C = emission.shape
    tmask = step_mask(lengths, T, torch.bool)
    delta = start_w[None, :] + emission[:, 0]
    backs = []
    for t in range(1, T):
        scores = delta[:, :, None] + trans[None]  # [B, from, to]
        backs.append(torch.argmax(scores, dim=1))
        best = scores.amax(dim=1) + emission[:, t]
        delta = torch.where(tmask[:, t, None], best, delta)
    state = torch.argmax(delta + end_w[None, :], dim=1)
    rows = torch.arange(B, device=emission.device)
    states = [state]
    for t in range(T - 2, -1, -1):
        # backs[t] points from step t + 1 back to step t; a row follows
        # it only inside its length
        state = torch.where(t + 1 < lengths, backs[t][rows, state], state)
        states.append(state)
    path = torch.stack(states[::-1], dim=1)
    return {"ViterbiPath": [torch.where(tmask, path, 0).to(torch.int32)]}
