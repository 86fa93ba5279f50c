"""Composable beam-search ops, the port of ``paddle_tpu/ops/beam_ops.py``:
``beam_search`` (one step: pick beam_size continuations of each live
hypothesis, beam_search_op.h:96), ``beam_search_decode`` (walk every
step's selections back into sentences, beam_search_decode_op.cc:41) and
``beam_expand``.

The beam is a static [B, K] lane set: a finished lane proposes end_id at
its frozen score, a dead lane stays at DEAD, so every step is the same
fixed-shape top-k.  The top-k is ``stable_topk``: among equal scores the
lowest flat index wins, as ``jax.lax.top_k`` picks it, which decides the
parent once fewer than K live candidates leave several DEAD entries
tied."""

from __future__ import annotations

import torch

from .registry import register_op
from .tensor_ops import stable_topk

DEAD = -1e9  # score of an unused beam lane


@register_op("beam_search", grad=None, non_diff_inputs=("PreIds", "Ids"))
def beam_search(ctx, ins, attrs):
    """One beam step.

    Inputs: PreIds [B, K] int (last token of each hypothesis), PreScores
    [B, K] (cumulative log-prob), Ids [B, K, C] int and Scores [B, K, C]
    (candidates per beam; with is_accumulated=False, Scores are per-step
    log-probs added to PreScores).  Attrs: beam_size, end_id,
    is_accumulated (default True).  Outputs: SelectedIds [B, K] (PreIds'
    dtype), SelectedScores [B, K] f32, ParentIdx [B, K] int32."""
    pre_ids = ins["PreIds"][0]
    pre_scores = ins["PreScores"][0].float()
    cand_ids = ins["Ids"][0]
    cand_scores = ins["Scores"][0].float()
    K = int(attrs.get("beam_size", pre_ids.shape[1]))
    end_id = int(attrs.get("end_id", 1))
    B, Kin, C = cand_scores.shape
    if not bool(attrs.get("is_accumulated", True)):
        cand_scores = cand_scores + pre_scores[:, :, None]

    finished = (pre_ids == end_id)[:, :, None]
    # a finished hypothesis proposes end_id at its frozen score (slot 0)
    slot0 = torch.arange(C, device=cand_scores.device)[None, None, :] == 0
    cand_scores = torch.where(
        finished, torch.where(slot0, pre_scores[:, :, None], DEAD),
        cand_scores)
    cand_ids = torch.where(finished, end_id, cand_ids)
    # dead lanes never revive
    cand_scores = torch.where(pre_scores[:, :, None] <= DEAD / 2, DEAD,
                              cand_scores)

    top_scores, top_idx = stable_topk(cand_scores.reshape(B, Kin * C), K)
    sel_ids = torch.gather(cand_ids.reshape(B, Kin * C), 1, top_idx)
    return {"SelectedIds": [sel_ids.to(pre_ids.dtype)],
            "SelectedScores": [top_scores],
            "ParentIdx": [(top_idx // C).to(torch.int32)]}


@register_op("beam_search_decode", grad=None)
def beam_search_decode(ctx, ins, attrs):
    """Pack every step's selections into whole sentences.

    Inputs: Ids [L, B, K] int and ParentIdx [L, B, K] (per-step
    selections, array_write'd), Scores [B, K], StepCount [1] (optional:
    steps at and past it are padding).  Attrs: end_id.  Outputs:
    SentenceIds [B, K, L] (end_id padded), SentenceScores [B, K],
    SentenceLength [B, K] int32 (tokens before the first end_id)."""
    ids = ins["Ids"][0]
    parents = ins["ParentIdx"][0].long()
    end_id = int(attrs.get("end_id", 1))
    L, B, K = ids.shape
    steps = None
    if ins.get("StepCount") and ins["StepCount"][0] is not None:
        steps = ins["StepCount"][0].reshape(()).long()
    # lane [B, K]: which beam at step t+1 each final hypothesis occupied
    lane = torch.arange(K, device=ids.device)[None, :].expand(B, K)
    toks = []
    for t in range(L - 1, -1, -1):
        tok = torch.gather(ids[t], 1, lane)
        par = torch.gather(parents[t], 1, lane)
        if steps is not None:
            live = t < steps
            tok = torch.where(live, tok, end_id)
            par = torch.where(live, par, lane)
        lane = par
        toks.append(tok)
    sent = torch.stack(toks[::-1], dim=-1)  # [B, K, L]
    not_end = (sent != end_id).to(torch.int32)
    length = torch.cumprod(not_end, dim=-1).sum(-1).to(torch.int32)
    return {"SentenceIds": [sent], "SentenceScores": [ins["Scores"][0]],
            "SentenceLength": [length]}


@register_op("beam_expand", grad=None)
def beam_expand(ctx, ins, attrs):
    """Beam-lane broadcast [B, ...] -> [B*K, ...]: every lane of a sample
    sees that sample's data."""
    return {"Out": [ins["X"][0].repeat_interleave(int(attrs["beam_size"]),
                                                  dim=0)]}
