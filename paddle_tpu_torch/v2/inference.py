"""v2 inference surface, the port of ``paddle_tpu/v2/inference.py``
(reference python/paddle/v2/inference.py + api/PaddleAPI.h
SequenceGenerator:1025).

`infer(output_layer, input, ...)` is re-exported from trainer.py; this
module adds the reference's beam-search text-generation wrapper: the v2
user hands it the outputs of a generation graph (e.g.
models.seq2seq.Seq2SeqAttention.generate / generate_composable, or any
program producing ids/scores/lengths) and iterates ranked hypotheses per
input — the SequenceGenerator contract — while the whole beam search runs
on the device the executor runs on (the card unless `place` says
otherwise)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..framework.executor import Executor
from ..framework.place import default_place
from ..framework.scope import global_scope


class SequenceGenerator:
    """Ranked beam hypotheses per batch row.

    ids_var/scores_var/lengths_var: Variables produced by a generation
    graph — Ids [B, K, T] int32, Scores [B, K] (total log-prob, best
    first), Lengths [B, K] int32 (as produced by beam_search_generate or
    the composable beam_search + beam_search_decode pair)."""

    def __init__(self, ids_var, scores_var, lengths_var=None, program=None,
                 eos_id: Optional[int] = None, place=None):
        self.ids_var = ids_var
        self.scores_var = scores_var
        self.lengths_var = lengths_var
        self.program = program if program is not None \
            else ids_var.block.program
        self.eos_id = eos_id
        self.exe = Executor(place or default_place())

    def __call__(self, feed: Dict[str, object],
                 top_k: Optional[int] = None
                 ) -> List[List[Tuple[float, List[int]]]]:
        """-> per batch row: [(score, token_ids), ...] best-first."""
        fetch = [self.ids_var, self.scores_var]
        if self.lengths_var is not None:
            fetch.append(self.lengths_var)
        outs = self.exe.run(self.program, feed=feed, fetch_list=fetch,
                            scope=global_scope())
        ids = np.asarray(outs[0])
        scores = np.asarray(outs[1])
        lengths = np.asarray(outs[2]) if self.lengths_var is not None \
            else None
        B, K = scores.shape
        k = K if top_k is None else min(top_k, K)
        result = []
        for b in range(B):
            row = []
            order = np.argsort(-scores[b])[:k]
            for j in order:
                toks = [int(t) for t in ids[b, j]]
                if lengths is not None:
                    # SentenceLength counts tokens BEFORE the end token
                    toks = toks[: int(lengths[b, j])]
                elif self.eos_id is not None and self.eos_id in toks:
                    # same contract: hypotheses exclude the trailing EOS
                    toks = toks[: toks.index(self.eos_id)]
                row.append((float(scores[b, j]), toks))
            result.append(row)
        return result
