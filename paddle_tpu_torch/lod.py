"""LoD (Level-of-Detail) ragged sequences, the port's own copy of
``paddle_tpu/lod.py`` (numpy only).

host side   — ``LoDTensor`` keeps the reference's representation: flattened
              data plus an offset table per nesting level;
feed time   — level-1 sequences pad to [batch, bucket_len, ...] plus an
              int32 ``lengths[batch]`` companion (the ``<name>@LENGTH``
              variable); lengths round up to the next bucket, so the
              padded shapes a program sees stay few;
device side — sequence ops take (padded, lengths) and mask; the LSTM and
              GRU recurrences run over the padded time axis
              (``ops/sequence_ops.py``).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

LENGTH_SUFFIX = "@LENGTH"

_DEFAULT_BUCKETS = (8, 16, 32, 64, 96, 128, 192, 256, 384, 512, 768, 1024)


def bucket_len(n: int, buckets: Sequence[int] = _DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return int(np.ceil(n / 128.0) * 128)


class LoDTensor:
    """Reference-parity ragged tensor: flat `data` + `lod` offset levels.

    lod = [[0, 2, 5]] means two sequences: rows [0:2) and [2:5).
    Two-level lod nests (paragraphs of sentences), as in lod_tensor.md."""

    def __init__(self, data, lod: List[List[int]]):
        self.data = np.asarray(data)
        self.lod = [list(map(int, level)) for level in lod]
        if self.lod and self.lod[-1][-1] != self.data.shape[0]:
            raise ValueError(f"lod {self.lod} inconsistent with data rows "
                             f"{self.data.shape[0]}")

    # -- construction -------------------------------------------------------
    @staticmethod
    def from_sequences(seqs: List[np.ndarray]) -> "LoDTensor":
        seqs = [np.asarray(s) for s in seqs]
        offsets = [0]
        for s in seqs:
            offsets.append(offsets[-1] + (s.shape[0] if s.ndim else 1))
        data = np.concatenate([np.atleast_1d(s) for s in seqs], axis=0)
        return LoDTensor(data, [offsets])

    # -- views --------------------------------------------------------------
    @property
    def num_sequences(self) -> int:
        return len(self.lod[0]) - 1 if self.lod else self.data.shape[0]

    def sequence_lengths(self, level: int = -1) -> np.ndarray:
        offs = self.lod[level]
        return np.diff(np.asarray(offs)).astype(np.int32)

    def sequences(self, level: int = -1):
        offs = self.lod[level]
        for i in range(len(offs) - 1):
            yield self.data[offs[i]: offs[i + 1]]

    # -- static-shape conversion --------------------------------------------
    def to_padded(self, bucket: bool = True, max_len: int = None):
        """→ (padded [batch, T, ...], lengths [batch] int32)."""
        lens = self.sequence_lengths()
        T = int(max_len or lens.max())
        if bucket and max_len is None:
            T = bucket_len(T)
        batch = len(lens)
        feat = self.data.shape[1:]
        out = np.zeros((batch, T) + tuple(feat), dtype=self.data.dtype)
        for i, seq in enumerate(self.sequences()):
            n = min(len(seq), T)
            out[i, :n] = seq[:n]
        return out, np.minimum(lens, T).astype(np.int32)

    @staticmethod
    def from_padded(padded: np.ndarray, lengths: np.ndarray) -> "LoDTensor":
        seqs = [padded[i, : int(n)] for i, n in enumerate(lengths)]
        return LoDTensor.from_sequences(seqs)

    def __repr__(self):
        return f"LoDTensor(shape={self.data.shape}, lod={self.lod})"


def is_lod_feed(value) -> bool:
    return isinstance(value, LoDTensor) or (
        isinstance(value, (list, tuple)) and len(value) > 0
        and isinstance(value[0], (list, np.ndarray))
        and not np.isscalar(value[0])
    )


def as_lod_tensor(value) -> LoDTensor:
    if isinstance(value, LoDTensor):
        return value
    return LoDTensor.from_sequences([np.asarray(v) for v in value])
