"""IMDB sentiment (reference v2/dataset/imdb.py): token-id sequences + 0/1.

Real data is the aclImdb_v1 tarball (reference imdb.py:36 URL/md5), read
straight out of the tar: reviews are tokenized (lowercase, punctuation
stripped), the word dict is built from train-set frequencies with the
reference's cutoff-150 threshold, and each sample is (ids, 0|1).  Fallbacks:
legacy pkl cache, then the synthetic surrogate.

The port of ``paddle_tpu/dataset/imdb.py``: the same readers, the same
synthetic samples in the same order, and the same parser, reading
the archive only when it is already in the cache (``common.local``:
the md5-verified original, or a provenance-marked sliver); nothing
is fetched."""

from __future__ import annotations

import re
import tarfile

import numpy as np

from . import common
from .common import DATA_MODE, has_cached, load_cached, synthetic_rng

URL = "https://ai.stanford.edu/~amaas/data/sentiment/aclImdb_v1.tar.gz"
MD5 = "7c2ac02c03563afcf9b574c7e56c153a"
CUTOFF = 150  # reference imdb.py word_dict frequency cutoff

WORD_DICT_SIZE = 5147  # synthetic-surrogate vocab (reference dict ballpark)

_token_rx = re.compile(r"[a-z0-9']+")


def tokenize(text: str):
    return _token_rx.findall(text.lower().replace("<br />", " "))


def _tar_docs(path: str, pattern: str):
    """Yield token lists for members matching `pattern` (a regex on member
    names, e.g. aclImdb/train/pos/.*\\.txt)."""
    rx = re.compile(pattern)
    with tarfile.open(path, mode="r") as f:
        for m in f.getmembers():
            if m.isfile() and rx.match(m.name):
                text = f.extractfile(m).read().decode("utf-8", "replace")
                yield tokenize(text)


def build_real_dict(path: str, cutoff: int | None = None):
    """Frequency dict over the train split, ids ordered by (-freq, word)
    with '<unk>' appended last — the reference build_dict/word_dict shape."""
    if cutoff is None:
        cutoff = CUTOFF
    freq: dict = {}
    for toks in _tar_docs(path, r"aclImdb/train/(pos|neg)/.*\.txt$"):
        for t in toks:
            freq[t] = freq.get(t, 0) + 1
    kept = sorted(((f, w) for w, f in freq.items() if f > cutoff),
                  key=lambda x: (-x[0], x[1]))
    word_idx = {w: i for i, (_, w) in enumerate(kept)}
    word_idx["<unk>"] = len(word_idx)
    return word_idx


def word_dict():
    path = common.local(URL, "imdb", MD5)
    if path is not None:
        return build_real_dict(path)
    return {f"w{i}": i for i in range(WORD_DICT_SIZE)}


def _real_samples(path, split, word_idx):
    unk = word_idx["<unk>"] if "<unk>" in word_idx else len(word_idx) - 1
    for label, sub in ((1, "pos"), (0, "neg")):
        pat = rf"aclImdb/{split}/{sub}/.*\.txt$"
        for toks in _tar_docs(path, pat):
            ids = np.asarray([word_idx.get(t, unk) for t in toks],
                             dtype=np.int64)
            yield ids, label


def _synthetic(n, seed):
    rng = synthetic_rng("imdb", seed)
    out = []
    for _ in range(n):
        ln = rng.randint(8, 64)
        label = rng.randint(0, 2)
        toks = rng.randint(0, WORD_DICT_SIZE // 2, ln) * 2 + label
        out.append((np.minimum(toks, WORD_DICT_SIZE - 1).astype(np.int64),
                    int(label)))
    return out


def _reader(n, seed, fname, split, word_idx):
    def reader():
        path = common.local(URL, "imdb", MD5)
        if path is not None:
            DATA_MODE["imdb"] = "real"
            wd = word_idx if word_idx is not None else build_real_dict(path)
            yield from _real_samples(path, split, wd)
            return
        if has_cached("imdb", fname):
            DATA_MODE["imdb"] = "cache"
            data = load_cached("imdb", fname)
        else:
            DATA_MODE["imdb"] = "synthetic"
            data = _synthetic(n, seed)
        for toks, label in data:
            yield toks, int(label)

    return reader


def train(word_idx=None, n=2048):
    return _reader(n, 0, "train.pkl", "train", word_idx)


def test(word_idx=None, n=512):
    return _reader(n, 1, "test.pkl", "test", word_idx)


def convert(path):
    """Write train/test as RecordIO shards (reference
    v2/dataset/imdb.py:163)."""
    from . import common

    w = word_dict()
    common.convert(path, train(w), 1000, "imdb_train")
    common.convert(path, test(w), 1000, "imdb_test")
