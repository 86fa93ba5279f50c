"""PTB language model n-grams (reference v2/dataset/imikolov.py) — feeds the
word2vec book test (N-gram next-word prediction).

Real data is the simple-examples tarball (reference imikolov.py:30 URL/md5);
the dict is built from ptb.train.txt with the reference's min-word-freq=50
cutoff plus '<s>'/'<e>'/'<unk>' markers, and each sentence is emitted as
sliding n-grams.  Fallbacks: legacy pkl cache, then a synthetic stream.

The port of ``paddle_tpu/dataset/imikolov.py``: the same readers, the same
synthetic samples in the same order, and the same parser, reading
the archive only when it is already in the cache (``common.local``:
the md5-verified original, or a provenance-marked sliver); nothing
is fetched."""

from __future__ import annotations

import tarfile

import numpy as np

from . import common
from .common import DATA_MODE, has_cached, load_cached, synthetic_rng

URL = "http://www.fit.vutbr.cz/~imikolov/rnnlm/simple-examples.tgz"
MD5 = "30177ea32e27c525793142b6bf2c8e2d"
MIN_WORD_FREQ = 50

DICT_SIZE = 2073  # synthetic-surrogate vocab (reference dict ballpark)


def _tar_lines(path: str, member: str):
    with tarfile.open(path, mode="r") as f:
        for line in f.extractfile(member).read().decode().splitlines():
            yield line.split()


def build_real_dict(path: str, min_word_freq: int | None = None):
    if min_word_freq is None:
        min_word_freq = MIN_WORD_FREQ
    freq: dict = {}
    for words in _tar_lines(path, "./simple-examples/data/ptb.train.txt"):
        for w in words:
            freq[w] = freq.get(w, 0) + 1
    freq.pop("<unk>", None)
    kept = sorted(((f, w) for w, f in freq.items() if f > min_word_freq),
                  key=lambda x: (-x[0], x[1]))
    word_idx = {w: i for i, (_, w) in enumerate(kept)}
    for marker in ("<s>", "<e>", "<unk>"):
        word_idx.setdefault(marker, len(word_idx))
    return word_idx


def build_dict(min_word_freq: int | None = None):
    path = common.local(URL, "imikolov", MD5)
    if path is not None:
        return build_real_dict(path, min_word_freq)
    return {f"w{i}": i for i in range(DICT_SIZE)}


def _real_ngrams(path, member, word_idx, gram):
    unk = word_idx["<unk>"]
    for words in _tar_lines(path, member):
        ids = ([word_idx["<s>"]]
               + [word_idx.get(w, unk) for w in words]
               + [word_idx["<e>"]])
        for i in range(gram, len(ids) + 1):
            yield tuple(ids[i - gram:i])


def _reader(n, gram, seed, fname, member, word_idx):
    def reader():
        path = common.local(URL, "imikolov", MD5)
        if path is not None:
            DATA_MODE["imikolov"] = "real"
            wd = word_idx if word_idx is not None else build_real_dict(path)
            yield from _real_ngrams(path, member, wd, gram)
            return
        if has_cached("imikolov", fname):
            DATA_MODE["imikolov"] = "cache"
            for s in load_cached("imikolov", fname):
                yield tuple(s)
            return
        DATA_MODE["imikolov"] = "synthetic"
        rng = synthetic_rng("imikolov", seed)
        # markov-ish synthetic stream: next = (sum of context) % vocab band
        for _ in range(n):
            ctx = rng.randint(0, DICT_SIZE, gram - 1)
            nxt = int(ctx.sum() * 7 % DICT_SIZE)
            yield tuple(int(c) for c in ctx) + (nxt,)

    return reader


def train(word_idx=None, n=4096, gram=5):
    return _reader(n, gram, 0, "train.pkl",
                   "./simple-examples/data/ptb.train.txt", word_idx)


def test(word_idx=None, n=512, gram=5):
    return _reader(n, gram, 1, "test.pkl",
                   "./simple-examples/data/ptb.valid.txt", word_idx)


def convert(path):
    """Write train/test 5-gram streams as RecordIO shards (reference
    v2/dataset/imikolov.py:143)."""
    from . import common

    word_idx = build_dict()
    common.convert(path, train(word_idx, gram=5), 1000, "imikolov_train")
    common.convert(path, test(word_idx, gram=5), 1000, "imikolov_test")
