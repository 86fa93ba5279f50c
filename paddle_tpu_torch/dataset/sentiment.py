"""NLTK movie-review sentiment (reference v2/dataset/sentiment.py):
(token-id sequence, 0/1 polarity).

Real data is NLTK's movie_reviews corpus (the reference shells out to
nltk.download('movie_reviews'); here an installed corpus — including one
placed under DATA_HOME, which is appended to nltk.data.path — is used when
present): word dict by corpus frequency, 1600 train / 400 test documents
with the reference's interleaved pos/neg split.  Fallbacks: legacy pkl
cache, then the synthetic surrogate.

The port of ``paddle_tpu/dataset/sentiment.py``: the same readers, the same
synthetic samples in the same order, and the same parser, reading
only what is already on disk."""

from __future__ import annotations

import numpy as np

from . import common
from .common import DATA_MODE, has_cached, load_cached, synthetic_rng

WORD_DICT_LEN = 8192
NUM_TRAINING_INSTANCES = 1600
NUM_TOTAL_INSTANCES = 2000


def _movie_reviews():
    """The NLTK corpus reader, or None when the corpus isn't installed
    (zero-egress runs can pre-place it under DATA_HOME/nltk_data)."""
    try:
        import nltk
        from nltk.corpus import movie_reviews

        home = common.DATA_HOME  # resolve at call time, not import time
        for extra in (home, f"{home}/nltk_data"):
            if extra not in nltk.data.path:
                nltk.data.path.append(extra)
        movie_reviews.categories()  # raises LookupError when absent
        return movie_reviews
    except Exception:
        return None


_real_cache: dict = {}  # "docs"/"dict" parsed once per process


def _real_docs(mr):
    """Interleaved (ids, polarity) docs — the reference alternates pos/neg
    so a prefix split stays balanced."""
    if "docs" not in _real_cache:
        wd = _real_word_dict(mr)
        unk = WORD_DICT_LEN - 1
        out = []
        for p, n in zip(mr.fileids("pos"), mr.fileids("neg")):
            for fid, label in ((p, 1), (n, 0)):
                ids = np.asarray([wd.get(w.lower(), unk)
                                  for w in mr.words(fid)], np.int64)
                out.append((ids, label))
        _real_cache["docs"] = out
    return _real_cache["docs"]


def _real_word_dict(mr):
    """Frequency dict capped to the module's WORD_DICT_LEN contract: ids
    stay < WORD_DICT_LEN (last id doubles as <unk>) so embedding tables
    sized by WORD_DICT_LEN are always safe."""
    if "dict" not in _real_cache:
        from collections import Counter

        freq = Counter(w.lower() for w in mr.words())
        words = [w for w, _ in freq.most_common(WORD_DICT_LEN - 1)]
        d = {w: i for i, w in enumerate(words)}
        d["<unk>"] = len(d)
        while len(d) < WORD_DICT_LEN:  # tiny-corpus pad to the contract
            d[f"w{len(d)}"] = len(d)
        _real_cache["dict"] = d
    return _real_cache["dict"]


def get_word_dict():
    """word → id, sorted by frequency (reference sentiment.py
    get_word_dict), capped at WORD_DICT_LEN."""
    mr = _movie_reviews()
    if mr is not None:
        return _real_word_dict(mr)
    return {f"w{i}": i for i in range(WORD_DICT_LEN)}


def _synthetic(n, seed):
    rng = synthetic_rng("sentiment", seed)
    for _ in range(n):
        ln = int(rng.randint(6, 48))
        label = int(rng.randint(0, 2))
        toks = rng.randint(0, WORD_DICT_LEN // 2, ln) * 2 + label
        yield np.minimum(toks, WORD_DICT_LEN - 1).astype(np.int64), label


def _reader(n, seed, fname, lo, hi):
    def reader():
        mr = _movie_reviews()
        if mr is not None:
            DATA_MODE["sentiment"] = "real"
            for ids, label in _real_docs(mr)[lo:hi]:
                yield ids, label
            return
        if has_cached("sentiment", fname):
            DATA_MODE["sentiment"] = "cache"
            for sample in load_cached("sentiment", fname):
                yield sample
        else:
            DATA_MODE["sentiment"] = "synthetic"
            yield from _synthetic(n, seed)

    return reader


def train(n=1600):
    return _reader(n, 0, "train.pkl", 0, NUM_TRAINING_INSTANCES)


def test(n=400):
    return _reader(n, 1, "test.pkl", NUM_TRAINING_INSTANCES,
                   NUM_TOTAL_INSTANCES)


def convert(path):
    """Write train/test as RecordIO shards (reference
    v2/dataset/sentiment.py:128)."""
    from . import common

    common.convert(path, train(), 1000, "sentiment_train")
    common.convert(path, test(), 1000, "sentiment_test")
