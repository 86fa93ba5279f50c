"""LETOR MQ2007 learning-to-rank (reference v2/dataset/mq2007.py).

Three reader formats, as in the reference:
- ``pointwise``: (feature [46], relevance score)
- ``pairwise``: (higher-ranked feature, lower-ranked feature)
- ``listwise``: (label list, feature list) per query

The port of ``paddle_tpu/dataset/mq2007.py``: the same readers, the same
synthetic samples in the same order, and the same parser, reading
only what is already on disk."""

from __future__ import annotations

import glob
import os

import numpy as np

from . import common
from .common import DATA_MODE, has_cached, load_cached, synthetic_rng

FEATURE_DIM = 46
MAX_REL = 2  # relevance grades 0..2


def parse_letor(path: str):
    """Parse a LETOR text file (`rel qid:N 1:v ... 46:v #docid...`) into
    [(labels [n], feats [n, 46])] grouped by query, file order."""
    queries: dict = {}
    order = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            rel = int(parts[0])
            qid = parts[1].split(":", 1)[1]
            feats = np.zeros(FEATURE_DIM, np.float32)
            for tok in parts[2:]:
                k, v = tok.split(":", 1)
                k = int(k)
                if 1 <= k <= FEATURE_DIM:
                    feats[k - 1] = float(v)
            if qid not in queries:
                queries[qid] = []
                order.append(qid)
            queries[qid].append((rel, feats))
    out = []
    for qid in order:
        rows = queries[qid]
        out.append((np.asarray([r for r, _ in rows], np.int64),
                    np.stack([x for _, x in rows])))
    return out


def _real_file(split: str):
    """A pre-extracted LETOR file under DATA_HOME/mq2007 (the reference
    distributes MQ2007 as a .rar — extract it there first; Fold1 layout
    `Fold1/{train,vali,test}.txt` or flat `{split}.txt` both work)."""
    base = os.path.join(common.DATA_HOME, "mq2007")
    for pat in (os.path.join(base, f"{split}.txt"),
                os.path.join(base, "Fold1", f"{split}.txt"),
                os.path.join(base, "**", f"{split}.txt")):
        hits = sorted(glob.glob(pat, recursive=True))
        if hits:
            return hits[0]
    return None


def _synthetic_queries(n_queries, seed):
    rng = synthetic_rng("mq2007", seed)
    queries = []
    for _ in range(n_queries):
        n_docs = int(rng.randint(4, 12))
        labels = rng.randint(0, MAX_REL + 1, n_docs)
        # relevance-correlated features so rankers can learn
        feats = (rng.normal(0, 0.3, (n_docs, FEATURE_DIM))
                 + labels[:, None] * 0.5).astype(np.float32)
        queries.append((labels.astype(np.int64), feats))
    return queries


def _load(n_queries, seed, fname, split):
    real = _real_file(split)
    if real is not None:
        DATA_MODE["mq2007"] = "real"
        return parse_letor(real)
    if has_cached("mq2007", fname):
        DATA_MODE["mq2007"] = "cache"
        return load_cached("mq2007", fname)
    DATA_MODE["mq2007"] = "synthetic"
    return _synthetic_queries(n_queries, seed)


def _reader(format, n_queries, seed, fname, split):
    def pointwise():
        for labels, feats in _load(n_queries, seed, fname, split):
            for y, x in zip(labels, feats):
                yield x, int(y)

    def pairwise():
        for labels, feats in _load(n_queries, seed, fname, split):
            for i in range(len(labels)):
                for j in range(len(labels)):
                    if labels[i] > labels[j]:
                        yield feats[i], feats[j]

    def listwise():
        for labels, feats in _load(n_queries, seed, fname, split):
            yield list(labels), list(feats)

    return {"pointwise": pointwise, "pairwise": pairwise,
            "listwise": listwise}[format]


def train(format="pairwise", n_queries=120):
    return _reader(format, n_queries, 0, "train.pkl", "train")


def test(format="pairwise", n_queries=30):
    return _reader(format, n_queries, 1, "test.pkl", "test")
