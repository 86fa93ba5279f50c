"""CoNLL-2005 semantic role labelling, the port of
``paddle_tpu/dataset/conll05.py``.

A sample has the nine slots of the book's label_semantic_roles reader:
the word ids, the five words around the predicate (ctx_n2 .. ctx_p2)
repeated over the sentence, the predicate id repeated, the mark (1 on the
predicate's five-word window) and the IOB role labels.  Per reader: the
public conll05st-tests tarball (its gzipped ``words`` and ``props``
column files) with the three dict files when all are in the cache
(``common.local``: the md5-verified originals or provenance-marked
slivers), else a legacy ``*.pkl`` cache, else the JAX package's synthetic
surrogate from the same seed.  ``common.data_mode('conll05')`` says which
one served.  The embedding table is the cached ``emb.pkl`` or the
surrogate's."""

from __future__ import annotations

import gzip
import tarfile

import numpy as np

from . import common

DATA_URL = "http://www.cs.upc.edu/~srlconll/conll05st-tests.tar.gz"
DATA_MD5 = "387719152ae52d60422c016e92a742fc"
WORDDICT_URL = ("http://paddlepaddle.bj.bcebos.com/demo/"
                "srl_dict_and_embedding/wordDict.txt")
WORDDICT_MD5 = "ea7fb7d4c75cc6254716f0177a506baa"
VERBDICT_URL = ("http://paddlepaddle.bj.bcebos.com/demo/"
                "srl_dict_and_embedding/verbDict.txt")
VERBDICT_MD5 = "0d2977293bbb6cbefab5b0f97db1e77c"
TRGDICT_URL = ("http://paddlepaddle.bj.bcebos.com/demo/"
               "srl_dict_and_embedding/targetDict.txt")
TRGDICT_MD5 = "d8c7f03ceb5fc2e5a0fa7503a4353751"

WORDS_MEMBER = "conll05st-release/test.wsj/words/test.wsj.words.gz"
PROPS_MEMBER = "conll05st-release/test.wsj/props/test.wsj.props.gz"

WORD_DICT_LEN = 44068   # the reference's word dict
LABEL_DICT_LEN = 59     # 29 role types x (B, I) + O
PRED_DICT_LEN = 3162
UNK_IDX = 0


# -- parsing ------------------------------------------------------------------

def brackets_to_iob(tags):
    """One predicate's bracket column ('(A0*', '*', '*)', '(V*)') → its
    B-/I-/O tags."""
    out, cur, inside = [], "O", False
    for t in tags:
        if t == "*":
            out.append("I-" + cur if inside else "O")
        elif t == "*)":
            out.append("I-" + cur)
            inside = False
        elif "(" in t:
            cur = t[1:t.index("*")]
            out.append("B-" + cur)
            inside = ")" not in t
        else:
            raise ValueError(f"unexpected props tag {t!r}")
    return out


def _sentences(path, words_member, props_member):
    """(words, verb lemma, IOB labels) for each predicate of each
    sentence of the tarball at `path`."""
    with tarfile.open(path) as tf:
        wf = gzip.GzipFile(fileobj=tf.extractfile(words_member))
        pf = gzip.GzipFile(fileobj=tf.extractfile(props_member))
        words, cols = [], []
        for wline, pline in zip(wf, pf):
            w = wline.strip().decode("utf-8", "replace")
            parts = pline.strip().decode("utf-8", "replace").split()
            if not w:
                yield from _emit(words, cols)
                words, cols = [], []
            else:
                words.append(w)
                cols.append(parts)
        yield from _emit(words, cols)


def _emit(words, cols):
    if not cols:
        return
    verbs = [r[0] for r in cols if r[0] != "-"]
    for k in range(1, len(cols[0])):
        yield words, verbs[k - 1], brackets_to_iob([r[k] for r in cols])


def _load_dict_file(path):
    with open(path) as f:
        return {line.strip(): i for i, line in enumerate(f)}


def _window_sample(sentence, predicate, labels, word_dict, verb_dict,
                   label_dict):
    """The nine slots of one predicate: five words around its B-V
    position (bos/eos past the edges) and the mark of that window."""
    n = len(sentence)
    v = labels.index("B-V")
    mark = [0] * n

    def at(i, edge):
        if 0 <= i < n:
            mark[i] = 1
            return sentence[i]
        return edge

    ctx = [at(v - 2, "bos"), at(v - 1, "bos"), at(v, "bos"),
           at(v + 1, "eos"), at(v + 2, "eos")]
    wi = np.asarray([word_dict.get(w, UNK_IDX) for w in sentence], np.int64)
    ctx_cols = [np.full(n, word_dict.get(c, UNK_IDX), np.int64) for c in ctx]
    pred = np.full(n, verb_dict.get(predicate, UNK_IDX), np.int64)
    lab = np.asarray([label_dict.get(x, 0) for x in labels], np.int64)
    return (wi, *ctx_cols, pred, np.asarray(mark, np.int64), lab)


# -- dicts and the embedding --------------------------------------------------

def _real_dicts():
    """The word, verb and label dicts from the cached dict files, or None
    when any is missing."""
    paths = [common.local(url, "conll05", md5) for url, md5 in (
        (WORDDICT_URL, WORDDICT_MD5), (VERBDICT_URL, VERBDICT_MD5),
        (TRGDICT_URL, TRGDICT_MD5))]
    if all(paths):
        return tuple(_load_dict_file(p) for p in paths)
    return None


def get_dict():
    """(word, verb, label) dicts: the reference's dict files when cached,
    index surrogates of the reference's sizes otherwise."""
    real = _real_dicts()
    if real is not None:
        return real
    return ({f"w{i}": i for i in range(WORD_DICT_LEN)},
            {f"v{i}": i for i in range(PRED_DICT_LEN)},
            {f"l{i}": i for i in range(LABEL_DICT_LEN)})


def get_embedding():
    """The pretrained word embedding [WORD_DICT_LEN, 32]: the cached
    ``emb.pkl``, else the surrogate uniform(-1, 1) table."""
    if common.has_cached("conll05", "emb.pkl"):
        return common.load_cached("conll05", "emb.pkl")
    rng = common.synthetic_rng("conll05_emb")
    return rng.uniform(-1, 1, (WORD_DICT_LEN, 32)).astype(np.float32)


# -- readers ------------------------------------------------------------------

def _synthetic(n, seed):
    """n sentences of 5 to 29 words, one predicate each, O labels but for
    one role span that ends at the predicate (the JAX package's
    surrogate, draw for draw)."""
    rng = common.synthetic_rng("conll05", seed)
    out = []
    for _ in range(n):
        ln = int(rng.randint(5, 30))
        words = rng.randint(0, WORD_DICT_LEN, ln).astype(np.int64)
        pred_pos = int(rng.randint(0, ln))
        pred = np.full(ln, rng.randint(0, PRED_DICT_LEN), np.int64)
        mark = np.zeros(ln, np.int64)
        mark[pred_pos] = 1

        def ctx(off):
            return words[np.clip(np.full(ln, pred_pos + off), 0, ln - 1)]

        labels = np.full(ln, LABEL_DICT_LEN - 1, np.int64)
        span = int(rng.randint(1, 4))
        start = max(0, pred_pos - span)
        role = int(rng.randint(0, (LABEL_DICT_LEN - 1) // 2))
        labels[start] = 2 * role
        labels[start + 1:pred_pos + 1] = 2 * role + 1
        out.append((words, ctx(-2), ctx(-1), ctx(0), ctx(1), ctx(2),
                    pred, mark, labels))
    return out


def _reader(n, seed, fname):
    def reader():
        path = common.local(DATA_URL, "conll05", DATA_MD5)
        # the real corpus only with the real dicts: mapping its words
        # through the index surrogates would give all-UNK samples
        dicts = _real_dicts() if path is not None else None
        if dicts is not None:
            common.DATA_MODE["conll05"] = "real"
            for sentence, predicate, labels in _sentences(
                    path, WORDS_MEMBER, PROPS_MEMBER):
                yield _window_sample(sentence, predicate, labels, *dicts)
            return
        if common.has_cached("conll05", fname):
            common.DATA_MODE["conll05"] = "cache"
            data = common.load_cached("conll05", fname)
        else:
            common.DATA_MODE["conll05"] = "synthetic"
            data = _synthetic(n, seed)
        yield from data

    return reader


def test(n=512):
    return _reader(n, 1, "test.pkl")


def train(n=2048):
    return _reader(n, 0, "train.pkl")


def convert(path):
    """Write the test split as RecordIO shards (reference
    v2/dataset/conll05.py:198 — like the reference, conll05 ships only
    its test split publicly)."""
    from . import common

    common.convert(path, test(), 1000, "conll05_test")
