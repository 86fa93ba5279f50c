"""WMT14 fr-en (reference v2/dataset/wmt14.py) — NMT book test data:
(src_ids, tgt_ids_with_bos, tgt_next_ids_with_eos).

Real data is the shrunk wmt14.tgz (reference wmt14.py:33 URL/md5): dict
members `*src.dict`/`*trg.dict` (one word per line, id = line number) and
tab-separated tokenized parallel lines under `train/train` / `test/test`;
samples longer than 80 tokens are skipped, <s>/<e>/<unk> conventions as in
the reference.  Fallbacks: legacy pkl cache, then the synthetic
reversal-task surrogate.

The port of ``paddle_tpu/dataset/wmt14.py``: the same readers, the same
synthetic samples in the same order, and the same parser, reading
the archive only when it is already in the cache (``common.local``:
the md5-verified original, or a provenance-marked sliver); nothing
is fetched."""

from __future__ import annotations

import tarfile

import numpy as np

from . import common
from .common import DATA_MODE, has_cached, load_cached, synthetic_rng

URL = "http://paddlepaddle.cdn.bcebos.com/demo/wmt_shrinked_data/wmt14.tgz"
MD5 = "0791583d57d5beb693b9414c5b36798c"

DICT_SIZE = 30000
BOS, EOS, UNK = 0, 1, 2
START_W, END_W, UNK_W = "<s>", "<e>", "<unk>"
MAX_LEN = 80


def _read_dict(f, member_suffix, dict_size):
    name = next(m.name for m in f.getmembers()
                if m.name.endswith(member_suffix))
    out = {}
    for i, line in enumerate(f.extractfile(name)):
        if i >= dict_size:
            break
        out[line.strip().decode("utf-8", "replace")] = i
    return out


def read_dicts(path: str, dict_size: int):
    """-> (src_dict, trg_dict) from the tarball's *.dict members."""
    with tarfile.open(path, mode="r") as f:
        return (_read_dict(f, "src.dict", dict_size),
                _read_dict(f, "trg.dict", dict_size))


def _real_samples(path, member_suffix, dict_size):
    # one open per epoch: dicts and corpus come off the same decompression
    # pass (gzip tars cannot seek — a second open re-reads the archive)
    with tarfile.open(path, mode="r") as f:
        src_dict = _read_dict(f, "src.dict", dict_size)
        trg_dict = _read_dict(f, "trg.dict", dict_size)
        unk_s = src_dict.get(UNK_W, UNK)
        unk_t = trg_dict.get(UNK_W, UNK)
        names = [m.name for m in f.getmembers()
                 if m.name.endswith(member_suffix)]
        for name in names:
            for line in f.extractfile(name):
                parts = line.strip().decode("utf-8", "replace").split("\t")
                if len(parts) != 2:
                    continue
                src_ids = [src_dict.get(w, unk_s)
                           for w in [START_W] + parts[0].split() + [END_W]]
                trg_ids = [trg_dict.get(w, unk_t) for w in parts[1].split()]
                if len(src_ids) > MAX_LEN or len(trg_ids) > MAX_LEN:
                    continue
                yield (np.asarray(src_ids, np.int64),
                       np.asarray([trg_dict[START_W]] + trg_ids, np.int64),
                       np.asarray(trg_ids + [trg_dict[END_W]], np.int64))


def _reader(n, dict_size, seed, fname, member_suffix):
    def reader():
        path = common.local(URL, "wmt14", MD5)
        if path is not None:
            DATA_MODE["wmt14"] = "real"
            yield from _real_samples(path, member_suffix, dict_size)
            return
        if has_cached("wmt14", fname):
            DATA_MODE["wmt14"] = "cache"
            for s in load_cached("wmt14", fname):
                yield tuple(s)
            return
        DATA_MODE["wmt14"] = "synthetic"
        rng = synthetic_rng("wmt14", seed)
        # synthetic 'translation': target = reversed source band-shifted
        for _ in range(n):
            ln = rng.randint(3, 12)
            src = rng.randint(3, dict_size, ln).astype(np.int64)
            tgt = src[::-1].copy()
            yield (src,
                   np.concatenate([[BOS], tgt]).astype(np.int64),
                   np.concatenate([tgt, [EOS]]).astype(np.int64))

    return reader


def train(dict_size=DICT_SIZE, n=2048):
    return _reader(n, dict_size, 0, "train.pkl", "train/train")


def test(dict_size=DICT_SIZE, n=256):
    return _reader(n, dict_size, 1, "test.pkl", "test/test")


def convert(path):
    """Write train/test as RecordIO shards (reference
    v2/dataset/wmt14.py:152)."""
    from . import common

    dict_size = 30000
    common.convert(path, train(dict_size), 1000, "wmt14_train")
    common.convert(path, test(dict_size), 1000, "wmt14_test")
