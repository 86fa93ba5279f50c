"""CIFAR-10/100 (reference v2/dataset/cifar.py): 3x32x32 images.

Real data is the official python-pickle tarball (cifar-10-python.tar.gz /
cifar-100-python.tar.gz, md5s as in reference cifar.py:30-34), parsed
straight out of the tar without extracting.  Fallbacks: legacy pkl cache,
then the deterministic synthetic surrogate.

The port of ``paddle_tpu/dataset/cifar.py``: the same readers, the same
synthetic samples in the same order, and the same parser, reading
the archive only when it is already in the cache (``common.local``:
the md5-verified original, or a provenance-marked sliver); nothing
is fetched."""

from __future__ import annotations

import pickle
import tarfile

import numpy as np

from . import common
from .common import DATA_MODE, has_cached, load_cached, synthetic_rng

URL_PREFIX = "https://www.cs.toronto.edu/~kriz/"
CIFAR10_URL = URL_PREFIX + "cifar-10-python.tar.gz"
CIFAR10_MD5 = "c58f30108f718f92721af3b95e74349a"
CIFAR100_URL = URL_PREFIX + "cifar-100-python.tar.gz"
CIFAR100_MD5 = "eb9058c3a382ffc7106e4002c42a8d85"


def parse_tar(path: str, sub_name: str, label_key: str):
    """Yield (float32 [3072] in [0,1], int label) from every pickled batch
    member whose name contains `sub_name` (reference cifar.py reader())."""
    with tarfile.open(path, mode="r") as f:
        names = sorted(m.name for m in f.getmembers()
                       if sub_name in m.name and m.isfile())
        for name in names:
            batch = pickle.load(f.extractfile(name), encoding="bytes")
            data = np.asarray(batch[b"data"], dtype=np.float32) / 255.0
            labels = batch.get(label_key.encode())
            for x, y in zip(data, labels):
                yield x, int(y)


def _synthetic(n, ncls, seed):
    rng = synthetic_rng("cifar", seed)
    templates = rng.rand(ncls, 3 * 32 * 32).astype(np.float32)
    labels = rng.randint(0, ncls, n)
    imgs = np.clip(templates[labels] +
                   0.25 * rng.rand(n, 3 * 32 * 32).astype(np.float32), 0, 1)
    return imgs, labels.astype(np.int64)


def _reader(n, ncls, seed, fname, url, md5, sub_name, label_key):
    def reader():
        path = common.local(url, "cifar", md5)
        if path is not None:
            DATA_MODE["cifar"] = "real"
            yield from parse_tar(path, sub_name, label_key)
            return
        if has_cached("cifar", fname):
            DATA_MODE["cifar"] = "cache"
            imgs, labels = load_cached("cifar", fname)
        else:
            DATA_MODE["cifar"] = "synthetic"
            imgs, labels = _synthetic(n, ncls, seed)
        for x, y in zip(imgs, labels):
            yield x, int(y)

    return reader


def train10(n=4096):
    return _reader(n, 10, 0, "train10.pkl", CIFAR10_URL, CIFAR10_MD5,
                   "data_batch", "labels")


def test10(n=512):
    return _reader(n, 10, 1, "test10.pkl", CIFAR10_URL, CIFAR10_MD5,
                   "test_batch", "labels")


def train100(n=4096):
    return _reader(n, 100, 0, "train100.pkl", CIFAR100_URL, CIFAR100_MD5,
                   "train", "fine_labels")


def test100(n=512):
    return _reader(n, 100, 1, "test100.pkl", CIFAR100_URL, CIFAR100_MD5,
                   "test", "fine_labels")


def convert(path):
    """Write all four splits as RecordIO shards (reference
    v2/dataset/cifar.py:132)."""
    from . import common

    common.convert(path, train100(), 1000, "cifar_train100")
    common.convert(path, test100(), 1000, "cifar_test100")
    common.convert(path, train10(), 1000, "cifar_train10")
    common.convert(path, test10(), 1000, "cifar_test10")
