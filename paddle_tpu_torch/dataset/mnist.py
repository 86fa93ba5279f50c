"""MNIST, the port of ``paddle_tpu/dataset/mnist.py``: 28x28 grayscale
digits.  Per reader, the idx-format files when they are in the cache
(the md5-verified originals, or a provenance-marked sliver of real
digits), else a legacy ``*.pkl`` cache, else the JAX package's
class-template synthetic surrogate.  ``common.data_mode('mnist')`` says
which one served."""

from __future__ import annotations

import gzip
import struct

import numpy as np

from . import common

URL_PREFIX = "https://storage.googleapis.com/cvdf-datasets/mnist/"
TRAIN_IMAGE = ("train-images-idx3-ubyte.gz", "f68b3c2dcbeaaa9fbdd348bbdeb94873")
TRAIN_LABEL = ("train-labels-idx1-ubyte.gz", "d53e105ee54ea40749a09fcbcd1e9432")
TEST_IMAGE = ("t10k-images-idx3-ubyte.gz", "9fb629c4189551a2d022fa330f9573f3")
TEST_LABEL = ("t10k-labels-idx1-ubyte.gz", "ec29112dd5afa0611ce80d1b7f02629c")


def _open(path):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def parse_idx_images(path: str) -> np.ndarray:
    """idx3-ubyte (optionally gzipped): big-endian magic 2051, n, rows,
    cols, then raw pixels.  Returns float32 [n, rows*cols] in [0, 1]."""
    with _open(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"{path}: bad idx3 magic {magic}")
        buf = f.read(n * rows * cols)
    imgs = np.frombuffer(buf, dtype=np.uint8).reshape(n, rows * cols)
    return imgs.astype(np.float32) / 255.0


def parse_idx_labels(path: str) -> np.ndarray:
    with _open(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"{path}: bad idx1 magic {magic}")
        buf = f.read(n)
    return np.frombuffer(buf, dtype=np.uint8).astype(np.int64)


def _real(image_spec, label_spec):
    """Both idx files in the cache -> (imgs, labels); else None."""
    paths = []
    for fname, md5 in (image_spec, label_spec):
        p = common.local(URL_PREFIX + fname, "mnist", md5)
        if p is None:
            return None
        paths.append(p)
    return parse_idx_images(paths[0]), parse_idx_labels(paths[1])


def _synthetic(n, seed):
    rng = common.synthetic_rng("mnist", seed)
    templates = rng.rand(10, 784).astype(np.float32)
    labels = rng.randint(0, 10, n)
    imgs = np.clip(
        templates[labels] + 0.25 * rng.rand(n, 784).astype(np.float32), 0, 1)
    return imgs.astype(np.float32), labels.astype(np.int64)


def _reader(n, seed, image_spec, label_spec, pkl_name):
    def reader():
        real = _real(image_spec, label_spec)
        if real is not None:
            common.DATA_MODE["mnist"] = "real"
            imgs, labels = real
        elif common.has_cached("mnist", pkl_name):
            common.DATA_MODE["mnist"] = "cache"
            imgs, labels = common.load_cached("mnist", pkl_name)
        else:
            common.DATA_MODE["mnist"] = "synthetic"
            imgs, labels = _synthetic(n, seed)
        for x, y in zip(imgs, labels):
            yield x, int(y)

    return reader


def train(n=8192):
    return _reader(n, 0, TRAIN_IMAGE, TRAIN_LABEL, "train.pkl")


def test(n=1024):
    return _reader(n, 1, TEST_IMAGE, TEST_LABEL, "test.pkl")
