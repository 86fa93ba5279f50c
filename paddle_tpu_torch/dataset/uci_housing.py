"""UCI housing, the port of ``paddle_tpu/dataset/uci_housing.py``: 13
features -> price.  The whitespace-separated housing.data table when it
is in the cache, feature-normalised ((x - mean) / (max - min) per
column) and split 80/20 train/test; else a legacy pickle cache; else the
same synthetic linear-model surrogate as the JAX package."""

from __future__ import annotations

import numpy as np

from . import common

URL = ("https://archive.ics.uci.edu/ml/machine-learning-databases/"
       "housing/housing.data")
MD5 = "d4accdce7a25600298819f8e28e8d593"


def parse_housing(path: str):
    """-> (x [n,13] float32 normalised, y [n,1] float32)."""
    table = np.loadtxt(path, dtype=np.float64)
    if table.ndim != 2 or table.shape[1] != 14:
        raise ValueError(f"{path}: expected 14 columns, got {table.shape}")
    feats = table[:, :13]
    spread = feats.max(axis=0) - feats.min(axis=0)
    spread[spread == 0] = 1.0
    x = ((feats - feats.mean(axis=0)) / spread).astype(np.float32)
    y = table[:, 13:14].astype(np.float32)
    return x, y


def _data(n, seed, split):
    path = common.local(URL, "uci_housing", MD5)
    if path is not None:
        common.DATA_MODE["uci_housing"] = "real"
        x, y = parse_housing(path)
        cut = int(len(x) * 0.8)
        return (x[:cut], y[:cut]) if split == "train" else (x[cut:], y[cut:])
    if common.has_cached("uci_housing", "housing.pkl"):
        common.DATA_MODE["uci_housing"] = "cache"
        return common.load_cached("uci_housing", "housing.pkl")
    common.DATA_MODE["uci_housing"] = "synthetic"
    rng = common.synthetic_rng("uci_housing", seed)
    w = rng.uniform(-1, 1, (13, 1))
    x = rng.uniform(-1, 1, (n, 13)).astype(np.float32)
    y = (x @ w + 0.3 + 0.05 * rng.randn(n, 1)).astype(np.float32)
    return x, y


def _reader(n, seed, split):
    def reader():
        x, y = _data(n, seed, split)
        for xi, yi in zip(x, y):
            yield xi, yi

    return reader


def train(n=404):
    return _reader(n, 0, "train")


def test(n=102):
    return _reader(n, 1, "test")
