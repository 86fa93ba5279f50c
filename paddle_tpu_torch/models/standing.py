"""The standing calibration programs, the port of
``paddle_tpu/models/standing.py``: fit-a-line, recognize-digits, the
small decoder LM and the small stacked-LSTM classifier — a fixed set of
small programs that always describe the same descs.

Each function adds to the default main and startup programs (call
``paddle_tpu_torch.reset()`` first) and returns ``(feed, fetch_list,
batch_size)``."""

from __future__ import annotations

import numpy as np

from .. import layers, optimizer


def build_fit_a_line():
    x = layers.data(name="x", shape=[13])
    y = layers.data(name="y", shape=[1])
    pred = layers.fc(input=x, size=1)
    cost = layers.mean(layers.square_error_cost(pred, y))
    optimizer.SGD(learning_rate=0.01).minimize(cost)
    rng = np.random.RandomState(0)
    bs = 64
    feed = {"x": rng.rand(bs, 13).astype(np.float32),
            "y": rng.rand(bs, 1).astype(np.float32)}
    return feed, [cost], bs


def build_recognize_digits():
    img = layers.data(name="img", shape=[1, 28, 28])
    label = layers.data(name="label", shape=[1], dtype="int64")
    c = layers.conv2d(img, num_filters=8, filter_size=5, bias_attr=False)
    b = layers.batch_norm(c, act="relu")
    p = layers.pool2d(b, pool_size=2, pool_stride=2)
    flat = layers.reshape(p, [-1, 8 * 12 * 12])
    pred = layers.fc(flat, size=10, act="softmax")
    loss = layers.mean(layers.cross_entropy(pred, label))
    optimizer.Adam(learning_rate=1e-3).minimize(loss)
    rng = np.random.RandomState(1)
    bs = 16
    feed = {"img": rng.rand(bs, 1, 28, 28).astype(np.float32),
            "label": rng.randint(0, 10, (bs, 1)).astype(np.int64)}
    return feed, [loss], bs


def build_small_lm():
    from . import transformer

    S, V = 32, 128
    loss = transformer.build_lm_train_program(
        seq_len=S, vocab_size=V, dim=32, n_layers=2, n_heads=2,
        dtype="float32", learning_rate=1e-2)
    rng = np.random.RandomState(2)
    bs = 4
    toks = rng.randint(0, V, (bs, S, 1)).astype(np.int64)
    feed = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    return feed, [loss], bs


def build_lstm():
    """The LSTM benchmark's program at a small size: two stacked LSTM
    layers (hidden 128) over 32 steps of a 1000-word vocabulary, an fc to
    2 classes, Adam 0.002, batch 8 (the JAX package's autotune LSTM
    workload, whose program this copies)."""
    from . import image_models

    bs, hidden, seq = 8, 128, 32
    words = layers.sequence_data(name="words", shape=[1], dtype="int64",
                                 max_len=seq)
    label = layers.data(name="label", shape=[1], dtype="int64")
    emb = layers.sequence_embedding(words, size=[1000, hidden],
                                    dtype="float32")
    logits = image_models.stacked_lstm_net(emb, hidden_dim=hidden,
                                           stacked_num=2, class_dim=2)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    optimizer.Adam(learning_rate=0.002).minimize(loss)
    rng = np.random.RandomState(11)
    feed = {"words": rng.randint(0, 1000, (bs, seq, 1)).astype(np.int64),
            "words@LENGTH": np.full((bs,), seq, dtype=np.int32),
            "label": rng.randint(0, 2, (bs, 1)).astype(np.int64)}
    return feed, [loss], bs


MODELS = (("fit_a_line", build_fit_a_line),
          ("recognize_digits", build_recognize_digits),
          ("small_lm", build_small_lm),
          ("lstm", build_lstm))


def get_builder(name):
    for n, b in MODELS:
        if n == name:
            return b
    return None
