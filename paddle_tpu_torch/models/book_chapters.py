"""The book chapters that read the dataset modules, built by one code for
either package, with their readers and feeds.

Each chapter is a ``Chapter``: ``build(fluid, **widths)`` appends its
network, cost and optimizer to the default programs and returns (loss,
the feed variables in the reader's sample order); ``reader(fluid,
**widths)`` is its training reader; ``batches(fluid, chapter, feed_vars,
steps, **widths)`` runs that reader through ``reader.batch`` and
``DataFeeder`` into `steps` feed dicts.  `fluid` is the package
(``paddle_tpu_torch``, or in the parity tests the JAX package), and every
layer, reader and dataset module is taken from it, so both packages build
the same desc from this code.

- **understand_sentiment** on ``dataset.imdb``: path A's network
  (``models/rnn_bench.py``): a sequence embedding of the imdb dictionary
  at the hidden width, ``stacked_lstm_net`` (two LSTM layers, the second
  reversed, a max pool, an fc to 2 classes), softmax cross entropy, Adam
  0.002; f32.
- **machine_translation** on ``dataset.wmt14``: path B's
  ``Seq2SeqAttention.train_cost`` (both dictionaries, embedding, hidden
  and attention widths), Adam 0.001; f32.
- **recommender_system** on ``dataset.movielens``: the book's two towers
  (``test_recommender_system.py``): user, gender, age and job embeddings
  each through an fc, joined through an fc of `tower` tanh; movie id
  through an fc, the category sequence sum-pooled, the title through
  ``nets.sequence_conv_pool`` (window 3, tanh, sum), joined the same way;
  ``cos_sim`` scaled by 5 against the rating, ``square_error_cost``, SGD
  0.2.
- **word2vec** on ``dataset.imikolov``: the N-gram model: the N − 1
  context words through one shared embedding, an fc of `hidden` sigmoid,
  a softmax over the dictionary, cross entropy, SGD 0.001.
- **rank_net** and **lambda_rank** on ``dataset.mq2007``: a scorer of the
  46 LETOR features (an fc of `hidden` tanh, an fc to 1) under the v1
  ``rank_cost`` (``rank_loss``) over pairwise samples, every other pair
  swapped so both labels occur, and under the v1 ``lambda_cost``
  (``lambda_rank``, NDCG@5) over listwise ones; SGD 0.05.

``v2_sentiment_build(paddle, ...)`` is the v2 book's understand_sentiment
``stacked_lstm_net`` in the v2 idiom, built through the package's ``v2``
API (`paddle` is ``paddle_tpu_torch.v2``, or in the parity tests the JAX
package's): ``layer.data`` of ``integer_value_sequence(dict_size)``,
``layer.embedding``, then `stacked_num` times an fc of `hid` (linear; from
the second on over the ``layer.concat`` of the previous fc and LSTM) and
an ``lstmemory`` of ``hid / 4`` (every other one reversed),
``layer.pooling`` with ``pooling.Max()`` of the last fc and LSTM, an fc
of 2 softmax and
``layer.classification_cost``; Adam with L2 decay through the package's
own ``regularizer``, trained by ``trainer.SGD``.  ``V2_SENTIMENT`` holds
the book's widths (``full``) and narrow ones for the CPU (``small``).
The book's dropout (``drop_rate`` 0.5), per-parameter learning rates and
initial std are left out: the v1 ``lstmemory`` takes no ``layer_attr``,
and the parity steps carry no dropout.
"""

from __future__ import annotations

from dataclasses import dataclass
from importlib import import_module
from typing import Callable, Dict

import numpy as np


def _sub(fluid, name):
    """The module `name` of the package `fluid`."""
    return import_module(f"{fluid.__name__}.{name}")


# -- understand_sentiment ------------------------------------------------------

def sentiment_build(fluid, dict_size, hidden, layers=2, lr=0.002, **_):
    L = fluid.layers
    words = L.sequence_data(name="words", shape=[1], dtype="int64")
    label = L.data(name="label", shape=[1], dtype="int64")
    emb = L.sequence_embedding(words, size=[dict_size, hidden])
    logits = _sub(fluid, "models.image_models").stacked_lstm_net(
        emb, hidden_dim=hidden, stacked_num=layers, class_dim=2)
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    return loss, [words, label]


def sentiment_reader(fluid, n=2048, **_):
    return _sub(fluid, "dataset.imdb").train(n=n)


# -- machine_translation -------------------------------------------------------

def nmt_build(fluid, dict_size, dim, lr=0.001, **_):
    L = fluid.layers
    model = _sub(fluid, "models.seq2seq").Seq2SeqAttention(
        dict_size, dict_size, emb_dim=dim, hidden=dim, attn=dim)
    src = L.sequence_data("src", shape=[1], dtype="int64")
    tgt = L.sequence_data("tgt", shape=[1], dtype="int64")
    nxt = L.sequence_data("tgt_next", shape=[1], dtype="int64")
    loss = model.train_cost(src, tgt, nxt)
    fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    return loss, [src, tgt, nxt]


def nmt_reader(fluid, dict_size, n=2048, **_):
    return _sub(fluid, "dataset.wmt14").train(dict_size=dict_size, n=n)


# -- recommender_system --------------------------------------------------------

def recommender_build(fluid, emb=32, small_emb=16, filters=32, tower=200,
                      lr=0.2, **_):
    L, ml = fluid.layers, _sub(fluid, "dataset.movielens")

    def lookup(name, size, width):
        ids = L.data(name=name, shape=[1], dtype="int64")
        table = L.embedding(ids, size=[size, width],
                            param_attr={"name": f"{name}_table"})
        return ids, L.fc(input=table, size=width)

    uid, usr = lookup("user_id", ml.max_user_id() + 1, emb)
    gid, gender = lookup("gender_id", 2, small_emb)
    aid, age = lookup("age_id", ml.AGE_BANDS, small_emb)
    jid, job = lookup("job_id", ml.max_job_id() + 1, small_emb)
    usr_vec = L.fc(input=L.concat([usr, gender, age, job], axis=1),
                   size=tower, act="tanh")
    mid, mov = lookup("movie_id", ml.max_movie_id() + 1, emb)
    cat = L.sequence_data("category_id", shape=[1], dtype="int64")
    cats = L.sequence_pool(L.sequence_embedding(
        cat, size=[ml.CATEGORY_COUNT, emb]), pool_type="sum")
    title = L.sequence_data("movie_title", shape=[1], dtype="int64")
    title_vec = fluid.nets.sequence_conv_pool(
        L.sequence_embedding(title, size=[ml.TITLE_DICT, emb]),
        num_filters=filters, filter_size=3, act="tanh", pool_type="sum")
    mov_vec = L.fc(input=L.concat([mov, cats, title_vec], axis=1),
                   size=tower, act="tanh")
    score = L.data(name="score", shape=[1], dtype="float32")
    pred = L.scale(L.cos_sim(X=usr_vec, Y=mov_vec), scale=5.0)
    loss = L.mean(L.square_error_cost(input=pred, label=score))
    fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    return loss, [uid, gid, aid, jid, mid, cat, title, score]


def recommender_reader(fluid, n=4096, **_):
    return _sub(fluid, "dataset.movielens").train(n=n)


# -- word2vec ------------------------------------------------------------------

def word2vec_build(fluid, emb=32, hidden=256, gram=5, lr=0.001, **_):
    L = fluid.layers
    dict_size = len(_sub(fluid, "dataset.imikolov").build_dict())
    words = [L.data(name=f"w{i}", shape=[1], dtype="int64")
             for i in range(gram - 1)]
    nxt = L.data(name="next_word", shape=[1], dtype="int64")
    embs = [L.embedding(w, size=[dict_size, emb],
                        param_attr={"name": "shared_w"}) for w in words]
    h = L.fc(input=L.concat(embs, axis=1), size=hidden, act="sigmoid")
    predict = L.fc(input=h, size=dict_size, act="softmax")
    loss = L.mean(L.cross_entropy(input=predict, label=nxt))
    fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    return loss, words + [nxt]


def word2vec_reader(fluid, gram=5, n=4096, **_):
    mod = _sub(fluid, "dataset.imikolov")
    return mod.train(mod.build_dict(), n=n, gram=gram)


# -- learning to rank ------------------------------------------------------------

def _scorer(fluid, x, hidden, seq):
    """The LETOR scorer, its parameters named so that both sides of a
    pair share them."""
    fc = fluid.layers.sequence_fc if seq else fluid.layers.fc
    h = fc(x, size=hidden, act="tanh", param_attr={"name": "rank_h.w"},
           bias_attr={"name": "rank_h.b"})
    return fc(h, size=1, param_attr={"name": "rank_out.w"},
              bias_attr={"name": "rank_out.b"})


def rank_net_build(fluid, hidden=128, lr=0.05, **_):
    L, v1 = fluid.layers, _sub(fluid, "v1.layers")
    dim = _sub(fluid, "dataset.mq2007").FEATURE_DIM
    left = L.data(name="left", shape=[dim], dtype="float32")
    right = L.data(name="right", shape=[dim], dtype="float32")
    label = L.data(name="pair_label", shape=[1], dtype="float32")
    cost = v1.rank_cost(_scorer(fluid, left, hidden, False),
                        _scorer(fluid, right, hidden, False), label)
    fluid.optimizer.SGD(learning_rate=lr).minimize(cost.var)
    return cost.var, [left, right, label]


def rank_net_reader(fluid, n_queries=120, **_):
    pairs = _sub(fluid, "dataset.mq2007").train("pairwise",
                                               n_queries=n_queries)

    def reader():
        for i, (hi, lo) in enumerate(pairs()):
            yield (hi, lo, 1.0) if i % 2 == 0 else (lo, hi, 0.0)

    return reader


def lambda_rank_build(fluid, hidden=128, ndcg=5, lr=0.05, **_):
    L, v1 = fluid.layers, _sub(fluid, "v1.layers")
    dim = _sub(fluid, "dataset.mq2007").FEATURE_DIM
    feats = L.sequence_data("ltr_feats", shape=[dim], dtype="float32")
    rel = L.sequence_data("ltr_rel", shape=[1], dtype="float32")
    cost = v1.lambda_cost(_scorer(fluid, feats, hidden, True), rel,
                          NDCG_num=ndcg)
    fluid.optimizer.SGD(learning_rate=lr).minimize(cost.var)
    return cost.var, [feats, rel]


def lambda_rank_reader(fluid, n_queries=120, **_):
    lists = _sub(fluid, "dataset.mq2007").train("listwise",
                                               n_queries=n_queries)

    def reader():
        for labels, feats in lists():
            yield (np.asarray(feats, np.float32),
                   np.asarray(labels, np.float32).reshape(-1, 1))

    return reader


# -- understand_sentiment, v2 API ---------------------------------------------

V2_SENTIMENT = {
    "full": {"dict_size": 5147, "emb": 128, "hid": 512, "stacked_num": 3,
             "bs": 100},
    "small": {"dict_size": 64, "emb": 16, "hid": 32, "stacked_num": 3,
              "bs": 8},
}


def v2_sentiment_build(paddle, dict_size, emb, hid, stacked_num=3,
                       lr=2e-3, l2=8e-4, **_):
    """The v2 book's ``stacked_lstm_net`` (see the module docstring) in
    the default programs; returns (cost, output, the optimizer), the
    optimizer for ``paddle.trainer.SGD(update_equation=...)``."""
    assert stacked_num % 2 == 1
    root = import_module(paddle.__name__.rsplit(".", 1)[0])
    linear = paddle.activation.Linear()
    data = paddle.layer.data(
        "word", paddle.data_type.integer_value_sequence(dict_size))
    embedding = paddle.layer.embedding(input=data, size=emb)
    fc = paddle.layer.fc(input=embedding, size=hid, act=linear)
    lstm = paddle.layer.lstmemory(input=fc)
    for i in range(2, stacked_num + 1):
        # the book's fc over [fc, lstm], as one fc over their concat: the
        # v1 fc of several sequences drops their lengths (ROADMAP Queue C)
        fc = paddle.layer.fc(input=paddle.layer.concat(input=[fc, lstm]),
                             size=hid, act=linear)
        lstm = paddle.layer.lstmemory(input=fc, reverse=(i % 2) == 0)
    fc_last = paddle.layer.pooling(input=fc,
                                   pooling_type=paddle.pooling.Max())
    lstm_last = paddle.layer.pooling(input=lstm,
                                     pooling_type=paddle.pooling.Max())
    output = paddle.layer.fc(input=[fc_last, lstm_last], size=2,
                             act=paddle.activation.Softmax())
    label = paddle.layer.data("label", paddle.data_type.integer_value(2))
    cost = paddle.layer.classification_cost(input=output, label=label)
    opt = paddle.optimizer.Adam(
        learning_rate=lr, regularization=root.regularizer.L2Decay(l2))
    return cost, output, opt


# -- the table -------------------------------------------------------------------

@dataclass(frozen=True)
class Chapter:
    name: str
    dataset: str
    build: Callable
    reader: Callable
    full: Dict          # the book's widths and batch
    small: Dict         # narrow widths, a small vocabulary, for the CPU
    adam: bool          # trained with Adam (else SGD)


CHAPTERS = {c.name: c for c in (
    Chapter("understand_sentiment", "imdb", sentiment_build,
            sentiment_reader,
            {"dict_size": 5147, "hidden": 512, "layers": 2, "bs": 64},
            {"dict_size": 5147, "hidden": 8, "layers": 2, "bs": 4, "n": 16},
            True),
    Chapter("machine_translation", "wmt14", nmt_build, nmt_reader,
            {"dict_size": 30000, "dim": 512, "bs": 64},
            {"dict_size": 64, "dim": 8, "bs": 4, "n": 16}, True),
    Chapter("recommender_system", "movielens", recommender_build,
            recommender_reader,
            {"emb": 32, "small_emb": 16, "filters": 32, "tower": 200,
             "bs": 256},
            {"emb": 4, "small_emb": 2, "filters": 4, "tower": 8, "bs": 8,
             "n": 32}, False),
    Chapter("word2vec", "imikolov", word2vec_build, word2vec_reader,
            {"emb": 32, "hidden": 256, "gram": 5, "bs": 100},
            {"emb": 4, "hidden": 8, "gram": 5, "bs": 8, "n": 32}, False),
    Chapter("rank_net", "mq2007", rank_net_build, rank_net_reader,
            {"hidden": 128, "bs": 256, "n_queries": 240},
            {"hidden": 8, "bs": 16, "n_queries": 8}, False),
    Chapter("lambda_rank", "mq2007", lambda_rank_build, lambda_rank_reader,
            {"hidden": 128, "ndcg": 5, "bs": 16, "n_queries": 240},
            {"hidden": 8, "ndcg": 5, "bs": 4, "n_queries": 16}, False),
)}


def batches(fluid, chapter, feed_vars, steps, **widths):
    """The first `steps` minibatches of the chapter's reader at batch
    ``widths["bs"]`` (``reader.batch``, whole batches only), each made a
    feed dict by ``DataFeeder``; the reader cycles when it runs short."""
    feeder = fluid.DataFeeder(feed_list=feed_vars)
    reader = fluid.reader.batch(chapter.reader(fluid, **widths),
                                widths["bs"], drop_last=True)
    out = []
    while len(out) < steps:
        before = len(out)
        for mb in reader():
            out.append(feeder.feed(mb))
            if len(out) == steps:
                break
        if len(out) == before:
            raise ValueError(f"{chapter.name}: the reader yields no whole "
                             f"batch of {widths['bs']}")
    return out
