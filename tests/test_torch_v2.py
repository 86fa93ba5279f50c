"""The port's v2 API (``paddle_tpu_torch/v2/``) on the CPU, against the JAX
package's: the cases of ``tests/test_v2_api.py``,
``test_fluid_compat.py::test_v2_topology_and_master_client``,
``test_aux.py::test_v2_ploter_collects_and_renders``,
``test_machine_translation.py::test_v2_sequence_generator`` and the
``SequenceGenerator`` use in ``test_v1_layers_full.py``, each run in both
packages from the same lines, and the v2 book's stacked-LSTM sentiment
net (``models/book_chapters.py`` ``v2_sentiment_build``) at narrow widths.

Each package builds the same desc (``to_json`` letter for letter); the
JAX startup's parameters reach the port through a ``Parameters`` tar
(the two packages write the same tar bytes and load each other's to the
bit); the training costs, and the parameters after them, agree within
1e-5 relative (SGD, Momentum) or 1e-4 (Adam), as in
``tests/test_torch_book_chapters.py``; ``infer`` outputs within 1e-5 of
their largest value; ``SequenceGenerator`` rankings equal."""

import io

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.v2 as jpaddle
import paddle_tpu_torch as tfluid
import paddle_tpu_torch.v2 as tpaddle
from paddle_tpu.dataset import common as jcommon
from paddle_tpu_torch.dataset import common as tcommon
from paddle_tpu_torch.models.book_chapters import (V2_SENTIMENT,
                                                   v2_sentiment_build)

PKGS = ((jfluid, jpaddle), (tfluid, tpaddle))  # JAX first: its state leads


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    for common in (tcommon, jcommon):
        monkeypatch.setattr(common, "DATA_HOME", str(tmp_path / "data"))
    tfluid.reset()
    jfluid.reset()
    yield


def _rel(t, j):
    j = np.asarray(j, np.float64)
    return float(np.abs(np.asarray(t, np.float64) - j).max()
                 / max(float(np.abs(j).max()), 1e-30))


def _tar(params):
    buf = io.BytesIO()
    params.to_tar(buf)
    return buf.getvalue()


def _carry(jtrainer, ttrainer):
    """Run both startups, then give the port the JAX parameters through a
    tar; both packages' tars of them are then the same bytes."""
    jtrainer._ensure_startup()
    ttrainer._ensure_startup()
    blob = _tar(jtrainer.parameters)
    ttrainer.parameters.from_tar(io.BytesIO(blob))
    assert _tar(ttrainer.parameters) == blob
    return blob


def _train(paddle, trainer, reader, passes, feeding, events=None):
    costs = []

    def handler(e):
        if events is not None:
            events.append(type(e).__name__)
        if isinstance(e, paddle.event.EndIteration):
            costs.append(e.cost)

    trainer.train(reader, num_passes=passes, event_handler=handler,
                  feeding=feeding)
    return costs


def _same_params(jparams, tparams, tol):
    assert sorted(tparams.names()) == sorted(jparams.names())
    for n in jparams.names():
        assert _rel(tparams.get(n), jparams.get(n)) <= tol, n


def _json():
    return (tfluid.default_main_program().to_json(),
            jfluid.default_main_program().to_json())


# -- tests/test_v2_api.py -----------------------------------------------------

def _housing_cost(fluid):
    x = fluid.layers.data(name="x", shape=[13], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    pred = fluid.layers.fc(input=x, size=1)
    cost = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    return cost, pred


def _housing_trainers():
    out = []
    for fluid, paddle in PKGS:
        cost, pred = _housing_cost(fluid)
        tr = paddle.trainer.SGD(
            cost=cost, place=fluid.CPUPlace(),
            update_equation=paddle.optimizer.SGD(learning_rate=0.05))
        out.append((paddle, tr, pred))
    t, j = _json()
    assert t == j
    _carry(out[0][1], out[1][1])
    return out


def test_v2_train_event_loop():
    runs = []
    for paddle, tr, _ in _housing_trainers():
        events = []
        reader = paddle.batch(paddle.dataset.uci_housing.train(), 64)
        costs = _train(paddle, tr, reader, 10, {"x": 0, "y": 1}, events)
        assert events.count("BeginPass") == events.count("EndPass") == 10
        assert len(costs) == 10 * len(list(reader()))
        assert costs[-1] < costs[0]
        res = tr.test(paddle.batch(paddle.dataset.uci_housing.test(), 64),
                      feeding={"x": 0, "y": 1})
        assert np.isfinite(res.cost)
        runs.append((costs, res.cost, events, tr.parameters))
    (jc, jt, je, jp), (tc, tt, te, tp) = runs
    assert te == je
    np.testing.assert_allclose(tc, jc, rtol=1e-5)
    np.testing.assert_allclose(tt, jt, rtol=1e-5)
    _same_params(jp, tp, 1e-5)


def test_v2_parameters_tar_roundtrip():
    (jpad, jtr, _), (tpad, ttr, _) = _housing_trainers()
    for paddle, tr in ((jpad, jtr), (tpad, ttr)):
        _train(paddle, tr, paddle.batch(paddle.dataset.uci_housing.train(),
                                        64), 3, {"x": 0, "y": 1})
    params = ttr.parameters
    blob = _tar(params)
    w_before = params.get(params.names()[0]).copy()
    params.set(params.names()[0], np.zeros_like(w_before))
    params.from_tar(io.BytesIO(blob))
    np.testing.assert_array_equal(params.get(params.names()[0]), w_before)
    # the port's tar loads into JAX to the bit, and back
    jtr.parameters.from_tar(io.BytesIO(blob))
    for n in params.names():
        np.testing.assert_array_equal(jtr.parameters.get(n), params.get(n))
    assert _tar(jtr.parameters) == blob


def test_v2_infer():
    outs = []
    for paddle, tr, pred in _housing_trainers():
        _train(paddle, tr, paddle.batch(paddle.dataset.uci_housing.train(),
                                        64), 5, {"x": 0, "y": 1})
        samples = [(x,) for x, _ in
                   list(paddle.dataset.uci_housing.test()())[:8]]
        out = paddle.infer(output_layer=pred, parameters=tr.parameters,
                           input=samples, **({"place": tfluid.CPUPlace()}
                                             if paddle is tpaddle else {}))
        assert out.shape == (8, 1) and np.isfinite(out).all()
        outs.append(out)
    assert _rel(outs[1], outs[0]) <= 1e-5


def test_v2_infer_runs_on_the_card_by_default(monkeypatch):
    """``infer`` and ``SGD`` take the card unless given a place: without
    CUDA both raise naming CPUPlace."""
    import torch

    cost, pred = _housing_cost(tfluid)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        tpaddle.trainer.SGD(cost=cost)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        tpaddle.infer(output_layer=pred, parameters=None,
                      input=[(np.zeros(13, np.float32),)])


def test_v2_book_style_api():
    """The reference v2 book idiom: layer.data with data_type slots,
    activation objects, parameters.create, trainer.SGD over a batched
    reader, infer with a feeding map."""
    runs = []
    for fluid, paddle in PKGS:
        pixel = paddle.layer.data(name="pixel",
                                  type=paddle.data_type.dense_vector(64))
        label = paddle.layer.data(name="label",
                                  type=paddle.data_type.integer_value(4))
        hidden = paddle.layer.fc(input=pixel, size=32,
                                 act=paddle.activation.Sigmoid())
        inference = paddle.layer.fc(input=hidden, size=4,
                                    act=paddle.activation.Softmax())
        cost = paddle.layer.classification_cost(input=inference, label=label)
        parameters = paddle.parameters.create(cost)
        assert len(parameters.names()) >= 4  # two fc layers' w+b
        tr = paddle.trainer.SGD(
            cost=cost.var, parameters=parameters, place=fluid.CPUPlace(),
            update_equation=paddle.optimizer.Momentum(learning_rate=0.1,
                                                      momentum=0.9))
        runs.append((paddle, tr, inference))
    t, j = _json()
    assert t == j
    _carry(runs[0][1], runs[1][1])
    out = []
    for paddle, tr, inference in runs:
        rng = np.random.RandomState(0)
        temps = rng.rand(4, 64)

        def reader():
            for _ in range(128):
                y = rng.randint(0, 4)
                yield (temps[y] + 0.1 * rng.rand(64)).astype(np.float32), y

        costs = _train(paddle, tr, paddle.batch(reader, batch_size=32), 6,
                       {"pixel": 0, "label": 1})
        assert costs[-1] < costs[0]
        kw = {"place": tfluid.CPUPlace()} if paddle is tpaddle else {}
        probs = paddle.infer(output_layer=inference.var,
                             parameters=tr.parameters,
                             input=[(temps[2].astype(np.float32),)],
                             feeding={"pixel": 0}, **kw)
        assert np.asarray(probs).shape[-1] == 4
        out.append((costs, probs, tr.parameters))
    (jc, jprob, jp), (tc, tprob, tp) = out
    np.testing.assert_allclose(tc, jc, rtol=1e-5)
    assert _rel(tprob, jprob) <= 1e-5
    _same_params(jp, tp, 1e-5)


def test_v2_image_pipeline(tmp_path):
    """resize_short -> crop -> flip -> CHW float32 - mean, and tar
    batching, equal to the JAX package's on the same image."""
    import pickle
    import tarfile

    from PIL import Image

    from paddle_tpu.v2 import image as jimg
    from paddle_tpu_torch.v2 import image as timg

    rng = np.random.RandomState(0)
    arr = rng.randint(0, 255, (48, 64, 3), dtype=np.uint8)
    p = tmp_path / "a.jpg"
    Image.fromarray(arr).save(p)

    im = timg.load_image(str(p))
    assert im.shape == (48, 64, 3)
    np.testing.assert_array_equal(im, jimg.load_image(str(p)))
    rs = timg.resize_short(im, 32)
    assert min(rs.shape[:2]) == 32 and rs.shape[1] > rs.shape[0]
    np.testing.assert_array_equal(rs, jimg.resize_short(im, 32))
    rsf = timg.resize_short(im.astype(np.float32), 20)
    np.testing.assert_array_equal(
        rsf, jimg.resize_short(im.astype(np.float32), 20))
    cc = timg.center_crop(rs, 32)
    assert cc.shape[:2] == (32, 32)
    out = timg.simple_transform(im, 40, 32, is_train=False,
                                mean=[1.0, 2.0, 3.0])
    assert out.shape == (3, 32, 32) and out.dtype == np.float32
    np.testing.assert_array_equal(out, jimg.simple_transform(
        im, 40, 32, is_train=False, mean=[1.0, 2.0, 3.0]))
    tr = timg.simple_transform(im, 40, 32, is_train=True,
                               rng=np.random.RandomState(1))
    assert tr.shape == (3, 32, 32)
    np.testing.assert_array_equal(tr, jimg.simple_transform(
        im, 40, 32, is_train=True, rng=np.random.RandomState(1)))
    flipped = timg.left_right_flip(cc)
    np.testing.assert_array_equal(flipped[:, ::-1], cc)

    tarp = tmp_path / "imgs.tar"
    with tarfile.open(tarp, "w") as tf:
        tf.add(p, arcname="imgs/a.jpg")
    meta = timg.batch_images_from_tar(str(tarp), "toy", {"imgs/a.jpg": 3},
                                      num_per_batch=8)
    batch_files = open(meta).read().split()
    rec = pickle.load(open(batch_files[0], "rb"))
    assert rec["label"] == [3]
    assert timg.load_image_bytes(rec["data"][0]).shape == (48, 64, 3)


def test_v2_operator_sugar_and_data_feeder():
    """v2/op.py: +, -, unary minus, scalar *, size-1 scaling and the unary
    math ops compose through v1 layers and train; v2.DataFeeder with an
    explicit feeding map."""
    runs = []
    for fluid, paddle in PKGS:
        op = __import__(f"{paddle.__name__}.op", fromlist=["op"])
        x = paddle.layer.data(name="x", type=paddle.data_type.dense_vector(4))
        y = paddle.layer.data(name="y", type=paddle.data_type.dense_vector(4))
        h = paddle.layer.fc(input=x, size=4)
        gate = paddle.layer.fc(input=x, size=1)
        out = op.tanh((h + x) * 0.5 - 1.0 + gate * h - (-y))
        cost = paddle.layer.mse_cost(input=out, label=y)
        tr = paddle.trainer.SGD(
            cost=cost, parameters=paddle.parameters.create(cost),
            update_equation=paddle.optimizer.Adam(learning_rate=5e-3),
            place=fluid.CPUPlace())
        runs.append((paddle, tr, x, h))
    t, j = _json()
    assert t == j
    _carry(runs[0][1], runs[1][1])
    rng = np.random.RandomState(0)
    data = [(rng.rand(4).astype(np.float32),
             rng.rand(4).astype(np.float32)) for _ in range(32)]
    out = []
    for paddle, tr, _, _ in runs:
        costs = _train(paddle, tr, paddle.batch(lambda: iter(data),
                                                batch_size=8), 8,
                       {"x": 0, "y": 1})
        assert costs[-1] < costs[0], (costs[0], costs[-1])
        feeder = paddle.DataFeeder(
            [("x", paddle.data_type.dense_vector(4)),
             ("y", paddle.data_type.dense_vector(4))], {"x": 0, "y": 1})
        feed = feeder(data[:8])
        assert set(feed.keys()) == {"x", "y"}
        assert np.asarray(feed["x"]).shape == (8, 4)
        out.append((costs, feed, tr.parameters))
    (jc, jfeed, jp), (tc, tfeed, tp) = out
    np.testing.assert_allclose(tc, jc, rtol=1e-4)
    _same_params(jp, tp, 1e-4)
    for k in jfeed:
        np.testing.assert_array_equal(tfeed[k], np.asarray(jfeed[k]))

    paddle, _, x, h = runs[1]
    with pytest.raises(TypeError):
        h + "nope"
    big = paddle.layer.fc(input=x, size=3)
    with pytest.raises(TypeError):
        h + big  # unequal sizes, neither is 1
    with pytest.raises(TypeError):
        h * big  # neither operand size-1


def test_v2_data_feeder_subset_and_noncontiguous_positions():
    """Samples may carry extra columns and feeding positions need not be
    contiguous: the feeder projects only the fed columns."""
    rng = np.random.RandomState(0)
    data = [(rng.rand(3).astype(np.float32), "meta-%d" % i, i % 4)
            for i in range(6)]
    feeds = []
    for _, paddle in PKGS:
        paddle.layer.data(name="img", type=paddle.data_type.dense_vector(3))
        paddle.layer.data(name="lbl", type=paddle.data_type.integer_value(4))
        feeder = paddle.DataFeeder(
            [("img", paddle.data_type.dense_vector(3)),
             ("lbl", paddle.data_type.integer_value(4))],
            {"img": 0, "lbl": 2})
        feed = feeder(data)
        assert np.asarray(feed["img"]).shape == (6, 3)
        assert np.asarray(feed["lbl"]).reshape(-1).tolist() == [
            0, 1, 2, 3, 0, 1]
        feeds.append(feed)
    for k in feeds[0]:
        np.testing.assert_array_equal(feeds[1][k], np.asarray(feeds[0][k]))


# -- the other JAX tests of v2 -------------------------------------------------

def _data_types(topo):
    return [(n, type(t).__name__, t.dim, t.seq) for n, t in topo.data_type()]


def test_v2_topology_and_master_client(tmp_path):
    topos = []
    for _, paddle in PKGS:
        img = paddle.layer.data(name="timg",
                                type=paddle.data_type.dense_vector(8))
        lbl = paddle.layer.data(name="tlbl",
                                type=paddle.data_type.integer_value(4))
        fc = paddle.layer.fc(input=img, size=4,
                             act=paddle.activation.Softmax())
        cost = paddle.layer.classification_cost(input=fc, label=lbl)
        topo = paddle.Topology(cost)
        blob = topo.proto()
        assert isinstance(blob, bytes) and len(blob) > 0
        assert {"timg", "tlbl"} <= set(dict(topo.data_type()))
        topos.append(topo)
    assert topos[1].proto() == topos[0].proto()
    assert _data_types(topos[1]) == _data_types(topos[0])

    from paddle_tpu_torch.distributed.master import (MasterServer,
                                                     MasterService)
    from paddle_tpu_torch.native.recordio import write_shards

    recs = [f"rec{i}".encode() for i in range(8)]
    write_shards(recs, str(tmp_path / "data"), num_shards=2)
    srv = MasterServer(MasterService(timeout_s=10.0)).start()
    try:
        host, port = srv.addr
        c = tpaddle.master.client(f"{host}:{port}", 30)
        c.set_dataset([str(tmp_path / "data-*")])
        for pass_id in range(2):  # the second pass re-dispenses everything
            c.paddle_start_get_records(pass_id)
            got = []
            while True:
                r, n = c.next_record()
                if r is None:
                    break
                assert n == len(r)
                got.append(r)
            assert sorted(got) == sorted(recs)
        assert c.request_save_model("t0", 60000) == 1
        assert c.request_save_model("t1", 60000) == 0
        c.release()
    finally:
        srv.stop()


def test_v2_ploter_collects_and_renders(tmp_path):
    import os

    from paddle_tpu_torch.v2.plot import Ploter

    p = Ploter("train", "test")
    for i in range(5):
        p.append("train", i, 1.0 / (i + 1))
        p.append("test", i, 2.0 / (i + 1))
    assert p.__plot_data__["train"].value[0] == 1.0
    out = p.plot(str(tmp_path / "curve.png"))
    if out is not None:  # matplotlib present
        assert os.path.getsize(out) > 0
    p.reset()
    assert p.__plot_data__["train"].step == []


NMT_VOCAB, BOS, EOS = 18, 0, 1


def _nmt_pairs(n, rng, lo=3, hi=7):
    src, tgt_in, tgt_out = [], [], []
    for _ in range(n):
        toks = rng.randint(2, NMT_VOCAB, rng.randint(lo, hi))
        rev = toks[::-1]
        src.append(toks.reshape(-1, 1).astype(np.int64))
        tgt_in.append(np.concatenate([[BOS], rev]).reshape(-1, 1)
                      .astype(np.int64))
        tgt_out.append(np.concatenate([rev, [EOS]]).reshape(-1, 1)
                       .astype(np.int64))
    return src, tgt_in, tgt_out


def _persistables(fluid):
    return [n for n, v in
            fluid.default_main_program().global_block().vars.items()
            if v.persistable]


def test_v2_sequence_generator():
    """SequenceGenerator (reference PaddleAPI.h SequenceGenerator:1025)
    over the attention NMT's beam search, after a few Adam steps from the
    JAX startup's state: ranked (score, tokens) per input, the port's
    equal to JAX's."""
    import importlib

    hyps = []
    state = None
    for fluid, paddle in PKGS:
        pkg = fluid.__name__
        LoD = importlib.import_module(f"{pkg}.lod").LoDTensor
        S2S = importlib.import_module(
            f"{pkg}.models.seq2seq").Seq2SeqAttention
        kw = dict(src_vocab=NMT_VOCAB, tgt_vocab=NMT_VOCAB, emb_dim=24,
                  hidden=32, attn=24, bos_id=BOS, eos_id=EOS)
        src = fluid.layers.sequence_data(name="src", shape=[1],
                                         dtype="int64")
        tgt = fluid.layers.sequence_data(name="tgt", shape=[1],
                                         dtype="int64")
        tgt_next = fluid.layers.sequence_data(name="tgt_next", shape=[1],
                                              dtype="int64")
        cost = S2S(**kw).train_cost(src, tgt, tgt_next)
        fluid.optimizer.Adam(learning_rate=0.01).minimize(cost)
        gen_prog = fluid.Program()
        with fluid.program_guard(gen_prog):
            g_src = fluid.layers.sequence_data(name="src", shape=[1],
                                               dtype="int64")
            ids, scores, lengths = S2S(**kw).generate(g_src, beam_size=4,
                                                      max_len=10)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(fluid.default_startup_program())
        if state is None:
            state = {n: np.array(fluid.global_scope().find_np(n))
                     for n in _persistables(fluid)}
        else:
            fluid.load_persistables(fluid.default_main_program(), state)
        rng = np.random.RandomState(3)
        src_seqs, tgt_in, tgt_out = _nmt_pairs(32, rng)
        for i in range(0, 32, 16):
            exe.run(feed={"src": LoD.from_sequences(src_seqs[i:i + 16]),
                          "tgt": LoD.from_sequences(tgt_in[i:i + 16]),
                          "tgt_next": LoD.from_sequences(tgt_out[i:i + 16])},
                    fetch_list=[cost])
        gen = paddle.SequenceGenerator(ids, scores, lengths,
                                       program=gen_prog, eos_id=EOS,
                                       place=fluid.CPUPlace())
        test_src, _, _ = _nmt_pairs(4, np.random.RandomState(7), lo=3, hi=5)
        out = gen({"src": LoD.from_sequences(test_src)}, top_k=3)
        assert len(out) == 4
        for row in out:
            assert 1 <= len(row) <= 3
            assert all(row[i][0] >= row[i + 1][0]
                       for i in range(len(row) - 1))
            for score, toks in row:
                assert np.isfinite(score)
                assert all(0 <= t < NMT_VOCAB for t in toks)
        hyps.append(out)
    jh, th = hyps
    assert [[toks for _, toks in row] for row in th] == \
        [[toks for _, toks in row] for row in jh]
    np.testing.assert_allclose([[s for s, _ in row] for row in th],
                               [[s for s, _ in row] for row in jh],
                               atol=1e-4)


def test_v1_beam_search_sequence_generator():
    """The v1 ``beam_search`` outputs handed to SequenceGenerator
    (``test_v1_layers_full.py`` ≈:476), the port against JAX from the
    JAX startup's state."""
    import importlib

    V, H, B, K, L = 7, 8, 2, 3, 5
    res = []
    state = None
    feed = {"bs_enc": np.random.RandomState(7).rand(B, H).astype(np.float32)}
    for fluid, paddle in PKGS:
        v1 = importlib.import_module(f"{fluid.__name__}.v1.layers")
        acts = importlib.import_module(f"{fluid.__name__}.v1.activations")
        enc = v1.data_layer("bs_enc", size=H)

        def rnn_step(static_enc, cur_word):
            prev = v1.memory(name="bs_dec", size=H)
            hid = v1.fc_layer([static_enc, cur_word, prev], size=H,
                              act=acts.TanhActivation(), name="bs_dec")
            return v1.fc_layer(hid, size=V, act=acts.SoftmaxActivation())

        gen_in = v1.GeneratedInput(size=V, embedding_name="bs_emb",
                                   embedding_size=4)
        out = v1.beam_search(step=rnn_step,
                             input=[v1.StaticInput(enc), gen_in],
                             bos_id=0, eos_id=1, beam_size=K, max_length=L)
        scores = v1.get_output_layer(out, "scores")
        lengths = v1.get_output_layer(out, "lengths")
        fluid.Executor(fluid.CPUPlace()).run(
            fluid.default_startup_program())
        if state is None:
            state = {n: np.array(fluid.global_scope().find_np(n))
                     for n in _persistables(fluid)}
        else:
            fluid.load_persistables(fluid.default_main_program(), state)
        gen = paddle.SequenceGenerator(out.var, scores.var, lengths.var,
                                       eos_id=1, place=fluid.CPUPlace())
        r = gen(feed)
        assert len(r) == B and all(len(row) <= K for row in r)
        res.append(r)
    t, j = _json()
    assert t == j
    assert [[toks for _, toks in row] for row in res[1]] == \
        [[toks for _, toks in row] for row in res[0]]
    np.testing.assert_allclose([[s for s, _ in row] for row in res[1]],
                               [[s for s, _ in row] for row in res[0]],
                               atol=1e-5)


# -- the v2 book's stacked-LSTM net --------------------------------------------

# |g| at which Adam's first sqrt(v) = sqrt(1 - beta2) |g| equals its
# epsilon (1e-8): an element whose gradient stays within 100 times this
# has an update that moves with 1e-8 differences of that gradient
ADAM_EPS_G = 1e-8 / np.sqrt(1 - 0.999)


def test_v2_sentiment_stacked_lstm_trains_as_in_jax():
    """understand_sentiment's ``stacked_lstm_net`` in the v2 idiom at dict
    64, emb 16, hid 32, 3 layers, batch 8: the same desc, the tar in both
    directions, three Adam iterations from ``reader.batch`` over the imdb
    reader: losses within 1e-4, every gradient of the first iteration (one
    state in both) within 1e-5 of its max |g|, the parameters after the
    three within 1e-4 of their max |value| (the elements whose gradient
    stayed under 100 x ``ADAM_EPS_G`` held by their step-1 gradient
    alone: the two packages' step-1 gradient of one fc bias element,
    3.5e-6, a sum that cancels, differ by 1.7e-8, and Adam's epsilon turns
    that into 1.3e-4 of the bias), ``infer`` within 1e-5 and ``Topology``
    types and proto bytes equal."""
    w = V2_SENTIMENT["small"]
    runs = []
    for fluid, paddle in PKGS:
        cost, output, opt = v2_sentiment_build(paddle, **w)
        tr = paddle.trainer.SGD(cost=cost, update_equation=opt,
                                place=fluid.CPUPlace())
        block = tr.program.global_block()
        tr.extra_layers = [block.var(n + "@GRAD")
                           for n in tr.parameters.names()]
        runs.append((fluid, paddle, tr, cost, output))
    t, j = _json()
    assert t == j
    assert [op.type for op in tfluid.default_main_program().global_block()
            .ops].count("lstm") == 3
    blob = _carry(runs[0][2], runs[1][2])
    # and the port's tar into JAX: the same values, bitwise
    runs[0][2].parameters.from_tar(io.BytesIO(_tar(runs[1][2].parameters)))
    assert _tar(runs[0][2].parameters) == blob
    out = []
    for fluid, paddle, tr, cost, output in runs:
        imdb = paddle.dataset.imdb

        def reader():
            for words, label in imdb.train(n=3 * w["bs"])():
                yield np.minimum(words, w["dict_size"] - 1), label

        grads = []

        def handler(e):
            if isinstance(e, paddle.event.EndIteration):
                grads.append((e.cost, e.metrics))

        tr.train(paddle.batch(reader, w["bs"]), event_handler=handler,
                 feeding={"word": 0, "label": 1})
        assert len(grads) == 3 and np.isfinite([c for c, _ in grads]).all()
        samples = [(s[0],) for s in list(reader())[:5]]
        kw = {"place": tfluid.CPUPlace()} if paddle is tpaddle else {}
        probs = paddle.infer(output_layer=output, parameters=tr.parameters,
                             input=samples, feeding={"word": 0}, **kw)
        assert probs.shape == (5, 2)
        out.append((grads, tr.parameters, probs, paddle.Topology(cost)))
    (jg, jp, jprob, jtopo), (tg, tp, tprob, ttopo) = out
    np.testing.assert_allclose([c for c, _ in tg], [c for c, _ in jg],
                               rtol=1e-4)
    for n in jp.names():
        g = [np.asarray(m[n + "@GRAD"]) for _, m in jg]
        assert _rel(tg[0][1][n + "@GRAD"], g[0]) <= 1e-5, n
        tv, jv = tp.get(n), jp.get(n)
        by_value = np.min([np.abs(x) for x in g], 0) >= 100 * ADAM_EPS_G
        err = np.abs(tv - jv)[by_value]
        assert err.size == 0 or err.max() <= 1e-4 * np.abs(jv).max(), n
    assert _rel(tprob, jprob) <= 1e-5
    assert _data_types(ttopo) == _data_types(jtopo) == [
        ("word", "_IntegerSeq", 1, True), ("label", "_Integer", 1, False)]
    assert ttopo.proto() == jtopo.proto()


# -- the package surface ---------------------------------------------------------

def test_v2_layer_names_match_jax():
    assert sorted(tpaddle.layer.__all__) == sorted(jpaddle.layer.__all__)
    assert sorted(tpaddle.evaluator.__all__) == \
        sorted(jpaddle.evaluator.__all__)
    assert sorted(tpaddle.op.__all__) == sorted(jpaddle.op.__all__)
    for mod in ("activation", "attr", "pooling", "data_type"):
        names = sorted(n for n in dir(getattr(jpaddle, mod))
                       if not n.startswith("_"))
        assert sorted(n for n in dir(getattr(tpaddle, mod))
                      if not n.startswith("_")) == names, mod


def test_v2_fluid_aliases_the_port_root():
    import sys

    import paddle_tpu_torch.v2.fluid as vfluid
    from paddle_tpu_torch.v2.fluid.layers import fc

    assert vfluid.layers is tfluid.layers and fc is tfluid.layers.fc
    assert sys.modules["paddle_tpu_torch.v2.fluid.core"] is \
        sys.modules["paddle_tpu_torch.framework.core"]
    assert vfluid.Executor is tfluid.Executor
    assert vfluid.Tensor is vfluid.LoDTensor
    assert not any(m == "paddle_tpu" or m.startswith("paddle_tpu.")
                   for m in (getattr(v, "__name__", "") for v in
                             vars(vfluid).values()))


def test_v2_init_is_a_no_op():
    assert tpaddle.init(use_gpu=False, trainer_count=4) is None


def test_parameters_bf16_tar_and_device():
    """A bfloat16 parameter goes into the tar as its bits under '<V2' and
    comes back to the bit, from the port's tar and from the JAX
    package's; ``set`` puts a value on the device of the program's
    values (the meta device stands in for the card here)."""
    import torch
    import ml_dtypes

    x = tfluid.layers.data(name="x", shape=[4], dtype="bfloat16")
    tfluid.layers.fc(input=x, size=3, bias_attr=False)
    tfluid.Executor(tfluid.CPUPlace()).run(tfluid.default_startup_program())
    params = tpaddle.Parameters()
    name = params.names()[0]
    w = tfluid.global_scope().find(name)
    assert w.dtype == torch.bfloat16
    blob = _tar(params)
    params.set(name, np.zeros((4, 3), np.float32))
    assert not tfluid.global_scope().find(name).any()
    params.from_tar(io.BytesIO(blob))
    assert torch.equal(tfluid.global_scope().find(name).view(torch.int16),
                       w.view(torch.int16))
    # the JAX package writes a bfloat16 value as '<V2' too
    jx = jfluid.layers.data(name="x", shape=[4], dtype="float32")
    jfluid.layers.fc(input=jx, size=3, bias_attr=False)
    jparams = jpaddle.Parameters()
    bits = np.random.RandomState(0).randint(-2 ** 14, 2 ** 14, (4, 3))
    jparams.set(jparams.names()[0],
                bits.astype(np.int16).view(ml_dtypes.bfloat16))
    params.from_tar(io.BytesIO(_tar(jparams)))
    got = tfluid.global_scope().find(name)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), bits)
    # the device where the program's values live
    for n in tfluid.default_main_program().global_block().vars:
        v = tfluid.global_scope().find(n)
        if v is not None:
            tfluid.global_scope().set(n, v.to("meta"))
    params.set(name, np.ones((4, 3), np.float32))
    assert tfluid.global_scope().find(name).device.type == "meta"
