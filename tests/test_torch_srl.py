"""The sequence-labelling slice against the JAX package on the CPU.

Programs are built by the same code through each package's public API;
the JAX startup's values are carried into the port by name (``_twin``);
feeds come from numpy seeds.  The JAX ``lstm`` and ``gru`` emitters take
their ``lax.scan`` path here, the port's wrappers the kernels' plain
versions.

- (a) The JAX book test's BiGRU + CRF (``tests/test_book_models.py``
  ``test_label_semantic_roles_crf``): ``to_json`` equal, 3 Adam steps
  from the carried weights with losses within 1e-5 relative, the step-1
  gradients within 1e-5 of their max |g|, the decoded paths equal.
- (b) The book's label_semantic_roles network (``srl_net``: six word
  lookups into one frozen ``emb`` table, predicate and mark embeddings,
  ``depth`` stacked LSTMs of alternating direction over mixed ``fc``
  sums, a linear-chain CRF with ``crfw``'s learning rate × 1e-3, Viterbi,
  ``chunk_eval`` into a ``ChunkEvaluator``, SGD on the exponential decay)
  at hidden_dim 32, depth 2 and a 200-word dict, with the book's LSTM
  activations (relu candidate, sigmoid cell: the plain loop) and with
  the kernels' (sigmoid/tanh/tanh): ``to_json`` equal, 3 steps from the
  synthetic conll05 reader with losses within 1e-5, every step-1
  gradient within 1e-5 of its max |g|, equal paths and per-batch chunk
  counts, equal ``ChunkEvaluator`` precision, recall and F1; the
  test-mode clone equal too; at a base learning rate of 1 one step moves
  every trainable parameter by its gradient and leaves ``emb`` as loaded,
  in both packages (neither applies ``crfw``'s learning-rate multiplier:
  ROADMAP.md Queue C).
- (c) The ``lstm_unit``-in-``StaticRNN`` sentiment model
  (``tests/test_sequence.py``): ``to_json`` equal and 3 Adam steps
  within 1e-5.
- (d) ``dataset.conll05``: the synthetic train and test samples, the
  embedding surrogate and the dict surrogates equal to JAX's; the
  real-corpus parser on a tarball and dict files the test writes,
  sample for sample equal to JAX's.
- The ``fluid_compat`` layers this slice adds (rank tables, array views,
  the IfElse routing, ``sequence_expand``, first and last steps,
  ``sequence_reshape``, ``cos_sim``, ``gru_unit``, ``l2_normalize``,
  ``array_length``, ``create_tensor``): the same program and the same
  values; ``Accuracy`` accumulates and resets as JAX's does."""

import gzip
import io
import math
import tarfile

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import lod as jlod
from paddle_tpu.dataset import common as jcommon
from paddle_tpu.dataset import conll05 as jconll05
from paddle_tpu_torch import lod as tlod
from paddle_tpu_torch.dataset import common as tcommon
from paddle_tpu_torch.dataset import conll05 as tconll05
from test_sequence import _sentiment_data

PKG = {"jax": (jfluid, jlod, jconll05), "port": (tfluid, tlod, tconll05)}
TOL = 1e-5
SLOTS = ("word_data", "ctx_n2_data", "ctx_n1_data", "ctx_0_data",
         "ctx_p1_data", "ctx_p2_data", "verb_data", "mark_data", "target")


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    jfluid.reset()
    yield


def _persistable(program):
    return [n for n, v in program.global_block().vars.items()
            if v.persistable]


def _max_rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _twin(build, init=None):
    """`build(pkg)` in both packages' fresh defaults; the JAX startup's
    values (after `init(jax scope)`) loaded into the port.  Returns
    (port result, JAX result, port executor, JAX executor)."""
    jfluid.reset()
    tfluid.reset()
    j_out = build("jax")
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    if init is not None:
        init(jfluid.global_scope())
    t_out = build("port")
    tfluid.load_persistables(
        tfluid.default_main_program(),
        {n: np.asarray(jfluid.global_scope().find_np(n))
         for n in _persistable(jfluid.default_main_program())})
    assert tfluid.default_main_program().to_json() == \
        jfluid.default_main_program().to_json()
    return t_out, j_out, tfluid.Executor(tfluid.CPUPlace()), jexe


def _steps(exe, fetch, feed, n):
    return [exe.run(feed=feed(), fetch_list=fetch) for _ in range(n)]


def _hold_steps(tag, t_rows, j_rows, n_grads, first=1):
    """Row k: [loss, *step-1 grads, *exact outputs]: losses within TOL
    relative, the grads of step 1 within TOL of their max |g|, the rest
    equal."""
    for k, (t, j) in enumerate(zip(t_rows, j_rows)):
        loss_rel = abs(float(t[0][0]) - float(j[0][0])) / abs(float(j[0][0]))
        assert loss_rel <= TOL, (tag, k, t[0], j[0])
        if k == 0:
            for g, (tg, jg) in enumerate(zip(t[first:first + n_grads],
                                             j[first:first + n_grads])):
                assert _max_rel(tg, jg) <= TOL, (tag, g, _max_rel(tg, jg))
        for e, (te, je) in enumerate(zip(t[first + n_grads:],
                                         j[first + n_grads:])):
            np.testing.assert_array_equal(te, je, err_msg=f"{tag} {k} {e}")


# -- (a) the JAX book test's GRU + CRF ----------------------------------------

VOCAB, NTAG, GRU_H = 64, 5, 32


def _book_crf(pkg):
    f = PKG[pkg][0]
    L = f.layers
    words = L.sequence_data(name="words", shape=[1], dtype="int64")
    tags = L.sequence_data(name="tags", shape=[1], dtype="int64")
    emb = L.sequence_embedding(words, size=[VOCAB, 16])
    proj = L.sequence_fc(emb, size=3 * GRU_H)
    gru = L.dynamic_gru(proj, size=GRU_H)
    emission = L.sequence_fc(gru, size=NTAG)
    nll = L.linear_chain_crf(emission, tags)
    cost = L.mean(nll)
    decoded = L.crf_decoding(emission, nll._crf_transition)
    f.optimizer.Adam(learning_rate=0.02).minimize(cost)
    return cost, decoded


def _book_feed(pkg):
    lod = PKG[pkg][1]
    rng = np.random.RandomState(0)
    seqs, tag_seqs = [], []
    for _ in range(16):
        ln = rng.randint(1, 9)
        toks = rng.randint(0, VOCAB, ln)
        seqs.append(toks.reshape(-1, 1).astype(np.int64))
        tag_seqs.append((toks % NTAG).reshape(-1, 1).astype(np.int64))
    return {"words": lod.LoDTensor.from_sequences(seqs),
            "tags": lod.LoDTensor.from_sequences(tag_seqs)}


def test_book_gru_crf_trains_and_decodes_as_jax():
    (tc, td), (jc, jd), texe, jexe = _twin(_book_crf)
    params = [p.name for p in
              tfluid.default_main_program().global_block().all_parameters()]
    grads = [p + "@GRAD" for p in params]
    t_rows = _steps(texe, [tc] + grads + [td],
                    lambda: _book_feed("port"), 3)
    j_rows = _steps(jexe, [jc] + grads + [jd],
                    lambda: _book_feed("jax"), 3)
    _hold_steps("book_crf", t_rows, j_rows, len(grads))
    assert "linear_chain_crf_0.w_0@GRAD" in grads


# -- (b) label_semantic_roles -------------------------------------------------

SMALL = {"word_dict_len": 200, "hidden_dim": 32, "depth": 2}
KERNEL_ACTS = {"candidate_activation": "tanh",
               "gate_activation": "sigmoid", "cell_activation": "tanh"}
BOOK_ACTS = {"candidate_activation": "relu",
             "gate_activation": "sigmoid", "cell_activation": "sigmoid"}
MIX_HIDDEN_LR = 1e-3


def srl_net(f, word_dict_len, hidden_dim, depth, acts, label_dict_len=59,
            pred_len=3162, word_dim=32, mark_dim=5, lr=None):
    """The book's db_lstm + CRF + Viterbi + chunk_eval (PaddlePaddle
    v0.11 ``fluid/tests/book/test_label_semantic_roles.py``) through
    `f`'s layers; SGD on exponential_decay(1e-4, 100000, 0.5, staircase)
    unless a constant `lr` is given.  The ChunkEvaluator and the
    test-mode clone (loss, path, chunk counts) come before minimize."""
    L = f.layers
    data = {n: L.sequence_data(name=n, shape=[1], dtype="int64")
            for n in SLOTS}
    embs = [L.sequence_embedding(
        data[n], size=[word_dict_len, word_dim],
        param_attr=f.ParamAttr(name="emb", trainable=False))
        for n in SLOTS[:6]]
    embs.append(L.sequence_embedding(data["verb_data"],
                                     size=[pred_len, word_dim],
                                     param_attr=f.ParamAttr(name="vemb")))
    embs.append(L.sequence_embedding(data["mark_data"], size=[2, mark_dim]))

    def mix(inputs, size):
        fcs = [L.sequence_fc(x, size) for x in inputs]
        return L.propagate_length(fcs[0], L.sums(fcs))

    hidden_0 = mix(embs, hidden_dim)
    lstm_0, _ = L.dynamic_lstm(hidden_0, size=hidden_dim, **acts)
    input_tmp = [hidden_0, lstm_0]
    for i in range(1, depth):
        mix_hidden = mix(input_tmp, hidden_dim)
        lstm, _ = L.dynamic_lstm(mix_hidden, size=hidden_dim,
                                 is_reverse=(i % 2) == 1, **acts)
        input_tmp = [mix_hidden, lstm]
    feature_out = mix(input_tmp, label_dict_len)
    crf_cost = L.linear_chain_crf(
        feature_out, data["target"],
        param_attr=f.ParamAttr(name="crfw", learning_rate=MIX_HIDDEN_LR))
    avg_cost = L.mean(crf_cost)
    decode = L.crf_decoding(feature_out, crf_cost._crf_transition)
    chunk = L.chunk_eval(decode, data["target"], chunk_scheme="IOB",
                         num_chunk_types=int(math.ceil(
                             (label_dict_len - 1) / 2.0)))
    evaluator = f.evaluator.ChunkEvaluator(*chunk[3:])
    test = f.default_main_program().clone(for_test=True)
    rate = lr if lr is not None else f.learning_rate_decay.exponential_decay(
        learning_rate=0.0001, decay_steps=100000, decay_rate=0.5,
        staircase=True)
    f.optimizer.SGD(learning_rate=rate).minimize(avg_cost)
    return {"cost": avg_cost, "decode": decode, "chunk": chunk,
            "evaluator": evaluator, "test": test}


def srl_feed(pkg, bs, word_dict_len, pred_len=3162, seed=0):
    """`bs` samples of the synthetic conll05 reader, ids folded into the
    dicts, as one LoDTensor a slot; the labels as [len] sequences, which
    the JAX ``chunk_eval`` takes beside a [B, T] path (ROADMAP.md Queue
    C)."""
    lod, conll = PKG[pkg][1], PKG[pkg][2]
    samples = conll._synthetic(bs, seed)
    mods = [word_dict_len] * 6 + [pred_len, 2]
    feed = {n: lod.LoDTensor.from_sequences(
        [(s[k] % m).reshape(-1, 1) for s in samples])
        for k, (n, m) in enumerate(zip(SLOTS, mods))}
    feed["target"] = lod.LoDTensor.from_sequences([s[8] for s in samples])
    return feed


def _load_emb(dict_len):
    def init(scope):
        scope.set("emb", jconll05.get_embedding()[:dict_len])
    return init


@pytest.mark.parametrize("acts", ["kernel", "book"])
def test_srl_trains_decodes_and_evaluates_as_jax(acts):
    a = KERNEL_ACTS if acts == "kernel" else BOOK_ACTS
    n = SMALL["word_dict_len"]
    t, j, texe, jexe = _twin(lambda p: srl_net(PKG[p][0], acts=a, **SMALL),
                             init=_load_emb(n))
    for pkg, exe, net in (("port", texe, t), ("jax", jexe, j)):
        net["test_rows"] = exe.run(
            net["test"], feed=srl_feed(pkg, 6, n, seed=1),
            fetch_list=[net["cost"], net["decode"], *net["chunk"][3:]])
    _hold_steps("srl_test_mode", [t["test_rows"]], [j["test_rows"]], 0)
    for net in (t, j):  # the test run counted chunks too
        net["evaluator"].reset(None)
    params = sorted(p.name for p in tfluid.default_main_program()
                    .global_block().all_parameters() if p.trainable)
    assert "emb" not in params and "crfw" in params
    grads = [p + "@GRAD" for p in params]
    rows = {}
    for pkg, exe, net in (("port", texe, t), ("jax", jexe, j)):
        rows[pkg] = _steps(exe, [net["cost"]] + grads
                           + [net["decode"], *net["chunk"][3:]],
                           lambda: srl_feed(pkg, 8, n), 3)
    _hold_steps(f"srl_{acts}", rows["port"], rows["jax"], len(grads))
    t_eval, j_eval = t["evaluator"].eval(), j["evaluator"].eval()
    assert t_eval == j_eval, (t_eval, j_eval)
    assert int(tfluid.global_scope().find_np(
        t["evaluator"].num_label.name)[0]) > 0
    np.testing.assert_array_equal(tfluid.global_scope().find_np("emb"),
                                  jconll05.get_embedding()[:n])


def test_srl_parameter_attributes_reach_the_optimizer_as_in_jax():
    """One SGD step at a constant base rate of 1: emb (trainable=False)
    gets no gradient and stays as loaded; every trainable parameter,
    crfw included, moves by the base rate times its gradient in both
    packages.  Neither optimizer applies ParamAttr's learning_rate (crfw's
    1e-3), which the reference's does (ROADMAP.md Queue C)."""
    n = SMALL["word_dict_len"]
    t, j, texe, jexe = _twin(
        lambda p: srl_net(PKG[p][0], acts=KERNEL_ACTS, lr=1.0, **SMALL),
        init=_load_emb(n))
    block = tfluid.default_main_program().global_block()
    params = sorted(p.name for p in block.all_parameters() if p.trainable)
    assert "emb@GRAD" not in block.vars
    assert block.var("crfw").optimize_attr == {"learning_rate": 1e-3}
    for pkg, exe, net, f in (("port", texe, t, tfluid),
                             ("jax", jexe, j, jfluid)):
        scope = f.global_scope()
        before = {p: np.array(scope.find_np(p), np.float64)
                  for p in params + ["emb"]}
        row = exe.run(feed=srl_feed(pkg, 8, n),
                      fetch_list=[p + "@GRAD" for p in params])
        net["moved"] = {}
        for p, g in zip(params, row):
            moved = before[p] - np.asarray(scope.find_np(p), np.float64)
            assert _max_rel(moved, g) <= 1e-3, (pkg, p, _max_rel(moved, g))
            net["moved"][p] = moved
        np.testing.assert_array_equal(scope.find_np("emb"), before["emb"])
    for p in params:
        assert _max_rel(t["moved"][p], j["moved"][p]) <= 1e-3, p


# -- (c) lstm_unit in a StaticRNN ---------------------------------------------

def _static_lstm_unit(pkg):
    f = PKG[pkg][0]
    L = f.layers
    H = 24
    words = L.sequence_data(name="words", shape=[1], dtype="int64")
    label = L.data(name="label", shape=[1], dtype="int64")
    emb = L.sequence_embedding(words, size=[100, 16])
    lengths = L.get_length_var(emb)
    rnn = L.StaticRNN(lengths=lengths)
    with rnn.step():
        x_t = rnn.step_input(emb)
        h_prev = rnn.memory(shape=[H], batch_ref=emb)
        c_prev = rnn.memory(shape=[H], batch_ref=emb)
        h, c = L.lstm_unit(x_t, h_prev, c_prev, forget_bias=1.0)
        rnn.update_memory(h_prev, h)
        rnn.update_memory(c_prev, c)
        rnn.step_output(h)
    hidden = rnn()
    L.propagate_length(emb, hidden)
    pooled = L.sequence_pool(hidden, pool_type="last")
    logits = L.fc(input=pooled, size=2)
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    f.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return loss


def test_static_rnn_lstm_unit_sentiment_trains_as_jax():
    tl, jl, texe, jexe = _twin(_static_lstm_unit)
    seqs, labels = _sentiment_data(24)
    rows = {}
    for pkg, exe, loss in (("port", texe, tl), ("jax", jexe, jl)):
        lod = PKG[pkg][1]
        rows[pkg] = _steps(exe, [loss], lambda: {
            "words": lod.LoDTensor.from_sequences(seqs), "label": labels}, 3)
    _hold_steps("static_lstm_unit", rows["port"], rows["jax"], 0)


# -- (d) conll05 --------------------------------------------------------------

def test_conll05_synthetic_samples_and_surrogates_equal_jax():
    for reader in ("train", "test"):
        t = list(getattr(tconll05, reader)(n=24)())
        j = list(getattr(jconll05, reader)(n=24)())
        assert tcommon.data_mode("conll05") == "synthetic"
        assert len(t) == len(j) == 24
        for ts, js in zip(t, j):
            assert len(ts) == 9
            for a, b in zip(ts, js):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tconll05.get_embedding(),
                                  jconll05.get_embedding())
    assert [len(d) for d in tconll05.get_dict()] == \
        [len(d) for d in jconll05.get_dict()] == [44068, 3162, 59]
    assert (tconll05.WORD_DICT_LEN, tconll05.LABEL_DICT_LEN,
            tconll05.PRED_DICT_LEN) == (44068, 59, 3162)
    assert tconll05.brackets_to_iob(["(A0*", "*", "*)", "(V*)", "*"]) == \
        ["B-A0", "I-A0", "I-A0", "B-V", "O"]


def _write_corpus(d, module):
    """Two sentences, the first with two predicates, and the three dict
    files; returns the md5s to pin."""
    words = "The\ncat\nchased\nmice\nand\nfled\n\nDogs\nbark\n\n"
    props = ("-\t(A0*\t*\n-\t*)\t(A0*)\nchase\t(V*)\t*\n-\t(A1*)\t*\n"
             "-\t*\t*\nflee\t*\t(V*)\n\n-\t(A0*)\nbark\t(V*)\n\n")
    blobs = []
    for text in (words, props):
        buf = io.BytesIO()
        with gzip.GzipFile(fileobj=buf, mode="wb") as f:
            f.write(text.encode())
        blobs.append(buf.getvalue())
    tar_path = d / "conll05st-tests.tar.gz"
    with tarfile.open(tar_path, "w:gz") as tf:
        for name, blob in zip((module.WORDS_MEMBER, module.PROPS_MEMBER),
                              blobs):
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))
    (d / "wordDict.txt").write_text("\n".join(
        ["<unk>", "The", "cat", "chased", "mice", "and", "fled", "Dogs",
         "bark", "bos", "eos"]) + "\n")
    (d / "verbDict.txt").write_text("<unk>\nchase\nflee\nbark\n")
    (d / "targetDict.txt").write_text(
        "O\nB-A0\nI-A0\nB-A1\nI-A1\nB-V\nI-V\n")
    return {"DATA_MD5": tar_path, "WORDDICT_MD5": d / "wordDict.txt",
            "VERBDICT_MD5": d / "verbDict.txt",
            "TRGDICT_MD5": d / "targetDict.txt"}


def test_conll05_parses_a_real_corpus_as_jax(tmp_path, monkeypatch):
    d = tmp_path / "conll05"
    d.mkdir()
    pins = _write_corpus(d, tconll05)
    for common, module in ((tcommon, tconll05), (jcommon, jconll05)):
        monkeypatch.setattr(common, "DATA_HOME", str(tmp_path))
        for attr, path in pins.items():
            monkeypatch.setattr(module, attr, common.md5file(str(path)))
    jconll05._dicts_cache.clear()
    t = list(tconll05.test()())
    assert tcommon.data_mode("conll05") == "real"
    j = list(jconll05.test()())
    assert jcommon.data_mode("conll05") == "real"
    assert len(t) == len(j) == 3
    for ts, js in zip(t, j):
        for a, b in zip(ts, js):
            np.testing.assert_array_equal(a, b)
    words, *_, mark, labels = t[0]
    assert words.tolist() == [1, 2, 3, 4, 5, 6]
    assert mark.tolist() == [1, 1, 1, 1, 1, 0]
    assert labels.tolist() == [1, 2, 5, 3, 0, 0]
    assert [len(x) for x in tconll05.get_dict()] == [11, 4, 7]
    jconll05._dicts_cache.clear()


# -- fluid_compat, Accuracy ---------------------------------------------------

def _compat(pkg):
    f = PKG[pkg][0]
    L = f.layers
    s = L.sequence_data("s", shape=[4], dtype="float32")
    x = L.data("x", shape=[4], dtype="float32")
    flag = L.data("flag", shape=[1], dtype="bool")
    table = L.lod_rank_table(s)
    outs = [table, L.max_sequence_len(table),
            L.reorder_lod_tensor_by_rank(s, table)]
    arr = L.lod_tensor_to_array(s, table)
    outs += [arr, L.array_to_lod_tensor(L.shrink_memory(arr, None, table),
                                        table), L.array_length(arr)]
    t, e = L.split_lod_tensor(x, flag)
    outs += [t, e, L.merge_lod_tensor(L.scale(t, scale=2.0), e, x, flag)]
    outs += [L.sequence_expand(x, s), L.sequence_first_step(s),
             L.sequence_last_step(s), L.sequence_reshape(s, 2),
             L.cos_sim(x, L.scale(x, scale=-0.5, bias=1.0)),
             L.l2_normalize(x, axis=1)]
    h, r, g = L.gru_unit(L.fc(x, size=12), x, size=12)
    outs += [h, r, g]
    L.create_tensor("float32", name="made")
    return outs


def test_fluid_compat_layers_build_and_compute_as_jax():
    rng = np.random.RandomState(7)
    seqs = [rng.uniform(-1, 1, (n, 4)).astype(np.float32)
            for n in (2, 4, 1, 4)]
    x = rng.uniform(-1, 1, (4, 4)).astype(np.float32)
    flag = np.array([[True], [False], [False], [True]])
    t_outs, j_outs, texe, jexe = _twin(_compat)
    got = {}
    for pkg, exe, outs in (("port", texe, t_outs), ("jax", jexe, j_outs)):
        lod = PKG[pkg][1]
        got[pkg] = exe.run(feed={"s": lod.LoDTensor.from_sequences(seqs),
                                 "x": x, "flag": flag}, fetch_list=outs)
    for k, (a, b) in enumerate(zip(got["port"], got["jax"])):
        assert a.shape == b.shape, (k, a.shape, b.shape)
        if np.asarray(b).dtype.kind in "iub":
            np.testing.assert_array_equal(a, b, err_msg=str(k))
        else:
            assert _max_rel(a, b) <= TOL, (k, _max_rel(a, b))
    np.testing.assert_array_equal(got["port"][0], [1, 3, 0, 2])
    assert tfluid.layers.get_places(2, "cpu") == [tfluid.CPUPlace()] * 2


def _accuracy(pkg):
    f = PKG[pkg][0]
    x = f.layers.data("x", shape=[5], dtype="float32")
    label = f.layers.data("label", shape=[1], dtype="int64")
    return f.evaluator.Accuracy(f.layers.softmax(x), label, k=2)


def test_accuracy_evaluator_accumulates_and_resets_as_jax():
    t, j, texe, jexe = _twin(_accuracy)
    rng = np.random.RandomState(3)
    feeds = [{"x": rng.randn(6, 5).astype(np.float32),
              "label": rng.randint(0, 5, (6, 1)).astype(np.int64)}
             for _ in range(3)]
    for ev, exe in ((t, texe), (j, jexe)):
        for feed in feeds:
            exe.run(feed=feed, fetch_list=[ev.batch_acc])
    assert t.eval() == j.eval()
    assert 0.0 < t.eval() < 1.0
    t.reset(texe)
    texe.run(feed=feeds[0], fetch_list=[t.batch_acc])
    (want,) = texe.run(feed=feeds[0], fetch_list=[t.batch_acc])
    assert t.eval() == pytest.approx(float(want[0]))
