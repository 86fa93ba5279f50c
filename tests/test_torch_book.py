"""The book's fit_a_line and recognize_digits on the port's CPU executor,
with the thresholds of ``tests/test_fit_a_line.py`` and
``tests/test_recognize_digits.py``, and 3 steps of each program against
the JAX package.

- fit_a_line on ``dataset.uci_housing`` in synthetic mode (an empty
  ``DATA_HOME``): SGD to a loss under 0.1; and on sklearn's diabetes
  table (a real regression table bundled here) under 0.05.
- recognize_digits, the MLP and the conv net (``nets.simple_img_conv_pool``
  twice, ``cross_entropy``), on ``dataset.mnist`` in real mode: the
  provenance-marked sliver of real digits that
  ``fixtures.dataset_fixtures.make_mnist_sliver`` writes into an isolated
  ``DATA_HOME``; accuracy over 0.9.  The batch-norm program trains and its
  ``clone(for_test=True)`` evaluates.
- Parity: each program built in both packages through the public API,
  the JAX startup's values carried into the port by name, 3 steps on the
  same batches: per-step losses within 1e-5 relative, every persistable
  within 1e-5 of its largest |value| (the conv bias before the batch
  norm has a zero gradient but for rounding, so its values are rounding
  noise: both packages' stay under 1e-5); the two Adam nets within 1e-4: an
  Adam step of lr 0.01 turns 1e-7 differences in tiny gradients into
  1e-5 of a weight.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from fixtures.dataset_fixtures import make_mnist_sliver
from paddle_tpu.dataset import common as jcommon
from paddle_tpu.dataset import mnist as jmnist
from paddle_tpu_torch.dataset import common as tcommon
from paddle_tpu_torch.dataset import mnist as tmnist
from paddle_tpu_torch.dataset import uci_housing as tuci


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    yield


@pytest.fixture(scope="session")
def _sliver_home(tmp_path_factory):
    home = tmp_path_factory.mktemp("mnist_real_port")
    make_mnist_sliver(str(home))
    return str(home)


@pytest.fixture
def real_mnist(_sliver_home, monkeypatch):
    for common in (tcommon, jcommon):
        monkeypatch.setattr(common, "DATA_HOME", _sliver_home)
        common.DATA_MODE.pop("mnist", None)


@pytest.fixture
def empty_data_home(tmp_path, monkeypatch):
    monkeypatch.setattr(tcommon, "DATA_HOME", str(tmp_path))
    tcommon.DATA_MODE.pop("uci_housing", None)


# -- fit_a_line -----------------------------------------------------------------

def _fit_a_line(f, n_features=13, lr=0.05):
    x = f.layers.data(name="x", shape=[n_features], dtype="float32")
    y = f.layers.data(name="y", shape=[1], dtype="float32")
    y_predict = f.layers.fc(input=x, size=1, act=None)
    cost = f.layers.square_error_cost(input=y_predict, label=y)
    avg_cost = f.layers.mean(cost)
    f.optimizer.SGD(learning_rate=lr).minimize(avg_cost)
    return avg_cost


def _housing(n=512):
    samples = list(tuci.train(n=n)())
    x = np.stack([s[0] for s in samples]).astype(np.float32)
    y = np.stack([s[1] for s in samples]).astype(np.float32).reshape(-1, 1)
    return x, y / max(1.0, float(np.abs(y).max()))


def _train_regression(avg_cost, xs, ys, epochs, bs=64):
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    losses = []
    for _ in range(epochs):
        for i in range(0, len(xs), bs):
            (loss,) = exe.run(feed={"x": xs[i:i + bs], "y": ys[i:i + bs]},
                              fetch_list=[avg_cost])
        losses.append(float(loss[0]))
    return losses


def test_fit_a_line(empty_data_home):
    avg_cost = _fit_a_line(tfluid)
    xs, ys = _housing()
    assert tcommon.data_mode("uci_housing") == "synthetic"
    losses = _train_regression(avg_cost, xs, ys, epochs=30)
    assert losses[-1] < 0.1, f"did not converge: {losses[::5]}"
    assert losses[-1] < losses[0]


def test_synthetic_housing_equals_jax(empty_data_home, tmp_path,
                                      monkeypatch):
    from paddle_tpu.dataset import uci_housing as juci

    monkeypatch.setattr(jcommon, "DATA_HOME", str(tmp_path))
    for split in ("train", "test"):
        t = list(getattr(tuci, split)()())
        j = list(getattr(juci, split)()())
        assert len(t) == len(j)
        for (tx, ty), (jx, jy) in zip(t, j):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)


def test_fit_a_line_real_table():
    """sklearn's diabetes corpus (442 real records, 10 features), as
    ``tests/test_fit_a_line.py`` trains it."""
    sklearn_datasets = pytest.importorskip("sklearn.datasets")
    d = sklearn_datasets.load_diabetes()
    xs = d.data.astype(np.float32)
    ys = (d.target / d.target.max()).astype(np.float32).reshape(-1, 1)
    avg_cost = _fit_a_line(tfluid, n_features=10, lr=0.1)
    losses = _train_regression(avg_cost, xs, ys, epochs=60)
    assert losses[-1] < 0.05, f"did not converge: {losses[::10]}"
    assert losses[-1] < losses[0]


# -- recognize_digits ---------------------------------------------------------------

def _digits(mnist, common, n=512, expect_mode="real"):
    xs, ys = [], []
    for x, y in mnist.train(n=n)():
        xs.append(np.asarray(x, dtype=np.float32).reshape(1, 28, 28))
        ys.append(y)
        if len(xs) >= n:
            break
    assert common.data_mode("mnist") == expect_mode
    return np.stack(xs), np.asarray(ys, dtype=np.int64).reshape(-1, 1)


def _mlp_net(f):
    img = f.layers.data(name="img", shape=[1, 28, 28], dtype="float32")
    label = f.layers.data(name="label", shape=[1], dtype="int64")
    flat = f.layers.reshape(img, [-1, 784])
    h1 = f.layers.fc(input=flat, size=64, act="relu")
    h2 = f.layers.fc(input=h1, size=64, act="relu")
    logits = f.layers.fc(input=h2, size=10)
    loss = f.layers.softmax_with_cross_entropy(logits, label)
    avg_cost = f.layers.mean(loss)
    prob = f.layers.softmax(logits)
    acc = f.layers.accuracy(input=prob, label=label)
    f.optimizer.Adam(learning_rate=0.01).minimize(avg_cost)
    return avg_cost, acc


def _conv_net(f):
    img = f.layers.data(name="img", shape=[1, 28, 28], dtype="float32")
    label = f.layers.data(name="label", shape=[1], dtype="int64")
    c1 = f.nets.simple_img_conv_pool(
        input=img, filter_size=5, num_filters=8, pool_size=2, pool_stride=2,
        act="relu")
    c2 = f.nets.simple_img_conv_pool(
        input=c1, filter_size=5, num_filters=16, pool_size=2, pool_stride=2,
        act="relu")
    logits = f.layers.fc(input=c2, size=10, num_flatten_dims=1)
    prob = f.layers.softmax(logits)
    loss = f.layers.cross_entropy(input=prob, label=label)
    avg_cost = f.layers.mean(loss)
    acc = f.layers.accuracy(input=prob, label=label)
    f.optimizer.Adam(learning_rate=0.01).minimize(avg_cost)
    return avg_cost, acc


def _bn_net(f):
    img = f.layers.data(name="img", shape=[1, 28, 28], dtype="float32")
    label = f.layers.data(name="label", shape=[1], dtype="int64")
    conv = f.layers.conv2d(input=img, num_filters=4, filter_size=3)
    bn = f.layers.batch_norm(input=conv, act="relu")
    logits = f.layers.fc(input=bn, size=10)
    loss = f.layers.softmax_with_cross_entropy(logits, label)
    avg_cost = f.layers.mean(loss)
    test_program = f.default_main_program().clone(for_test=True)
    f.optimizer.SGD(learning_rate=0.05).minimize(avg_cost)
    return avg_cost, test_program


def _train_digits(avg_cost, acc, epochs, bs=64):
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    xs, ys = _digits(tmnist, tcommon)
    accs = []
    for _ in range(epochs):
        for i in range(0, len(xs), bs):
            out = exe.run(feed={"img": xs[i:i + bs], "label": ys[i:i + bs]},
                          fetch_list=[avg_cost, acc])
        accs.append(float(out[1][0]))
    return accs


def test_recognize_digits_mlp(real_mnist):
    avg_cost, acc = _mlp_net(tfluid)
    accs = _train_digits(avg_cost, acc, epochs=6)
    assert accs[-1] > 0.9, f"accuracy too low: {accs}"


def test_recognize_digits_conv(real_mnist):
    avg_cost, acc = _conv_net(tfluid)
    accs = _train_digits(avg_cost, acc, epochs=4)
    assert accs[-1] > 0.9, f"accuracy too low: {accs}"


def test_batch_norm_training_and_eval(real_mnist):
    avg_cost, test_program = _bn_net(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    xs, ys = _digits(tmnist, tcommon, 128)
    scope = tfluid.global_scope()
    for _ in range(8):
        exe.run(feed={"img": xs[:64], "label": ys[:64]},
                fetch_list=[avg_cost])
    bn_stats = [n for n, v in tfluid.default_main_program().global_block()
                .vars.items() if v.persistable and "batch_norm" in n
                and "global" in n]
    assert len(bn_stats) == 2, bn_stats
    assert any(not np.allclose(scope.find_np(n), 0.0)
               and not np.allclose(scope.find_np(n), 1.0) for n in bn_stats)
    assert not any(op.type == "generic_grad"
                   for op in test_program.global_block().ops)
    (test_loss,) = exe.run(test_program,
                           feed={"img": xs[64:], "label": ys[64:]},
                           fetch_list=[avg_cost])
    assert np.isfinite(test_loss).all()


def test_mnist_sliver_reads_as_jax(real_mnist):
    t = _digits(tmnist, tcommon, 64)
    j = _digits(jmnist, jcommon, 64)
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[1], j[1])
    assert tcommon.data_provenance("mnist") == jcommon.data_provenance(
        "mnist") != ""


def test_offline_mnist_without_files_is_synthetic(empty_data_home):
    _digits(tmnist, tcommon, 16, expect_mode="synthetic")


# -- three steps against JAX ------------------------------------------------------------

def _persistable(program):
    return [n for n, v in program.global_block().vars.items()
            if v.persistable]


def _rel(t, j):
    j = np.asarray(j, np.float64)
    return float(np.abs(np.asarray(t, np.float64) - j).max()
                 / max(float(np.abs(j).max()), 1e-30))


def _parity(build, feeds, tol=1e-5, noise=()):
    jfluid.reset()
    tfluid.reset()
    jloss = build(jfluid)[0]
    jmain = jfluid.default_main_program()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    names = _persistable(jmain)
    tloss = build(tfluid)[0]
    tmain = tfluid.default_main_program()
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    tfluid.load_persistables(
        tmain, {n: jfluid.global_scope().find_np(n) for n in names})
    texe = tfluid.Executor(tfluid.CPUPlace())
    jl = [float(np.asarray(jexe.run(jmain, feed=f, fetch_list=[jloss])[0])
                [0]) for f in feeds]
    tl = [float(texe.run(tmain, feed=f, fetch_list=[tloss])[0][0])
          for f in feeds]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for n in names:
        t = tfluid.global_scope().find_np(n)
        j = jfluid.global_scope().find_np(n)
        if n in noise:
            assert np.abs(t).max() < 1e-5 and np.abs(j).max() < 1e-5, n
            continue
        assert _rel(t, j) <= tol, (n, _rel(t, j))


def _digit_feeds(n=3, bs=32):
    xs, ys = _digits(tmnist, tcommon, n * bs)
    return [{"img": xs[i * bs:(i + 1) * bs], "label": ys[i * bs:(i + 1) * bs]}
            for i in range(n)]


def test_fit_a_line_three_steps_match_jax(empty_data_home):
    xs, ys = _housing(96)
    feeds = [{"x": xs[i:i + 32], "y": ys[i:i + 32]} for i in (0, 32, 64)]
    _parity(lambda f: (_fit_a_line(f),), feeds)


@pytest.mark.parametrize("net,tol", [("mlp", 1e-4), ("conv", 1e-4),
                                     ("batch_norm", 1e-5)])
def test_recognize_digits_three_steps_match_jax(real_mnist, net, tol):
    build = {"mlp": _mlp_net, "conv": _conv_net, "batch_norm": _bn_net}[net]
    _parity(build, _digit_feeds(), tol,
            noise=("conv2d_0.b_0",) if net == "batch_norm" else ())
