"""The port's RecordIO data plane (``paddle_tpu_torch/native/recordio.py``
and ``recordio.cc``, ``reader.creator.recordio``, ``dataset.common.convert``
and ``recordio_task_loader``, the nine dataset ``convert``s) on the CPU,
held against the JAX package: the cases of ``tests/test_recordio.py`` in
the port, files of either package and either codec equal byte for byte
and read by both, a corrupt chunk raising in both, no fall-back to the
Python codec when the library cannot be built, and each ``convert``
giving JAX's samples in JAX's order in as many shards."""

import os
import pickle

import numpy as np
import pytest

import paddle_tpu_torch as tfluid
from paddle_tpu.dataset import common as jcommon
from paddle_tpu.native import recordio as jrecordio
from paddle_tpu_torch.dataset import common as tcommon
from paddle_tpu_torch.native import recordio

CONVERTS = ("uci_housing", "conll05", "imdb", "movielens", "wmt14", "mnist",
            "imikolov", "sentiment", "cifar")


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    for common in (tcommon, jcommon):
        monkeypatch.setattr(common, "DATA_HOME", str(tmp_path / "data"))
    tfluid.reset()
    yield


def _samples(n=100):
    rng = np.random.RandomState(0)
    return [pickle.dumps((rng.rand(4).tolist(), int(i % 7)))
            for i in range(n)]


def _write(mod, path, records, use_native, chunk_bytes=256):
    with mod.Writer(path, chunk_bytes=chunk_bytes,
                    use_native=use_native) as w:
        for r in records:
            w.write(r)
    with open(path, "rb") as f:
        return f.read()


def _corrupt(path, at=20):
    with open(path, "r+b") as f:
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ 0xFF]))


# -- tests/test_recordio.py, in the port -------------------------------------

def test_native_lib_builds():
    path = recordio.build_lib()
    assert recordio.native_available()
    # built under the package's _build/, named by a hash of its source
    # and command, never beside its source
    assert os.path.dirname(path) == os.path.join(
        os.path.dirname(os.path.dirname(recordio.__file__)), "_build")
    assert os.path.basename(path).startswith("librecordio_")
    assert not [f for f in os.listdir(os.path.dirname(recordio.__file__))
                if f.endswith(".so")]


def test_roundtrip_native(tmp_path):
    p = str(tmp_path / "data.rio")
    samples = _samples()
    _write(recordio, p, samples, True, chunk_bytes=512)
    assert list(recordio.read_records(p, use_native=True)) == samples


def test_cross_interop_python_and_native(tmp_path):
    """Files written by C++ read back via pure Python and vice versa."""
    samples = _samples(50)
    p1 = str(tmp_path / "native.rio")
    _write(recordio, p1, samples, True)
    assert list(recordio.read_records(p1, use_native=False)) == samples
    p2 = str(tmp_path / "py.rio")
    _write(recordio, p2, samples, False)
    assert list(recordio.read_records(p2, use_native=True)) == samples


def test_crc_corruption_detected(tmp_path):
    p = str(tmp_path / "c.rio")
    _write(recordio, p, _samples(10), None, chunk_bytes=1 << 20)
    _corrupt(p)
    with pytest.raises(IOError):
        list(recordio.read_records(p, use_native=False))
    with pytest.raises(IOError):
        list(recordio.read_records(p, use_native=True))


def test_sharding_and_master_integration(tmp_path):
    from paddle_tpu_torch.distributed import MasterService, master_reader

    samples = _samples(60)
    paths = recordio.write_shards(samples, str(tmp_path / "shard"), 4)
    assert len(paths) == 4
    svc = MasterService(timeout_s=30)
    svc.set_dataset(paths)

    class _C:  # in-proc client shim
        get_task = staticmethod(svc.get_task)
        task_finished = staticmethod(svc.task_finished)
        task_failed = staticmethod(svc.task_failed)

    got = []
    for rec in master_reader(_C(), lambda p: recordio.read_records(p))():
        got.append(rec)
        if len(got) >= 60:
            break
    assert sorted(got) == sorted(samples)


def test_dataset_convert_trains_through_master_chunks(tmp_path):
    """convert -> master chunk dispatch -> trainer (reference
    v2/dataset/common.py:193), as the JAX test runs it, on the CPU."""
    from paddle_tpu_torch.dataset.common import convert, recordio_task_loader
    from paddle_tpu_torch.distributed import MasterService, master_reader

    rng = np.random.RandomState(0)
    w_true = rng.rand(8).astype("float32")

    def reader():
        for i in range(120):
            x = rng.rand(8).astype("float32")
            yield (x, np.float32(x @ w_true))

    shards = convert(str(tmp_path), reader, 25, "reg_train")
    assert len(shards) == 5  # 120 samples / 25 per shard, tail included
    svc = MasterService(timeout_s=60)
    svc.set_dataset(shards)

    class _C:
        get_task = staticmethod(svc.get_task)
        task_finished = staticmethod(svc.task_finished)
        task_failed = staticmethod(svc.task_failed)

    x = tfluid.layers.data(name="x", shape=[8], dtype="float32")
    y = tfluid.layers.data(name="y", shape=[1], dtype="float32")
    pred = tfluid.layers.fc(input=x, size=1)
    loss = tfluid.layers.mean(
        tfluid.layers.square_error_cost(input=pred, label=y))
    tfluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())

    losses, batch, seen = [], [], 0
    for xs, ys in master_reader(_C(), recordio_task_loader)():
        batch.append((xs, ys))
        seen += 1
        if len(batch) == 20:
            xb = np.stack([b[0] for b in batch])
            yb = np.asarray([[b[1]] for b in batch], dtype="float32")
            (l,) = exe.run(feed={"x": xb, "y": yb}, fetch_list=[loss])
            losses.append(float(np.asarray(l).ravel()[0]))
            batch = []
        if seen == 120:
            break
    assert seen == 120
    assert losses[-1] < losses[0]


# -- the port against the JAX package ---------------------------------------

@pytest.mark.parametrize("chunk_bytes", [64, 1 << 20])
def test_bytes_equal_across_packages_and_codecs(tmp_path, chunk_bytes):
    """The four writers (JAX and port, C++ and Python) give one file; each
    of the four readers gives the records back from it."""
    assert jrecordio.build_lib() is not None
    samples = _samples(40) + [b"x" * 300]
    files = {(name, nat): _write(mod, str(tmp_path / f"{name}{nat}.rio"),
                                 samples, nat, chunk_bytes)
             for name, mod in (("jax", jrecordio), ("port", recordio))
             for nat in (True, False)}
    assert len(set(files.values())) == 1, {k: len(v) for k, v in
                                           files.items()}
    for (name, nat) in files:
        p = str(tmp_path / f"{name}{nat}.rio")
        for mod in (jrecordio, recordio):
            for read_nat in (True, False):
                assert list(mod.read_records(p, use_native=read_nat)) == \
                    samples, (name, nat, mod.__name__, read_nat)


def test_corruption_raises_in_both_packages(tmp_path):
    p = str(tmp_path / "c.rio")
    _write(jrecordio, p, _samples(30), False, chunk_bytes=128)
    _corrupt(p, at=40)
    for mod in (jrecordio, recordio):
        for nat in (True, False):
            with pytest.raises(IOError):
                list(mod.read_records(p, use_native=nat))
    # through the creator's read-ahead too: the error reaches the reader
    from paddle_tpu_torch.reader import creator

    with pytest.raises(IOError):
        list(creator.recordio(p)())


def test_records_the_jax_library_misreads(tmp_path):
    """An empty record and one past the reader's first 64 KiB buffer come
    back from the port's library as from the Python codec (the JAX
    package's library ends the stream at an empty record and garbles the
    long one: ROADMAP Queue C)."""
    samples = [b"a", b"", b"y" * 70000, b"b", b""]
    p = str(tmp_path / "edge.rio")
    _write(recordio, p, samples, True, chunk_bytes=1 << 20)
    assert list(recordio.read_records(p, use_native=True)) == samples
    assert list(jrecordio.read_records(p, use_native=False)) == samples


def test_use_native_never_falls_back(tmp_path, monkeypatch):
    """A compiler that cannot run fails the native codec loudly, with the
    compiler named; only use_native=False reaches the Python codec."""
    monkeypatch.setattr(recordio, "CXX",
                        str(tmp_path / "no-such-dir" / "g++"))
    monkeypatch.setattr(recordio, "_dll", None)
    p = str(tmp_path / "f.rio")
    for use_native in (True, None):
        with pytest.raises(RuntimeError, match="no-such-dir"):
            recordio.Writer(p, use_native=use_native)
        with pytest.raises(RuntimeError, match="no-such-dir"):
            list(recordio.read_records(p, use_native=use_native))
    assert not recordio.native_available()
    _write(recordio, p, [b"r0", b"r1"], False)
    assert list(recordio.read_records(p, use_native=False)) == [b"r0", b"r1"]
    # and the default creator over it raises too
    from paddle_tpu_torch.reader import creator

    with pytest.raises(RuntimeError, match="no-such-dir"):
        list(creator.recordio(p)())


def test_failed_compile_raises_with_its_message(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(recordio, "_SRC", str(bad))
    monkeypatch.setattr(recordio, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(recordio, "_dll", None)
    with pytest.raises(RuntimeError, match="bad.cc"):
        recordio.build_lib()
    assert not os.listdir(tmp_path / "build")


def _unpickled(paths, mod):
    return [pickle.loads(r) for p in paths for r in mod.read_records(p)]


def _equal(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (np.asarray(a).dtype == np.asarray(b).dtype
                and np.array_equal(a, b))
    if isinstance(a, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_equal(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("name", CONVERTS)
def test_dataset_convert_matches_jax(tmp_path, name):
    import importlib

    tmod = importlib.import_module(f"paddle_tpu_torch.dataset.{name}")
    jmod = importlib.import_module(f"paddle_tpu.dataset.{name}")
    tdir, jdir = tmp_path / "port", tmp_path / "jax"
    tmod.convert(str(tdir))
    jmod.convert(str(jdir))
    tfiles, jfiles = sorted(os.listdir(tdir)), sorted(os.listdir(jdir))
    assert tfiles == jfiles and tfiles
    for f in tfiles:
        t = _unpickled([str(tdir / f)], recordio)
        j = _unpickled([str(jdir / f)], jrecordio)
        assert len(t) == len(j) and t, f
        assert all(_equal(a, b) for a, b in zip(t, j)), f
    assert tcommon.data_mode(name) == "synthetic"


def test_task_loader_and_creator_over_a_jax_shard(tmp_path):
    from paddle_tpu.dataset.common import convert as jconvert
    from paddle_tpu_torch.reader import creator

    rng = np.random.RandomState(3)
    samples = [(rng.rand(5).astype(np.float32), int(rng.randint(9)))
               for _ in range(23)]
    shards = jconvert(str(tmp_path), lambda: iter(samples), 10, "j")
    assert len(shards) == 3
    got = list(tcommon.recordio_task_loader(shards))
    assert all(_equal(a, b) for a, b in zip(got, samples))
    assert len(got) == len(samples)
    got = list(tcommon.recordio_task_loader(shards[1]))
    assert all(_equal(a, b) for a, b in zip(got, samples[10:20]))
    # the creator: a glob, a comma-separated string and a list, in order
    recs = [pickle.dumps(s, protocol=pickle.HIGHEST_PROTOCOL)
            for s in samples]
    for paths in (str(tmp_path / "j-*"), ",".join(shards), shards):
        assert list(creator.recordio(paths, buf_size=2)()) == recs
