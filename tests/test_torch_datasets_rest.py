"""The port's nine dataset modules (cifar, flowers, imdb, imikolov,
movielens, mq2007, sentiment, voc2012, wmt14) against the JAX package's
on the CPU:

- every synthetic reader yields the JAX reader's first samples, equal
  element for element and in dtype, and records the same ``DATA_MODE``;
- each real-format parser reads a tiny archive written into ``tmp_path``
  (tar, tgz, zip, ``.mat``, LETOR text) as the JAX parser reads it, and
  both record "real";
- the schema checks of ``tests/test_datasets_memory.py``;
- each module exports the JAX module's public names and constants (but
  ``convert``, which writes RecordIO, ROADMAP Queue A 12)."""

import io
import pickle
import tarfile
import types
import zipfile

import numpy as np
import pytest

import paddle_tpu.dataset as J
import paddle_tpu_torch.dataset as T

MODULES = ("cifar", "flowers", "imdb", "imikolov", "movielens", "mq2007",
           "sentiment", "voc2012", "wmt14")


@pytest.fixture()
def data_home(tmp_path, monkeypatch):
    home = tmp_path / "data"
    home.mkdir()
    for pkg in (J, T):
        monkeypatch.setattr(pkg.common, "DATA_HOME", str(home))
    return home


def _equal(t, j, tag):
    """Samples equal element for element: tuples and lists recursively,
    arrays in shape, dtype and value, scalars in type and value."""
    if isinstance(j, (tuple, list)):
        assert type(t) is type(j) and len(t) == len(j), tag
        for k, (a, b) in enumerate(zip(t, j)):
            _equal(a, b, f"{tag}[{k}]")
    elif isinstance(j, np.ndarray):
        assert isinstance(t, np.ndarray), tag
        assert t.dtype == j.dtype and t.shape == j.shape, tag
        np.testing.assert_array_equal(t, j, err_msg=tag)
    elif isinstance(j, dict):
        assert t == j, tag
    else:
        assert type(t) is type(j) and t == j, tag


# -- the synthetic surrogates -------------------------------------------------

SYNTHETIC = [
    ("cifar", "train10", {"n": 6}), ("cifar", "test10", {"n": 4}),
    ("cifar", "train100", {"n": 6}), ("cifar", "test100", {"n": 4}),
    ("flowers", "train", {"n": 3}), ("flowers", "valid", {"n": 2}),
    ("flowers", "test", {"n": 2}),
    ("imdb", "train", {"n": 16}), ("imdb", "test", {"n": 8}),
    ("imikolov", "train", {"n": 32}), ("imikolov", "test", {"n": 8, "gram": 3}),
    ("movielens", "train", {"n": 32}), ("movielens", "test", {"n": 8}),
    ("mq2007", "train", {"format": "pairwise", "n_queries": 3}),
    ("mq2007", "train", {"format": "pointwise", "n_queries": 3}),
    ("mq2007", "test", {"format": "listwise", "n_queries": 3}),
    ("sentiment", "train", {"n": 16}), ("sentiment", "test", {"n": 8}),
    ("voc2012", "train", {"n": 2}), ("voc2012", "val", {"n": 2}),
    ("voc2012", "test", {"n": 2}),
    ("wmt14", "train", {"n": 16}), ("wmt14", "test", {"n": 8}),
    ("wmt14", "train", {"dict_size": 500, "n": 8}),
]


@pytest.mark.parametrize("mod,fn,kw", SYNTHETIC,
                         ids=[f"{m}.{f}-{i}" for i, (m, f, _) in
                              enumerate(SYNTHETIC)])
def test_synthetic_reader_yields_jax_samples(data_home, mod, fn, kw):
    if mod == "sentiment" and T.sentiment._movie_reviews() is not None:
        pytest.skip("an installed NLTK movie_reviews corpus serves as real")
    t = list(getattr(getattr(T, mod), fn)(**kw)())
    j = list(getattr(getattr(J, mod), fn)(**kw)())
    assert T.common.data_mode(mod) == J.common.data_mode(mod) == "synthetic"
    assert len(t) == len(j) > 0
    _equal(t, j, f"{mod}.{fn}")


def test_synthetic_dicts_equal_jax(data_home):
    assert T.imdb.word_dict() == J.imdb.word_dict()
    assert len(T.imdb.word_dict()) == T.imdb.WORD_DICT_SIZE == 5147
    assert T.imikolov.build_dict() == J.imikolov.build_dict()
    assert len(T.imikolov.build_dict()) == T.imikolov.DICT_SIZE == 2073
    if T.sentiment._movie_reviews() is None:
        assert T.sentiment.get_word_dict() == J.sentiment.get_word_dict()


def test_public_names_and_constants_equal_jax():
    for mod in MODULES:
        jm, tm = getattr(J, mod), getattr(T, mod)
        names = {n for n, v in vars(jm).items() if not n.startswith("_")
                 and not isinstance(v, types.ModuleType)
                 and getattr(v, "__module__", jm.__name__) == jm.__name__}
        names -= {"convert", "annotations"}
        missing = {n for n in names if not hasattr(tm, n)}
        assert not missing, (mod, missing)
        for n in names:
            v = getattr(jm, n)
            if isinstance(v, (int, float, str, tuple, list)):
                assert getattr(tm, n) == v, (mod, n)
    assert (T.wmt14.DICT_SIZE, T.movielens.USER_COUNT,
            T.movielens.MOVIE_COUNT, T.mq2007.FEATURE_DIM) == \
        (30000, 6040, 3952, 46)


# -- the real formats, from tiny archives --------------------------------------

def _add(tf, name, blob):
    info = tarfile.TarInfo(name)
    info.size = len(blob)
    tf.addfile(info, io.BytesIO(blob))


def _pin(monkeypatch, mod, attr, path):
    md5 = T.common.md5file(str(path))
    for pkg in (J, T):
        monkeypatch.setattr(getattr(pkg, mod), attr, md5)


def _real_cifar(home, monkeypatch):
    rng = np.random.RandomState(1)
    (home / "cifar").mkdir()
    path = home / "cifar" / "cifar-10-python.tar.gz"
    with tarfile.open(path, "w:gz") as tf:
        for name in ("data_batch_1", "data_batch_2", "test_batch"):
            blob = pickle.dumps({b"data": rng.randint(0, 256, (3, 3072),
                                                      dtype=np.uint8),
                                 b"labels": rng.randint(0, 10, 3).tolist()},
                                2)
            _add(tf, f"cifar-10-batches-py/{name}", blob)
    _pin(monkeypatch, "cifar", "CIFAR10_MD5", path)
    return [("train10", {}), ("test10", {})]


def _real_imdb(home, monkeypatch):
    (home / "imdb").mkdir()
    path = home / "imdb" / "aclImdb_v1.tar.gz"
    docs = {"aclImdb/train/pos/0_9.txt": b"a great great movie , truly great",
            "aclImdb/train/pos/1_8.txt": b"great fun ; great cast<br />yes",
            "aclImdb/train/neg/0_2.txt": b"a terrible movie . terrible !",
            "aclImdb/test/pos/0_10.txt": b"great",
            "aclImdb/test/neg/0_1.txt": b"terrible unseen"}
    with tarfile.open(path, "w:gz") as tf:
        for name, blob in docs.items():
            _add(tf, name, blob)
    _pin(monkeypatch, "imdb", "MD5", path)
    for pkg in (J, T):
        monkeypatch.setattr(pkg.imdb, "CUTOFF", 0)
    return [("word_dict", None), ("train", {}), ("test", {})]


def _real_imikolov(home, monkeypatch):
    (home / "imikolov").mkdir()
    path = home / "imikolov" / "simple-examples.tgz"
    with tarfile.open(path, "w:gz") as tf:
        _add(tf, "./simple-examples/data/ptb.train.txt",
             b"the cat sat on the mat\nthe dog sat <unk>\n")
        _add(tf, "./simple-examples/data/ptb.valid.txt", b"the cat ran\n")
    _pin(monkeypatch, "imikolov", "MD5", path)
    for pkg in (J, T):
        monkeypatch.setattr(pkg.imikolov, "MIN_WORD_FREQ", 0)
    return [("build_dict", None), ("train", {"gram": 3}),
            ("test", {"gram": 2})]


def _real_movielens(home, monkeypatch):
    (home / "movielens").mkdir()
    path = home / "movielens" / "ml-1m.zip"
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("ml-1m/users.dat",
                   "1::M::25::15::12345\n2::F::45::7::67890\n3::M::1::0::1\n")
        z.writestr("ml-1m/movies.dat",
                   "1::Toy Story (1995)::Animation|Children's|Comedy\n"
                   "2::Heat (1995)::Action|Crime|Thriller\n"
                   "3::Odd (1990)::Unknown\n")
        z.writestr("ml-1m/ratings.dat",
                   "1::1::5::978300760\n1::2::3::978302109\n"
                   "2::1::4::978301968\n2::2::2::978300275\n"
                   "3::3::1::978300275\n9::1::4::1\n")
    _pin(monkeypatch, "movielens", "MD5", path)
    return [("train", {}), ("test", {})]


def _real_wmt14(home, monkeypatch):
    (home / "wmt14").mkdir()
    path = home / "wmt14" / "wmt14.tgz"
    src = "\n".join(["<s>", "<e>", "<unk>", "le", "chat", "dort"])
    trg = "\n".join(["<s>", "<e>", "<unk>", "the", "cat", "sleeps"])
    with tarfile.open(path, "w:gz") as tf:
        _add(tf, "wmt14/src.dict", src.encode())
        _add(tf, "wmt14/trg.dict", trg.encode())
        _add(tf, "wmt14/train/train",
             ("le chat dort\tthe cat sleeps\nle chat inconnu\tthe unknown "
              "cat\nbad line\n" + "le " * 90 + "\tthe\n").encode())
        _add(tf, "wmt14/test/test", b"le chat\tthe cat\n")
    _pin(monkeypatch, "wmt14", "MD5", path)
    return [("train", {"dict_size": 6}), ("test", {"dict_size": 5})]


def _jpeg(rng, h, w):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8)).save(
        buf, format="JPEG")
    return buf.getvalue()


def _real_flowers(home, monkeypatch):
    scio = pytest.importorskip("scipy.io")
    pytest.importorskip("PIL")
    d = home / "flowers"
    d.mkdir()
    rng = np.random.RandomState(0)
    with tarfile.open(d / "102flowers.tgz", "w:gz") as tf:
        for i in (1, 2, 3):
            _add(tf, f"jpg/image_{i:05d}.jpg", _jpeg(rng, 32, 40))
    scio.savemat(d / "imagelabels.mat",
                 {"labels": np.asarray([[5, 17, 5]], np.uint8)})
    scio.savemat(d / "setid.mat", {"tstid": np.asarray([[1, 3]]),
                                   "trnid": np.asarray([[2]]),
                                   "valid": np.asarray([[2]])})
    _pin(monkeypatch, "flowers", "DATA_MD5", d / "102flowers.tgz")
    _pin(monkeypatch, "flowers", "LABEL_MD5", d / "imagelabels.mat")
    _pin(monkeypatch, "flowers", "SETID_MD5", d / "setid.mat")
    return [("train", {}), ("test", {}), ("valid", {})]


def _real_voc2012(home, monkeypatch):
    pytest.importorskip("PIL")
    from PIL import Image

    (home / "voc2012").mkdir()
    path = home / "voc2012" / "VOCtrainval_11-May-2012.tar"
    rng = np.random.RandomState(1)
    voc = T.voc2012
    with tarfile.open(path, "w") as tf:
        _add(tf, voc.SET_FILE.format("trainval"), b"img_a\nimg_b\n")
        _add(tf, voc.SET_FILE.format("train"), b"img_a\n")
        _add(tf, voc.SET_FILE.format("val"), b"img_b\n")
        for name in ("img_a", "img_b"):
            _add(tf, voc.DATA_FILE.format(name), _jpeg(rng, 24, 30))
            mask = np.zeros((24, 30), np.uint8)
            mask[4:10, 5:12] = 7
            mask[4, 5:12] = 255
            buf = io.BytesIO()
            Image.fromarray(mask, mode="L").save(buf, format="PNG")
            _add(tf, voc.LABEL_FILE.format(name), buf.getvalue())
    _pin(monkeypatch, "voc2012", "VOC_MD5", path)
    return [("train", {}), ("val", {}), ("test", {})]


def _real_mq2007(home, monkeypatch):
    d = home / "mq2007" / "Fold1"
    d.mkdir(parents=True)
    (d / "train.txt").write_text(
        "2 qid:10 1:0.1 2:0.5 46:0.9 #docid = A\n"
        "0 qid:10 1:0.0 2:0.1 #docid = B\n"
        "1 qid:10 47:3.0 5:0.25\n"
        "1 qid:11 3:0.7 #docid = C\n\n")
    (d / "test.txt").write_text("1 qid:3 4:0.5\n0 qid:3 4:0.1\n")
    return [("train", {"format": f}) for f in ("pointwise", "pairwise",
                                                "listwise")] + \
        [("test", {"format": "pairwise"})]


REAL = {"cifar": _real_cifar, "imdb": _real_imdb,
        "imikolov": _real_imikolov, "movielens": _real_movielens,
        "wmt14": _real_wmt14, "flowers": _real_flowers,
        "voc2012": _real_voc2012, "mq2007": _real_mq2007}


@pytest.mark.parametrize("mod", sorted(REAL))
def test_real_format_parses_as_jax(data_home, monkeypatch, mod):
    calls = REAL[mod](data_home, monkeypatch)
    for fn, kw in calls:
        if kw is None:  # a dict builder
            _equal(getattr(getattr(T, mod), fn)(),
                   getattr(getattr(J, mod), fn)(), f"{mod}.{fn}")
            continue
        t = list(getattr(getattr(T, mod), fn)(**kw)())
        assert T.common.data_mode(mod) == "real", (mod, fn)
        j = list(getattr(getattr(J, mod), fn)(**kw)())
        assert J.common.data_mode(mod) == "real", (mod, fn)
        assert len(t) == len(j) > 0, (mod, fn, len(t), len(j))
        _equal(t, j, f"{mod}.{fn}{kw}")


def test_real_archive_with_a_wrong_checksum_is_not_read(data_home,
                                                        monkeypatch):
    _real_imdb(data_home, monkeypatch)
    monkeypatch.setattr(T.imdb, "MD5", "0" * 32)
    list(T.imdb.train(n=4)())
    assert T.common.data_mode("imdb") == "synthetic"


def test_sentiment_real_path_or_fallback(data_home):
    samples = list(T.sentiment.test(n=8)())
    mode = T.common.data_mode("sentiment")
    if mode == "real":
        assert len(samples) == 400
    else:
        assert mode == "synthetic" and len(samples) == 8
    ids, label = samples[0]
    assert np.asarray(ids).dtype == np.int64 and label in (0, 1)


# -- the schema checks of tests/test_datasets_memory.py -------------------------

def test_schemas(data_home):
    conll05 = T.conll05
    w, v, lab = conll05.get_dict()
    assert len(lab) == conll05.LABEL_DICT_LEN
    assert conll05.get_embedding().shape[0] == conll05.WORD_DICT_LEN
    s = next(conll05.test(n=4)())
    assert len(s) == 9 and all(len(q) == len(s[0]) for q in s[:8])
    assert all(0 <= t < conll05.LABEL_DICT_LEN for t in s[8])

    img, label = next(T.flowers.train(n=2)())
    assert img.shape == (3, 224, 224) and img.dtype == np.float32
    assert 0 <= label < T.flowers.NUM_CLASSES

    img, seg = next(T.voc2012.train(n=2)())
    assert img.shape[0] == 3 and img.shape[1:] == seg.shape
    assert set(np.unique(seg)) - {T.voc2012.IGNORE_LABEL} <= \
        set(range(T.voc2012.NUM_CLASSES))

    toks, label = next(T.sentiment.train(n=2)())
    assert toks.dtype == np.int64 and label in (0, 1)
    assert len(T.sentiment.get_word_dict()) == T.sentiment.WORD_DICT_LEN

    mq = T.mq2007
    x, y = next(mq.train("pointwise", n_queries=2)())
    assert x.shape == (mq.FEATURE_DIM,) and 0 <= y <= mq.MAX_REL
    hi, lo = next(mq.train("pairwise", n_queries=2)())
    assert hi.shape == lo.shape == (mq.FEATURE_DIM,)
    labels, feats = next(mq.train("listwise", n_queries=2)())
    assert len(labels) == len(feats)


def test_fetching_is_not_ported():
    with pytest.raises(NotImplementedError, match="not ported"):
        T.common.fetch(T.imdb.URL, "imdb", T.imdb.MD5)
