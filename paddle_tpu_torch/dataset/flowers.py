"""Oxford 102 flowers (reference v2/dataset/flowers.py): 3x224x224 float32
CHW images in [0,1] + one of 102 labels.

Real data: 102flowers.tgz (jpegs) + imagelabels.mat + setid.mat (reference
flowers.py:43-48 URLs/md5s); the reference swaps tstid/trnid so the larger
split trains.  JPEGs decode with PIL, resize to 224x224 CHW.  Fallbacks:
legacy pkl cache, then the class-correlated synthetic surrogate.

The port of ``paddle_tpu/dataset/flowers.py``: the same readers, the same
synthetic samples in the same order, and the same parser, reading
the archive only when it is already in the cache (``common.local``:
the md5-verified original, or a provenance-marked sliver); nothing
is fetched."""

from __future__ import annotations

import tarfile

import numpy as np

from . import common
from .common import DATA_MODE, has_cached, load_cached, synthetic_rng

DATA_URL = "http://www.robots.ox.ac.uk/~vgg/data/flowers/102/102flowers.tgz"
DATA_MD5 = "33bfc11892f1e405ca193ae9a9f2a118"
LABEL_URL = ("http://www.robots.ox.ac.uk/~vgg/data/flowers/102/"
             "imagelabels.mat")
LABEL_MD5 = "e0620be6f572b9609742df49c70aed4d"
SETID_URL = "http://www.robots.ox.ac.uk/~vgg/data/flowers/102/setid.mat"
SETID_MD5 = "a5357ecc9cb78c4bef273ce3793fc85c"
# official readme: tstid flags test, trnid train — but test > train, so the
# reference swaps them (flowers.py:50-53); same here
TRAIN_FLAG, TEST_FLAG, VALID_FLAG = "tstid", "trnid", "valid"

NUM_CLASSES = 102
IMG_SHAPE = (3, 224, 224)


def _decode_jpeg(blob) -> np.ndarray:
    from PIL import Image
    import io

    img = Image.open(io.BytesIO(blob)).convert("RGB")
    img = img.resize((IMG_SHAPE[2], IMG_SHAPE[1]))
    arr = np.asarray(img, np.float32) / 255.0
    return arr.transpose(2, 0, 1)  # HWC -> CHW


def _real_samples(split_flag):
    data = common.local(DATA_URL, "flowers", DATA_MD5)
    labels_p = common.local(LABEL_URL, "flowers", LABEL_MD5)
    setid_p = common.local(SETID_URL, "flowers", SETID_MD5)
    if not (data and labels_p and setid_p):
        return None
    try:  # decode deps only needed once real archives are present
        import scipy.io as scio
        from PIL import Image  # noqa: F401
    except ImportError:
        return None
    labels = scio.loadmat(labels_p)["labels"][0]          # 1-based classes
    ids = scio.loadmat(setid_p)[split_flag][0]            # 1-based image ids

    def gen():
        wanted = {f"jpg/image_{i:05d}.jpg": i for i in ids}
        with tarfile.open(data) as tf:
            for m in tf.getmembers():
                i = wanted.get(m.name)
                if i is None:
                    continue
                img = _decode_jpeg(tf.extractfile(m).read())
                yield img, int(labels[i - 1]) - 1   # 0-based label

    return gen


def _synthetic(n, seed):
    rng = synthetic_rng("flowers", seed)
    for _ in range(n):
        label = int(rng.randint(0, NUM_CLASSES))
        # class-correlated mean so a classifier can actually learn
        img = rng.normal(label / NUM_CLASSES, 0.2,
                         IMG_SHAPE).astype(np.float32)
        yield np.clip(img, 0.0, 1.0), label


def _reader(n, seed, fname, split_flag):
    def reader():
        real = _real_samples(split_flag)
        if real is not None:
            DATA_MODE["flowers"] = "real"
            yield from real()
            return
        if has_cached("flowers", fname):
            DATA_MODE["flowers"] = "cache"
            for sample in load_cached("flowers", fname):
                yield sample
        else:
            DATA_MODE["flowers"] = "synthetic"
            yield from _synthetic(n, seed)

    return reader


def train(n=256, mapper=None, buffered_size=1024, use_xmap=False):
    return _reader(n, 0, "train.pkl", TRAIN_FLAG)


def valid(n=64, mapper=None, buffered_size=1024, use_xmap=False):
    return _reader(n, 1, "valid.pkl", VALID_FLAG)


def test(n=64, mapper=None, buffered_size=1024, use_xmap=False):
    return _reader(n, 2, "test.pkl", TEST_FLAG)
