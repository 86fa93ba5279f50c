"""PASCAL VOC2012 segmentation (reference v2/dataset/voc2012.py): (image
3xHxW float32, label map HxW int32 with 0..20 classes + 255 ignore).

Real data is the VOCtrainval tarball (reference voc2012.py:30 URL/md5):
JPEG images + palette-PNG class masks selected by the ImageSets/Segmentation
split files (train/val/trainval).  Fallbacks: legacy pkl cache, then the
rectangle-object synthetic surrogate.

The port of ``paddle_tpu/dataset/voc2012.py``: the same readers, the same
synthetic samples in the same order, and the same parser, reading
the archive only when it is already in the cache (``common.local``:
the md5-verified original, or a provenance-marked sliver); nothing
is fetched."""

from __future__ import annotations

import tarfile

import numpy as np

from . import common
from .common import DATA_MODE, has_cached, load_cached, synthetic_rng

VOC_URL = ("http://host.robots.ox.ac.uk/pascal/VOC/voc2012/"
           "VOCtrainval_11-May-2012.tar")
VOC_MD5 = "6cd6e144f989b92b3379bac3b3de84fd"
SET_FILE = "VOCdevkit/VOC2012/ImageSets/Segmentation/{}.txt"
DATA_FILE = "VOCdevkit/VOC2012/JPEGImages/{}.jpg"
LABEL_FILE = "VOCdevkit/VOC2012/SegmentationClass/{}.png"

NUM_CLASSES = 21
IGNORE_LABEL = 255
IMG_HW = (128, 128)  # synthetic surrogate resolution


def _synthetic(n, seed):
    rng = synthetic_rng("voc2012", seed)
    H, W = IMG_HW
    for _ in range(n):
        img = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
        label = np.zeros((H, W), np.int32)
        # one rectangular object per image
        cls = int(rng.randint(1, NUM_CLASSES))
        y0, x0 = rng.randint(0, H // 2), rng.randint(0, W // 2)
        y1, x1 = y0 + rng.randint(8, H // 2), x0 + rng.randint(8, W // 2)
        label[y0:y1, x0:x1] = cls
        img[:, y0:y1, x0:x1] += cls / NUM_CLASSES  # signal for learning
        # thin ignore border around the object, as in real VOC masks
        label[y0, x0:x1] = IGNORE_LABEL
        yield np.clip(img, 0, 2), label


def _real_samples(path, sub_name):
    """Yield (CHW float32 image in [0,1], HxW int32 mask) per split entry."""
    import io as _io

    from PIL import Image

    with tarfile.open(path) as tf:
        members = {m.name: m for m in tf.getmembers()}
        split = tf.extractfile(members[SET_FILE.format(sub_name)])
        for line in split.read().decode().splitlines():
            name = line.strip()
            if not name:
                continue
            img = Image.open(_io.BytesIO(
                tf.extractfile(members[DATA_FILE.format(name)]).read()
            )).convert("RGB")
            mask = Image.open(_io.BytesIO(
                tf.extractfile(members[LABEL_FILE.format(name)]).read()))
            arr = np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0
            yield arr, np.asarray(mask, np.int32)


def _reader(n, seed, fname, sub_name):
    def reader():
        path = common.local(VOC_URL, "voc2012", VOC_MD5)
        if path is not None:
            DATA_MODE["voc2012"] = "real"
            yield from _real_samples(path, sub_name)
            return
        if has_cached("voc2012", fname):
            DATA_MODE["voc2012"] = "cache"
            for sample in load_cached("voc2012", fname):
                yield sample
        else:
            DATA_MODE["voc2012"] = "synthetic"
            yield from _synthetic(n, seed)

    return reader


def train(n=128):
    return _reader(n, 0, "train.pkl", "trainval")


def val(n=32):
    return _reader(n, 1, "val.pkl", "val")


def test(n=32):
    return _reader(n, 2, "test.pkl", "train")
