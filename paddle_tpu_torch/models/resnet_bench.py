"""The ResNet training bench at full width, and its feed: ``bench.py``'s
``bench_resnet_train`` configuration — ResNet-50, ``class_dim`` 1000,
224 x 224 x 3 NHWC images, bf16 activations and weights with the logits
cast to f32, Momentum(0.1, 0.9), batch 128, the feed from
``RandomState(0)`` — with the BatchNorm -> conv fusion on or off, and
rematerialized residual blocks on or off; and ``bench_resnet_infer``'s
inference program (batch 16, softmax over the f32-cast logits), which
``fuse_batch_norm`` folds.

``chip_smoke.py``, ``tools/profile_torch_train.py`` and the tests build
it here, so their numbers describe one workload.  These functions reset
nothing: call ``paddle_tpu_torch.reset()`` first for fresh programs.
"""

from __future__ import annotations

import numpy as np

DEPTH, CLASSES, IMAGE, BS = 50, 1000, 224, 128
DTYPE, LR, MOMENTUM = "bfloat16", 0.1, 0.9
INFER_BS = 16


def train_program(depth=DEPTH, class_dim=CLASSES, image=IMAGE, dtype=DTYPE,
                  learning_rate=LR, fuse_bn=True, remat=False):
    """Build the NHWC training program into the default programs; returns
    (avg_cost, accuracy)."""
    from .resnet import build_train_program

    return build_train_program(
        depth=depth, class_dim=class_dim, image_shape=(3, image, image),
        dtype=dtype, learning_rate=learning_rate, momentum=MOMENTUM,
        layout="NHWC", fuse_bn=fuse_bn, remat=remat)


def infer_program(depth=DEPTH, class_dim=CLASSES, image=IMAGE, dtype=DTYPE):
    """Build the NHWC inference program into the default programs: the
    tower with no grad ops (its batch_norm ops run on the running
    statistics) and softmax over the logits cast to f32; returns the
    probabilities."""
    from .. import layers
    from .resnet import resnet_imagenet

    img = layers.data(name="image", shape=[image, image, 3], dtype=dtype)
    logits = resnet_imagenet(img, class_dim=class_dim, depth=depth,
                             layout="NHWC")
    return layers.softmax(layers.cast(logits, "float32")
                          if dtype != "float32" else logits)


def feed(bs=BS, image=IMAGE, class_dim=CLASSES, seed=0):
    """The bench's batch from ``RandomState(seed)``: images uniform in
    [0, 1) [bs, image, image, 3] f32 (the executor casts them to the
    program's dtype) and int64 labels [bs, 1]."""
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(bs, image, image, 3).astype(np.float32),
            "label": rng.randint(0, class_dim, (bs, 1)).astype(np.int64)}
