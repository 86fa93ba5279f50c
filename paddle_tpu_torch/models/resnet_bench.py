"""The ResNet training bench at full width, and its feed: ``bench.py``'s
``bench_resnet_train`` configuration — ResNet-50, ``class_dim`` 1000,
224 x 224 x 3 NHWC images, bf16 activations and weights with the logits
cast to f32, Momentum(0.1, 0.9), batch 128, the feed from
``RandomState(0)`` — with the BatchNorm -> conv fusion on or off.

``chip_smoke.py``, ``tools/profile_torch_train.py`` and the tests build
it here, so their numbers describe one workload.  These functions reset
nothing: call ``paddle_tpu_torch.reset()`` first for fresh programs.
"""

from __future__ import annotations

import numpy as np

DEPTH, CLASSES, IMAGE, BS = 50, 1000, 224, 128
DTYPE, LR, MOMENTUM = "bfloat16", 0.1, 0.9


def train_program(depth=DEPTH, class_dim=CLASSES, image=IMAGE, dtype=DTYPE,
                  learning_rate=LR, fuse_bn=True):
    """Build the NHWC training program into the default programs; returns
    (avg_cost, accuracy)."""
    from .resnet import build_train_program

    return build_train_program(
        depth=depth, class_dim=class_dim, image_shape=(3, image, image),
        dtype=dtype, learning_rate=learning_rate, momentum=MOMENTUM,
        layout="NHWC", fuse_bn=fuse_bn)


def feed(bs=BS, image=IMAGE, class_dim=CLASSES, seed=0):
    """The bench's batch from ``RandomState(seed)``: images uniform in
    [0, 1) [bs, image, image, 3] f32 (the executor casts them to the
    program's dtype) and int64 labels [bs, 1]."""
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(bs, image, image, 3).astype(np.float32),
            "label": rng.randint(0, class_dim, (bs, 1)).astype(np.int64)}
