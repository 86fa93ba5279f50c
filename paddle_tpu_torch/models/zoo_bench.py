"""The model zoo's training workloads at ``bench.py``'s configurations, and
their feeds, so that ``chip_smoke.py`` and the tests describe one
workload each:

- ``bench_cnn_train`` (AlexNet, GoogLeNet, VGG-19): 224 x 224 x 3 NHWC
  images, ``class_dim`` 1000, bf16 activations and weights with the
  logits cast to f32, softmax with cross entropy → mean, Momentum(0.01,
  0.9), batch 128, the feed from ``RandomState(0)``; VGG-19 also with
  the BatchNorm → 3x3 fusion of ``training_fusion.fuse_bn_matmul``;
- ``bench_unet_train``: the DDPM U-Net at 64 px, ``base_ch`` 64,
  ``ch_mults`` (1, 2, 4), f32, Adam(1e-3), batch 64, ``ddpm_feed`` from
  ``RandomState(0)``;
- the ``nets`` presets no model here uses (``sequence_conv_pool``,
  ``dot_product_attention``, ``glu``) in one small text classifier;
- DeepFM (no ``bench.py`` workload): the click model of the JAX
  package's CTR test (6 fields, vocabulary 256, embedding 8, hidden (32,
  16), Adam(0.02), 512 rows) and the DeepFM paper's Criteo widths (39
  fields, embedding 10, hidden 400-400-400) over a hashed vocabulary of
  1,000,000, the click ``sigmoid_cross_entropy_with_logits`` → mean.

These functions reset nothing: call ``paddle_tpu_torch.reset()`` first
for fresh programs."""

from __future__ import annotations

import numpy as np

from .. import layers, optimizer

CNN_MODELS = ("alexnet", "googlenet", "vgg")
CNN_BS, CNN_IMAGE, CNN_CLASSES = 128, 224, 1000
CNN_DTYPE, CNN_LR, CNN_MOMENTUM = "bfloat16", 0.01, 0.9

UNET_BS, UNET_IMAGE, UNET_CH, UNET_MULTS, UNET_LR = 64, 64, 64, (1, 2, 4), 1e-3
UNET_T = 1000

# (num_fields, vocab, embed_dim, hidden, learning rate, rows)
DEEPFM_CTR = (6, 256, 8, (32, 16), 0.02, 512)
DEEPFM_CRITEO = (39, 1_000_000, 10, (400, 400, 400), 1e-3, 4096)

# the nets program: vocabulary, embedding, conv filters, classes, Adam's
# rate; its feed's batch and padded length
NETS_VOCAB, NETS_EMB, NETS_FILTERS, NETS_CLASSES = 100, 16, 16, 4
NETS_LR = 0.01
NETS_BS, NETS_LEN = 4, 7


def set_dropout(program, prob):
    """Set every ``dropout`` op of `program` to probability `prob`; call
    it before ``minimize``, whose grad ops copy the forward's attributes.
    The parity runs set 0: the card and the CPU draw different masks."""
    for block in program.blocks:
        for op in block.ops:
            if op.type == "dropout":
                op.attrs["dropout_prob"] = float(prob)


def cnn_logits(model, img, class_dim, layout, **kw):
    """The class logits of `model` (``alexnet``, ``googlenet``, ``vgg`` —
    VGG-19 —, ``vgg16``, ``vgg_cifar`` or ``smallnet``) on `img`."""
    from . import image_models, vgg

    if model == "alexnet":
        return image_models.alexnet(img, class_dim=class_dim, layout=layout)
    if model == "googlenet":
        return image_models.googlenet(img, class_dim=class_dim,
                                      layout=layout)
    if model == "vgg":
        return vgg.vgg19(img, class_dim=class_dim, layout=layout, **kw)
    if model == "vgg16":
        return vgg.vgg16(img, class_dim=class_dim, layout=layout, **kw)
    if model == "vgg_cifar":
        return vgg.vgg_cifar(img, class_dim=class_dim)
    if model == "smallnet":
        return image_models.smallnet_mnist_cifar(img, class_dim=class_dim)
    raise ValueError(f"unknown model {model!r}")


def cnn_train_program(model, image=CNN_IMAGE, class_dim=CNN_CLASSES,
                      dtype=CNN_DTYPE, layout="NHWC", fuse_bn=False,
                      dropout_prob=None, **model_kw):
    """``bench_cnn_train``'s program for `model` in the default programs:
    softmax with cross entropy over the f32 logits → mean, then
    Momentum.  The test-mode clone is taken first, at the model's dropout
    rates; then ``dropout_prob`` (None: the model's rates) sets every
    dropout op, and ``fuse_bn`` runs the fusion pass (NHWC only) before
    the backward.  Returns (loss, test_program)."""
    shape = [image, image, 3] if layout == "NHWC" else [3, image, image]
    img = layers.data(name="image", shape=shape, dtype=dtype)
    label = layers.data(name="label", shape=[1], dtype="int64")
    logits = cnn_logits(model, img, class_dim, layout, **model_kw)
    if dtype in ("bfloat16", "float16"):
        logits = layers.cast(logits, "float32")
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    from ..framework.core import default_main_program

    test_program = default_main_program().clone(for_test=True)
    if dropout_prob is not None:
        set_dropout(default_main_program(), dropout_prob)
    if fuse_bn:
        from ..training_fusion import fuse_bn_matmul

        fuse_bn_matmul()
    optimizer.Momentum(learning_rate=CNN_LR,
                       momentum=CNN_MOMENTUM).minimize(loss)
    return loss, test_program


def cnn_feed(bs=CNN_BS, image=CNN_IMAGE, class_dim=CNN_CLASSES,
             layout="NHWC"):
    """``bench_cnn_train``'s batch from ``RandomState(0)``: images uniform
    in [0, 1) (f32; the executor casts them to the program's dtype) and
    int64 labels."""
    rng = np.random.RandomState(0)
    shape = (image, image, 3) if layout == "NHWC" else (3, image, image)
    return {"image": rng.rand(bs, *shape).astype(np.float32),
            "label": rng.randint(0, class_dim, (bs, 1)).astype(np.int64)}


def unet_train_program(image=UNET_IMAGE, base_ch=UNET_CH,
                       ch_mults=UNET_MULTS):
    """``bench_unet_train``'s program; returns (loss, eps_hat,
    infer_prog) as ``unet.build_ddpm_train_program``."""
    from . import unet

    return unet.build_ddpm_train_program(
        image_size=image, channels=3, base_ch=base_ch, ch_mults=ch_mults,
        learning_rate=UNET_LR)


def unet_feed(bs=UNET_BS, image=UNET_IMAGE, seed=0):
    """``bench_unet_train``'s feed: images uniform in [0, 1), then
    ``ddpm_feed``'s timesteps, noise and coefficients from the same
    ``RandomState``."""
    from . import unet

    rng = np.random.RandomState(seed)
    x0 = rng.rand(bs, 3, image, image).astype(np.float32)
    return unet.ddpm_feed(x0, unet.ddpm_schedule(T=UNET_T), rng)


def deepfm_train_program(num_fields, vocab, embed_dim, hidden,
                         learning_rate):
    """DeepFM's click model: field ids [B, num_fields] int64, click [B, 1]
    f32, mean sigmoid cross entropy, Adam.  Returns (loss, logit)."""
    from . import deepfm

    fields = layers.data(name="fields", shape=[num_fields], dtype="int64")
    click = layers.data(name="click", shape=[1], dtype="float32")
    logit = deepfm.deepfm(fields, num_fields=num_fields, vocab_size=vocab,
                          embed_dim=embed_dim, hidden_sizes=tuple(hidden))
    loss = layers.mean(layers.sigmoid_cross_entropy_with_logits(logit,
                                                                click))
    optimizer.Adam(learning_rate=learning_rate).minimize(loss)
    return loss, logit


def deepfm_feed(rows, num_fields, vocab):
    """Ids uniform over the vocabulary from ``RandomState(0)``; the
    click is the parity of the row's id sum, as the JAX package's CTR
    test makes it."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, vocab, (rows, num_fields)).astype(np.int64)
    click = (ids.sum(1) % 2).astype(np.float32).reshape(-1, 1)
    return {"fields": ids, "click": click}


def nets_train_program():
    """A small classifier over ragged word ids through the ``nets``
    presets: ``sequence_conv_pool`` (tanh, max) and
    ``dot_product_attention`` of three per-step projections (averaged
    over time) side by side, an fc to 2 x NETS_CLASSES and ``glu`` to the
    logits; softmax with cross entropy → mean, Adam.  Returns the
    loss."""
    from .. import nets

    words = layers.sequence_data(name="words", shape=[1], dtype="int64")
    label = layers.data(name="label", shape=[1], dtype="int64")
    x = layers.sequence_embedding(words, size=[NETS_VOCAB, NETS_EMB])
    pooled = nets.sequence_conv_pool(x, num_filters=NETS_FILTERS,
                                     filter_size=3, act="tanh",
                                     pool_type="max")
    q, k, v = (layers.fc(x, size=NETS_EMB, num_flatten_dims=2)
               for _ in range(3))
    context, _ = nets.dot_product_attention(q, k, v)
    att = layers.reshape(layers.reduce_mean(context, dim=1), [-1, NETS_EMB])
    hidden = layers.fc(layers.concat([pooled, att], axis=1),
                       size=2 * NETS_CLASSES)
    logits = layers.reshape(nets.glu(hidden, dim=-1), [-1, NETS_CLASSES])
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    optimizer.Adam(learning_rate=NETS_LR).minimize(loss)
    return loss


def nets_feed():
    """Padded ids [NETS_BS, NETS_LEN, 1] from ``RandomState(0)`` with
    ragged lengths (one row full, one of length 1) and their
    ``words@LENGTH``, labels from the same ``RandomState``."""
    rng = np.random.RandomState(0)
    lengths = np.array([NETS_LEN, 1]
                       + list(rng.randint(2, NETS_LEN, NETS_BS - 2)),
                       np.int32)
    ids = rng.randint(0, NETS_VOCAB, (NETS_BS, NETS_LEN, 1)).astype(np.int64)
    ids[np.arange(NETS_LEN)[None, :] >= lengths[:, None]] = 0
    return {"words": ids, "words@LENGTH": lengths,
            "label": rng.randint(0, NETS_CLASSES,
                                 (NETS_BS, 1)).astype(np.int64)}
