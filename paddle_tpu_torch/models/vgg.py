"""VGG, the port of ``paddle_tpu/models/vgg.py``: ``vgg16``, ``vgg19``
(``bench.py``'s ``bench_cnn_train`` VGG) and the book's 32 x 32
``vgg_cifar``.  Each convolution is followed by ``batch_norm(act="relu")``
(``nets.img_conv_group``), so in NHWC every 3x3 that reads such an output
is one that ``training_fusion.fuse_bn_matmul`` fuses."""

from __future__ import annotations

from .. import layers, nets


def vgg16(input, class_dim=1000, dropout_prob=0.5, fc_dim=4096,
          layout="NCHW"):
    """Full VGG-16 (conv batches 2-2-3-3-3 + two fc4096)."""

    def group(x, nf, n):
        return nets.img_conv_group(
            x, conv_num_filter=[nf] * n, conv_filter_size=3,
            conv_act="relu", conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=0.0, pool_size=2, pool_stride=2,
            data_format=layout)

    c1 = group(input, 64, 2)
    c2 = group(c1, 128, 2)
    c3 = group(c2, 256, 3)
    c4 = group(c3, 512, 3)
    c5 = group(c4, 512, 3)
    d1 = layers.dropout(c5, dropout_prob)
    f1 = layers.fc(input=d1, size=fc_dim, act=None)
    b1 = layers.batch_norm(input=f1, act="relu")
    d2 = layers.dropout(b1, dropout_prob)
    f2 = layers.fc(input=d2, size=fc_dim, act="relu")
    return layers.fc(input=f2, size=class_dim)


def vgg19(input, class_dim=1000, dropout_prob=0.5, fc_dim=4096,
          layout="NCHW"):
    """VGG-19 (conv batches 2-2-4-4-4 + two fc4096)."""

    def group(x, nf, n):
        return nets.img_conv_group(
            x, conv_num_filter=[nf] * n, conv_filter_size=3,
            conv_act="relu", conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=0.0, pool_size=2, pool_stride=2,
            data_format=layout)

    c1 = group(input, 64, 2)
    c2 = group(c1, 128, 2)
    c3 = group(c2, 256, 4)
    c4 = group(c3, 512, 4)
    c5 = group(c4, 512, 4)
    d1 = layers.dropout(c5, dropout_prob)
    f1 = layers.fc(input=d1, size=fc_dim, act=None)
    b1 = layers.batch_norm(input=f1, act="relu")
    d2 = layers.dropout(b1, dropout_prob)
    f2 = layers.fc(input=d2, size=fc_dim, act="relu")
    return layers.fc(input=f2, size=class_dim)


def vgg_cifar(input, class_dim=10):
    """The book image_classification VGG for 32x32 inputs."""

    def group(x, nf, n, drop):
        return nets.img_conv_group(
            x, conv_num_filter=[nf] * n, conv_filter_size=3,
            conv_act="relu", conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=drop, pool_size=2, pool_stride=2)

    c1 = group(input, 64, 2, 0.3)
    c2 = group(c1, 128, 2, 0.4)
    c3 = group(c2, 256, 3, 0.4)
    d = layers.dropout(c3, 0.5)
    f1 = layers.fc(input=d, size=512, act=None)
    bn = layers.batch_norm(input=f1, act="relu")
    d2 = layers.dropout(bn, 0.5)
    f2 = layers.fc(input=d2, size=512, act="relu")
    return layers.fc(input=f2, size=class_dim)
