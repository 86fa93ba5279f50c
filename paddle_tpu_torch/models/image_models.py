"""The benchmark models of ``paddle_tpu/models/image_models.py``:
``alexnet``, ``googlenet`` and ``smallnet_mnist_cifar`` (NCHW or NHWC,
``bench.py``'s ``bench_cnn_train`` runs NHWC), and the stacked-LSTM text
classifier of the repository's RNN benchmark."""

from __future__ import annotations

from .. import layers


def alexnet(input, class_dim=1000, layout="NCHW"):
    """AlexNet as the reference benchmark builds it: five convolutions
    (11x11/4, 5x5, three 3x3) with three 3x3/2 max pools, then two fc 4096
    behind dropout 0.5 and the class fc.  `layout` is NCHW or NHWC."""
    c1 = layers.conv2d(input, num_filters=64, filter_size=11, stride=4,
                       padding=2, act="relu", data_format=layout)
    p1 = layers.pool2d(c1, pool_size=3, pool_stride=2, pool_type="max",
                       data_format=layout)
    c2 = layers.conv2d(p1, num_filters=192, filter_size=5, padding=2,
                       act="relu", data_format=layout)
    p2 = layers.pool2d(c2, pool_size=3, pool_stride=2, pool_type="max",
                       data_format=layout)
    c3 = layers.conv2d(p2, num_filters=384, filter_size=3, padding=1,
                       act="relu", data_format=layout)
    c4 = layers.conv2d(c3, num_filters=256, filter_size=3, padding=1,
                       act="relu", data_format=layout)
    c5 = layers.conv2d(c4, num_filters=256, filter_size=3, padding=1,
                       act="relu", data_format=layout)
    p5 = layers.pool2d(c5, pool_size=3, pool_stride=2, pool_type="max",
                       data_format=layout)
    d1 = layers.dropout(p5, 0.5)
    f1 = layers.fc(input=d1, size=4096, act="relu")
    d2 = layers.dropout(f1, 0.5)
    f2 = layers.fc(input=d2, size=4096, act="relu")
    return layers.fc(input=f2, size=class_dim)


def _inception(x, nf1, nf3r, nf3, nf5r, nf5, proj, layout="NCHW"):
    """One inception module: 1x1, 1x1 → 3x3, 1x1 → 5x5 and 3x3 max pool →
    1x1 branches concatenated on the channel axis."""
    ch_axis = 3 if layout == "NHWC" else 1
    b1 = layers.conv2d(x, num_filters=nf1, filter_size=1, act="relu",
                       data_format=layout)
    b3 = layers.conv2d(x, num_filters=nf3r, filter_size=1, act="relu",
                       data_format=layout)
    b3 = layers.conv2d(b3, num_filters=nf3, filter_size=3, padding=1,
                       act="relu", data_format=layout)
    b5 = layers.conv2d(x, num_filters=nf5r, filter_size=1, act="relu",
                       data_format=layout)
    b5 = layers.conv2d(b5, num_filters=nf5, filter_size=5, padding=2,
                       act="relu", data_format=layout)
    bp = layers.pool2d(x, pool_size=3, pool_stride=1, pool_padding=1,
                       pool_type="max", data_format=layout)
    bp = layers.conv2d(bp, num_filters=proj, filter_size=1, act="relu",
                       data_format=layout)
    return layers.concat([b1, b3, b5, bp], axis=ch_axis)


def googlenet(input, class_dim=1000, layout="NCHW"):
    """GoogLeNet's main tower (no auxiliary heads, as the reference
    benchmark times it): stem, inception 3a-3b, 4a-4e, 5a-5b, a global
    average pool, dropout 0.4 and the class fc."""
    c1 = layers.conv2d(input, num_filters=64, filter_size=7, stride=2,
                       padding=3, act="relu", data_format=layout)
    p1 = layers.pool2d(c1, pool_size=3, pool_stride=2, pool_type="max",
                       data_format=layout)
    c2 = layers.conv2d(p1, num_filters=64, filter_size=1, act="relu",
                       data_format=layout)
    c3 = layers.conv2d(c2, num_filters=192, filter_size=3, padding=1,
                       act="relu", data_format=layout)
    p3 = layers.pool2d(c3, pool_size=3, pool_stride=2, pool_type="max",
                       data_format=layout)
    i3a = _inception(p3, 64, 96, 128, 16, 32, 32, layout)
    i3b = _inception(i3a, 128, 128, 192, 32, 96, 64, layout)
    p4 = layers.pool2d(i3b, pool_size=3, pool_stride=2, pool_type="max",
                       data_format=layout)
    i4a = _inception(p4, 192, 96, 208, 16, 48, 64, layout)
    i4b = _inception(i4a, 160, 112, 224, 24, 64, 64, layout)
    i4c = _inception(i4b, 128, 128, 256, 24, 64, 64, layout)
    i4d = _inception(i4c, 112, 144, 288, 32, 64, 64, layout)
    i4e = _inception(i4d, 256, 160, 320, 32, 128, 128, layout)
    p5 = layers.pool2d(i4e, pool_size=3, pool_stride=2, pool_type="max",
                       data_format=layout)
    i5a = _inception(p5, 256, 160, 320, 32, 128, 128, layout)
    i5b = _inception(i5a, 384, 192, 384, 48, 128, 128, layout)
    gp = layers.pool2d(i5b, pool_size=7, pool_type="avg",
                       global_pooling=True, data_format=layout)
    d = layers.dropout(gp, 0.4)
    return layers.fc(input=d, size=class_dim)


def smallnet_mnist_cifar(input, class_dim=10):
    """The reference benchmark's small 32 x 32 net: three 5x5
    convolutions with 3x3/2 pools (max, avg, avg), fc 64 and the class
    fc."""
    c1 = layers.conv2d(input, num_filters=32, filter_size=5, padding=2,
                       act="relu")
    p1 = layers.pool2d(c1, pool_size=3, pool_stride=2, pool_type="max")
    c2 = layers.conv2d(p1, num_filters=32, filter_size=5, padding=2,
                       act="relu")
    p2 = layers.pool2d(c2, pool_size=3, pool_stride=2, pool_type="avg")
    c3 = layers.conv2d(p2, num_filters=64, filter_size=5, padding=2,
                       act="relu")
    p3 = layers.pool2d(c3, pool_size=3, pool_stride=2, pool_type="avg")
    f1 = layers.fc(input=p3, size=64, act="relu")
    return layers.fc(input=f1, size=class_dim)



def stacked_lstm_net(seq_input, hidden_dim=512, stacked_num=2, class_dim=2):
    """Stacked LSTM text classifier: per layer a per-step fc to 4H and a
    ``dynamic_lstm`` (odd layers run reversed), then a max pool over time
    and an fc to the classes."""
    inp = seq_input
    for i in range(stacked_num):
        proj = layers.sequence_fc(inp, size=hidden_dim * 4)
        hidden, _ = layers.dynamic_lstm(proj, size=hidden_dim * 4,
                                        is_reverse=(i % 2 == 1))
        inp = hidden
    pooled = layers.sequence_pool(inp, pool_type="max")
    return layers.fc(input=pooled, size=class_dim)
