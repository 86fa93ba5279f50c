"""ResNet for ImageNet-scale image classification, built on the layers
API: the port of ``paddle_tpu/models/resnet.py`` (the reference
benchmark/paddle/image/resnet.py topology, depths 18/34/50/101/152).

``layout="NHWC"`` keeps activations channels-last end to end (filters
stay OIHW); with ``fuse_bn`` the training program's BatchNorm(+residual)
+ReLU -> conv chains become the fused ops of ``training_fusion.py``, which
run on the hand-written kernels K11-K15.  ``remat=True`` builds every
residual block inside ``layers.recompute``, fused or not: the fusion pass
walks the sub-blocks too."""

from __future__ import annotations

import contextlib

from .. import layers


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu",
                  layout="NCHW"):
    conv = layers.conv2d(
        input=input,
        num_filters=ch_out,
        filter_size=filter_size,
        stride=stride,
        padding=padding,
        act=None,
        bias_attr=False,
        data_format=layout,
    )
    return layers.batch_norm(input=conv, act=act, data_layout=layout)


def shortcut(input, ch_in, ch_out, stride, layout="NCHW"):
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, 0, act=None,
                             layout=layout)
    return input


def basicblock(input, ch_in, ch_out, stride, layout="NCHW"):
    short = shortcut(input, ch_in, ch_out, stride, layout=layout)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, layout=layout)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None, layout=layout)
    return layers.elementwise_add(x=short, y=conv2, act="relu")


def bottleneck(input, ch_in, ch_out, stride, layout="NCHW"):
    short = shortcut(input, ch_in, ch_out * 4, stride, layout=layout)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0, layout=layout)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, layout=layout)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None, layout=layout)
    return layers.elementwise_add(x=short, y=conv3, act="relu")


def layer_warp(block_func, input, ch_in, ch_out, count, stride,
               layout="NCHW", remat=False):
    """`remat=True` wraps every residual block in ``layers.recompute()``:
    its activations are recomputed in the backward instead of kept."""
    def scope():
        return layers.recompute() if remat else contextlib.nullcontext()

    with scope():
        res = block_func(input, ch_in, ch_out, stride, layout=layout)
    for _ in range(1, count):
        ch_in_cur = ch_out * (4 if block_func is bottleneck else 1)
        with scope():
            res = block_func(res, ch_in_cur, ch_out, 1, layout=layout)
    return res


_DEPTH_CFG = {
    50: (bottleneck, [3, 4, 6, 3]),
    101: (bottleneck, [3, 4, 23, 3]),
    152: (bottleneck, [3, 8, 36, 3]),
    18: (basicblock, [2, 2, 2, 2]),
    34: (basicblock, [3, 4, 6, 3]),
}


def resnet_imagenet(input, class_dim=1000, depth=50, layout="NCHW",
                    remat=False):
    """Reference resnet.py ImageNet topology (224x224)."""
    block, counts = _DEPTH_CFG[depth]
    expansion = 4 if block is bottleneck else 1
    conv1 = conv_bn_layer(input, ch_out=64, filter_size=7, stride=2,
                          padding=3, layout=layout)
    pool1 = layers.pool2d(input=conv1, pool_size=3, pool_stride=2,
                          pool_padding=1, pool_type="max",
                          data_format=layout)
    res1 = layer_warp(block, pool1, 64, 64, counts[0], 1, layout=layout,
                      remat=remat)
    res2 = layer_warp(block, res1, 64 * expansion, 128, counts[1], 2,
                      layout=layout, remat=remat)
    res3 = layer_warp(block, res2, 128 * expansion, 256, counts[2], 2,
                      layout=layout, remat=remat)
    res4 = layer_warp(block, res3, 256 * expansion, 512, counts[3], 2,
                      layout=layout, remat=remat)
    pool2 = layers.pool2d(input=res4, pool_size=7, pool_type="avg",
                          global_pooling=True, data_format=layout)
    return layers.fc(input=pool2, size=class_dim)


def resnet_cifar10(input, class_dim=10, depth=32, layout="NCHW"):
    """Reference resnet.py cifar topology (32x32)."""
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input, ch_out=16, filter_size=3, stride=1,
                          padding=1, layout=layout)
    res1 = layer_warp(basicblock, conv1, 16, 16, n, 1, layout=layout)
    res2 = layer_warp(basicblock, res1, 16, 32, n, 2, layout=layout)
    res3 = layer_warp(basicblock, res2, 32, 64, n, 2, layout=layout)
    pool = layers.pool2d(input=res3, pool_size=8, pool_type="avg",
                         global_pooling=True, data_format=layout)
    return layers.fc(input=pool, size=class_dim)


def build_train_program(batch_size=64, depth=50, class_dim=1000,
                        image_shape=(3, 224, 224), dtype="float32",
                        learning_rate=0.1, momentum=0.9, layout="NCHW",
                        remat=False, fuse_bn=False):
    """Full training program: returns (avg_cost, accuracy).

    With dtype='bfloat16' the convolutions and the fc run in bf16 and the
    softmax/loss head in float32.  With layout='NHWC' the 'image' feed is
    channels-last ([H, W, C]).  ``fuse_bn=True`` runs the fusion pass,
    which is NHWC-only (the JAX function's ``fuse_bn=None``, which reads
    PADDLE_TPU_FUSE_BN_MM, is not ported: pass the choice).
    ``remat=True`` checkpoints every residual block (see layer_warp)."""
    import paddle_tpu_torch as fluid

    # image_shape is always the reference's CHW spec; NHWC transposes the
    # feed contract to HWC
    shape = list(image_shape)
    if layout == "NHWC":
        shape = [shape[1], shape[2], shape[0]]
    img = layers.data(name="image", shape=shape, dtype=dtype)
    label = layers.data(name="label", shape=[1], dtype="int64")
    logits = resnet_imagenet(img, class_dim=class_dim, depth=depth,
                             layout=layout, remat=remat)
    logits32 = layers.cast(logits, "float32") if dtype != "float32" else logits
    loss = layers.softmax_with_cross_entropy(logits32, label)
    avg_cost = layers.mean(loss)
    prob = layers.softmax(logits32)
    acc = layers.accuracy(input=prob, label=label)
    if fuse_bn and layout != "NHWC":
        import warnings

        warnings.warn("fuse_bn requested but layout is NCHW: the fusion "
                      "pass is NHWC-only, training proceeds UNFUSED")
    if fuse_bn and layout == "NHWC":
        from ..training_fusion import fuse_bn_matmul

        fuse_bn_matmul(fluid.default_main_program())
    opt = fluid.optimizer.Momentum(learning_rate=learning_rate,
                                   momentum=momentum)
    opt.minimize(avg_cost)
    return avg_cost, acc
