"""The model zoo (``models/image_models.py``, ``vgg.py``, ``unet.py``,
``deepfm.py``, ``standing.py``, ``models/zoo_bench.py``) against the JAX
package on the CPU.

- Each model builds the JAX package's program: main and startup
  ``to_json`` equal letter for letter, both layouts where the model has
  two, a small classifier through ``nets.sequence_conv_pool``,
  ``dot_product_attention`` and ``glu`` (``zoo_bench.nets_train_program``), the U-Net's pre-minimize test-mode clone included, and VGG-19's
  NHWC desc through ``fuse_bn_matmul``: the same 11 of its 16
  convolutions fused (those reading ``relu(batch_norm(·))``).
- Training: each program built in both packages, the JAX startup's
  values carried into the port by name, 3 steps on the same feed, every
  dropout op at probability 0 in both descs (torch cannot draw JAX's
  masks): losses within 1e-4 relative, step-1 gradients of the first,
  a middle and the last parameter within 1e-3 of their max |g|; before
  them, the test-mode clones (taken before the dropout rates were
  zeroed, so they scale by 1 − p) on the carried state within 1e-5 of
  their max |value|.
  The VGG models normalize every convolution, and a chain of 8 to 16
  BatchNorms makes their f32 step ill-conditioned: from one state the
  f32 first-filter gradient of either package lies 1e-4 to 2e-2 from a
  float64 step's, at 32 and 64 px alike (the ResNet-50 finding of
  ``tests/test_torch_resnet.py``).  They are held in float64 (3 steps,
  the same tolerances; VGG-19 fused in the port against the unfused JAX
  program), and in f32 by their step 1: the loss and the class fc's
  gradient as above, all gradients together no further (in norm) from
  the JAX float64 ones than twice the JAX f32 ones.
- The U-Net samplers (``ddim_sample``, ``ddpm_sample``, 3 steps of the
  1000-step schedule) on the carried state from one numpy seed: within
  1e-4 of max |x|.  (After three Adam steps the two packages' weights
  part by Adam's amplification of 1e-7 gradient differences, and the
  first DDIM step divides by sqrt(ᾱ_999) = 6e-3: 2.4e-4 of max |x|.)
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import training_fusion as jfusion
from paddle_tpu.models import deepfm as jdeepfm
from paddle_tpu.models import image_models as jimage
from paddle_tpu.models import standing as jstanding
from paddle_tpu.models import unet as junet
from paddle_tpu.models import vgg as jvgg
from paddle_tpu_torch import training_fusion as tfusion
from paddle_tpu_torch.models import deepfm as tdeepfm
from paddle_tpu_torch.models import image_models as timage
from paddle_tpu_torch.models import standing as tstanding
from paddle_tpu_torch.models import unet as tunet
from paddle_tpu_torch.models import vgg as tvgg
from paddle_tpu_torch.models import zoo_bench as zb

PKG = {"jax": (jfluid, jimage, jvgg, junet, jdeepfm, jfusion),
       "port": (tfluid, timage, tvgg, tunet, tdeepfm, tfusion)}


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    jfluid.reset()
    yield


# -- programs, the same code for both packages ----------------------------------

def _cnn(pkg, model, image, layout, dtype="float32", fuse=False,
         dropout=0.0, **kw):
    """zoo_bench.cnn_train_program's program (class_dim 10) built through
    `pkg`'s public API; returns (loss, test-mode clone)."""
    f, im, vg, _, _, fusion = PKG[pkg]
    shape = [image, image, 3] if layout == "NHWC" else [3, image, image]
    img = f.layers.data(name="image", shape=shape, dtype=dtype)
    label = f.layers.data(name="label", shape=[1], dtype="int64")
    if model in ("alexnet", "googlenet"):
        logits = getattr(im, model)(img, class_dim=10, layout=layout)
    elif model == "smallnet":
        logits = im.smallnet_mnist_cifar(img, class_dim=10)
    elif model == "vgg_cifar":
        logits = vg.vgg_cifar(img, class_dim=10)
    else:
        logits = getattr(vg, {"vgg": "vgg19"}.get(model, model))(
            img, class_dim=10, layout=layout, **kw)
    if dtype == "bfloat16":
        logits = f.layers.cast(logits, "float32")
    loss = f.layers.mean(f.layers.softmax_with_cross_entropy(logits, label))
    test = f.default_main_program().clone(for_test=True)
    if dropout is not None:
        zb.set_dropout(f.default_main_program(), dropout)
    if fuse:
        fusion.fuse_bn_matmul()
    f.optimizer.Momentum(learning_rate=zb.CNN_LR,
                         momentum=zb.CNN_MOMENTUM).minimize(loss)
    return loss, test


def _unet(pkg, image=16, ch=8):
    return PKG[pkg][3].build_ddpm_train_program(
        image_size=image, channels=3, base_ch=ch, ch_mults=(1, 2))


def _deepfm(pkg, dims=zb.DEEPFM_CTR):
    f, dfm = PKG[pkg][0], PKG[pkg][4]
    nf, vocab, emb, hidden, lr, _ = dims
    fields = f.layers.data(name="fields", shape=[nf], dtype="int64")
    click = f.layers.data(name="click", shape=[1], dtype="float32")
    logit = dfm.deepfm(fields, num_fields=nf, vocab_size=vocab,
                       embed_dim=emb, hidden_sizes=tuple(hidden))
    loss = f.layers.mean(f.layers.sigmoid_cross_entropy_with_logits(logit,
                                                                    click))
    f.optimizer.Adam(learning_rate=lr).minimize(loss)
    return loss, logit


def _nets(pkg):
    """zoo_bench.nets_train_program through `pkg`'s public API."""
    f = PKG[pkg][0]
    L = f.layers
    words = L.sequence_data(name="words", shape=[1], dtype="int64")
    label = L.data(name="label", shape=[1], dtype="int64")
    x = L.sequence_embedding(words, size=[zb.NETS_VOCAB, zb.NETS_EMB])
    pooled = f.nets.sequence_conv_pool(x, num_filters=zb.NETS_FILTERS,
                                       filter_size=3, act="tanh",
                                       pool_type="max")
    q, k, v = (L.fc(x, size=zb.NETS_EMB, num_flatten_dims=2)
               for _ in range(3))
    context, _ = f.nets.dot_product_attention(q, k, v)
    att = L.reshape(L.reduce_mean(context, dim=1), [-1, zb.NETS_EMB])
    hidden = L.fc(L.concat([pooled, att], axis=1), size=2 * zb.NETS_CLASSES)
    logits = L.reshape(f.nets.glu(hidden, dim=-1), [-1, zb.NETS_CLASSES])
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    f.optimizer.Adam(learning_rate=zb.NETS_LR).minimize(loss)
    return loss


# -- programs ----------------------------------------------------------------------

def _zoo(model, layout="NHWC", fuse=False):
    """(port function, JAX function) building the zoo_bench programs."""
    image = 64 if model in ("alexnet", "googlenet") else 32
    kw = {"fc_dim": 64} if model in ("vgg", "vgg16") else {}
    return (lambda: zb.cnn_train_program(model, image=image, class_dim=10,
                                         dtype="bfloat16", layout=layout,
                                         fuse_bn=fuse, **kw),
            lambda: _cnn("jax", model, image, layout, "bfloat16", fuse,
                         dropout=None, **kw))


BUILDS = {
    "alexnet_nhwc": _zoo("alexnet"),
    "alexnet_nchw": _zoo("alexnet", "NCHW"),
    "googlenet_nhwc": _zoo("googlenet"),
    "googlenet_nchw": _zoo("googlenet", "NCHW"),
    "smallnet": _zoo("smallnet", "NCHW"),
    "vgg19_nhwc": _zoo("vgg"),
    "vgg19_nhwc_fused": _zoo("vgg", fuse=True),
    "vgg16_nchw": _zoo("vgg16", "NCHW"),
    "vgg_cifar": _zoo("vgg_cifar", "NCHW"),
    "unet_bench": (lambda: zb.unet_train_program(image=16, base_ch=8),
                   lambda: junet.build_ddpm_train_program(
                       image_size=16, base_ch=8, ch_mults=(1, 2, 4))),
    "nets": (zb.nets_train_program, lambda: _nets("jax")),
    "deepfm_criteo_widths": (
        lambda: zb.deepfm_train_program(*zb.DEEPFM_CRITEO[:5]),
        lambda: _deepfm("jax", zb.DEEPFM_CRITEO)),
    **{f"standing_{n}": (tstanding.get_builder(n),
                         jstanding.get_builder(n))
       for n, _ in tstanding.MODELS},
}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_model_builds_the_jax_program(name):
    t_out = BUILDS[name][0]()
    j_out = BUILDS[name][1]()
    for prog in ("default_main_program", "default_startup_program"):
        t, j = getattr(tfluid, prog)(), getattr(jfluid, prog)()
        assert [op.type for op in t.global_block().ops] == \
            [op.type for op in j.global_block().ops], prog
        assert t.to_json() == j.to_json(), prog
    # the test-mode clones (zoo_bench's CNNs and the U-Net's infer_prog)
    clones = [(a, b) for a, b in zip(t_out, j_out)
              if hasattr(a, "to_json") and hasattr(b, "to_json")] \
        if isinstance(t_out, tuple) else []
    for a, b in clones:
        assert a.to_json() == b.to_json()
    if name.startswith(("alexnet", "googlenet", "vgg", "unet")):
        assert clones
    if name == "nets":
        types = [op.type for op in tfluid.default_main_program()
                 .global_block().ops]
        assert {"sequence_conv", "sequence_pool", "matmul", "split",
                "sigmoid"} <= set(types)


def test_vgg19_fusion_fuses_what_the_jax_pass_fuses():
    fused = {}
    for pkg in ("jax", "port"):
        f = PKG[pkg][0]
        f.reset()
        _cnn(pkg, "vgg", 32, "NHWC", fuse=True, fc_dim=64)
        ops = f.default_main_program().global_block().ops
        fused[pkg] = [op.inputs["Filter"][0] for op in ops
                      if op.type == "bn_act_conv3x3"]
        convs = [op for op in ops if op.type == "conv2d"]
        assert not any(op.type == "bn_act_conv1x1" for op in ops)
        assert len(fused[pkg]) + len(convs) == 16
    assert fused["port"] == fused["jax"]
    assert len(fused["port"]) == 11
    # the first convolution of each of the five groups stays cuDNN's
    assert [op.inputs["Filter"][0] for op in convs] == [
        f"conv2d_{i}.w_0" for i in (0, 2, 4, 8, 12)]


# -- training against JAX -----------------------------------------------------------

def _persistable(program):
    return [n for n, v in program.global_block().vars.items()
            if v.persistable]


def _max_rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _scalar(v):
    return float(np.asarray(v).reshape(-1)[0])


def _twin(build_t, build_j):
    """Both programs in fresh defaults, the JAX startup's values loaded
    into the port.  Returns (port (loss, extra), JAX (loss, extra),
    port executor, JAX executor)."""
    jfluid.reset()
    tfluid.reset()
    j_out = build_j()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    t_out = build_t()
    tfluid.load_persistables(
        tfluid.default_main_program(),
        {n: np.asarray(jfluid.global_scope().find_np(n))
         for n in _persistable(jfluid.default_main_program())})
    return t_out, j_out, tfluid.Executor(tfluid.CPUPlace()), jexe


def _steps(exe, loss, feed, n, grads):
    """`n` steps, each fetching the loss and `grads` (one fetch list: the
    JAX executor compiles a program once per fetch list); returns the
    losses and step 1's gradients."""
    rows = [exe.run(feed=feed, fetch_list=[loss] + grads) for _ in range(n)]
    return [_scalar(r[0]) for r in rows], dict(zip(grads, rows[0][1:]))


def _test_mode_agrees(tag, texe, ttest, jexe, jtest, feed):
    """The test-mode clones' logits on the carried startup state: the
    dropout ops scale by 1 − p, the BatchNorms read the running
    statistics."""
    logits = _logits(ttest)
    (t,) = texe.run(ttest, feed=feed, fetch_list=logits)
    (j,) = jexe.run(jtest, feed=feed, fetch_list=logits)
    assert _max_rel(t, j) <= 1e-5, (tag, _max_rel(t, j))


def _watched(program):
    params = [p.name for p in program.global_block().all_parameters()]
    return [params[0] + "@GRAD", params[len(params) // 2] + "@GRAD",
            params[-1] + "@GRAD"]


def _hold(tag, t_losses, j_losses, t_grads, j_grads):
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(t_losses, j_losses)]
    assert max(loss_rel) <= 1e-4, (tag, t_losses, j_losses)
    for n in j_grads:
        assert _max_rel(t_grads[n], j_grads[n]) <= 1e-3, (
            tag, n, _max_rel(t_grads[n], j_grads[n]))


TRAIN = {  # name: (model, image, batch, layout)
    "smallnet": ("smallnet", 32, 4, "NCHW"),
    "alexnet": ("alexnet", 64, 2, "NHWC"),
    "googlenet": ("googlenet", 64, 2, "NHWC"),
}


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_cnn_trains_as_jax_and_its_test_mode_agrees(name):
    model, image, bs, layout = TRAIN[name]
    (tl, ttest), (jl, jtest), texe, jexe = _twin(
        lambda: _cnn("port", model, image, layout),
        lambda: _cnn("jax", model, image, layout))
    feed = zb.cnn_feed(bs, image, 10, layout)
    _test_mode_agrees(name, texe, ttest, jexe, jtest, feed)
    grads = _watched(tfluid.default_main_program())
    j_losses, j_grads = _steps(jexe, jl, feed, 3, grads)
    t_losses, t_grads = _steps(texe, tl, feed, 3, grads)
    _hold(name, t_losses, j_losses, t_grads, j_grads)


def _logits(program):
    return [op.inputs["Logits"][0] for op in program.global_block().ops
            if op.type == "softmax_with_cross_entropy"]


def test_vgg_cifar_trains_as_jax_in_float64_and_its_f32_step_holds():
    """3 float64 steps against JAX's, then one f32 step from the same
    start: the loss and the class fc's gradient as the other models, all
    gradients together (in norm) no further from JAX's float64 ones than
    twice JAX's f32 ones are."""
    feed = zb.cnn_feed(4, 32, 10, "NCHW")
    runs = {}
    for dtype in ("float64", "float32"):
        (tl, ttest), (jl, jtest), texe, jexe = _twin(
            lambda: _cnn("port", "vgg_cifar", 32, "NCHW", dtype),
            lambda: _cnn("jax", "vgg_cifar", 32, "NCHW", dtype))
        names = sorted(p.name + "@GRAD" for p in
                       tfluid.default_main_program().global_block()
                       .all_parameters())
        f = dict(feed, image=feed["image"].astype(dtype))
        n = 3 if dtype == "float64" else 1
        if dtype == "float64":
            _test_mode_agrees("vgg_cifar", texe, ttest, jexe, jtest, f)
        runs[dtype] = {"jax": _steps(jexe, jl, f, n, names),
                       "port": _steps(texe, tl, f, n, names)}
    watched = _watched(tfluid.default_main_program())
    fc = max(n for n in names if n.startswith("fc_") and ".w_" in n)
    t64, j64 = runs["float64"]["port"], runs["float64"]["jax"]
    _hold("vgg_cifar float64", t64[0], j64[0],
          {n: t64[1][n] for n in watched}, {n: j64[1][n] for n in watched})
    t32, j32 = runs["float32"]["port"], runs["float32"]["jax"]
    _hold("vgg_cifar f32 step 1", t32[0], j32[0], {fc: t32[1][fc]},
          {fc: j32[1][fc]})

    def norm_rel(g):
        num = sum(float(((np.asarray(g[n], np.float64) - j64[1][n]) ** 2)
                        .sum()) for n in names)
        return (num / sum(float((j64[1][n] ** 2).sum())
                          for n in names)) ** 0.5

    assert norm_rel(t32[1]) <= 2 * norm_rel(j32[1]), (
        norm_rel(t32[1]), norm_rel(j32[1]))


def test_fused_vgg19_trains_as_unfused_jax_in_float64():
    (tl, _), (jl, _), texe, jexe = _twin(
        lambda: _cnn("port", "vgg", 32, "NHWC", "float64", True, fc_dim=16),
        lambda: _cnn("jax", "vgg", 32, "NHWC", "float64", fc_dim=16))
    assert [op.type for op in tfluid.default_main_program().global_block()
            .ops].count("bn_act_conv3x3") == 11
    feed = zb.cnn_feed(2, 32, 10, "NHWC")
    feed["image"] = feed["image"].astype(np.float64)
    grads = _watched(tfluid.default_main_program())
    j_losses, j_grads = _steps(jexe, jl, feed, 3, grads)
    t_losses, t_grads = _steps(texe, tl, feed, 3, grads)
    _hold("vgg19 fused", t_losses, j_losses, t_grads, j_grads)


def test_unet_samples_and_trains_as_jax():
    (tl, teps, tinf), (jl, jeps, jinf), texe, jexe = _twin(
        lambda: _unet("port"), lambda: _unet("jax"))
    sched = tunet.ddpm_schedule(T=1000)
    for name in ("ddim_sample", "ddpm_sample"):
        j = getattr(junet, name)(jexe, jinf, jeps, sched, (2, 3, 16, 16),
                                 np.random.RandomState(5), steps=3)
        t = getattr(tunet, name)(texe, tinf, teps, sched, (2, 3, 16, 16),
                                 np.random.RandomState(5), steps=3)
        assert t.dtype == np.float32 and np.isfinite(t).all()
        assert _max_rel(t, j) <= 1e-4, (name, _max_rel(t, j))
    feed = zb.unet_feed(4, 16)
    grads = _watched(tfluid.default_main_program())
    j_losses, j_grads = _steps(jexe, jl, feed, 3, grads)
    t_losses, t_grads = _steps(texe, tl, feed, 3, grads)
    _hold("unet", t_losses, j_losses, t_grads, j_grads)
    assert {k: v.tolist() for k, v in tunet.ddpm_schedule(T=50).items()
            if k != "T"} == {k: v.tolist() for k, v in
                             junet.ddpm_schedule(T=50).items() if k != "T"}
    jf = junet.ddpm_feed(np.ones((2, 3, 4, 4), np.float32), sched,
                         np.random.RandomState(1))
    tf = tunet.ddpm_feed(np.ones((2, 3, 4, 4), np.float32), sched,
                         np.random.RandomState(1))
    for k in jf:
        np.testing.assert_array_equal(tf[k], jf[k])


def test_deepfm_trains_as_jax():
    (tl, _), (jl, _), texe, jexe = _twin(lambda: _deepfm("port"),
                                         lambda: _deepfm("jax"))
    nf, vocab = zb.DEEPFM_CTR[:2]
    feed = zb.deepfm_feed(zb.DEEPFM_CTR[5], nf, vocab)
    grads = ["deepfm.w1@GRAD", "deepfm.emb@GRAD",
             _watched(tfluid.default_main_program())[-1]]
    j_losses, j_grads = _steps(jexe, jl, feed, 3, grads)
    t_losses, t_grads = _steps(texe, tl, feed, 3, grads)
    _hold("deepfm", t_losses, j_losses, t_grads, j_grads)
    lookups = [op for op in tfluid.default_main_program().global_block().ops
               if op.type == "lookup_table"]
    assert [op.attrs["is_sparse"] for op in lookups] == [True, True]


def test_nets_program_trains_as_jax():
    tl, jl, texe, jexe = _twin(lambda: _nets("port"), lambda: _nets("jax"))
    feed = zb.nets_feed()
    # the embedding, the sequence_conv filter, the query projection and
    # the fc to the gates (the key projection's bias has no gradient: softmax
    # ignores a shift of a query's row of scores)
    grads = [n + "@GRAD" for n in ("embedding_0.w_0", "sequence_conv_0.w_0",
                                   "fc_0.w_0", "fc_3.w_0")]
    j_losses, j_grads = _steps(jexe, jl, feed, 3, grads)
    t_losses, t_grads = _steps(texe, tl, feed, 3, grads)
    _hold("nets", t_losses, j_losses, t_grads, j_grads)


@pytest.mark.parametrize("name", [n for n, _ in tstanding.MODELS])
def test_standing_program_trains_as_jax(name):
    holder = {}

    def build(make, key):
        def run():
            holder[key] = make()
            return holder[key]
        return run

    _, _, texe, jexe = _twin(build(tstanding.get_builder(name), "port"),
                             build(jstanding.get_builder(name), "jax"))
    feed, (tl,), _ = holder["port"]
    _, (jl,), _ = holder["jax"]
    grads = _watched(tfluid.default_main_program())
    j_losses, j_grads = _steps(jexe, jl, feed, 2, grads)
    t_losses, t_grads = _steps(texe, tl, feed, 2, grads)
    _hold(name, t_losses, j_losses, t_grads, j_grads)

