"""The port's ResNet slice against the JAX package on the CPU.

- (a) the plain versions of K11-K15 (``bn_matmul_*_ref``,
  ``bn_conv3x3_*_ref``) and ``BNMatmulTrain`` / ``BNConv3x3Train`` on CPU
  tensors against the Pallas kernels in interpret mode, at the JAX tests'
  shapes, forward and every gradient including dmean and dvar;
- (b) the same plain versions against the JAX ``*_reference`` functions
  and their autodiff at shapes the Pallas kernels refuse (K = 64, O = 96,
  H = W = 7 at stride 2) and at a border case whose mean and beta lie far
  from 0;
- (c) every op the slice adds, forward and ``generic_grad``, against the
  JAX emitters;
- (d) the programs: the fusion pass's counts, the descs op for op with
  and without fusion, the fused program equal to the unfused one in
  float64, three Momentum steps of the fused ResNet-18 (f32) and
  ResNet-50 (f32 and float64, each held to the JAX float64 run) from the
  JAX startup's state, and the executor's dead-op skipping.

Inputs come from numpy seeds and go through both packages.  On the CPU
the JAX fused emitters take their jnp reference path (the Pallas dispatch
is TPU-only) and the port's wrappers take the kernels' plain versions.
The CUDA kernels themselves are held to their plain versions on a card by
``tests/test_torch_kernels.py`` (``-k on_card``) and ``chip_smoke.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.ops import registry as jreg
from paddle_tpu.ops.pallas_kernels import bn_conv as jbc
from paddle_tpu.ops.pallas_kernels import bn_matmul as jbm
from paddle_tpu_torch.autotune import knobs
from paddle_tpu_torch.framework import executor as texecutor
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models import resnet_bench
from paddle_tpu_torch.ops import registry as treg
from paddle_tpu_torch.ops.cuda_kernels import bn_conv as tbc
from paddle_tpu_torch.ops.cuda_kernels import bn_matmul as tbm
from paddle_tpu_torch.training_fusion import fuse_bn_matmul

# gradients relative to each tensor's max |g|: f32 in two frameworks, the
# JAX tests' own bound for the Pallas kernels against their reference
GRAD_TOL = 2e-5
NAMES = ("x", "gamma", "beta", "mean", "var", "w", "r")


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    yield


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _bn_inputs(xshape, O, ksize, has_r, seed=0, border=False):
    """x, gamma, beta, mean, var, w (OIHW), r, dO as numpy f32."""
    rng = np.random.RandomState(seed)
    K = xshape[-1]
    x = rng.randn(*xshape).astype(np.float32)
    w = (rng.randn(O, K, ksize, ksize) * 0.05).astype(np.float32)
    g = (rng.rand(K) + 0.5).astype(np.float32)
    b = (rng.randn(K) + (5.0 if border else 0.0)).astype(np.float32)
    mu = (rng.randn(K) * 0.1 + (3.0 if border else 0.0)).astype(np.float32)
    var = (rng.rand(K) + 0.5).astype(np.float32)
    r = rng.randn(*xshape).astype(np.float32) if has_r else None
    return x, g, b, mu, var, w, r, rng


def _torch_grads(fn, args, ct):
    """The output and every input's gradient of a torch function on CPU
    tensors made from numpy `args` (None stays None)."""
    leaves = [None if a is None else torch.from_numpy(a).requires_grad_(True)
              for a in args]
    out = fn(*leaves)
    live = [t for t in leaves if t is not None]
    grads = torch.autograd.grad(out, live, torch.from_numpy(ct))
    return out, grads


def _jax_grads(fn, args, ct):
    live = [jnp.asarray(a) for a in args if a is not None]
    out = fn(*live)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a) * ct),
                     argnums=tuple(range(len(live))))(*live)
    return out, grads


def _check(tag, t_out, j_out, t_grads, j_grads, names, out_tol=2e-5):
    assert _rel(t_out, j_out) <= out_tol, (tag, "out", _rel(t_out, j_out))
    assert len(t_grads) == len(j_grads)
    for name, t, j in zip(names, t_grads, j_grads):
        assert _np(t).shape == _np(j).shape, (tag, name)
        assert _rel(t, j) <= GRAD_TOL, (tag, name, _rel(t, j))


# -- (a) the plain versions against the Pallas kernels in interpret mode ----

@pytest.mark.parametrize("act,has_r", [("relu", False), (None, False),
                                       ("relu", True), (None, True)])
def test_bn_matmul_plain_matches_pallas_interpret(act, has_r):
    """K11/K12 at the JAX test's shape (M 64, K 128, N 256): the plain
    forward and backward, and ``BNMatmulTrain`` through autograd."""
    x, g, b, mu, var, w, r, rng = _bn_inputs((64, 128), 256, 1, has_r)
    w2 = np.ascontiguousarray(w.reshape(256, 128).T)
    ct = rng.randn(64, 256).astype(np.float32)
    args = (x, g, b, mu, var, w2, r)
    f = jbm.make_bn_matmul_train(act=act, has_residual=has_r,
                                 interpret=True)
    j_out, j_grads = _jax_grads(f, args, ct)
    names = NAMES[:6] + (("r",) if has_r else ())
    t_out, t_grads = _torch_grads(
        lambda *a: tbm.BNMatmulTrain.apply(*a[:6], a[6] if has_r else None,
                                           act, 1e-5), args, ct)
    _check("train", t_out, j_out, t_grads, j_grads, names)
    tt = [None if a is None else torch.from_numpy(a) for a in args]
    plain = tbm.bn_matmul_bwd_ref(*tt[:6], torch.from_numpy(ct), tt[6], act)
    _check("plain", tbm.bn_matmul_fwd_ref(*tt[:6], tt[6], act), j_out,
           plain, j_grads, names)


_CONV_CASES = [("relu", False, 1), (None, False, 1), ("relu", True, 1),
               (None, True, 1), ("relu", False, 2), ("relu", True, 2)]


@pytest.mark.parametrize("act,has_r,stride", _CONV_CASES)
def test_bn_conv3x3_plain_matches_pallas_interpret(act, has_r, stride):
    """K13/K15 at the JAX test's shape (N 2, H = W = 6, K = O = 128): the
    plain forward and backward, and ``BNConv3x3Train`` (HWIO weights)
    through autograd."""
    x, g, b, mu, var, w, r, rng = _bn_inputs((2, 6, 6, 128), 128, 3, has_r)
    wh = np.ascontiguousarray(w.transpose(2, 3, 1, 0))
    ct = rng.randn(2, 6 // stride, 6 // stride, 128).astype(np.float32)
    args = (x, g, b, mu, var, wh, r)
    f = jbc.make_bn_conv3x3_train(act=act, has_residual=has_r,
                                  stride=stride, interpret=True)
    j_out, j_grads = _jax_grads(f, args, ct)
    names = NAMES[:6] + (("r",) if has_r else ())
    t_out, t_grads = _torch_grads(
        lambda *a: tbc.BNConv3x3Train.apply(*a[:6], a[6] if has_r else None,
                                            act, 1e-5, stride, "v1"),
        args, ct)
    _check("train", t_out, j_out, t_grads, j_grads, names)
    tt = [None if a is None else torch.from_numpy(a) for a in args]
    plain = tbc.bn_conv3x3_bwd_ref(*tt[:6], torch.from_numpy(ct), tt[6], act,
                                   stride=stride)
    _check("plain", tbc.bn_conv3x3_fwd_ref(*tt[:6], tt[6], act,
                                           stride=stride),
           j_out, plain, j_grads, names)


@pytest.mark.parametrize("stride,has_r", [(1, False), (2, True)])
def test_bn_conv3x3_v2_plain_matches_pallas_interpret(stride, has_r,
                                                      monkeypatch):
    """K14 (the O-blocked forward) at the JAX test's shape (N 2, H = W = 8,
    K 128, O 256), the Pallas kernel with its default O block and with 128
    forced (the JAX package's override), and the port's O-block rule equal
    to the JAX one."""
    x, g, b, mu, var, w, r, _ = _bn_inputs((2, 8, 8, 128), 256, 3, has_r,
                                           seed=1)
    wh = np.ascontiguousarray(w.transpose(2, 3, 1, 0))
    args = (x, g, b, mu, var, wh)
    tt = [torch.from_numpy(a) for a in args]
    tr = None if r is None else torch.from_numpy(r)
    for bo in ("", "128"):  # the JAX package's O-block override
        monkeypatch.setenv("PADDLE_TPU_BNCONV_BO", bo)
        want = jbc.bn_conv3x3_fwd_v2(*(jnp.asarray(a) for a in args),
                                     r=None if r is None else jnp.asarray(r),
                                     stride=stride, interpret=True)
        got = tbc.bn_conv3x3_fwd_v2(*tt, tr, "relu", stride=stride)
        assert _rel(got, want) <= 2e-5, bo
    monkeypatch.setenv("PADDLE_TPU_BNCONV_BO", "")
    assert [tbc._v2_block_o(o) for o in (64, 96, 128, 256, 512, 2048)] == \
        [jbc._v2_block_o(o) for o in (64, 96, 128, 256, 512, 2048)] == \
        [64, 96, 128, 128, 256, 256]


# -- (b) against the JAX references where the Pallas kernels refuse --------

@pytest.mark.parametrize("shape,O,has_r,border", [
    ((40, 64), 96, True, False),       # K = 64, N = 96: no lane tiling
    ((64, 128), 128, False, True),     # mean and beta far from 0
])
def test_bn_matmul_plain_matches_jax_reference(shape, O, has_r, border):
    x, g, b, mu, var, w, r, rng = _bn_inputs(shape, O, 1, has_r, seed=2,
                                             border=border)
    w2 = np.ascontiguousarray(w.reshape(O, shape[1]).T)
    ct = rng.randn(shape[0], O).astype(np.float32)
    args = (x, g, b, mu, var, w2, r)

    def ref(*a):
        return jbm.bn_matmul_reference(*a[:6], r=a[6] if has_r else None)

    j_out, j_grads = _jax_grads(ref, args, ct)
    t_out, t_grads = _torch_grads(
        lambda *a: tbm.BNMatmulTrain.apply(*a[:6], a[6] if has_r else None,
                                           "relu", 1e-5), args, ct)
    _check("ref", t_out, j_out, t_grads, j_grads,
           NAMES[:6] + (("r",) if has_r else ()))


@pytest.mark.parametrize("xshape,O,stride,has_r,border", [
    ((2, 7, 7, 64), 96, 2, True, False),   # K 64, O 96, odd H at stride 2
    ((1, 5, 9, 20), 33, 2, False, False),  # odd everything
    ((2, 6, 6, 64), 64, 1, True, True),    # the border: relu(beta - mu*gi)
    ((2, 6, 6, 64), 64, 1, False, True),
])
def test_bn_conv3x3_plain_matches_jax_reference(xshape, O, stride, has_r,
                                                border):
    """The conv formula Ho = (H - 1)//2 + 1 at odd H, and zero padding of
    the activation (a pad of raw zeros would normalize to relu(beta -
    mean * gi), far from 0 here)."""
    x, g, b, mu, var, w, r, rng = _bn_inputs(xshape, O, 3, has_r, seed=3,
                                             border=border)
    N, H, W, _ = xshape
    ct = rng.randn(N, (H - 1) // stride + 1, (W - 1) // stride + 1,
                   O).astype(np.float32)
    args = (x, g, b, mu, var, w, r)

    def ref(*a):
        return jbc.bn_conv3x3_reference(*a[:6], r=a[6] if has_r else None,
                                        stride=stride)

    j_out, j_grads = _jax_grads(ref, args, ct)
    t_out, t_grads = _torch_grads(
        lambda *a: tbc.BNConv3x3Train.apply(*a[:5], tbc.w_hwio(a[5]),
                                            a[6] if has_r else None, "relu",
                                            1e-5, stride, "v1"), args, ct)
    _check("ref", t_out, j_out, t_grads, j_grads,
           NAMES[:6] + (("r",) if has_r else ()))
    if border:
        # every border pixel of the output differs from a raw-zero pad
        tt = [None if a is None else torch.from_numpy(a) for a in args]
        raw = torch.nn.functional.pad(tt[0], (0, 0, 1, 1, 1, 1))
        rr = None if tt[6] is None else torch.nn.functional.pad(
            tt[6], (0, 0, 1, 1, 1, 1))
        wrong = tbc.bn_conv3x3_fwd_ref(raw, *tt[1:5], tbc.w_hwio(tt[5]), rr,
                                       "relu")[:, 1:-1, 1:-1]
        # the padding is 1: a 3x3 window at pad 1 on the padded input
        # reads one more ring, so only the border rows and columns differ
        assert _rel(wrong[:, 0], j_out[:, 0]) > 1e-2


# -- (c) each new op and its generic_grad ---------------------------------

def _f(rng, *shape, lo=None):
    a = rng.randn(*shape).astype(np.float32)
    return np.abs(a) + lo if lo is not None else a


def _op_cases():
    r = np.random.RandomState(0)
    img = _f(r, 2, 6, 7, 8)            # NHWC
    img_c = _f(r, 2, 8, 6, 7)          # NCHW
    bn_ins = {"Scale": [_f(r, 8, lo=0.5)], "Bias": [_f(r, 8)],
              "Mean": [_f(r, 8)], "Variance": [_f(r, 8, lo=0.5)]}
    fused = {"X": [_f(r, 2, 6, 6, 8)], "Scale": [_f(r, 8, lo=0.5)],
             "Bias": [_f(r, 8)], "SavedMean": [_f(r, 8) * 0.1],
             "SavedVariance": [_f(r, 8, lo=0.5)]}
    res = _f(r, 2, 6, 6, 8)
    mom = {"Param": [_f(r, 3, 4)], "Grad": [_f(r, 3, 4)],
           "Velocity": [_f(r, 3, 4)],
           "LearningRate": [np.array([0.1], np.float32)]}
    logits = _f(r, 6, 5)
    return {
        "conv2d_nchw": ("conv2d", {"Input": [img_c],
                                   "Filter": [_f(r, 6, 4, 3, 3)]},
                        {"strides": [2, 1], "paddings": [1, 0],
                         "dilations": [1, 1], "groups": 2,
                         "data_format": "NCHW"}),
        "conv2d_nhwc": ("conv2d", {"Input": [img],
                                   "Filter": [_f(r, 5, 8, 3, 3)]},
                        {"strides": [2, 2], "paddings": [1, 1],
                         "dilations": [1, 1], "groups": 1,
                         "data_format": "NHWC"}),
        "conv2d_nhwc_7x7": ("conv2d", {"Input": [img],
                                       "Filter": [_f(r, 4, 8, 7, 7)]},
                            {"strides": [2, 2], "paddings": [3, 3],
                             "data_format": "NHWC"}),
        "pool2d_max": ("pool2d", {"X": [img]},
                       {"pooling_type": "max", "ksize": [3, 3],
                        "strides": [2, 2], "paddings": [1, 1],
                        "global_pooling": False, "data_format": "NHWC"}),
        "pool2d_avg_exclusive": ("pool2d", {"X": [img_c]},
                                 {"pooling_type": "avg", "ksize": [3, 3],
                                  "strides": [2, 2], "paddings": [1, 1],
                                  "data_format": "NCHW"}),
        "pool2d_avg_inclusive": ("pool2d", {"X": [img_c]},
                                 {"pooling_type": "avg", "ksize": [3, 3],
                                  "strides": [2, 2], "paddings": [1, 1],
                                  "exclusive": False,
                                  "data_format": "NCHW"}),
        "pool2d_global": ("pool2d", {"X": [img]},
                          {"pooling_type": "avg", "ksize": [7, 7],
                           "global_pooling": True, "data_format": "NHWC"}),
        "batch_norm_nhwc": ("batch_norm", {"X": [img], **bn_ins},
                            {"momentum": 0.9, "epsilon": 1e-5,
                             "is_test": False, "data_layout": "NHWC"}),
        "batch_norm_nchw": ("batch_norm",
                            {"X": [_f(r, 2, 8, 6, 7)], **bn_ins},
                            {"momentum": 0.9, "epsilon": 1e-5,
                             "is_test": False, "data_layout": "NCHW"}),
        "batch_norm_test": ("batch_norm", {"X": [img], **bn_ins},
                            {"momentum": 0.9, "epsilon": 1e-5,
                             "is_test": True, "data_layout": "NHWC"}),
        "relu": ("relu", {"X": [_f(r, 3, 4)]}, {}),
        "softmax": ("softmax", {"X": [logits]}, {}),
        "top_k": ("top_k", {"X": [logits]}, {"k": 2}),
        "accuracy": ("accuracy",
                     {"Indices": [np.argsort(-logits, 1)[:, :2]
                                  .astype(np.int64)],
                      "Label": [r.randint(0, 5, (6, 1)).astype(np.int64)]},
                     {}),
        "momentum": ("momentum", mom, {"mu": 0.9, "use_nesterov": False}),
        "momentum_nesterov": ("momentum", mom,
                              {"mu": 0.9, "use_nesterov": True}),
        "bn_act_conv1x1": ("bn_act_conv1x1",
                           {**fused, "Filter": [_f(r, 5, 8, 1, 1)]},
                           {"epsilon": 1e-5, "act": "relu",
                            "strides": [1, 1]}),
        "bn_act_conv1x1_s2_res": ("bn_act_conv1x1",
                                  {**fused, "Filter": [_f(r, 5, 8, 1, 1)],
                                   "Residual": [res]},
                                  {"epsilon": 1e-5, "act": "relu",
                                   "strides": [2, 2]}),
        "bn_act_conv3x3": ("bn_act_conv3x3",
                           {**fused, "Filter": [_f(r, 5, 8, 3, 3)]},
                           {"epsilon": 1e-5, "act": "relu",
                            "strides": [1, 1]}),
        "bn_act_conv3x3_s2_res": ("bn_act_conv3x3",
                                  {**fused, "Filter": [_f(r, 5, 8, 3, 3)],
                                   "Residual": [res]},
                                  {"epsilon": 1e-5, "act": "",
                                   "strides": [2, 2]}),
        "bn_act_conv3x3_nonsquare": ("bn_act_conv3x3",
                                     {**fused,
                                      "Filter": [_f(r, 5, 8, 3, 3)]},
                                     {"epsilon": 1e-5, "act": "relu",
                                      "strides": [2, 1]}),
    }


_OP_CASES = _op_cases()


def _emit(reg, conv, ctx, op_type, ins, attrs, bf16=()):
    return reg.get_op_info(op_type).emit(
        ctx, {s: [conv(a, s in bf16) for a in v] for s, v in ins.items()},
        attrs)


def _jconv(a, bf16=False):
    return jnp.asarray(a, dtype=jnp.bfloat16 if bf16 else None)


def _tconv(a, bf16=False):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.bfloat16) if bf16 else t


# f32 on the CPU in two frameworks: 1e-5 covers reduction-order and
# transcendental differences at these sizes (windows and channels <= 72)
@pytest.mark.parametrize("case", sorted(_OP_CASES))
def test_op_and_grad_match_jax(case):
    op_type, ins, attrs = _OP_CASES[case]
    jinfo, tinfo = jreg.get_op_info(op_type), treg.get_op_info(op_type)
    is_test = bool(attrs.get("is_test", False))
    jctx = jreg.EmitContext(jax.random.PRNGKey(0), is_test=is_test)
    tctx = treg.EmitContext(torch.device("cpu"), is_test=is_test)
    jouts = _emit(jreg, _jconv, jctx, op_type, ins, attrs)
    touts = _emit(treg, _tconv, tctx, op_type, ins, attrs)
    assert sorted(touts) == sorted(jouts)
    for slot in jouts:
        for j, t in zip(jouts[slot], touts[slot]):
            assert _np(t).shape == _np(j).shape, slot
            assert _np(t).dtype == _np(j).dtype, slot
            np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{case} {slot}")
    assert tinfo.non_diff_outputs == jinfo.non_diff_outputs
    assert tinfo.non_diff_inputs == jinfo.non_diff_inputs
    assert (tinfo.grad is None) == (jinfo.grad is None)
    if tinfo.grad is None:
        return
    # cotangents for every output the op differentiates: SavedMean and
    # SavedVariance of batch_norm included
    rng = np.random.RandomState(1)
    cts = {s: [rng.randn(*_np(o).shape).astype(np.float32)
               for o in jouts[s]]
           for s in jouts if s not in tinfo.non_diff_outputs}
    wanted = {(s, i) for s, v in ins.items()
              if s not in tinfo.non_diff_inputs
              for i, a in enumerate(v) if a.dtype.kind == "f"}
    gattrs = {"__fwd_type__": op_type, "__fwd_attrs__": dict(attrs),
              "__fwd_input_slots__": sorted(ins),
              "__fwd_output_slots__": sorted(jouts), "__uid__": 0,
              "__wanted__": wanted}

    def grad_ins(conv, outs):
        g = {s: [conv(a) for a in v] for s, v in ins.items()}
        g.update({s: list(v) for s, v in outs.items()})
        g.update({s + "@GRAD": [conv(a) for a in v] for s, v in cts.items()})
        return g

    jg = jreg.get_op_info("generic_grad").emit(
        jctx, grad_ins(_jconv, jouts), gattrs)
    tg = treg.get_op_info("generic_grad").emit(
        tctx, grad_ins(_tconv, touts), gattrs)
    assert sorted(tg) == sorted(jg) == sorted(
        {s + "@GRAD" for s, _ in wanted})
    for slot in jg:
        for j, t in zip(jg[slot], tg[slot]):
            np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{case} {slot}")


@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_on_bf16_params_keeps_an_f32_velocity(nesterov):
    op_type, ins, _ = _OP_CASES["momentum"]
    attrs = {"mu": 0.9, "use_nesterov": nesterov}
    jctx = jreg.EmitContext(jax.random.PRNGKey(0), is_test=False)
    tctx = treg.EmitContext(torch.device("cpu"), is_test=False)
    bf16 = ("Param", "Grad")
    jo = _emit(jreg, _jconv, jctx, op_type, ins, attrs, bf16)
    to = _emit(treg, _tconv, tctx, op_type, ins, attrs, bf16)
    assert to["ParamOut"][0].dtype == torch.bfloat16
    assert to["VelocityOut"][0].dtype == torch.float32
    for slot in ("ParamOut", "VelocityOut"):
        np.testing.assert_array_equal(_np(to[slot][0]),
                                      _np(jo[slot][0]).astype(np.float32))


def test_batch_norm_saved_stats_stay_functions_of_x():
    """A cotangent on SavedMean and SavedVariance alone reaches X (the
    route the fused ops' dmean and dvar take), as in JAX."""
    _, ins, attrs = _OP_CASES["batch_norm_nhwc"]
    outs = treg.get_op_info("batch_norm").emit(
        treg.EmitContext(torch.device("cpu"), is_test=False),
        {s: [_tconv(a) for a in v] for s, v in ins.items()}, attrs)
    assert outs["SavedMean"][0].dtype == torch.float32
    x = _tconv(ins["X"][0]).requires_grad_(True)
    outs = treg.get_op_info("batch_norm").emit(
        treg.EmitContext(torch.device("cpu"), is_test=False),
        {**{s: [_tconv(a) for a in v] for s, v in ins.items()}, "X": [x]},
        attrs)
    g = torch.autograd.grad(outs["SavedMean"][0].sum()
                            + outs["SavedVariance"][0].sum(), x)[0]
    assert float(g.abs().max()) > 0.01


# -- (d) programs ------------------------------------------------------------

def _build(fluid, resnet, depth, fuse, dtype="float32", image=32,
           class_dim=10, bs=4):
    fluid.reset()
    return resnet.build_train_program(
        batch_size=bs, depth=depth, class_dim=class_dim,
        image_shape=(3, image, image), dtype=dtype, learning_rate=0.001,
        layout="NHWC", fuse_bn=fuse)


def _desc(program):
    return [(op.type, op.inputs, op.outputs, op.attrs)
            for op in program.global_block().ops]


@pytest.mark.parametrize("depth,fuse", [(50, True), (50, False), (18, True),
                                        (18, False)])
def test_program_desc_matches_jax_op_for_op(depth, fuse):
    _build(jfluid, jresnet, depth, fuse)
    _build(tfluid, tresnet, depth, fuse)
    jops = _desc(jfluid.default_main_program())
    tops = _desc(tfluid.default_main_program())
    assert len(tops) == len(jops)
    for i, (t, j) in enumerate(zip(tops, jops)):
        assert t == j, f"op {i}: port {t[0]} != JAX {j[0]}"
    assert _desc(tfluid.default_startup_program()) == \
        _desc(jfluid.default_startup_program())
    kinds = [op[0] for op in tops]
    if fuse:
        assert (kinds.count("bn_act_conv1x1"),
                kinds.count("bn_act_conv3x3")) == \
            ((34, 16) if depth == 50 else (3, 15))


@pytest.mark.parametrize("depth,want", [(50, 50), (18, 18)])
def test_fusion_pass_counts(depth, want):
    tfluid.reset()
    img = tfluid.layers.data("image", shape=[32, 32, 3])
    logits = tresnet.resnet_imagenet(img, class_dim=10, depth=depth,
                                     layout="NHWC")
    tfluid.layers.mean(logits)
    assert fuse_bn_matmul(tfluid.default_main_program()) == want
    # once minimized, the pass refuses
    loss = _build(tfluid, tresnet, depth, False)[0]
    assert loss is not None
    with pytest.raises(ValueError, match="before append_backward"):
        fuse_bn_matmul(tfluid.default_main_program())


def _f64_net(fuse):
    """ResNet-18 (every fused form: 1x1 stride 2 with a residual, 3x3 at
    stride 1 and 2 with and without one) with a float64 head."""
    tfluid.reset()
    img = tfluid.layers.data("image", shape=[32, 32, 3], dtype="float64")
    label = tfluid.layers.data("label", shape=[1], dtype="int64")
    logits = tresnet.resnet_imagenet(img, class_dim=5, depth=18,
                                     layout="NHWC")
    loss = tfluid.layers.mean(
        tfluid.layers.softmax_with_cross_entropy(logits, label))
    n = fuse_bn_matmul(tfluid.default_main_program()) if fuse else 0
    tfluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
    return loss, n


def test_fused_equals_unfused_in_float64():
    """The decisive gate: in float64 the fused program's step-1 parameter
    gradients equal the unfused program's to 1e-10 relative (the fused ops'
    dmean and dvar reach dX through batch_norm's generic grad).  Batch 4 at
    32 x 32 leaves 4 values per channel to the last stage's statistics;
    fewer make them ill-conditioned enough to cost f64 digits."""
    rng = np.random.RandomState(7)
    feed = {"image": rng.rand(4, 32, 32, 3),
            "label": rng.randint(0, 5, (4, 1)).astype(np.int64)}
    grads, state = [], None
    for fuse in (False, True):
        loss, n = _f64_net(fuse)
        assert n == (18 if fuse else 0)
        main = tfluid.default_main_program()
        exe = tfluid.Executor(tfluid.CPUPlace())
        if state is None:
            exe.run(tfluid.default_startup_program())
            state = {v: tfluid.global_scope().find_np(v)
                     for v, var in main.global_block().vars.items()
                     if var.persistable}
        else:
            tfluid.load_persistables(main, state)
        names = sorted(p.name + "@GRAD"
                       for p in main.global_block().all_parameters())
        grads.append(dict(zip(names, exe.run(main, feed=feed,
                                             fetch_list=names))))
    assert sorted(grads[0]) == sorted(grads[1])
    err = max(np.linalg.norm(grads[1][n] - grads[0][n])
              / (np.linalg.norm(grads[0][n]) + 1e-30) for n in grads[0])
    assert err < 1e-10, err


def _jax_steps(dtype, bs, state=None, steps=3, grads=False):
    """The JAX package's fused ResNet-50 (or -18 at ``bs`` 8) at 32 x 32 from
    its startup's state or from ``state`` (cast to each var's dtype), ``steps``
    Momentum steps on the test feed: (state, losses, step-1 gradients of
    every parameter when ``grads``, the running statistics after step 1,
    every persistable after the last step)."""
    depth = 18 if bs == 8 else 50
    loss, _ = _build(jfluid, jresnet, depth, True, dtype=dtype, bs=bs)
    main = jfluid.default_main_program()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(jfluid.default_startup_program())
    blk = main.global_block()
    persist = [n for n, v in blk.vars.items() if v.persistable]
    scope = jfluid.global_scope()
    if state is None:
        state = {n: scope.find_np(n) for n in persist}
    else:
        for n, a in state.items():
            scope.set(n, jnp.asarray(a.astype(blk.vars[n].dtype)))
    names = sorted(p.name + "@GRAD" for p in blk.all_parameters()) \
        if grads else []
    losses, g1, stats = [], {}, {}
    for step in range(steps):
        out = exe.run(main, feed=_feed(bs, dtype),
                      fetch_list=[loss] + (names if step == 0 else []))
        losses.append(float(np.asarray(out[0]).ravel()[0]))
        if step == 0:
            g1 = {n: np.asarray(g) for n, g in zip(names, out[1:])}
            stats = {n: scope.find_np(n) for n in persist if ".global" in n}
    return state, losses, g1, stats, {n: scope.find_np(n) for n in persist}


@functools.lru_cache(maxsize=None)
def _jax_resnet50_x64():
    """The JAX package's float64 run of ResNet-50 (batch 4) from its
    startup's state: the witness both ResNet-50 cases hold the port to."""
    return _jax_steps("float64", 4, grads=True)


def _feed(bs, dtype="float32"):
    feed = resnet_bench.feed(bs, 32, 10)
    return dict(feed, image=feed["image"].astype(dtype))


def _port_steps(depth, bs, dtype, state, steps=3, grads=False):
    """The port's side of ``_jax_steps``, from ``state`` by name."""
    loss, _ = _build(tfluid, tresnet, depth, True, dtype=dtype, bs=bs)
    main = tfluid.default_main_program()
    blk = main.global_block()
    tfluid.load_persistables(main, {n: a.astype(blk.vars[n].dtype)
                                    for n, a in state.items()})
    exe = tfluid.Executor(tfluid.CPUPlace())
    names = sorted(p.name + "@GRAD" for p in blk.all_parameters()) \
        if grads else []
    scope = tfluid.global_scope()
    losses, g1, stats = [], {}, {}
    for step in range(steps):
        out = exe.run(main, feed=_feed(bs, dtype),
                      fetch_list=[loss] + (names if step == 0 else []))
        losses.append(float(np.asarray(out[0]).ravel()[0]))
        if step == 0:
            g1 = dict(zip(names, out[1:]))
            stats = {n: scope.find_np(n) for n in state if ".global" in n}
    return losses, g1, stats, {n: scope.find_np(n) for n in state}


def _max_rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _norm_rel(got, want):
    """||got - want|| / ||want|| over every tensor of the dicts at once."""
    num = sum(float(((np.asarray(got[n], np.float64) - want[n]) ** 2).sum())
              for n in want)
    return (num / sum(float((want[n] ** 2).sum()) for n in want)) ** 0.5


@pytest.mark.parametrize("depth,bs,dtype", [(18, 8, "float32"),
                                            (50, 4, "float32"),
                                            (50, 4, "float64")])
def test_three_momentum_steps_match_jax(depth, bs, dtype):
    """The fused program (NHWC, 32 x 32, class_dim 10, lr 0.001) from the
    JAX startup's state carried across by name, three Momentum steps in
    each package.

    ResNet-18 (batch 8, f32) is held whole: the losses within 1e-4
    relative, and every parameter, velocity and running statistic after
    step 3 within 1e-4 of its max |value|.

    ResNet-50 (batch 4) is ill-conditioned at this size: its last stage
    normalizes 4 nearly equal values a channel.  In float64 the two
    packages' step-1 gradients of every parameter agree within 1e-6 of
    max |g| (6.4e-8 measured), yet by step 3 their losses lie 0.75% and
    their running statistics 1.8% apart; so float64 holds what precedes
    the first update: the step-1 loss within 1e-12, every step-1
    gradient, the running statistics after step 1 within 1e-9.  In
    float32 each package's step-1 gradients lie some percent from the
    JAX float64 ones (in norm over all parameters: JAX 5.1%, the port
    7.3%): f32's own spread, which JAX shows too (these numbers:
    ``tools/resnet_conditioning.py --jax --image 32 --class-dim 10``).  The
    f32 case holds the
    step-1 loss within 1e-4 relative, the running statistics after step 1
    within 1e-3 of their max |value|, and the port's step-1 gradients no
    further from JAX's float64 ones than twice JAX's own float32 ones.  The
    later losses must stay finite."""
    if depth == 18:
        start, jl, _, _, jfinal = _jax_steps(dtype, bs)
        tl, _, _, tfinal = _port_steps(depth, bs, dtype, start)
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        assert tl[2] < tl[0]
        for n in jfinal:
            assert _max_rel(tfinal[n], jfinal[n]) <= 1e-4, n
        assert len([n for n in jfinal if ".global" in n]) == 2 * 20
        moved = sum(not np.array_equal(jfinal[n], start[n]) for n in start)
        assert moved > len(start) // 2
        return
    start, l64, g64, s64, _ = _jax_resnet50_x64()
    assert len(s64) == 2 * 53 and len(g64) == 161
    if dtype == "float64":
        tl, tg, ts, _ = _port_steps(depth, bs, dtype, start, grads=True)
        assert abs(tl[0] - l64[0]) <= 1e-12 * abs(l64[0])
        for n in g64:
            assert _max_rel(tg[n], g64[n]) <= 1e-6, n
        for n in s64:
            assert _max_rel(ts[n], s64[n]) <= 1e-9, n
        assert np.isfinite(tl).all()
        return
    _, jl, jg, js, _ = _jax_steps(dtype, bs, start, steps=1, grads=True)
    tl, tg, ts, _ = _port_steps(depth, bs, dtype, start, grads=True)
    assert abs(tl[0] - jl[0]) <= 1e-4 * abs(jl[0])
    for n in s64:
        assert _max_rel(ts[n], js[n]) <= 1e-3, n
    assert _norm_rel(tg, g64) <= 2 * _norm_rel(jg, g64)
    assert np.isfinite(tl).all()


def test_dead_ops_are_skipped():
    """The fused ResNet-50 fetching only the loss: the 35 ReLUs and 3 adds
    whose only reader the pass replaced, and softmax -> top_k -> accuracy,
    are dead; fetching the accuracy keeps the metric chain.  The executor
    runs exactly the live ops."""
    loss, acc = _build(tfluid, tresnet, 50, True)
    block = tfluid.default_main_program().global_block()
    dead = [op.type for op, keep in zip(
        block.ops, texecutor.live_ops(block, [loss.name])) if not keep]
    assert sorted(set(dead)) == ["accuracy", "elementwise_add", "relu",
                                 "softmax", "top_k"]
    assert (dead.count("relu"), dead.count("elementwise_add"), len(dead)) \
        == (35, 3, 41)
    dead_acc = [op.type for op, keep in zip(
        block.ops, texecutor.live_ops(block, [loss.name, acc.name]))
        if not keep]
    assert len(dead_acc) == 38 and "accuracy" not in dead_acc
    _build(tfluid, tresnet, 18, True, image=16)
    block = tfluid.default_main_program().global_block()
    loss = block.vars[[op for op in block.ops if op.type == "mean"][0]
                      .outputs["Out"][0]]
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    ran = []
    orig = texecutor.Executor._run_op

    def counting(op, env, ctx):
        ran.append(op.type)
        return orig(op, env, ctx)

    rng = np.random.RandomState(0)
    feed = {"image": rng.rand(2, 16, 16, 3).astype(np.float32),
            "label": rng.randint(0, 10, (2, 1)).astype(np.int64)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(texecutor.Executor, "_run_op", staticmethod(counting))
        exe.run(feed=feed, fetch_list=[loss])
    assert len(ran) == sum(texecutor.live_ops(block, [loss.name]))
    assert len(ran) == len(block.ops) - 11 - 3 - 3


def _run_all_ops(monkeypatch):
    monkeypatch.setattr(texecutor, "live_ops",
                        lambda block, fetch: [True] * len(block.ops))


@pytest.mark.parametrize("which", ["gpt", "lstm", "nmt"])
def test_skipping_dead_ops_changes_no_result(which, monkeypatch):
    """One step of a tiny GPT, stacked-LSTM and NMT program with the
    skipping and with every op run: the loss and every persistable value
    are equal to the bit."""
    from paddle_tpu_torch.models import rnn_bench, transformer

    def build():
        tfluid.reset()
        if which == "gpt":
            loss = transformer.build_lm_train_program(
                seq_len=8, vocab_size=32, dim=16, n_layers=1, n_heads=2,
                dtype="float32", learning_rate=1e-2)
            rng = np.random.RandomState(0)
            toks = rng.randint(0, 32, (2, 8, 1)).astype(np.int64)
            feed = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
        elif which == "lstm":
            loss = rnn_bench.lstm_train_program(vocab=50, hidden=16,
                                                seq_len=6, dtype="float32")
            feed = rnn_bench.lstm_feed(3, 6, 50, ragged=True)
        else:
            loss = rnn_bench.nmt_train_program(vocab=40, dim=16, seq_len=5)
            feed = rnn_bench.nmt_feed(3, 5, 40)
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(tfluid.default_startup_program())
        (lv,) = exe.run(feed=feed, fetch_list=[loss])
        block = tfluid.default_main_program().global_block()
        state = {n: tfluid.global_scope().find_np(n)
                 for n, v in block.vars.items() if v.persistable}
        return lv, state

    lv, state = build()
    _run_all_ops(monkeypatch)
    lv_all, state_all = build()
    np.testing.assert_array_equal(lv, lv_all)
    assert sorted(state) == sorted(state_all)
    for n in state:
        np.testing.assert_array_equal(state[n], state_all[n], err_msg=n)


def test_bnconv_variant_knob(monkeypatch, tmp_path):
    """PADDLE_TPU_BNCONV_VARIANT picks the fused 3x3 forward, v1 when unset
    (and no stored winner); the legacy PADDLE_TPU_BNCONV_V2=1 picks v2, and
    the O-block override PADDLE_TPU_BNCONV_BO sets K14's block where it
    divides O, as in the JAX package."""
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_CACHE", str(tmp_path))
    monkeypatch.delenv("PADDLE_TPU_BNCONV_VARIANT", raising=False)
    monkeypatch.delenv("PADDLE_TPU_BNCONV_V2", raising=False)
    monkeypatch.delenv("PADDLE_TPU_BNCONV_BO", raising=False)
    assert knobs.bnconv_variant() == "v1"
    assert [tbc._v2_block_o(o) for o in (96, 192, 256)] == [96, 192, 128]
    monkeypatch.setenv("PADDLE_TPU_BNCONV_V2", "1")
    monkeypatch.setenv("PADDLE_TPU_BNCONV_BO", "64")
    assert knobs.bnconv_variant() == "v2"
    assert [tbc._v2_block_o(o) for o in (96, 192, 256)] == [96, 64, 64]
    for v in ("v1", "v2", "reference"):
        monkeypatch.setenv("PADDLE_TPU_BNCONV_VARIANT", v)
        assert knobs.bnconv_variant() == v
    monkeypatch.setenv("PADDLE_TPU_BNCONV_VARIANT", "v3")
    with pytest.raises(ValueError, match="v3"):
        knobs.bnconv_variant()


@pytest.mark.parametrize("variant", ["v1", "v2", "reference"])
def test_fused_3x3_op_takes_each_variant(variant, monkeypatch):
    """The op's output and grads do not depend on the variant; on the CPU
    no kernel counter moves."""
    monkeypatch.setenv("PADDLE_TPU_BNCONV_VARIANT", variant)
    op_type, ins, attrs = _OP_CASES["bn_act_conv3x3_s2_res"]
    before = [f.launches for f in (tbc.bn_conv3x3_fwd, tbc.bn_conv3x3_fwd_v2,
                                   tbc.bn_conv3x3_bwd)]
    outs = _emit(treg, _tconv, treg.EmitContext(torch.device("cpu"), False),
                 op_type, ins, attrs)
    want = tbc.bn_conv3x3_fwd_ref(
        *(_tconv(ins[s][0]) for s in ("X", "Scale", "Bias", "SavedMean",
                                      "SavedVariance")),
        tbc.w_hwio(_tconv(ins["Filter"][0])), _tconv(ins["Residual"][0]),
        None, stride=2)
    np.testing.assert_allclose(_np(outs["Output"][0]), _np(want), rtol=1e-6,
                               atol=1e-6)
    assert [f.launches for f in (tbc.bn_conv3x3_fwd, tbc.bn_conv3x3_fwd_v2,
                                 tbc.bn_conv3x3_bwd)] == before


def test_unported_options_raise():
    """``remat=True`` is ported now: it builds one ``recompute`` segment
    per residual block (``tests/test_torch_dropout_remat.py`` holds the
    program and a float64 step to JAX)."""
    img = tfluid.layers.data("image", shape=[32, 32, 3])
    tresnet.resnet_imagenet(img, depth=18, layout="NHWC", remat=True)
    assert [op.type for op in tfluid.default_main_program().global_block()
            .ops].count("recompute") == 8
    tfluid.reset()
    tresnet.build_train_program(depth=18, layout="NHWC", remat=True)
    assert len(tfluid.default_main_program().blocks) == 9


def test_resnet_bench_feed_keeps_the_bench_draws():
    """bench.py's feed: images then labels from RandomState(0)."""
    f = resnet_bench.feed(bs=3, image=8, class_dim=1000)
    rng = np.random.RandomState(0)
    np.testing.assert_array_equal(f["image"],
                                  rng.rand(3, 8, 8, 3).astype(np.float32))
    np.testing.assert_array_equal(f["label"],
                                  rng.randint(0, 1000, (3, 1)))
    assert f["label"].dtype == np.int64
    loss, acc = resnet_bench.train_program(depth=18, image=32, class_dim=10)
    ops = [op.type for op in
           tfluid.default_main_program().global_block().ops]
    assert ops.count("bn_act_conv3x3") == 15 and ops.count("momentum") > 0
