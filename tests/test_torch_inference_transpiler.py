"""The BatchNorm fold (``paddle_tpu_torch/inference_transpiler.py``)
against the JAX package's on the CPU, from the same parameters and
running statistics: the same pairs fold to the same program
(``to_json``) and the same weights (f32, 1e-6 relative: both fold in
float64), the folded program's outputs within 2e-5 of the unfolded ones
in f32, every skip rule, the training-program refusal, and
``save_inference_model(fold_batch_norm=True)`` leaving the live scope
untouched."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import io as jio
from paddle_tpu_torch import io as tio


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    jfluid.reset()
    yield


def _net(fl, layout="NCHW", dtype="float32", share=False, twice=False):
    """conv → BN(relu) → conv → BN, with the variants two skip rules
    need: the first conv output read twice; the second conv sharing the
    first's filter."""
    shape = [3, 16, 16] if layout == "NCHW" else [16, 16, 3]
    img = fl.layers.data("img", shape=shape, dtype=dtype)
    c1 = fl.layers.conv2d(img, num_filters=8, filter_size=3, padding=1,
                          bias_attr=False, data_format=layout,
                          param_attr={"name": "shared_w"} if share else None)
    b1 = fl.layers.batch_norm(c1, act="relu", data_layout=layout)
    extra = fl.layers.scale(c1, scale=0.5) if twice else None
    c2 = fl.layers.conv2d(img if share else b1, num_filters=8,
                          filter_size=3, padding=1, bias_attr=False,
                          data_format=layout,
                          param_attr={"name": "shared_w"} if share else None)
    b2 = fl.layers.batch_norm(c2, act=None, data_layout=layout)
    out = fl.layers.cast(b2, "float32") if dtype != "float32" else b2
    return out, c1, extra


def _init(fl):
    """Startup, then non-trivial BN parameters and running statistics
    (mean 0 / var 1 would let a broken fold pass)."""
    exe = fl.Executor(fl.CPUPlace())
    fl.default_startup_program().random_seed = 1
    exe.run(fl.default_startup_program())
    rng = np.random.RandomState(7)
    scope = fl.global_scope()
    for op in fl.default_main_program().global_block().ops:
        if op.type != "batch_norm":
            continue
        for slot in ("Mean", "Variance", "Scale", "Bias"):
            name = op.inputs[slot][0]
            C = scope.find_np(name).shape[0]
            val = (rng.rand(C) + 0.5 if slot == "Variance" else
                   rng.randn(C) * 0.3 + (slot == "Scale")).astype(np.float32)
            scope.set(name, val if fl is tfluid else jnp.asarray(val))
    return exe


def _carry():
    """The JAX scope's persistables into the port's."""
    main = jfluid.default_main_program()
    tfluid.load_persistables(tfluid.default_main_program(), {
        n: np.asarray(jfluid.global_scope().find_np(n))
        for n, v in main.global_block().vars.items() if v.persistable})


def _feed(layout, seed=3):
    shape = (2, 3, 16, 16) if layout == "NCHW" else (2, 16, 16, 3)
    return {"img": np.random.RandomState(seed).rand(*shape)
            .astype(np.float32)}


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_fold_matches_jax(layout):
    jout, _, _ = _net(jfluid, layout)
    tout, _, _ = _net(tfluid, layout)
    jexe = _init(jfluid)
    _carry()
    texe = tfluid.Executor(tfluid.CPUPlace())
    jmain, tmain = jfluid.default_main_program(), \
        tfluid.default_main_program()
    (before,) = texe.run(tmain, feed=_feed(layout), fetch_list=[tout])
    nj = jfluid.fuse_batch_norm(jmain, jfluid.global_scope())
    nt = tfluid.fuse_batch_norm(tmain, tfluid.global_scope())
    assert nt == nj == 2
    assert tmain.to_json() == jmain.to_json()
    persist = [n for n, v in tmain.global_block().vars.items()
               if v.persistable]
    assert sum(n.endswith("@bnfold_bias") for n in persist) == 2
    for n in persist:
        j = np.asarray(jfluid.global_scope().find_np(n), np.float64)
        t = tfluid.global_scope().find_np(n).astype(np.float64)
        np.testing.assert_allclose(t, j, rtol=1e-6,
                                   atol=1e-6 * np.abs(j).max(), err_msg=n)
    (after,) = texe.run(tmain, feed=_feed(layout), fetch_list=[tout])
    (jafter,) = jexe.run(jmain, feed=_feed(layout), fetch_list=[jout])
    np.testing.assert_allclose(after, before, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(after, np.asarray(jafter), rtol=2e-5,
                               atol=2e-5)


def test_fold_keeps_bf16_dtypes():
    out, _, _ = _net(tfluid, "NHWC", dtype="bfloat16")
    exe = _init(tfluid)
    main = tfluid.default_main_program()
    (before,) = exe.run(main, feed=_feed("NHWC"), fetch_list=[out])
    assert tfluid.fuse_batch_norm(main, tfluid.global_scope()) == 2
    scope = tfluid.global_scope()
    for n, v in main.global_block().vars.items():
        if v.persistable and scope.find(n) is not None and (
                n.endswith("@bnfold_bias") or n.startswith("conv2d")):
            assert scope.find(n).dtype == torch.bfloat16, n
    (after,) = exe.run(main, feed=_feed("NHWC"), fetch_list=[out])
    # bf16 activations: the fold's rounding of W and the bias, 2e-2
    np.testing.assert_allclose(after, before, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("rule", ["fetched", "twice", "shared",
                                  "persistable"])
def test_skip_rules_match_jax(rule):
    kw = {"fetched": {}, "twice": {"twice": True},
          "shared": {"share": True}, "persistable": {}}[rule]
    nets = {fl: _net(fl, **kw) for fl in (jfluid, tfluid)}
    _init(jfluid)
    _carry()
    if rule == "persistable":  # after the carry: it holds no value
        for fl in nets:
            nets[fl][1].persistable = True
    res = []
    for fl in (jfluid, tfluid):
        fetch = [nets[fl][1].name] if rule == "fetched" else []
        n = fl.fuse_batch_norm(fl.default_main_program(), fl.global_scope(),
                               fetch_names=fetch)
        res.append((n, fl.default_main_program().to_json()))
    assert res[1] == res[0]
    # the first pair is skipped; the second folds unless it shares W
    assert res[1][0] == (0 if rule == "shared" else 1)
    assert any(op.type == "batch_norm" for op in
               tfluid.default_main_program().global_block().ops)


def test_training_program_is_refused_as_jax():
    for fl in (jfluid, tfluid):
        out, _, _ = _net(fl)
        fl.optimizer.SGD(learning_rate=0.1).minimize(fl.layers.mean(out))
        with pytest.raises(ValueError, match="inference-only program"):
            fl.fuse_batch_norm(fl.default_main_program(), fl.global_scope())
    tfluid.reset()
    out, _, _ = _net(tfluid)
    blk = tfluid.default_main_program().global_block()
    blk.append_op("momentum", inputs={}, outputs={})
    with pytest.raises(ValueError, match="'momentum'"):
        tfluid.InferenceTranspiler().transpile(tfluid.default_main_program(),
                                               tfluid.global_scope())


def test_save_inference_model_folds_into_a_detached_scope(tmp_path):
    """The saved model carries folded weights; the live scope keeps the
    raw ones; the loaded model reproduces the unfolded outputs (2e-5);
    and the JAX package saves the same files."""
    out, _, _ = _net(tfluid)
    exe = _init(tfluid)
    main = tfluid.default_main_program()
    scope = tfluid.global_scope()
    live = {n: scope.find(n).clone() for n, v in
            main.global_block().vars.items() if v.persistable}
    (want,) = exe.run(main, feed=_feed("NCHW"), fetch_list=[out])
    prog = tio.save_inference_model(str(tmp_path / "t"), ["img"], [out],
                                    exe, fold_batch_norm=True)
    assert not any(op.type == "batch_norm" for op in prog.global_block().ops)
    for n, v in live.items():
        assert torch.equal(scope.find(n), v), n
    assert not any(n.endswith("@bnfold_bias") for n in scope.local_names())
    loaded = tfluid.Scope()
    lprog, feeds, fetches = tio.load_inference_model(str(tmp_path / "t"),
                                                     exe, loaded)
    (got,) = exe.run(lprog, feed=_feed("NCHW"), fetch_list=fetches,
                     scope=loaded)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)

    jout, _, _ = _net(jfluid)
    jexe = _init(jfluid)
    _carry_back = {n: tfluid.global_scope().find_np(n) for n in live}
    for n, a in _carry_back.items():
        jfluid.global_scope().set(n, jnp.asarray(a))
    jio.save_inference_model(str(tmp_path / "j"), ["img"], [jout], jexe,
                             fold_batch_norm=True)
    for f in ("program.json", "__model__", "persistables.json"):
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes(), f
