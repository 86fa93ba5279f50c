"""Dropout, remat (``layers.recompute``) and the ``__remat__`` mark: the
port against the JAX package on the CPU.

- the ``dropout`` op in test mode and at p = 0 equals JAX's exactly, in
  both implementations; in train mode torch cannot draw
  ``jax.random.fold_in``'s bits, so the test holds its properties: the
  mask's mean within a binomial 6 sigma of 1 - p, Out = X·Mask (or
  X·Mask/(1 - p)), the gradient dOut·Mask with the forward's own mask, the
  same (seed, step) replaying to the bit and the next step differing;
- ``decoder_lm(dropout_prob=, remat=)`` and remat ResNet (fused and
  unfused) build the JAX package's program: ``to_json`` equal, letter for
  letter;
- a small remat GPT takes three Adam steps from the JAX startup's state
  within the tolerances of ``tests/test_torch_training.py``; a remat
  ResNet-18 takes one step in float64 from JAX's state within those of
  ``tests/test_torch_resnet.py``; remat and no remat agree at p = 0;
- a JAX-built program whose grad ops carry ``__remat__`` runs in the port
  with the gradients it gives unmarked, and JAX's;
- a remat segment rides the captured step loop; one holding dropout
  takes the loud eager route, named."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.framework import step_loop
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.ops import registry as treg

V, D, L, NH, T, BS, LR = 64, 64, 2, 2, 16, 2, 1e-2


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    jfluid.reset()
    yield


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _emit(ctx, op_type, ins, attrs):
    return treg.get_op_info(op_type).emit(ctx, ins, attrs)


# -- the dropout op -----------------------------------------------------------

@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
@pytest.mark.parametrize("mode", ["attr_is_test", "ctx_is_test", "p0"])
def test_dropout_test_mode_matches_jax_exactly(impl, mode):
    x = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    p = 0.0 if mode == "p0" else 0.3
    attrs = {"dropout_prob": p, "is_test": mode == "attr_is_test",
             "dropout_implementation": impl, "__uid__": 3}
    ctx_test = mode == "ctx_is_test"
    j = jreg.get_op_info("dropout").emit(
        jreg.EmitContext(jax.random.PRNGKey(0), is_test=ctx_test),
        {"X": [jnp.asarray(x)]}, attrs)
    t = _emit(treg.EmitContext(torch.device("cpu"), is_test=ctx_test),
              "dropout", {"X": [torch.from_numpy(x)]}, attrs)
    for slot in ("Out", "Mask"):
        np.testing.assert_array_equal(_np(t[slot][0]), _np(j[slot][0]))
    assert treg.get_op_info("dropout").non_diff_outputs == \
        jreg.get_op_info("dropout").non_diff_outputs == ("Mask",)


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_train_mode_properties(impl, dtype):
    p, shape = 0.3, (64, 128)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1)).to(
        dtype)
    attrs = {"dropout_prob": p, "dropout_implementation": impl,
             "__uid__": 7}
    ctx = treg.EmitContext(torch.device("cpu"), is_test=False)
    outs = _emit(ctx, "dropout", {"X": [x]}, attrs)
    out, mask = outs["Out"][0], outs["Mask"][0]
    assert out.dtype == mask.dtype == dtype
    assert set(torch.unique(mask).tolist()) <= {0.0, 1.0}
    n = mask.numel()
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(float(mask.float().mean()) - (1 - p)) <= 6 * sigma
    want = x * mask / (1.0 - p) if impl == "upscale_in_train" else x * mask
    assert torch.equal(out, want)

    # the grad op re-runs the forward with the same (seed, step, uid):
    # d X = d Out · Mask (/ (1 - p)), the forward's own mask
    dout = torch.randn(shape, generator=torch.Generator().manual_seed(2)
                       ).to(dtype)
    gattrs = {"__fwd_type__": "dropout", "__fwd_attrs__": attrs,
              "__fwd_input_slots__": ["X"],
              "__fwd_output_slots__": ["Mask", "Out"], "__uid__": 7,
              "__wanted__": {("X", 0)}}
    g = _emit(ctx, "generic_grad", {"X": [x], "Out": [out], "Mask": [mask],
                                    "Out@GRAD": [dout], "Mask@GRAD": [None]},
              gattrs)["X@GRAD"][0]
    gwant = dout * mask / (1.0 - p) if impl == "upscale_in_train" \
        else dout * mask
    assert torch.equal(g, gwant)


def _dropout_program(fl):
    x = fl.layers.data("x", shape=[32])
    return fl.layers.dropout(x, 0.5)


def test_dropout_replays_per_step_and_differs_between_steps():
    """A training program (a grad op makes the executor's mode train):
    the same (seed, step) draws the same mask, the next step another; its
    test-mode clone draws none."""
    x = tfluid.layers.data("x", shape=[32])
    x.stop_gradient = False
    out = tfluid.layers.dropout(x, 0.5)
    tfluid.append_backward(tfluid.layers.mean(out))
    main = tfluid.default_main_program()
    main.random_seed = 11
    feed = {"x": np.ones((8, 32), np.float32)}

    def run(program, step):
        return tfluid.Executor(tfluid.CPUPlace()).run(
            program, feed=feed, fetch_list=[out], rng_step=step)[0]

    a, b, c = run(main, 5), run(main, 5), run(main, 6)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert set(np.unique(a)) == {0.0, 1.0}
    # downgrade_in_infer scales by 1 - p in test mode
    np.testing.assert_array_equal(run(main.clone(for_test=True), 5),
                                  np.full((8, 32), 0.5, np.float32))


def test_dropout_layer_desc_matches_jax():
    _dropout_program(jfluid)
    _dropout_program(tfluid)
    assert tfluid.default_main_program().to_json() == \
        jfluid.default_main_program().to_json()


# -- remat: the descs -----------------------------------------------------------

def _lm(fl, transformer, remat, dropout_prob=0.0, dim=D):
    tokens = fl.layers.data("tokens", shape=[T, 1], dtype="int64")
    targets = fl.layers.data("targets", shape=[T, 1], dtype="int64")
    logits = transformer.decoder_lm(tokens, V, dim, L, NH, max_len=T,
                                    remat=remat, dropout_prob=dropout_prob)
    loss = transformer.lm_loss(logits, targets)
    fl.optimizer.Adam(learning_rate=LR).minimize(loss)
    return loss


@pytest.mark.parametrize("remat,p", [(True, 0.0), (True, 0.1),
                                     (False, 0.1)])
def test_decoder_lm_desc_matches_jax(remat, p):
    _lm(jfluid, jtransformer, remat, p)
    _lm(tfluid, ttransformer, remat, p)
    for get in (lambda f: f.default_main_program(),
                lambda f: f.default_startup_program()):
        assert get(tfluid).to_json() == get(jfluid).to_json()
    main = tfluid.default_main_program()
    kinds = [op.type for op in main.global_block().ops]
    assert kinds.count("recompute") == (L if remat else 0)
    assert len(main.blocks) == (1 + L if remat else 1)
    n_drop = sum(op.type == "dropout" for b in main.blocks for op in b.ops)
    assert n_drop == (1 + 2 * L if p else 0)


def test_build_lm_train_program_remat_desc_matches_jax():
    args = dict(seq_len=T, vocab_size=V, dim=D, n_layers=L, n_heads=NH,
                dtype="float32", remat=True)
    jtransformer.build_lm_train_program(**args)
    ttransformer.build_lm_train_program(**args)
    assert tfluid.default_main_program().to_json() == \
        jfluid.default_main_program().to_json()


def test_recompute_layer_hoists_vars_and_orders_ops_as_jax():
    def build(fl):
        x = fl.layers.data("x", shape=[8])
        with fl.layers.recompute():
            h = fl.layers.fc(x, 16, act="relu")
            h = fl.layers.fc(h, 8)
        return h

    jh, th = build(jfluid), build(tfluid)
    main = tfluid.default_main_program()
    assert th.block is main.global_block()
    assert th.name in main.global_block().vars
    assert main.to_json() == jfluid.default_main_program().to_json()
    op = main.global_block().ops[-1]
    assert op.type == "recompute"
    assert op.attrs["out_names"][-1] == th.name == jh.name


@pytest.mark.parametrize("fuse", [False, True])
def test_remat_resnet_desc_matches_jax(fuse):
    for fl, resnet in ((jfluid, jresnet), (tfluid, tresnet)):
        fl.reset()
        resnet.build_train_program(
            depth=18, class_dim=10, image_shape=(3, 32, 32),
            learning_rate=0.001, layout="NHWC", fuse_bn=fuse, remat=True)
    tmain = tfluid.default_main_program()
    assert tmain.to_json() == jfluid.default_main_program().to_json()
    assert sum(op.type == "recompute"
               for op in tmain.global_block().ops) == 8
    # a chain never crosses a segment's edge: of each basic block only the
    # second 3x3 (whose BatchNorm is inside its segment) fuses, 8 of 18
    fused = sum(op.type.startswith("bn_act_conv")
                for b in tmain.blocks for op in b.ops)
    assert fused == (8 if fuse else 0)


# -- remat: the runs ------------------------------------------------------------

def _batch(seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, V, (BS, T, 1)).astype(np.int64)
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}


def _carry(jmain, tmain):
    names = [n for n, v in jmain.global_block().vars.items()
             if v.persistable]
    start = {n: jfluid.global_scope().find_np(n) for n in names}
    tfluid.load_persistables(tmain, {n: np.asarray(a)
                                     for n, a in start.items()})
    return names


@pytest.mark.parametrize("dim", [32, D])
def test_remat_gpt_three_adam_steps_match_jax(dim):
    """From the JAX startup's values: per-step losses 1e-5 relative and
    step-1 grads 1e-5 of their max |g| (``test_torch_training``'s
    tolerances).  At d 32, its width, every parameter and moment after
    step 3 within 1e-4 too; at d 64 one Adam step of 1e-2 where |g| ~
    sqrt(v) turns f32 grad noise into up to 1.3e-4 of a weight after
    three steps with or without remat (measured against JAX: 1.28e-4
    without, 1.79e-4 with), so the d 64 case holds the losses and grads,
    what remat changes."""
    jloss = _lm(jfluid, jtransformer, remat=True, dim=dim)
    jmain = jfluid.default_main_program()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    tloss = _lm(tfluid, ttransformer, remat=True, dim=dim)
    tmain = tfluid.default_main_program()
    names = _carry(jmain, tmain)
    texe = tfluid.Executor(tfluid.CPUPlace())
    params = [p.name for p in jmain.global_block().all_parameters()]
    grads = [n + "@GRAD" for n in (params[0], params[4], params[-1])]
    jl, tl = [], []
    for step in range(3):
        fetch = grads if step == 0 else []
        jo = jexe.run(jmain, feed=_batch(), fetch_list=[jloss] + fetch)
        to = texe.run(tmain, feed=_batch(), fetch_list=[tloss] + fetch)
        jl.append(float(np.asarray(jo[0])[0]))
        tl.append(float(to[0][0]))
        for name, j, t in zip(fetch, jo[1:], to[1:]):
            np.testing.assert_allclose(
                t, np.asarray(j), rtol=0,
                atol=1e-5 * float(np.abs(np.asarray(j)).max()),
                err_msg=name)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[2] < tl[0]
    if dim != 32:
        return
    for n in names:
        np.testing.assert_allclose(
            tfluid.global_scope().find_np(n),
            np.asarray(jfluid.global_scope().find_np(n)), rtol=1e-4,
            atol=1e-4, err_msg=n)


def _port_lm_run(remat, state, steps=2):
    tfluid.reset()
    loss = _lm(tfluid, ttransformer, remat=remat)
    main = tfluid.default_main_program()
    tfluid.load_persistables(main, state)
    exe = tfluid.Executor(tfluid.CPUPlace())
    params = [p.name for p in main.global_block().all_parameters()]
    grads = [p + "@GRAD" for p in params]
    out = [exe.run(main, feed=_batch(), fetch_list=[loss] + grads)
           for _ in range(steps)]
    return [float(o[0][0]) for o in out], dict(zip(grads, out[0][1:]))


def test_remat_equals_no_remat_at_p0():
    """One state, two steps: losses 1e-6 relative and every step-1 grad
    within 1e-5 of its max |g| (the same ops; autograd over the segment
    against one op at a time sums in another order)."""
    _lm(tfluid, ttransformer, remat=False)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    state = {n: tfluid.global_scope().find_np(n)
             for n, v in tfluid.default_main_program().global_block()
             .vars.items() if v.persistable}
    l0, g0 = _port_lm_run(False, state)
    l1, g1 = _port_lm_run(True, state)
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    assert sorted(g1) == sorted(g0)
    for n in g0:
        np.testing.assert_allclose(g1[n], g0[n], rtol=0,
                                   atol=1e-5 * float(np.abs(g0[n]).max()),
                                   err_msg=n)


def _resnet_step(fl, resnet, fuse, state=None):
    """One Momentum step of float64 remat ResNet-18 (NHWC, 32 x 32,
    batch 4, class_dim 5): (state, loss, step-1 grads, running stats)."""
    fl.reset()
    img = fl.layers.data("image", shape=[32, 32, 3], dtype="float64")
    label = fl.layers.data("label", shape=[1], dtype="int64")
    logits = resnet.resnet_imagenet(img, class_dim=5, depth=18,
                                    layout="NHWC", remat=True)
    loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(logits,
                                                               label))
    if fuse:
        from importlib import import_module
        import_module(fl.__name__ + ".training_fusion").fuse_bn_matmul(
            fl.default_main_program())
    fl.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
    main = fl.default_main_program()
    exe = fl.Executor(fl.CPUPlace())
    blk = main.global_block()
    if state is None:
        exe.run(fl.default_startup_program())
        state = {n: np.asarray(fl.global_scope().find_np(n))
                 for n, v in blk.vars.items() if v.persistable}
    else:
        fl.load_persistables(main, state)
    rng = np.random.RandomState(7)
    feed = {"image": rng.rand(4, 32, 32, 3),
            "label": rng.randint(0, 5, (4, 1)).astype(np.int64)}
    names = sorted(p.name + "@GRAD" for p in blk.all_parameters())
    out = exe.run(main, feed=feed, fetch_list=[loss] + names)
    stats = {n: np.asarray(fl.global_scope().find_np(n)) for n in state
             if ".global" in n}
    return (state, float(np.asarray(out[0]).ravel()[0]),
            {n: np.asarray(g) for n, g in zip(names, out[1:])}, stats)


@pytest.mark.parametrize("fuse", [False, True])
def test_remat_resnet18_float64_step_matches_jax(fuse):
    """``test_torch_resnet``'s float64 tolerances: the step-1 loss within
    1e-12, every step-1 gradient within 1e-6 of its max |g|, the running
    statistics after step 1 within 1e-9."""
    state, jl, jg, js = _resnet_step(jfluid, jresnet, fuse)
    _, tl, tg, ts = _resnet_step(tfluid, tresnet, fuse, state)
    assert abs(tl - jl) <= 1e-12 * abs(jl)
    assert sorted(tg) == sorted(jg) and len(jg) == 62
    for n in jg:
        err = np.abs(tg[n] - jg[n]).max() / max(np.abs(jg[n]).max(), 1e-30)
        assert err <= 1e-6, n
    assert len(js) == 2 * 20
    for n in js:
        err = np.abs(ts[n] - js[n]).max() / max(np.abs(js[n]).max(), 1e-30)
        assert err <= 1e-9, n


def test_carried_remat_grad_ops_give_the_same_gradients():
    """A JAX-built GPT program whose every ``generic_grad`` carries
    ``__remat__`` (the mark JAX's memory_optimize writes), carried into
    the port by ``to_json``: the port's step-1 grads equal its unmarked
    run's to the bit and JAX's marked run's within 1e-5 of max |g|."""
    jloss = _lm(jfluid, jtransformer, remat=False)
    jmain = jfluid.default_main_program()
    marked = 0
    for op in jmain.global_block().ops:
        if op.type == "generic_grad":
            op.attrs["__remat__"] = True
            marked += 1
    assert marked > 10
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    tmain = tfluid.Program.from_json(jmain.to_json())
    assert tmain.to_json() == jmain.to_json()
    names = _carry(jmain, tmain)
    state = {n: tfluid.global_scope().find_np(n) for n in names}
    params = [p.name for p in jmain.global_block().all_parameters()]
    grads = [p + "@GRAD" for p in params]
    jo = jexe.run(jmain, feed=_batch(), fetch_list=[jloss] + grads)
    texe = tfluid.Executor(tfluid.CPUPlace())
    to = texe.run(tmain, feed=_batch(), fetch_list=[jloss.name] + grads)
    plain = tfluid.Program.from_json(jmain.to_json())
    for op in plain.global_block().ops:
        op.attrs.pop("__remat__", None)
    tfluid.load_persistables(plain, state)
    tp = texe.run(plain, feed=_batch(), fetch_list=[jloss.name] + grads)
    for name, j, t, u in zip(["loss"] + grads, jo, to, tp):
        np.testing.assert_array_equal(t, u, err_msg=name)
        np.testing.assert_allclose(
            t, np.asarray(j), rtol=0,
            atol=1e-5 * float(np.abs(np.asarray(j)).max()), err_msg=name)


def test_unknown_sp_mode_in_a_carried_desc_raises():
    _lm(jfluid, jtransformer, remat=False)
    desc = json.loads(jfluid.default_main_program().to_json())
    for op in desc["blocks"][0]["ops"]:
        if op["type"] == "scaled_dot_product_attention":
            op["attrs"]["sp_mode"] = "ulysses2d"
    main = tfluid.Program.from_json(json.dumps(desc))
    exe = tfluid.Executor(tfluid.CPUPlace())
    tfluid.load_persistables(main, {
        n: np.zeros(v.shape, np.float32)
        for n, v in main.global_block().vars.items() if v.persistable})
    # sequence parallelism is ported: the unknown mode raises as the JAX
    # package's dispatch raises it
    with pytest.raises(Exception, match="use 'ring' or 'alltoall'"):
        exe.run(main, feed=_batch(), fetch_list=[main.global_block().ops[
            -1].output_names()[0]])


# -- remat under the captured step loop ---------------------------------------

def test_remat_gpt_is_loop_safe_and_dropout_is_not():
    _lm(tfluid, ttransformer, remat=True)
    assert step_loop.safety_report(tfluid.default_main_program()) == {
        "safe": True, "reasons": []}
    tfluid.reset()
    _lm(tfluid, ttransformer, remat=True, dropout_prob=0.1)
    report = step_loop.safety_report(tfluid.default_main_program())
    assert not report["safe"]
    assert all("'dropout'" in r for r in report["reasons"])
    # the embedding's dropout, each layer's two inside its segment, and
    # those the segments' grad ops re-run
    assert sum("'recompute'" in r for r in report["reasons"]) == 4 * L
    assert len(report["reasons"]) == 1 + 4 * L + 1


def test_remat_gpt_steps_per_dispatch_equals_sequential():
    loss = _lm(tfluid, ttransformer, remat=True)
    main = tfluid.default_main_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    state = {n: tfluid.global_scope().find_np(n)
             for n, v in main.global_block().vars.items() if v.persistable}
    batches = [_batch(i) for i in range(2)]
    seq = [float(exe.run(main, feed=b, fetch_list=[loss])[0][0])
           for b in batches]
    tfluid.load_persistables(main, state)
    stacked = {n: np.stack([b[n] for b in batches]) for n in batches[0]}
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        (got,) = exe.run(main, feed=stacked, fetch_list=[loss],
                         steps_per_dispatch=2)
    np.testing.assert_array_equal(got.reshape(-1), np.float32(seq))
