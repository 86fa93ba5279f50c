"""The port's training slice against the JAX package on the CPU.

- every op the LM training program runs, forward and grad: the port's
  emitter and its ``generic_grad`` (autograd over a re-run) against the
  JAX emitter and JAX's ``generic_grad`` (``jax.vjp``), on numpy inputs;
- the backward desc: the same ``build_lm_train_program`` in both packages
  gives the same ops after ``minimize``, op for op;
- the slice: three f32 Adam steps of a tiny ``build_lm_train_program``
  from the JAX startup's values, carried into the port by name — losses,
  step-1 gradients, parameters and moments after step 3;
- a bf16 step of the port.

JAX runs its attention op through the dense reference on the CPU (its
Pallas dispatch is TPU-only); the port takes the flash kernels' plain
versions for CPU tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.ops import registry as treg
from paddle_tpu_torch.ops.cuda_kernels import flash_attention as t_fa

V, D, L, NH, T, BS, LR = 64, 32, 2, 2, 16, 2, 1e-2


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    yield


# -- each op, forward and grad ------------------------------------------------

def _f(rng, *shape, positive=False):
    a = rng.randn(*shape).astype(np.float32)
    return np.abs(a) + 0.5 if positive else a


def _op_cases():
    r = np.random.RandomState(0)
    ids = r.randint(0, 10, (2, 3, 1)).astype(np.int64)
    ids[0, 0, 0] = 2  # the padding row appears
    sdpa = {"Q": [_f(r, 2, 2, 16, 8)], "K": [_f(r, 2, 2, 16, 8)],
            "V": [_f(r, 2, 2, 16, 8)]}
    adam_ins = {"Param": [_f(r, 3, 4)], "Grad": [_f(r, 3, 4)],
                "Moment1": [_f(r, 3, 4)],
                "Moment2": [_f(r, 3, 4, positive=True)],
                "LearningRate": [np.array([0.01], np.float32)],
                "Beta1Pow": [np.array([0.81], np.float32)],
                "Beta2Pow": [np.array([0.998], np.float32)]}
    return {
        "assign": ("assign", {"X": [_f(r, 3, 4)]}, {}),
        "cast": ("cast", {"X": [_f(r, 3, 4)]}, {"out_dtype": "float64"}),
        "reshape": ("reshape", {"X": [_f(r, 2, 3, 4)]}, {"shape": [0, -1]}),
        "transpose": ("transpose", {"X": [_f(r, 2, 3, 4)]},
                      {"axis": [2, 0, 1]}),
        "slice": ("slice", {"Input": [_f(r, 5, 4)]},
                  {"axes": [0], "starts": [1], "ends": [4]}),
        "lookup_table": ("lookup_table", {"W": [_f(r, 10, 4)], "Ids": [ids]},
                         {"is_sparse": False, "padding_idx": -1}),
        "lookup_table_pad": ("lookup_table", {"W": [_f(r, 10, 4)],
                                              "Ids": [ids]},
                             {"is_sparse": False, "padding_idx": 2}),
        "elementwise_add": ("elementwise_add", {"X": [_f(r, 2, 3, 4)],
                                                "Y": [_f(r, 3)]},
                            {"axis": 1}),
        "elementwise_sub": ("elementwise_sub", {"X": [_f(r, 2, 3, 4)],
                                                "Y": [_f(r, 4)]},
                            {"axis": -1}),
        "elementwise_mul": ("elementwise_mul", {"X": [_f(r, 2, 3, 4)],
                                                "Y": [_f(r, 2, 3, 4)]},
                            {"axis": -1}),
        "elementwise_div": ("elementwise_div",
                            {"X": [_f(r, 2, 3, 4)],
                             "Y": [_f(r, 3, 4, positive=True)]},
                            {"axis": 1}),
        "mul": ("mul", {"X": [_f(r, 2, 3, 4)], "Y": [_f(r, 4, 5)]},
                {"x_num_col_dims": 2, "y_num_col_dims": 1}),
        "sum": ("sum", {"X": [_f(r, 3, 4), _f(r, 3, 4), _f(r, 3, 4)]}, {}),
        "mean": ("mean", {"X": [_f(r, 3, 4)]}, {}),
        "layer_norm": ("layer_norm", {"X": [_f(r, 2, 3, 8)],
                                      "Scale": [_f(r, 8)],
                                      "Bias": [_f(r, 8)]},
                       {"epsilon": 1e-5, "begin_norm_axis": 2}),
        "gelu": ("gelu", {"X": [_f(r, 3, 4) * 3]}, {}),
        "softmax_with_cross_entropy": (
            "softmax_with_cross_entropy",
            {"Logits": [_f(r, 6, 5)],
             "Label": [r.randint(0, 5, (6, 1)).astype(np.int64)]},
            {"soft_label": False}),
        "scaled_dot_product_attention": (
            "scaled_dot_product_attention", sdpa,
            {"causal": True, "sp_mode": "ring", "sp_schedule": "zigzag"}),
        "scaled_dot_product_attention_full": (
            "scaled_dot_product_attention", sdpa,
            {"causal": False, "sp_mode": "ring", "sp_schedule": "plain"}),
        "adam": ("adam", adam_ins,
                 {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
        "adam_beta_pow_update": (
            "adam_beta_pow_update",
            {"Beta1Pow": [np.array([0.81], np.float32)],
             "Beta2Pow": [np.array([0.998], np.float32)]},
            {"beta1": 0.9, "beta2": 0.999}),
    }


_OP_CASES = _op_cases()


def _jax_ctx():
    return jreg.EmitContext(jax.random.PRNGKey(0), is_test=False)


def _torch_ctx():
    return treg.EmitContext(torch.device("cpu"), is_test=False)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _grad_attrs(op_type, ins, out_slots, attrs, wanted):
    return {"__fwd_type__": op_type, "__fwd_attrs__": dict(attrs),
            "__fwd_input_slots__": sorted(ins),
            "__fwd_output_slots__": sorted(out_slots), "__uid__": 0,
            "__wanted__": wanted}


# f32 on the CPU in two frameworks: 1e-5 covers reduction-order and
# transcendental differences at these sizes (T <= 16, widths <= 10)
@pytest.mark.parametrize("case", sorted(_OP_CASES))
def test_op_and_grad_match_jax(case):
    op_type, ins, attrs = _OP_CASES[case]
    jinfo, tinfo = jreg.get_op_info(op_type), treg.get_op_info(op_type)
    jouts = jinfo.emit(_jax_ctx(), {s: [jnp.asarray(a) for a in v]
                                    for s, v in ins.items()}, attrs)
    touts = tinfo.emit(_torch_ctx(), {s: [torch.from_numpy(a) for a in v]
                                      for s, v in ins.items()}, attrs)
    assert sorted(touts) == sorted(jouts)
    for slot in jouts:
        for j, t in zip(jouts[slot], touts[slot]):
            assert _np(t).shape == _np(j).shape, slot
            assert _np(t).dtype == _np(j).dtype, slot
            np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{case} {slot}")
    if tinfo.grad is None:
        assert jinfo.grad is None
        return

    # cotangents for every float output the op differentiates
    rng = np.random.RandomState(1)
    cts = {s: [rng.randn(*_np(o).shape).astype(_np(o).dtype)
               for o in jouts[s]]
           for s in jouts if s not in tinfo.non_diff_outputs}
    assert tinfo.non_diff_outputs == jinfo.non_diff_outputs
    assert tinfo.non_diff_inputs == jinfo.non_diff_inputs
    wanted = {(s, i) for s, v in ins.items()
              if s not in tinfo.non_diff_inputs
              for i, a in enumerate(v) if a.dtype.kind == "f"}
    gattrs = _grad_attrs(op_type, ins, jouts, attrs, wanted)

    def grad_ins(conv, outs):
        g = {s: [conv(a) for a in v] for s, v in ins.items()}
        g.update({s: list(v) for s, v in outs.items()})
        g.update({s + "@GRAD": [conv(a) for a in v] for s, v in cts.items()})
        return g

    jg = jreg.get_op_info("generic_grad").emit(
        _jax_ctx(), grad_ins(jnp.asarray, jouts), gattrs)
    tg = treg.get_op_info("generic_grad").emit(
        _torch_ctx(), grad_ins(torch.from_numpy, touts), gattrs)
    assert sorted(tg) == sorted(jg) == sorted(
        {s + "@GRAD" for s, _ in wanted})
    for slot in jg:
        for j, t in zip(jg[slot], tg[slot]):
            assert _np(t).dtype == _np(j).dtype, slot
            np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{case} {slot}")


def test_generic_grad_zero_fills_unreached_inputs_and_missing_cotangents():
    """layer_norm with a cotangent on Mean only: Y and Variance take zero
    cotangents, Scale and Bias (which Mean does not reach) get zero
    grads, X gets Mean's cotangent spread over its row — as in JAX."""
    r = np.random.RandomState(2)
    ins = {"X": [_f(r, 2, 3, 8)], "Scale": [_f(r, 8)], "Bias": [_f(r, 8)]}
    attrs = {"epsilon": 1e-5, "begin_norm_axis": 2}
    ct = _f(r, 6)
    gattrs = _grad_attrs("layer_norm", ins, ("Y", "Mean", "Variance"),
                         attrs, {("X", 0), ("Scale", 0), ("Bias", 0)})
    grads = []
    for reg, conv, ctx in ((jreg, jnp.asarray, _jax_ctx()),
                           (treg, torch.from_numpy, _torch_ctx())):
        outs = reg.get_op_info("layer_norm").emit(
            ctx, {s: [conv(a) for a in v] for s, v in ins.items()}, attrs)
        g_ins = {s: [conv(a) for a in v] for s, v in ins.items()}
        g_ins.update(outs)
        g_ins.update({"Y@GRAD": [None], "Mean@GRAD": [conv(ct)],
                      "Variance@GRAD": [None]})
        grads.append(reg.get_op_info("generic_grad").emit(ctx, g_ins,
                                                          gattrs))
    jg, tg = grads
    for slot in ("Scale@GRAD", "Bias@GRAD"):
        np.testing.assert_array_equal(_np(tg[slot][0]), np.zeros(8))
        np.testing.assert_array_equal(_np(jg[slot][0]), np.zeros(8))
    want = np.repeat(ct.reshape(2, 3, 1) / 8, 8, axis=2)
    np.testing.assert_allclose(_np(tg["X@GRAD"][0]), want, rtol=1e-6)
    np.testing.assert_allclose(_np(jg["X@GRAD"][0]), want, rtol=1e-6)


# -- the backward desc ---------------------------------------------------------

def _build(fluid, transformer, dtype="float32", **kw):
    args = dict(seq_len=T, vocab_size=V, dim=D, n_layers=L, n_heads=NH,
                dtype=dtype, learning_rate=LR)
    args.update(kw)
    return transformer.build_lm_train_program(**args)


def _desc(program):
    return [(op.type, op.inputs, op.outputs, op.attrs)
            for op in program.global_block().ops]


def test_backward_desc_matches_jax_op_for_op():
    jfluid.reset()
    _build(jfluid, jtransformer)
    _build(tfluid, ttransformer)
    jops = _desc(jfluid.default_main_program())
    tops = _desc(tfluid.default_main_program())
    assert len(tops) == len(jops)
    for i, (t, j) in enumerate(zip(tops, jops)):
        assert t == j, f"op {i}: port {t[0]} != JAX {j[0]}"
    # the startup programs: same initializer ops over the same vars
    assert _desc(tfluid.default_startup_program()) == \
        _desc(jfluid.default_startup_program())


def test_parameter_and_accumulator_names_match_jax():
    jfluid.reset()
    _build(jfluid, jtransformer)
    _build(tfluid, ttransformer)

    def names(program):
        vs = program.global_block().vars.values()
        return ([v.name for v in program.global_block().all_parameters()],
                sorted((v.name, v.accumulator_for) for v in vs
                       if v.persistable and v.accumulator_for),
                sorted(v.name for v in vs if v.persistable))

    jn, tn = (names(f.default_main_program()) for f in (jfluid, tfluid))
    assert tn == jn
    assert len(tn[0]) == 2 + 12 * L + 3
    assert len(tn[1]) == 2 * len(tn[0])  # moment1 and moment2 each


# -- the slice ----------------------------------------------------------------

def _batch(seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, V, (BS, T, 1)).astype(np.int64)
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}


def _grad_names(program):
    ps = [p.name for p in program.global_block().all_parameters()]
    # the embedding, one WQ, the position table and the head
    return [n + "@GRAD" for n in (ps[0], ps[1], ps[4], ps[-1])]


def test_three_adam_steps_match_jax():
    """From the JAX startup's values carried across by name: per-step
    losses, step-1 grads, and every parameter and moment after step 3."""
    jfluid.reset()
    jloss = _build(jfluid, jtransformer)
    jmain = jfluid.default_main_program()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    persist = [n for n, v in jmain.global_block().vars.items()
               if v.persistable]
    start = {n: jfluid.global_scope().find_np(n) for n in persist}

    tloss = _build(tfluid, ttransformer)
    tmain = tfluid.default_main_program()
    tfluid.load_persistables(tmain, start)
    texe = tfluid.Executor(tfluid.CPUPlace())

    feed = _batch()
    gnames = _grad_names(jmain)
    jl, tl = [], []
    for step in range(3):
        fetch = gnames if step == 0 else []
        jo = jexe.run(jmain, feed=feed, fetch_list=[jloss] + fetch)
        to = texe.run(tmain, feed=feed, fetch_list=[tloss] + fetch)
        jl.append(float(np.asarray(jo[0])[0]))
        tl.append(float(to[0][0]))
        for name, j, t in zip(fetch, jo[1:], to[1:]):
            # one step's grads, f32 reduction order: 1e-5 of the max |g|
            np.testing.assert_allclose(
                t, np.asarray(j), rtol=0,
                atol=1e-5 * float(np.abs(np.asarray(j)).max()),
                err_msg=name)
    # losses: f32 CPU reduction order in two frameworks, 1e-5 relative
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[2] < tl[0]
    tscope = tfluid.global_scope()
    for n in persist:
        j = jfluid.global_scope().find_np(n)
        t = tscope.find_np(n)
        # three Adam steps from one start; a unit-size Adam step amplifies
        # grad noise where |g| ~ sqrt(v): 1e-4 absolute at lr 1e-2
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4, err_msg=n)


def test_bf16_step_is_finite_with_f32_moments():
    loss = _build(tfluid, ttransformer, dtype="bfloat16")
    main = tfluid.default_main_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    (lv,) = exe.run(main, feed=_batch(), fetch_list=[loss])
    assert np.isfinite(lv).all()
    scope = tfluid.global_scope()
    moments = [v for v in main.global_block().vars.values()
               if v.accumulator_for]
    assert moments
    for v in moments:
        t = scope.find(v.name)
        assert t.dtype == torch.float32 and torch.isfinite(t).all(), v.name
        assert v.dtype == "float32"
    w = scope.find(main.global_block().all_parameters()[0].name)
    assert w.dtype == torch.bfloat16
    (lv2,) = exe.run(main, feed=_batch(), fetch_list=[loss])
    assert np.isfinite(lv2).all()


def test_train_step_launches_no_kernel_on_cpu():
    """On the CPU the attention op takes the plain versions: no launch
    counter moves."""
    loss = _build(tfluid, ttransformer)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    fns = (t_fa.flash_attention, t_fa.flash_attention_fwd,
           t_fa.flash_attention_dq, t_fa.flash_attention_dkv)
    before = [f.launches for f in fns]
    exe.run(feed=_batch(), fetch_list=[loss])
    assert [f.launches for f in fns] == before


def test_eval_program_matches_jax_logits():
    """An is_test tower (no grad ops): the attention op takes K1's path;
    logits equal the JAX tower's from the same weights."""
    jfluid.reset()

    def tower(fluid, transformer):
        lm = transformer.DecoderLM(V, D, L, NH, max_len=T)
        toks = fluid.layers.data("tokens", shape=[T, 1], dtype="int64")
        return lm, lm.logits(toks)

    jlm, jout = tower(jfluid, jtransformer)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    tlm, tout = tower(tfluid, ttransformer)
    tlm.load_params([jfluid.global_scope().find_np(p.name)
                     for p in jlm._params], tfluid.global_scope())
    feed = {"tokens": _batch()["tokens"]}
    (j,) = jexe.run(feed=feed, fetch_list=[jout])
    (t,) = tfluid.Executor(tfluid.CPUPlace()).run(feed=feed,
                                                   fetch_list=[tout])
    np.testing.assert_allclose(t, np.asarray(j), rtol=1e-5, atol=1e-5)


def test_load_persistables_checks_names_shapes_dtypes():
    _build(tfluid, ttransformer)
    main = tfluid.default_main_program()
    vs = {n: v for n, v in main.global_block().vars.items() if v.persistable}
    arrays = {n: np.zeros(v.shape, np.float32) for n, v in vs.items()}
    tfluid.load_persistables(main, arrays)
    some = next(iter(vs))
    with pytest.raises(KeyError, match="missing"):
        tfluid.load_persistables(
            main, {n: a for n, a in arrays.items() if n != some})
    with pytest.raises(KeyError, match="not persistable"):
        tfluid.load_persistables(main, {**arrays, "nope": np.zeros(1)})
    with pytest.raises(ValueError, match="shape"):
        tfluid.load_persistables(main, {**arrays, some: np.zeros((7, 7),
                                                                 np.float32)})
    with pytest.raises(TypeError, match="dtype"):
        tfluid.load_persistables(
            main, {**arrays, some: arrays[some].astype(np.int32)})


def test_unported_options_raise():
    """dropout, remat and calc_gradient are ported now (held to JAX in
    ``tests/test_torch_dropout_remat.py`` and
    ``tests/test_torch_calc_gradient.py``); the dataset downloads still
    raise."""
    toks = tfluid.layers.data("tokens", shape=[T, 1], dtype="int64")
    ttransformer.decoder_lm(toks, V, D, L, NH, T, dropout_prob=0.1)
    ttransformer.decoder_lm(toks, V, D, L, NH, T, remat=True)
    kinds = [op.type for b in tfluid.default_main_program().blocks
             for op in b.ops]
    assert kinds.count("dropout") == 1 + 2 * L
    assert kinds.count("recompute") == L
    h = tfluid.layers.fc(tfluid.layers.data("x", shape=[3]), 2)
    assert tfluid.calc_gradient(h, toks) == [None]
    for fetch in (tfluid.dataset.common.download,
                  tfluid.dataset.common.fetch):
        with pytest.raises(NotImplementedError, match="Queue A"):
            fetch("https://example.invalid/x", "mnist", None)
