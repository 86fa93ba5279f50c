"""The port's control flow against the JAX package on the CPU.

- (a) the JAX package's control-flow tests (``tests/test_control_flow.py``:
  While, StaticRNN training, ragged DynamicRNN, ifelse, tensor arrays) as
  parity tests: both packages build the program, the JAX startup's state
  is carried across by name, and both run on the same numpy inputs;
  ``ifelse``'s gradients are held against JAX's for each branch;
- (b) every op this slice adds outside the generation ops (beam ops,
  arrays, ``is_empty``, ``fill_constant_batch_size_like``, ``unsqueeze``
  and its grad, ``assign_value``, ``beam_gather``), emitter against
  emitter, with ``beam_search`` on inputs that force DEAD ties;
- (c) the executor's sub-block lowering: a missing name raises naming the
  op; ``step_loop.safety_report`` keeps a block holding ``while`` eager,
  loudly; ``layers.recompute`` raises.

Tolerances: f32 on the CPU in two frameworks, 1e-5 for one forward or
grad at these widths (<= 16), 1e-4 relative after several optimizer
steps (the steps compound reduction-order differences); integer outputs
exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.framework import step_loop
from paddle_tpu_torch.framework.executor import OpLoweringError
from paddle_tpu_torch.ops import registry as treg


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    jfluid.reset()
    yield


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() \
            else x.detach().numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind == "f" else x


def _carry_state():
    """The JAX startup's persistables into the port's global scope."""
    jmain = jfluid.default_main_program()
    names = [n for n, v in jmain.global_block().vars.items()
             if v.persistable]
    tfluid.load_persistables(
        tfluid.default_main_program(),
        {n: jfluid.global_scope().find_np(n) for n in names})
    return names


# -- (a) the JAX package's control-flow tests, against it ---------------------


def _while_program(fl):
    i = fl.layers.fill_constant(shape=[1], dtype="float32", value=0)
    n = fl.layers.fill_constant(shape=[1], dtype="float32", value=10)
    total = fl.layers.fill_constant(shape=[1], dtype="float32", value=0)
    cond = fl.layers.less_than(i, n)
    w = fl.layers.While(cond)
    with w.block():
        new_total = fl.layers.elementwise_add(total, i)
        fl.layers.assign(new_total, total)
        fl.layers.increment(i, 1.0)
        fl.layers.less_than(i, n, cond=cond)
    return total, i


def test_while_loop_accumulates_as_jax():
    jt, ji = _while_program(jfluid)
    tt, ti = _while_program(tfluid)
    jres = jfluid.Executor(jfluid.CPUPlace()).run(feed={},
                                                  fetch_list=[jt, ji])
    tres = tfluid.Executor(tfluid.CPUPlace()).run(feed={},
                                                  fetch_list=[tt, ti])
    assert float(tres[0].item()) == sum(range(10))
    for j, t in zip(jres, tres):
        np.testing.assert_array_equal(t, np.asarray(j))
    op = [o for o in tfluid.default_main_program().global_block().ops
          if o.type == "while"][0]
    assert op.attrs["carry_names"] == [o for o in [
        jop for jop in jfluid.default_main_program().global_block().ops
        if jop.type == "while"][0].attrs["carry_names"]]


def _static_rnn_program(fl, H=16):
    x = fl.layers.data(name="x", shape=[5, 8], dtype="float32")
    y = fl.layers.data(name="y", shape=[1], dtype="int64")
    rnn = fl.layers.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        h_prev = rnn.memory(shape=[H], batch_ref=x)
        h = fl.layers.fc(input=[x_t, h_prev], size=H, act="tanh")
        rnn.update_memory(h_prev, h)
        rnn.step_output(h)
    hidden_seq = rnn()
    last = fl.layers.reshape(hidden_seq, [-1, 5 * H])
    logits = fl.layers.fc(input=last, size=2)
    loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(logits, y))
    fl.optimizer.Adam(learning_rate=0.02).minimize(loss)
    return loss


def _dynamic_rnn_program(fl, H=8, train=False):
    x = fl.layers.sequence_data(name="x", shape=[4], dtype="float32")
    rnn = fl.layers.DynamicRNN()
    with rnn.block():
        x_t = rnn.step_input(x)
        h_prev = rnn.memory(shape=[H], batch_ref=x)
        h = fl.layers.fc(input=[x_t, h_prev], size=H, act="relu")
        rnn.update_memory(h_prev, h)
        rnn.step_output(h)
    out = rnn()
    if not train:
        return out, None
    pooled = fl.layers.sequence_pool(out, pool_type="sum")
    loss = fl.layers.mean(fl.layers.square_error_cost(
        fl.layers.fc(input=pooled, size=1),
        fl.layers.data(name="y", shape=[1], dtype="float32")))
    fl.optimizer.SGD(learning_rate=0.02).minimize(loss)
    return out, loss


def _ragged(rng, lens, width=4):
    return [rng.rand(n, width).astype(np.float32) for n in lens]


def _steps(n, loss, feed, fetch_more=()):
    """`n` steps of both packages from the JAX startup's state: the
    per-step losses, then every persistable's final value."""
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    names = _carry_state()
    texe = tfluid.Executor(tfluid.CPUPlace())
    jl, tl = [], []
    for _ in range(n):
        jl.append(float(np.asarray(jexe.run(
            feed=feed(jfluid), fetch_list=[loss[0]])[0]).reshape(-1)[0]))
        tl.append(float(texe.run(feed=feed(tfluid),
                                 fetch_list=[loss[1]])[0].reshape(-1)[0]))
    return jl, tl, names


def _hold_state(names, rtol=1e-4):
    for n in names:
        np.testing.assert_allclose(
            tfluid.global_scope().find_np(n),
            np.asarray(jfluid.global_scope().find_np(n)), rtol=rtol,
            atol=rtol, err_msg=n)


def test_static_rnn_trains_as_jax():
    """The JAX test's 15 Adam steps: losses within 1e-4 relative of the
    JAX package's step for step, every parameter and moment after them
    within 1e-4, and the loss falls as the JAX test demands."""
    losses = (_static_rnn_program(jfluid), _static_rnn_program(tfluid))
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 2, (64, 1)).astype(np.int64)
    xs = rng.rand(64, 5, 8).astype(np.float32) + labels[:, :, None] * 0.5
    jl, tl, names = _steps(15, losses, lambda fl: {"x": xs, "y": labels})
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0] * 0.7, tl
    _hold_state(names)


def test_dynamic_rnn_ragged_as_jax():
    """Forward over ragged sequences: equal to the JAX package's within
    1e-5, zero past each row's length, and the long row still moving."""
    jout, _ = _dynamic_rnn_program(jfluid)
    tout, _ = _dynamic_rnn_program(tfluid)
    jfluid.Executor(jfluid.CPUPlace()).run(
        jfluid.default_startup_program())
    _carry_state()
    seqs = _ragged(np.random.RandomState(1), (2, 5, 3))
    (jres,) = jfluid.Executor(jfluid.CPUPlace()).run(
        feed={"x": jfluid.lod.LoDTensor.from_sequences(seqs)},
        fetch_list=[jout])
    (tres,) = tfluid.Executor(tfluid.CPUPlace()).run(
        feed={"x": tfluid.lod.LoDTensor.from_sequences(seqs)},
        fetch_list=[tout])
    np.testing.assert_allclose(tres, np.asarray(jres), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tres[0, 2:], 0.0)
    np.testing.assert_array_equal(tres[2, 3:], 0.0)
    assert np.abs(tres[1, 4]).sum() > 0
    assert not np.allclose(tres[1, 4], tres[1, 1])


def test_dynamic_rnn_sgd_steps_as_jax():
    """Three SGD steps through the ragged DynamicRNN (generic_grad over
    ``static_rnn`` with a Length input): losses within 1e-4 relative,
    every parameter within 1e-4 after them."""
    losses = (_dynamic_rnn_program(jfluid, train=True)[1],
              _dynamic_rnn_program(tfluid, train=True)[1])
    rng = np.random.RandomState(2)
    seqs = _ragged(rng, (3, 6, 1, 4))
    ys = rng.rand(4, 1).astype(np.float32)

    def feed(fl):
        return {"x": fl.lod.LoDTensor.from_sequences(seqs), "y": ys}

    jl, tl, names = _steps(3, losses, feed)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[2] < tl[0]
    _hold_state(names)


def _ifelse_program(fl):
    x = fl.layers.data(name="x", shape=[4], dtype="float32")
    flag = fl.layers.data(name="flag", shape=[1], dtype="float32",
                          append_batch_size=False)

    def true_branch():
        return [fl.layers.fc(input=x, size=3, act="tanh",
                             param_attr={"name": "t.w"},
                             bias_attr={"name": "t.b"})]

    def false_branch():
        return [fl.layers.scale(fl.layers.fc(
            input=x, size=3, param_attr={"name": "f.w"},
            bias_attr={"name": "f.b"}), scale=-1.0)]

    out = fl.layers.ifelse(flag, true_branch, false_branch)
    return fl.layers.mean(fl.layers.elementwise_mul(out, out))


def test_ifelse_value_as_jax():
    """The JAX test's program: scale by 2 or by -1 on the flag."""
    outs = {}
    for name, fl in (("jax", jfluid), ("port", tfluid)):
        x = fl.layers.data(name="x", shape=[4], dtype="float32")
        flag = fl.layers.data(name="flag", shape=[1], dtype="float32",
                              append_batch_size=False)
        out = fl.layers.ifelse(flag,
                               lambda: [fl.layers.scale(x, scale=2.0)],
                               lambda: [fl.layers.scale(x, scale=-1.0)])
        s = fl.layers.mean(out)
        exe = fl.Executor(fl.CPUPlace())
        xv = np.ones((2, 4), np.float32)
        outs[name] = [float(np.asarray(exe.run(
            feed={"x": xv, "flag": np.asarray([f], np.float32)},
            fetch_list=[s])[0]).reshape(-1)[0]) for f in (1.0, 0.0)]
    assert outs["port"] == outs["jax"] == [2.0, -1.0]


@pytest.mark.parametrize("flag", [1.0, 0.0])
def test_ifelse_gradients_as_jax(flag):
    """Gradients reach the taken branch's parameters only (the untaken
    one's are zero, as with ``lax.cond``): every parameter gradient within
    1e-5 of the JAX package's."""
    fetch = {}
    for name, fl in (("jax", jfluid), ("port", tfluid)):
        fl.default_startup_program().random_seed = 3
        loss = _ifelse_program(fl)
        grads = fl.optimizer.SGD(learning_rate=0.1).minimize(loss)[1]
        fetch[name] = (loss, [g for _, g in grads],
                       [p.name for p, _ in grads])
    assert fetch["port"][2] == fetch["jax"][2]
    jfluid.Executor(jfluid.CPUPlace()).run(
        jfluid.default_startup_program())
    _carry_state()
    feed = {"x": np.random.RandomState(4).randn(2, 4).astype(np.float32),
            "flag": np.asarray([flag], np.float32)}
    jres = jfluid.Executor(jfluid.CPUPlace()).run(
        feed=feed, fetch_list=[fetch["jax"][0]] + fetch["jax"][1])
    tres = tfluid.Executor(tfluid.CPUPlace()).run(
        feed=feed, fetch_list=[fetch["port"][0]] + fetch["port"][1])
    for n, j, t in zip(["loss"] + fetch["port"][2], jres, tres):
        np.testing.assert_allclose(t, np.asarray(j), rtol=1e-5, atol=1e-5,
                                   err_msg=n)
    taken = "t." if flag else "f."
    for n, t in zip(fetch["port"][2], tres[1:]):
        assert (np.abs(t).sum() > 0) == n.startswith(taken), n


def test_array_ops_roundtrip_as_jax():
    res = {}
    for name, fl in (("jax", jfluid), ("port", tfluid)):
        arr = fl.layers.fill_constant(shape=[4, 3], dtype="float32",
                                      value=0)
        block = fl.default_main_program().global_block()
        x = fl.layers.data(name="x", shape=[3], dtype="float32",
                           append_batch_size=False)
        i = fl.layers.fill_constant(shape=[1], dtype="int32", value=2)
        written = fl.layers.fill_constant(shape=[4, 3], dtype="float32",
                                          value=0)
        block.append_op("array_write",
                        inputs={"Array": [arr.name], "X": [x.name],
                                "I": [i.name]},
                        outputs={"Out": [written.name]})
        read = fl.layers.fill_constant(shape=[3], dtype="float32", value=0)
        block.append_op("array_read",
                        inputs={"Array": [written.name], "I": [i.name]},
                        outputs={"Out": [read.name]})
        xv = np.asarray([1.0, 2.0, 3.0], np.float32)
        res[name] = [np.asarray(v) for v in fl.Executor(fl.CPUPlace()).run(
            feed={"x": xv}, fetch_list=[written, read])]
    w, r = res["port"]
    np.testing.assert_array_equal(w[2], [1.0, 2.0, 3.0])
    np.testing.assert_array_equal(w[0], 0)
    np.testing.assert_array_equal(r, [1.0, 2.0, 3.0])
    for j, t in zip(res["jax"], res["port"]):
        np.testing.assert_array_equal(t, j)


def test_array_layers_in_a_while_loop():
    """create_array (batch dim from a ref), array_write and array_read in
    a While body: step t writes t * ones(B) at index t; the read-back of
    index 2 and the whole buffer equal the JAX package's."""
    res = {}
    for name, fl in (("jax", jfluid), ("port", tfluid)):
        ref = fl.layers.data(name="ref", shape=[2], dtype="float32")
        arr = fl.layers.create_array("float32", 5, [-1], ref=ref)
        t = fl.layers.fill_constant(shape=[1], dtype="int32", value=0)
        n = fl.layers.fill_constant(shape=[1], dtype="int32", value=5)
        ones = fl.layers.fill_constant_batch_size_like(ref, [-1], "float32",
                                                       1.0)
        cond = fl.layers.less_than(t, n)
        w = fl.layers.While(cond)
        with w.block():
            val = fl.layers.elementwise_mul(ones,
                                            fl.layers.cast(t, "float32"))
            fl.layers.assign(fl.layers.array_write(val, t, arr), arr)
            fl.layers.increment(t, 1)
            fl.layers.less_than(t, n, cond=cond)
        two = fl.layers.fill_constant(shape=[1], dtype="int32", value=2)
        read = fl.layers.array_read(arr, two)
        res[name] = [np.asarray(v) for v in fl.Executor(fl.CPUPlace()).run(
            feed={"ref": np.zeros((3, 2), np.float32)},
            fetch_list=[arr, read])]
    np.testing.assert_array_equal(res["port"][0],
                                  np.arange(5)[:, None] * np.ones((5, 3)))
    np.testing.assert_array_equal(res["port"][1], [2.0, 2.0, 2.0])
    for j, t in zip(res["jax"], res["port"]):
        np.testing.assert_array_equal(t, j)


# -- (b) the ops, emitter against emitter -------------------------------------


def _jax_ctx():
    return jreg.EmitContext(jax.random.PRNGKey(0), is_test=True)


def _torch_ctx():
    return treg.EmitContext(torch.device("cpu"), is_test=True)


def _emit_both(op_type, ins, attrs):
    jouts = jreg.get_op_info(op_type).emit(
        _jax_ctx(), {s: [jnp.asarray(a) for a in v] for s, v in ins.items()},
        attrs)
    touts = treg.get_op_info(op_type).emit(
        _torch_ctx(), {s: [torch.from_numpy(np.asarray(a)) for a in v]
                       for s, v in ins.items()}, attrs)
    return jouts, touts


def _beam_inputs(seed, B=3, K=4, C=5, vocab=30):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, vocab, (B, K)).astype(np.int64),
            np.log(rng.rand(B, K)).astype(np.float32),
            rng.randint(0, vocab, (B, K, C)).astype(np.int64),
            np.log(rng.rand(B, K, C)).astype(np.float32))


def _beam_cases():
    cases = {}
    for acc in (True, False):
        pre_ids, pre_sc, ids, sc = _beam_inputs(0)
        cases[f"random_acc{int(acc)}"] = (pre_ids, pre_sc, ids, sc, acc)
    # finished lanes (pre id == end_id 1) and dead lanes (score DEAD)
    pre_ids, pre_sc, ids, sc = _beam_inputs(1)
    pre_ids[0, 1] = pre_ids[1, 0] = pre_ids[2, 3] = 1
    pre_sc[0, 2] = pre_sc[1, 3] = -1e9
    cases["finished_and_dead"] = (pre_ids, pre_sc, ids, sc, False)
    # DEAD ties: row 0 has one live lane and three finished lanes, so
    # fewer than K live candidates beat DEAD and the parent among the
    # tied DEAD entries decides ids and parents; row 1 is all dead but
    # one finished lane; row 2 repeats candidate scores exactly
    pre_ids, pre_sc, ids, sc = _beam_inputs(2, C=2)
    pre_ids[0, 1:] = 1
    pre_sc[0, 0] = -1e9
    pre_ids[1] = [5, 1, 7, 9]
    pre_sc[1] = [-1e9, -2.0, -1e9, -1e9]
    sc[2] = -0.5
    cases["dead_ties"] = (pre_ids, pre_sc, ids, sc, True)
    return cases


_BEAM_CASES = _beam_cases()


@pytest.mark.parametrize("case", sorted(_BEAM_CASES))
def test_beam_search_matches_jax(case):
    pre_ids, pre_sc, ids, sc, acc = _BEAM_CASES[case]
    ins = {"PreIds": [pre_ids], "PreScores": [pre_sc], "Ids": [ids],
           "Scores": [sc]}
    attrs = {"beam_size": pre_ids.shape[1], "end_id": 1,
             "is_accumulated": acc}
    jouts, touts = _emit_both("beam_search", ins, attrs)
    assert touts["ParentIdx"][0].dtype == torch.int32
    assert touts["SelectedIds"][0].dtype == torch.int64
    for slot in ("SelectedIds", "ParentIdx"):
        np.testing.assert_array_equal(_np(touts[slot][0]),
                                      np.asarray(jouts[slot][0]), slot)
    np.testing.assert_allclose(_np(touts["SelectedScores"][0]),
                               np.asarray(jouts["SelectedScores"][0]),
                               rtol=1e-6)
    if case == "dead_ties":
        # the ties were forced: several DEAD entries were selected
        assert (_np(touts["SelectedScores"][0]) <= -1e9 / 2).sum() >= 3


def _decode_inputs(seed, L=6, B=2, K=3, vocab=9, end_id=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (L, B, K)).astype(np.int64)
    ids[3, 0, 1] = end_id
    ids[1, 1, 0] = end_id
    parents = rng.randint(0, K, (L, B, K)).astype(np.int32)
    scores = rng.randn(B, K).astype(np.float32)
    return ids, parents, scores


@pytest.mark.parametrize("steps", [None, 4, 6])
def test_beam_search_decode_matches_jax(steps):
    ids, parents, scores = _decode_inputs(3)
    ins = {"Ids": [ids], "ParentIdx": [parents], "Scores": [scores]}
    if steps is not None:
        ins["StepCount"] = [np.asarray([steps], np.int32)]
    jouts, touts = _emit_both("beam_search_decode", ins, {"end_id": 1})
    assert touts["SentenceLength"][0].dtype == torch.int32
    for slot in ("SentenceIds", "SentenceScores", "SentenceLength"):
        np.testing.assert_array_equal(_np(touts[slot][0]),
                                      np.asarray(jouts[slot][0]), slot)


def _simple_cases():
    rng = np.random.RandomState(5)
    x = rng.randn(3, 4, 2).astype(np.float32)
    return {
        "beam_expand": ({"X": [x]}, {"beam_size": 3}),
        "beam_gather": ({"X": [x], "Index": [np.asarray(
            [[3, 3, 0, 1], [0, 1, 2, 3], [2, 2, 2, 2]], np.int32)]}, {}),
        "fill_constant_batch_size_like": (
            {"Input": [x]}, {"shape": [7, -1, 2], "value": 1.5,
                             "dtype": "int64", "input_dim_idx": 1,
                             "output_dim_idx": 1}),
        "unsqueeze": ({"X": [x]}, {"axes": [3, 0]}),
        "assign_value_f32": ({}, {"shape": [1, 3],
                                  "fp32_values": [0.0, -1e9, 2.5]}),
        "assign_value_i32": ({}, {"shape": [3], "int32_values": [4, -1, 2]}),
        "create_array_ref": ({"Ref": [x]}, {"shape": [5, -1, 2],
                                            "dtype": "int32"}),
        "is_empty": ({"X": [x]}, {}),
        "is_empty_empty": ({"X": [np.zeros((0, 3), np.float32)]}, {}),
        "array_write_clamped": (
            {"Array": [x], "X": [np.ones((4, 2), np.float32)],
             "I": [np.asarray([7], np.int64)]}, {}),
        "array_read": ({"Array": [x], "I": [np.asarray([1], np.int32)]}, {}),
    }


_SIMPLE = _simple_cases()


@pytest.mark.parametrize("case", sorted(_SIMPLE))
def test_op_matches_jax(case):
    op_type = {"assign_value_f32": "assign_value",
               "assign_value_i32": "assign_value",
               "create_array_ref": "create_array",
               "is_empty_empty": "is_empty",
               "array_write_clamped": "array_write"}.get(case, case)
    ins, attrs = _SIMPLE[case]
    jouts, touts = _emit_both(op_type, ins, attrs)
    assert sorted(touts) == sorted(jouts)
    for slot in jouts:
        for j, t in zip(jouts[slot], touts[slot]):
            j = np.asarray(j)
            assert _np(t).shape == j.shape, slot
            assert str(t.dtype).split(".")[1] in (str(j.dtype), "int64"), \
                (t.dtype, j.dtype)
            np.testing.assert_array_equal(_np(t), j.astype(_np(t).dtype))
    info_t, info_j = treg.get_op_info(op_type), jreg.get_op_info(op_type)
    assert info_t.non_diff_inputs == info_j.non_diff_inputs
    assert (info_t.grad is None) == (info_j.grad is None)


def test_unsqueeze_grad_matches_jax():
    x = np.random.RandomState(6).randn(3, 4).astype(np.float32)
    ct = np.random.RandomState(7).randn(1, 3, 1, 4).astype(np.float32)
    attrs = {"axes": [0, 2]}
    gattrs = {"__fwd_type__": "unsqueeze", "__fwd_attrs__": attrs,
              "__fwd_input_slots__": ["X"], "__fwd_output_slots__": ["Out"],
              "__uid__": 0, "__wanted__": {("X", 0)}}
    jouts, touts = _emit_both("unsqueeze", {"X": [x]}, attrs)
    jg = jreg.get_op_info("generic_grad").emit(
        _jax_ctx(), {"X": [jnp.asarray(x)], "Out": jouts["Out"],
                     "Out@GRAD": [jnp.asarray(ct)]}, gattrs)
    tg = treg.get_op_info("generic_grad").emit(
        _torch_ctx(), {"X": [torch.from_numpy(x)], "Out": touts["Out"],
                       "Out@GRAD": [torch.from_numpy(ct)]}, gattrs)
    np.testing.assert_array_equal(_np(tg["X@GRAD"][0]),
                                  np.asarray(jg["X@GRAD"][0]))


# -- (c) the executor's sub-block lowering ------------------------------------


def test_sub_block_name_missing_raises_naming_the_op():
    """A cond whose desc declares no externals: its branch reads `x`,
    which the sub-block's env lacks (no scope reads inside a sub-block)."""
    x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
    flag = tfluid.layers.data(name="flag", shape=[1], dtype="float32",
                              append_batch_size=False)
    out = tfluid.layers.ifelse(flag, lambda: [tfluid.layers.scale(x, 2.0)],
                               lambda: [tfluid.layers.scale(x, -1.0)])
    op = tfluid.default_main_program().global_block().ops[-1]
    assert op.type == "cond"
    op.inputs["X"] = []
    op.attrs["x_names"] = []
    with pytest.raises(OpLoweringError, match="'scale'") as e:
        tfluid.Executor(tfluid.CPUPlace()).run(
            feed={"x": np.ones((2, 4), np.float32),
                  "flag": np.ones(1, np.float32)}, fetch_list=[out])
    assert "'cond'" in str(e.value)


def test_while_block_takes_the_loud_eager_route():
    total, _ = _while_program(tfluid)
    report = step_loop.safety_report(tfluid.default_main_program())
    assert not report["safe"]
    assert any("'while'" in r and "nested control-flow block" in r
               for r in report["reasons"])
    exe = tfluid.Executor(tfluid.CPUPlace())
    with pytest.warns(UserWarning, match="loop-unsafe"):
        res = exe.run(feed={}, fetch_list=[total], steps_per_dispatch=2)
    np.testing.assert_array_equal(res[0], [[45.0], [45.0]])


def test_recompute_is_not_ported():
    """Ported since: ``layers.recompute`` builds the JAX package's
    segment (``tests/test_torch_dropout_remat.py`` holds it to JAX), and
    the op runs its sub-block."""
    x = tfluid.layers.data("x", shape=[4])
    with tfluid.layers.recompute():
        y = tfluid.layers.scale(x, scale=2.0)
    op = tfluid.default_main_program().global_block().ops[-1]
    assert op.type == "recompute" and op.attrs["out_names"] == [y.name]
    (got,) = tfluid.Executor(tfluid.CPUPlace()).run(
        feed={"x": np.ones((2, 4), np.float32)}, fetch_list=[y])
    np.testing.assert_array_equal(got, np.full((2, 4), 2.0, np.float32))
