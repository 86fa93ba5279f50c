"""K steps a dispatch (``Executor.run(steps_per_dispatch=K)``,
``framework/step_loop.py``), its run options and the data plane
(``reader/``, ``data_feeder.py``) of the port, on the CPU.

- Port against JAX: the same numpy state (the JAX startup's, carried in
  by name) and the same stacked feeds through both packages'
  ``run(steps_per_dispatch=4)``, for an MLP with Momentum and a tiny
  ``build_lm_train_program`` with Adam, in both fetch modes: the stacked
  losses at 1e-4 relative, the state after 4 steps at 1e-4 of each
  tensor's max |value|.
- The JAX package's contract (``tests/test_step_loop.py``), one
  counterpart each: K = 4 equals 4 sequential runs to the bit, unstacked
  feeds and K < 1 are refused, the unsafe fallback warns and stays
  bitwise, a clean block is safe, the environment knob.
- The captured graph's body (``CapturedLoop.record``), which the card
  records once and replays, run here eagerly on its static buffers: the
  same bits as 4 sequential runs, twice in a row, after the scope was
  replaced, through the executor's dispatches against two scopes in turn,
  and an error names the op being walked.
- The data plane: stacking order and the ragged tail, tuple samples, an
  exception in the producer, an abandoned iterator, ``feed_stacked``'s
  shape rules, ``DeviceFeeder`` blocks driving a dispatch.
- Program versions (an edit drops the cached loop), ``block_id``,
  ``rng_step``, ``check_nan_inf`` and ``verify``.

The capture and replay themselves need a card:
``tests/test_torch_step_loop_card.py`` (no JAX there) skips here, and the
smoke runs them at full width (``chip_smoke.py``'s ``step_loop_*``
phases)."""

import threading
import time
import warnings
from contextlib import nullcontext as _nullcontext

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu_torch.analysis import dataflow as tdataflow
from paddle_tpu_torch.autotune import knobs as tknobs
from paddle_tpu_torch.framework import executor as texecutor
from paddle_tpu_torch.framework import step_loop
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.reader import creator as tcreator
from paddle_tpu_torch.reader import decorator as rdec

K, BS = 4, 4
V, D, L, NH, T = 64, 32, 2, 2, 16


@pytest.fixture(autouse=True)
def _fresh():
    tfluid.reset()
    jfluid.reset()
    yield


def _mlp(fluid):
    x = fluid.layers.data(name="x", shape=[16])
    y = fluid.layers.data(name="y", shape=[1], dtype="int64")
    h = fluid.layers.fc(input=x, size=32, act="relu")
    logits = fluid.layers.fc(input=h, size=4)
    cost = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, y))
    fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(cost)
    return cost


def _mlp_feeds(seed=0, k=K, bs=BS):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(k, bs, 16).astype(np.float32),
            "y": rng.randint(0, 4, (k, bs, 1)).astype(np.int64)}


def _lm(fluid, transformer):
    # Adam 1e-3: a unit-size Adam step (lr 1e-2) turns f32 reduction-order
    # noise into lr-sized moves where |g| ~ sqrt(v) (test_torch_training's
    # note), which 1e-4 of max |value| after 4 steps does not hold
    return transformer.build_lm_train_program(
        seq_len=T, vocab_size=V, dim=D, n_layers=L, n_heads=NH,
        dtype="float32", learning_rate=1e-3)


def _lm_feeds(seed=0, k=K, bs=2):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, V, (k, bs, T, 1)).astype(np.int64)
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=2)}


def _persistable(program):
    return [n for n, v in program.global_block().vars.items()
            if v.persistable]


def _port(build):
    """The port's program, startup run on the CPU; (loss, main, exe)."""
    loss = build()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    return loss, tfluid.default_main_program(), exe


def _copy_scope(program, scope=None):
    src = scope or tfluid.global_scope()
    dst = tfluid.Scope()
    for n in _persistable(program):
        dst.set(n, src.find(n).clone())
    return dst


def _assert_scopes_equal(program, sa, sb):
    for n in _persistable(program):
        assert torch.equal(sa.find(n), sb.find(n)), n


# -- the port against JAX -------------------------------------------------------

CASES = {"mlp": (lambda f, t: _mlp(f), _mlp_feeds),
         "lm": (_lm, _lm_feeds)}


@pytest.mark.parametrize("fetch_every", ["all", "last"])
@pytest.mark.parametrize("case", ["mlp", "lm"])
def test_k4_dispatch_matches_jax(case, fetch_every):
    build, feeds_of = CASES[case]
    jloss = build(jfluid, jtransformer)
    jmain = jfluid.default_main_program()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    start = {n: jfluid.global_scope().find_np(n) for n in _persistable(jmain)}

    tloss = build(tfluid, ttransformer)
    tmain = tfluid.default_main_program()
    assert sorted(_persistable(tmain)) == sorted(start)
    tfluid.load_persistables(tmain, start)
    texe = tfluid.Executor(tfluid.CPUPlace())

    feeds = feeds_of()
    jout = np.asarray(jexe.run(jmain, feed=feeds, fetch_list=[jloss],
                               steps_per_dispatch=K,
                               fetch_every=fetch_every)[0])
    tout = texe.run(tmain, feed=feeds, fetch_list=[tloss],
                    steps_per_dispatch=K, fetch_every=fetch_every)[0]
    assert tout.shape == jout.shape == ((K, 1) if fetch_every == "all"
                                        else (1,))
    np.testing.assert_allclose(tout, jout, rtol=1e-4)
    for n in start:
        j = jfluid.global_scope().find_np(n)
        t = tfluid.global_scope().find_np(n)
        np.testing.assert_allclose(
            t, j, rtol=0, atol=1e-4 * max(float(np.abs(j).max()), 1e-12),
            err_msg=n)
    assert texe.global_step == K


# -- the JAX package's contract, one counterpart each ---------------------------

def _sequential(main, loss, feeds, scope, k=K, rng_step=0, exe=None):
    exe = exe or tfluid.Executor(tfluid.CPUPlace())
    return [exe.run(main, feed={n: v[i] for n, v in feeds.items()},
                    fetch_list=[loss], scope=scope, rng_step=rng_step + i)[0]
            for i in range(k)]


def test_fused_k4_bitwise_parity():
    loss, main, exe = _port(lambda: _mlp(tfluid))
    sb = _copy_scope(main)
    feeds = _mlp_feeds()
    seq = _sequential(main, loss, feeds, sb)
    fused = exe.run(main, feed=feeds, fetch_list=[loss], rng_step=0,
                    steps_per_dispatch=K)[0]
    assert fused.shape[0] == K
    for i in range(K):
        np.testing.assert_array_equal(fused[i], seq[i])
    _assert_scopes_equal(main, tfluid.global_scope(), sb)


def test_fetch_every_last():
    loss, main, exe = _port(lambda: _mlp(tfluid))
    sb = _copy_scope(main)
    feeds = _mlp_feeds()
    seq_last = _sequential(main, loss, feeds, sb)[-1]
    last = exe.run(main, feed=feeds, fetch_list=[loss], rng_step=0,
                   steps_per_dispatch=K, fetch_every="last")[0]
    assert last.shape == seq_last.shape  # no K dim
    np.testing.assert_array_equal(last, seq_last)


def test_return_numpy_false_stacks_tensors():
    loss, main, exe = _port(lambda: _mlp(tfluid))
    out = exe.run(main, feed=_mlp_feeds(), fetch_list=[loss],
                  steps_per_dispatch=K, return_numpy=False)[0]
    assert isinstance(out, torch.Tensor) and tuple(out.shape) == (K, 1)


def test_unstacked_feed_rejected():
    loss, main, exe = _port(lambda: _mlp(tfluid))
    feed = {n: v[0] for n, v in _mlp_feeds(bs=BS + 1).items()}
    with pytest.raises(ValueError, match="'x'|'y'"):
        exe.run(main, feed=feed, fetch_list=[loss], steps_per_dispatch=K)


def test_k_below_one_rejected():
    loss, main, exe = _port(lambda: _mlp(tfluid))
    with pytest.raises(ValueError):
        exe.run(main, feed={}, fetch_list=[loss], steps_per_dispatch=0)


def test_bad_fetch_mode_rejected():
    loss, main, exe = _port(lambda: _mlp(tfluid))
    with pytest.raises(ValueError, match="fetch_every"):
        exe.run(main, feed=_mlp_feeds(), fetch_list=[loss],
                steps_per_dispatch=K, fetch_every="first")


def test_unsafe_fallback_warns_and_stays_bitwise(monkeypatch):
    loss, main, exe = _port(lambda: _mlp(tfluid))
    sb = _copy_scope(main)
    feeds = _mlp_feeds()
    monkeypatch.setattr(step_loop, "safety_report", lambda *a: {
        "safe": False, "reasons": ["test: forced unsafe"]})
    seq = _sequential(main, loss, feeds, sb)
    with pytest.warns(UserWarning, match="loop-unsafe"):
        fused = exe.run(main, feed=feeds, fetch_list=[loss], rng_step=0,
                        steps_per_dispatch=K)[0]
    assert fused.shape[0] == K
    for i in range(K):
        np.testing.assert_array_equal(fused[i], seq[i])
    _assert_scopes_equal(main, tfluid.global_scope(), sb)


class TestSafetyReport:
    def test_clean_training_block_is_safe(self):
        _mlp(tfluid)
        rep = step_loop.safety_report(tfluid.default_main_program())
        assert rep["safe"] and not rep["reasons"]

    def test_lm_training_block_is_safe(self):
        _lm(tfluid, ttransformer)
        assert step_loop.safety_report(tfluid.default_main_program())["safe"]

    def test_host_io_flagged(self):
        _mlp(tfluid)
        main = tfluid.default_main_program()
        main.global_block().append_op(
            type="save", inputs={"X": ["fc_0.w_0"]}, outputs={},
            attrs={"file_path": "/tmp/x"})
        rep = step_loop.safety_report(main)
        assert not rep["safe"] and any("save" in r for r in rep["reasons"])

    def test_nested_block_flagged(self):
        _mlp(tfluid)
        main = tfluid.default_main_program()
        main.global_block().append_op(type="while", attrs={"sub_block": 1})
        rep = step_loop.safety_report(main)
        assert not rep["safe"] and "nested control-flow" in rep["reasons"][0]

    @pytest.mark.parametrize("op_type", ["uniform_random", "gaussian_random"])
    def test_generator_op_flagged_by_its_registration(self, op_type):
        from paddle_tpu_torch.ops.registry import get_op_info

        assert get_op_info(op_type).draws_rng
        assert not get_op_info("fill_constant").draws_rng
        _mlp(tfluid)
        main = tfluid.default_main_program()
        block = main.global_block()
        block.create_var(name="noise", shape=(2,), dtype="float32")
        block.append_op(op_type, outputs={"Out": ["noise"]},
                        attrs={"shape": [2], "dtype": "float32"})
        rep = step_loop.safety_report(main)
        assert not rep["safe"]
        assert rep["reasons"] == [
            f"op #{len(block.ops) - 1} {op_type!r}: draws from a generator "
            f"seeded on the host each step (a captured loop would replay "
            f"one step's draws)"]

    def test_grad_of_generator_op_flagged(self):
        _mlp(tfluid)
        main = tfluid.default_main_program()
        main.global_block().append_op(
            "generic_grad", attrs={"__fwd_type__": "uniform_random"})
        assert not step_loop.safety_report(main)["safe"]


def _noise_program():
    """x (fed, [2, 3]) + uniform noise → out, and a counter state that the
    block advances, so the random op is live every step."""
    block = tfluid.default_main_program().global_block()
    tfluid.layers.data(name="x", shape=[3])
    for n in ("noise", "out", "one"):
        block.create_var(name=n, shape=(2, 3), dtype="float32")
    block.create_var(name="count", shape=(1,), dtype="float32",
                     persistable=True)
    block.append_op("uniform_random", outputs={"Out": ["noise"]},
                    attrs={"shape": [2, 3], "dtype": "float32"})
    block.append_op("elementwise_add", inputs={"X": ["x"], "Y": ["noise"]},
                    outputs={"Out": ["out"]}, attrs={"axis": -1})
    block.append_op("fill_constant", outputs={"Out": ["one"]},
                    attrs={"shape": [1], "value": 1.0, "dtype": "float32"})
    block.append_op("elementwise_add", inputs={"X": ["count"], "Y": ["one"]},
                    outputs={"Out": ["count"]}, attrs={"axis": -1})
    tfluid.global_scope().set("count", np.zeros(1, np.float32))
    return tfluid.default_main_program()


def test_generator_op_warns_names_it_and_equals_sequential():
    main = _noise_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    x = np.random.RandomState(0).randn(K, 2, 3).astype(np.float32)
    with pytest.warns(UserWarning, match="'uniform_random'"):
        fused = exe.run(main, feed={"x": x}, fetch_list=["out"],
                        rng_step=5, steps_per_dispatch=K)[0]
    ref = tfluid.Scope()
    ref.set("count", np.zeros(1, np.float32))
    seq = [tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed={"x": x[i]}, fetch_list=["out"], scope=ref,
        rng_step=5 + i)[0] for i in range(K)]
    np.testing.assert_array_equal(fused, np.stack(seq))
    assert not np.array_equal(fused[0] - x[0], fused[1] - x[1])
    np.testing.assert_array_equal(tfluid.global_scope().find_np("count"),
                                  [float(K)])


class TestKnob:
    def test_env_override(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_STEPS_PER_DISPATCH", "4")
        assert tknobs.steps_per_dispatch(default=1, store=False) == 4

    def test_env_garbage_rejected(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_STEPS_PER_DISPATCH", "zero")
        with pytest.raises(ValueError):
            tknobs.steps_per_dispatch(default=1, store=False)
        monkeypatch.setenv("PADDLE_TPU_STEPS_PER_DISPATCH", "-2")
        with pytest.raises(ValueError):
            tknobs.steps_per_dispatch(default=1, store=False)

    def test_default_passthrough(self, monkeypatch):
        monkeypatch.delenv("PADDLE_TPU_STEPS_PER_DISPATCH", raising=False)
        assert tknobs.steps_per_dispatch(default=1, store=False) == 1
        assert tknobs.steps_per_dispatch(default=3) == 3

    def test_executor_run_respects_env(self, monkeypatch):
        loss, main, exe = _port(lambda: _mlp(tfluid))
        monkeypatch.setenv("PADDLE_TPU_STEPS_PER_DISPATCH", "2")
        out = exe.run(main, feed=_mlp_feeds(k=2), fetch_list=[loss])[0]
        assert out.shape[0] == 2  # env opted run() into the fused path


# -- the graph's body, run eagerly on its buffers -------------------------------

def _body(exe, main, loss, feeds, fetch_every="all", scope=None):
    scope = scope or tfluid.global_scope()
    loop = step_loop.CapturedLoop.prepare(
        exe, main, main.global_block(), feeds, [loss.name], scope, K,
        fetch_every, step0=0)
    loop.load_feeds(feeds)
    loop.adopt_state(scope)
    loop.record(exe)
    return loop


@pytest.mark.parametrize("fetch_every", ["all", "last"])
@pytest.mark.parametrize("case", ["mlp", "lm"])
def test_graph_body_equals_sequential_runs(case, fetch_every):
    """Twice in a row from one state, the body's stacked fetches and the
    scope (whose entries are the static buffers) equal 8 sequential runs
    to the bit; the buffers stay the scope's entries."""
    build, feeds_of = CASES[case]
    loss, main, exe = _port(lambda: build(tfluid, ttransformer))
    sb = _copy_scope(main)
    for d in range(2):
        feeds = feeds_of(seed=d)
        seq = _sequential(main, loss, feeds, sb, rng_step=K * d)
        loop = _body(exe, main, loss, feeds, fetch_every)
        got = loop.fetches[loss.name].numpy()
        want = np.stack(seq) if fetch_every == "all" else seq[-1]
        np.testing.assert_array_equal(got, want)
        _assert_scopes_equal(main, tfluid.global_scope(), sb)
    for n, buf in loop.state.items():
        assert tfluid.global_scope().find(n) is buf
    assert set(loop.writes) <= set(loop.state)
    assert "learning_rate_0" not in loop.writes  # read, never written


def test_graph_body_adopts_replaced_state():
    """A body run after an eager run() replaced the scope's entries reads
    the new values (the replay's identity check), and equals the eager
    continuation."""
    loss, main, exe = _port(lambda: _mlp(tfluid))
    feeds = _mlp_feeds()
    loop = step_loop.CapturedLoop.prepare(
        exe, main, main.global_block(), feeds, [loss.name],
        tfluid.global_scope(), K, "all", step0=0)
    exe.run(main, feed={n: v[0] for n, v in feeds.items()},
            fetch_list=[loss])
    w = "fc_0.w_0"
    assert tfluid.global_scope().find(w) is not loop.state[w]
    sb = _copy_scope(main)
    seq = _sequential(main, loss, feeds, sb)
    loop.load_feeds(feeds)
    loop.adopt_state(tfluid.global_scope())
    assert tfluid.global_scope().find(w) is loop.state[w]
    loop.record(exe)
    np.testing.assert_array_equal(loop.fetches[loss.name].numpy(),
                                  np.stack(seq))
    _assert_scopes_equal(main, tfluid.global_scope(), sb)


def test_graph_body_error_names_the_op(monkeypatch):
    loss, main, exe = _port(lambda: _mlp(tfluid))
    feeds = _mlp_feeds()
    loop = step_loop.CapturedLoop.prepare(
        exe, main, main.global_block(), feeds, [loss.name],
        tfluid.global_scope(), K, "all", step0=0)
    loop.load_feeds(feeds)
    from paddle_tpu_torch.ops import registry

    info = registry.get_op_info("momentum")

    def broken(ctx, ins, attrs):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(info, "emit", broken)
    first = next(i for i, op in enumerate(main.global_block().ops)
                 if op.type == "momentum")
    with pytest.raises(step_loop.StepLoopError,
                       match=rf"step 0 of 4, op #{first} 'momentum'"):
        loop.record(exe)


def test_aliased_state_gets_its_own_buffer():
    """Two written names on one tensor would take each other's final copy:
    the plan gives the second its own storage, in the scope too."""
    block = tfluid.default_main_program().global_block()
    for n in ("a", "b", "one"):
        block.create_var(name=n, shape=(1,), dtype="float32",
                         persistable=n != "one")
    block.append_op("fill_constant", outputs={"Out": ["one"]},
                    attrs={"shape": [1], "value": 1.0, "dtype": "float32"})
    block.append_op("elementwise_add", inputs={"X": ["a"], "Y": ["one"]},
                    outputs={"Out": ["a"]}, attrs={"axis": -1})
    block.append_op("elementwise_add", inputs={"X": ["b"], "Y": ["a"]},
                    outputs={"Out": ["b"]}, attrs={"axis": -1})
    shared = torch.zeros(1)
    scope = tfluid.global_scope()
    scope.set("a", shared)
    scope.set("b", shared)
    exe = tfluid.Executor(tfluid.CPUPlace())
    main = tfluid.default_main_program()
    loop = step_loop.CapturedLoop.prepare(exe, main, block, {}, ["b"], scope,
                                          K, "all", step0=0)
    assert loop.state["a"].data_ptr() != loop.state["b"].data_ptr()
    assert scope.find("b") is loop.state["b"]
    loop.record(exe)
    # a: 1, 2, 3, 4; b: 1, 3, 6, 10
    np.testing.assert_array_equal(loop.fetches["b"].numpy()[:, 0],
                                  [1, 3, 6, 10])
    np.testing.assert_array_equal(scope.find_np("a"), [4.0])


# -- program versions and run options --------------------------------------------

def test_program_version_and_token():
    a, b = tfluid.Program(), tfluid.Program()
    assert a._cache_token != b._cache_token
    v = a._version
    a.global_block().create_var(name="t", shape=(1,))
    a.global_block().append_op("fill_constant", outputs={"Out": ["t"]},
                               attrs={"shape": [1], "value": 0.0})
    assert a._version == v + 2
    a.create_block()
    assert a._version == v + 3 and a.current_block().idx == 1
    a.rollback()
    assert a.current_block().idx == 0


def test_fusion_pass_bumps_the_version():
    from paddle_tpu_torch import training_fusion
    from paddle_tpu_torch.models import resnet

    img = tfluid.layers.data(name="image", shape=[16, 16, 3])
    resnet.resnet_imagenet(img, class_dim=10, depth=18, layout="NHWC")
    main = tfluid.default_main_program()
    v = main._version
    assert training_fusion.fuse_bn_matmul(main) > 0
    assert main._version > v


class _FakeLoop:
    closed = 0

    def close(self):
        _FakeLoop.closed += 1


def test_edit_between_dispatches_drops_cached_loop():
    """A loop captured for one version of the program is released at the
    next dispatch after an edit; another program's stays, and the safety
    verdict is taken again."""
    loss, main, exe = _port(lambda: _mlp(tfluid))
    other = tfluid.Program()
    old = (main._cache_token, main._version)
    exe._loops[old + ("rest",)] = _FakeLoop()
    exe._loops[(other._cache_token, other._version, "rest")] = _FakeLoop()
    _FakeLoop.closed = 0
    block = main.global_block()
    block.create_var(name="noise", shape=(2,), dtype="float32")
    block.append_op("uniform_random", outputs={"Out": ["noise"]},
                    attrs={"shape": [2], "dtype": "float32"})
    with pytest.warns(UserWarning, match="uniform_random"):
        exe.run(main, feed=_mlp_feeds(), fetch_list=[loss],
                steps_per_dispatch=K)
    assert _FakeLoop.closed == 1
    keys = sorted(exe._loops, key=lambda key: key[0])
    assert [key[0] for key in keys] == sorted([other._cache_token,
                                               main._cache_token])
    (new,) = [key for key in keys if key[0] == main._cache_token]
    assert new[1] == main._version and new[1:2] != old[1:2]
    assert not exe._loops[new].safety["safe"] and exe._loops[new].loop is None
    exe.close()
    assert _FakeLoop.closed == 2 and not exe._loops


class _BodyGraph:
    """Stands in for a captured graph on the CPU: a replay runs the
    graph's body on its static buffers."""

    def __init__(self, loop, exe):
        self.loop, self.exe = loop, exe

    def replay(self):
        self.loop.record(self.exe)


def test_two_scopes_alternate_each_on_its_own_state(monkeypatch):
    """One executor and program dispatch against two scopes in turn
    (each scope's first dispatch eager, its second captured, its third a
    replay), the graph's body standing in for the graph: each scope
    equals K eager steps of its own, to the bit, every time.  Each scope
    has its own loop, and no two loops share a state buffer."""
    loss, main, exe = _port(lambda: _mlp(tfluid))
    exe._captures = True
    monkeypatch.setattr(step_loop.CapturedLoop, "record_graph",
                        lambda loop, exe: _BodyGraph(loop, exe))
    scopes = [tfluid.global_scope(), tfluid.Scope()]
    for n in _persistable(main):  # the second starts on the same tensors
        scopes[1].set(n, scopes[0].find(n))
    twins = [_copy_scope(main, s) for s in scopes]
    for d in range(3):
        for j, scope in enumerate(scopes):
            with tfluid.scope_guard(scope) if j else _nullcontext():
                feeds = _mlp_feeds(seed=10 * j + d)
                want = _sequential(main, loss, feeds, twins[j])
                got = exe.run(main, feed=feeds, fetch_list=[loss],
                              steps_per_dispatch=K)[0]
            np.testing.assert_array_equal(got, np.stack(want))
            _assert_scopes_equal(main, scope, twins[j])
    loops = [entry.loop for entry in exe._loops.values()]
    assert len(loops) == 2 and None not in loops
    ptrs = [{t.untyped_storage().data_ptr() for t in loop.state.values()}
            for loop in loops]
    assert not ptrs[0] & ptrs[1]
    for loop, scope in zip(loops, scopes):
        for n, buf in loop.state.items():
            assert scope.find(n) is buf


def test_block_id_runs_that_block():
    """Block 1 (child of block 0) holds its own ops; run(block_id=1) runs
    them and reads the parent's variables, in both packages."""
    got = {}
    for tag, fluid in (("jax", jfluid), ("torch", tfluid)):
        prog = fluid.default_main_program()
        g = prog.global_block()
        for n in ("a", "b", "c"):
            g.create_var(name=n, shape=(2,), dtype="float32")
        g.append_op("fill_constant", outputs={"Out": ["a"]},
                    attrs={"shape": [2], "value": 1.0, "dtype": "float32"})
        sub = prog.create_block()
        sub.append_op("fill_constant", outputs={"Out": ["b"]},
                      attrs={"shape": [2], "value": 5.0, "dtype": "float32"})
        sub.append_op("elementwise_add", inputs={"X": ["b"], "Y": ["b"]},
                      outputs={"Out": ["c"]}, attrs={"axis": -1})
        prog.rollback()
        exe = fluid.Executor(fluid.CPUPlace())
        got[tag] = (np.asarray(exe.run(prog, fetch_list=["a"])[0]),
                    np.asarray(exe.run(prog, fetch_list=["c"],
                                       block_id=1)[0]))
        with pytest.raises(Exception):
            exe.run(prog, fetch_list=["c"])  # block 0 never computes c
    for j, t in zip(got["jax"], got["torch"]):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(got["torch"][1], [10.0, 10.0])


def test_rng_step_pins_the_generator_step():
    main = _noise_program()
    x = np.zeros((2, 3), np.float32)

    def draw(exe, rng_step=None):
        return exe.run(main, feed={"x": x}, fetch_list=["out"],
                       rng_step=rng_step)[0]

    exe = tfluid.Executor(tfluid.CPUPlace())
    a = draw(exe, rng_step=7)
    b = draw(exe, rng_step=7)
    np.testing.assert_array_equal(a, b)
    assert exe.global_step == 2
    fresh = tfluid.Executor(tfluid.CPUPlace())
    assert not np.array_equal(draw(fresh), draw(fresh))  # steps 0, 1
    np.testing.assert_array_equal(draw(tfluid.Executor(tfluid.CPUPlace()),
                                       rng_step=1), draw(fresh, 1))


def test_check_nan_inf():
    block = tfluid.default_main_program().global_block()
    for n in ("x", "z", "y"):
        block.create_var(name=n, shape=(2,), dtype="float32")
    block.append_op("elementwise_div", inputs={"X": ["x"], "Y": ["z"]},
                    outputs={"Out": ["y"]}, attrs={"axis": -1})
    main = tfluid.default_main_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    one = np.ones(2, np.float32)
    bad = {"x": one, "z": np.array([1.0, 0.0], np.float32)}
    exe.run(main, feed=bad, fetch_list=["y"])  # off: inf passes
    exe.check_nan_inf = True
    np.testing.assert_array_equal(
        exe.run(main, feed={"x": one, "z": one}, fetch_list=["y"])[0], one)
    with pytest.raises(FloatingPointError, match="'y'"):
        exe.run(main, feed=bad, fetch_list=["y"])
    with pytest.raises(FloatingPointError, match="'y'"):
        exe.run(main, feed={"x": np.stack([one, one]),
                            "z": np.stack([one, bad["z"]])},
                fetch_list=["y"], steps_per_dispatch=2)


def test_verify_runs_the_verifier_and_raises_on_a_broken_program(
        monkeypatch):
    from paddle_tpu_torch.analysis import VerificationError

    loss, main, exe = _port(lambda: _mlp(tfluid))
    feed = {n: v[0] for n, v in _mlp_feeds().items()}
    stacked = _mlp_feeds(k=2)
    exe.run(main, feed=feed, fetch_list=[loss], verify=True)
    exe.run(main, feed=stacked, fetch_list=[loss], verify=True,
            steps_per_dispatch=2)
    main.global_block().append_op("bogus_xyz", outputs={"Out": ["zz"]})
    with pytest.raises(VerificationError, match="PTV002"):
        exe.run(main, feed=feed, fetch_list=[loss], verify=True)
    with pytest.raises(VerificationError, match="PTV002"):
        exe.run(main, feed=stacked, fetch_list=[loss], verify=True,
                steps_per_dispatch=2)
    monkeypatch.setenv("PADDLE_TPU_VERIFY", "1")
    with pytest.raises(VerificationError, match="Executor.run"):
        exe.run(main, feed=feed, fetch_list=[loss])
    monkeypatch.setenv("PADDLE_TPU_VERIFY", "0")
    # unverified, the walk skips the dead unregistered op and runs
    (got,) = exe.run(main, feed=feed, fetch_list=[loss])
    assert np.isfinite(got).all()


def test_sub_block_indices_matches_jax():
    from paddle_tpu.analysis import dataflow as jdataflow

    class Op:
        attrs = {"true_block": 2, "sub_block": 1, "x": 3}

    assert tdataflow.sub_block_indices(Op) == \
        jdataflow.sub_block_indices(Op) == [1, 2]
    assert tdataflow.SUB_BLOCK_ATTRS == jdataflow.SUB_BLOCK_ATTRS


# -- the data plane -------------------------------------------------------------

def _dict_reader(n, d=3):
    def reader():
        for i in range(n):
            yield {"x": np.full((2, d), i, np.float32),
                   "y": np.full((2, 1), i, np.float32)}
    return reader


def _threads_named(name):
    return [t for t in threading.enumerate()
            if t.name == name and t.is_alive()]


def _wait_gone(name):
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and _threads_named(name):
        time.sleep(0.05)
    return not _threads_named(name)


class TestPrefetch:
    def test_stacking_order_and_ragged_tail(self):
        blocks = list(rdec.prefetch(_dict_reader(10), depth=2, steps=4,
                                    to_device=False)())
        assert [b["x"].shape[0] for b in blocks] == [4, 4, 2]
        flat = np.concatenate([b["x"][:, 0, 0] for b in blocks])
        np.testing.assert_array_equal(flat, np.arange(10))

    def test_steps_one_is_identity(self):
        items = list(rdec.prefetch(_dict_reader(3), depth=2,
                                   to_device=False)())
        assert len(items) == 3
        assert items[1]["x"].shape == (2, 3)  # no K dim added

    def test_to_device_yields_tensors_on_the_place(self):
        blocks = list(rdec.prefetch(_dict_reader(4), steps=2,
                                    place=tfluid.CPUPlace())())
        assert all(isinstance(b["x"], torch.Tensor) for b in blocks)
        assert blocks[1]["x"].device == torch.device("cpu")
        np.testing.assert_array_equal(blocks[1]["y"].numpy()[:, 0, 0],
                                      [2, 3])

    def test_to_device_defaults_to_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CPUPlace"):
            list(rdec.prefetch(_dict_reader(2), steps=2)())

    def test_tuple_samples_stack_columnwise(self):
        def reader():
            for i in range(4):
                yield (np.full((2,), i, np.float32),
                       np.full((1,), -i, np.float32))
        blocks = list(rdec.prefetch(reader, steps=2, to_device=False)())
        assert len(blocks) == 2 and isinstance(blocks[0], tuple)
        assert blocks[0][0].shape == (2, 2)
        np.testing.assert_array_equal(blocks[1][1][:, 0], [-2, -3])

    def test_exception_propagates_to_consumer(self):
        def reader():
            yield {"x": np.zeros(2, np.float32)}
            yield {"x": np.ones(2, np.float32)}
            raise RuntimeError("source went away")
        it = rdec.prefetch(reader, steps=2, to_device=False)()
        next(it)  # the complete block arrives intact
        with pytest.raises(RuntimeError, match="source went away"):
            next(it)

    def test_abandoned_iterator_stops_producer(self):
        started = threading.Event()

        def endless():
            started.set()
            i = 0
            while True:
                yield {"x": np.full((2,), i, np.float32)}
                i += 1

        it = rdec.prefetch(endless, depth=2, steps=2, to_device=False)()
        next(it)
        assert started.is_set()
        it.close()  # GeneratorExit -> stop event -> producer exits
        assert _wait_gone("paddle-tpu-prefetch"), \
            "prefetch producer thread leaked after iterator close"

    def test_bad_args_rejected(self):
        with pytest.raises(ValueError):
            rdec.prefetch(_dict_reader(1), depth=0)
        with pytest.raises(ValueError):
            rdec.prefetch(_dict_reader(1), steps=0)


class TestReaders:
    def test_compose_batch_shuffle_firstn_chain(self):
        a = tcreator.np_array(np.arange(6))
        b = tcreator.np_array(np.arange(6) * 10)
        assert list(rdec.compose(a, b)())[2] == (2, 20)
        assert [len(x) for x in rdec.batch(a, 4)()] == [4, 2]
        assert [len(x) for x in rdec.batch(a, 4, drop_last=True)()] == [4]
        sh = list(rdec.shuffle(a, 3, seed=1)())
        assert sorted(sh) == list(range(6))
        assert list(rdec.firstn(rdec.chain(a, b), 8)()) == \
            [0, 1, 2, 3, 4, 5, 0, 10]
        assert list(rdec.map_readers(lambda x, y: x + y, a, b)()) == \
            [11 * i for i in range(6)]
        assert list(rdec.buffered(a, 2)()) == list(range(6))
        assert list(rdec.xmap_readers(lambda x: x * 2, a, 2, 4,
                                      order=True)()) == \
            [2 * i for i in range(6)]
        c = rdec.cache(a)
        assert list(c()) == list(c()) == list(range(6))

    def test_readers_match_jax(self):
        from paddle_tpu.reader import creator as jcreator
        from paddle_tpu.reader import decorator as jdec

        for mod, cr in ((rdec, tcreator), (jdec, jcreator)):
            r = cr.np_array(np.arange(20))
            got = list(mod.batch(mod.shuffle(r, 7, seed=3), 6)())
            if mod is rdec:
                mine = got
            else:
                assert [list(map(int, x)) for x in mine] == \
                    [list(map(int, x)) for x in got]

    def test_text_file_and_recordio(self, tmp_path):
        from paddle_tpu_torch.native import recordio as trecordio

        p = tmp_path / "lines.txt"
        p.write_text("a\nb b\n\nc\n")
        assert list(tcreator.text_file(str(p))()) == ["a", "b b", "", "c"]
        shard = str(tmp_path / "lines.rio")
        with trecordio.Writer(shard) as w:
            for line in tcreator.text_file(str(p))():
                w.write(line.encode())
        assert list(tcreator.recordio([shard])()) == [b"a", b"b b", b"",
                                                      b"c"]


class TestDataFeeder:
    def _feeder(self):
        tfluid.layers.data(name="x", shape=[3])
        tfluid.layers.data(name="y", shape=[1])
        return tfluid.DataFeeder(feed_list=["x", "y"],
                                 place=tfluid.CPUPlace())

    def test_feed_matches_jax(self):
        jfluid.layers.data(name="x", shape=[3])
        jfluid.layers.data(name="s", shape=[1], dtype="int64", lod_level=1)
        tfluid.layers.data(name="x", shape=[3])
        tfluid.layers.data(name="s", shape=[1], dtype="int64", lod_level=1)
        mb = [(np.arange(3) + i, np.arange(i + 1)) for i in range(3)]
        j = jfluid.DataFeeder(["x", "s"], jfluid.CPUPlace()).feed(mb)
        t = tfluid.DataFeeder(["x", "s"], tfluid.CPUPlace()).feed(mb)
        assert sorted(t) == sorted(j) == ["s", "s@LENGTH", "x"]
        for n in j:
            assert t[n].dtype == np.asarray(j[n]).dtype, n
            np.testing.assert_array_equal(t[n], np.asarray(j[n]))

    def test_feed_stacked_shapes(self):
        feeder = self._feeder()
        mbs = [[(np.arange(3) + i, [float(i)]) for _ in range(4)]
               for i in range(2)]
        out = feeder.feed_stacked(mbs)
        assert out["x"].shape == (2, 4, 3)
        assert out["y"].shape == (2, 4, 1)
        np.testing.assert_array_equal(out["x"][1, 0], np.arange(3) + 1)

    def test_feed_stacked_rejects_ragged_shapes(self):
        feeder = self._feeder()
        mbs = [[(np.arange(3), [0.0])] * 4, [(np.arange(3), [0.0])] * 3]
        with pytest.raises(ValueError, match="shapes differ"):
            feeder.feed_stacked(mbs)

    def test_feed_stacked_empty_rejected(self):
        with pytest.raises(ValueError):
            self._feeder().feed_stacked([])

    def test_device_feeder_steps_blocks(self):
        feeder = self._feeder()

        def reader():
            for i in range(5):
                yield [(np.arange(3) + i, [float(i)])] * 4

        blocks = list(tfluid.DeviceFeeder(feeder, reader, steps=2))
        assert [tuple(b["x"].shape) for b in blocks] == [
            (2, 4, 3), (2, 4, 3), (1, 4, 3)]
        assert isinstance(blocks[0]["x"], torch.Tensor)
        assert blocks[0]["x"].device == torch.device("cpu")
        np.testing.assert_array_equal(blocks[2]["y"].numpy()[0, :, 0],
                                      [4.0] * 4)

    def test_device_feeder_defaults_to_the_card(self, monkeypatch):
        tfluid.layers.data(name="x", shape=[3])
        feeder = tfluid.DataFeeder(feed_list=["x"])
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CPUPlace"):
            list(tfluid.DeviceFeeder(feeder, lambda: iter([])))

    def test_device_feeder_error_and_abandon(self):
        feeder = self._feeder()

        def failing():
            yield [(np.arange(3), [0.0])] * 2
            raise OSError("disk gone")

        it = iter(tfluid.DeviceFeeder(feeder, failing))
        next(it)
        with pytest.raises(OSError, match="disk gone"):
            next(it)

        def endless():
            while True:
                yield [(np.arange(3), [0.0])] * 2

        it = iter(tfluid.DeviceFeeder(feeder, endless, depth=1))
        next(it)
        it.close()
        assert _wait_gone("paddle-tpu-device-feeder"), \
            "device feeder thread leaked after iterator close"

    def test_device_feeder_drives_fused_dispatch(self):
        """4 minibatches as 2 blocks of K = 2: the losses equal the
        numpy-fed dispatches' from the same state, to the bit."""
        loss, main, exe = _port(lambda: _mlp(tfluid))
        sb = _copy_scope(main)
        feeder = tfluid.DataFeeder(feed_list=["x", "y"],
                                   place=tfluid.CPUPlace())

        def reader():
            rng = np.random.RandomState(0)
            for _ in range(4):
                yield [(rng.randn(16).astype(np.float32),
                        [int(rng.randint(0, 4))]) for _ in range(4)]

        losses = []
        for block in tfluid.DeviceFeeder(feeder, reader, steps=2):
            out = exe.run(main, feed=block, fetch_list=[loss],
                          steps_per_dispatch=2)
            losses.extend(out[0].ravel().tolist())
        mbs = list(reader())
        want = []
        ref = tfluid.Executor(tfluid.CPUPlace())
        for i in (0, 2):
            want.extend(ref.run(main, feed=feeder.feed_stacked(mbs[i:i + 2]),
                                fetch_list=[loss], scope=sb,
                                steps_per_dispatch=2)[0].ravel().tolist())
        assert len(losses) == 4 and losses == want
        _assert_scopes_equal(main, tfluid.global_scope(), sb)


def test_no_warning_on_a_safe_dispatch():
    loss, main, exe = _port(lambda: _mlp(tfluid))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        exe.run(main, feed=_mlp_feeds(), fetch_list=[loss],
                steps_per_dispatch=K)

