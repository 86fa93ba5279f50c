"""The port's training options against the JAX package on the CPU: every
optimizer class, both regularizers, each gradient clip (a parameter's
own by value, by norm and by global norm, the optimizer's global norm,
the error clip of a variable), the five learning-rate schedules, the
pruning hook, ``print_gradient`` and ``ModelAverage``.

Each case builds the same small MLP (8 -> 16 relu -> 4, softmax cross
entropy) in both packages through the public API, carries the JAX
startup's values into the port by name, runs 3 steps on the same feeds
(made from a seed) and compares the per-step losses, the programs op for
op, and every persistable after step 3: parameters, accumulators, the
learning rate or global step.  Each tensor is held within `tol` of its
own largest |value|, the losses within `tol` relative: 1e-5 in f32 and
1e-10 in f64.  Adam and Momentum keep f32 moments and update through f32
whatever the parameter's dtype (as in JAX), and the schedules compute in
f32, so those f64 runs are held at f32's tolerance.

Then what only the port has: K = 2 steps a dispatch through the captured
graph's body (``CapturedLoop.record``) bitwise against 2 sequential
steps, with a schedule, a global-norm clip and L2 decay, the learning
rate after K steps equal to the schedule's; ``ModelAverage.apply`` and
``restore`` between dispatches, the next one training from the raw
parameters.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.framework import step_loop
from test_torch_step_loop import (_assert_scopes_equal, _BodyGraph,
                                  _copy_scope, _persistable)

TOL = {"float32": 1e-5, "float64": 1e-10}
STEPS = 3


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    yield


def _feeds(dtype, n=STEPS, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(16, 8).astype(dtype),
             "y": rng.randint(0, 4, (16, 1)).astype(np.int64)}
            for _ in range(n)]


def _mlp(f, dtype, opt, attr=None, tweak=None, average=None):
    """The MLP with `opt(f)` minimizing its loss; `attr(f)` is the hidden
    layer's ParamAttr, `tweak(f, h)` marks the hidden var, `average` a
    ModelAverage window.  Returns (loss, h, the ModelAverage or None)."""
    x = f.layers.data("x", shape=[8], dtype=dtype)
    y = f.layers.data("y", shape=[1], dtype="int64")
    h = f.layers.fc(input=x, size=16, act="relu",
                    param_attr=attr(f) if attr else None)
    logits = f.layers.fc(input=h, size=4)
    loss = f.layers.mean(f.layers.softmax_with_cross_entropy(logits, y))
    if tweak:
        tweak(f, h)
    opt(f).minimize(loss)
    ma = f.optimizer.ModelAverage(max_average_window=average) \
        if average else None
    return loss, h, ma


def _desc(program):
    return [(op.type, op.inputs, op.outputs, op.attrs)
            for op in program.global_block().ops]


def _pair(build, dtype, fetch=(), steps=STEPS):
    """`build(fluid)` in both packages, the JAX startup's values carried
    into the port, `steps` steps of each on the same feeds.  Returns
    (JAX losses, port losses, the fetches of `fetch` per step for each,
    the persistable names, both builds' results)."""
    jfluid.reset()
    tfluid.reset()
    jb = build(jfluid)
    jmain = jfluid.default_main_program()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    names = _persistable(jmain)
    start = {n: jfluid.global_scope().find_np(n) for n in names}
    tb = build(tfluid)
    tmain = tfluid.default_main_program()
    assert _desc(tmain) == _desc(jmain)
    assert _persistable(tmain) == names
    tfluid.load_persistables(tmain, start)
    texe = tfluid.Executor(tfluid.CPUPlace())
    jl, tl, jf, tf = [], [], [], []
    for feed in _feeds(dtype, steps):
        jo = jexe.run(jmain, feed=feed, fetch_list=[jb[0]] + list(fetch))
        to = texe.run(tmain, feed=feed, fetch_list=[tb[0]] + list(fetch))
        jl.append(float(np.asarray(jo[0])[0]))
        tl.append(float(to[0][0]))
        jf.append([np.asarray(v) for v in jo[1:]])
        tf.append(to[1:])
    return jl, tl, jf, tf, names, jb, tb


def _rel(t, j):
    j = np.asarray(j, np.float64)
    return float(np.abs(np.asarray(t, np.float64) - j).max()
                 / max(float(np.abs(j).max()), 1e-30))


def _assert_state_matches(names, tol):
    for n in names:
        j = jfluid.global_scope().find_np(n)
        t = tfluid.global_scope().find_np(n)
        assert t.dtype == j.dtype and t.shape == j.shape, n
        assert _rel(t, j) <= tol, (n, _rel(t, j))


def _assert_pair(build, dtype, tol=None, fetch=()):
    tol = TOL[dtype] if tol is None else tol
    jl, tl, jf, tf, names, jb, tb = _pair(build, dtype, fetch)
    np.testing.assert_allclose(tl, jl, rtol=tol)
    _assert_state_matches(names, tol)
    return jl, tl, jf, tf, jb, tb


# -- every optimizer class ------------------------------------------------------

OPTIMIZERS = {
    "sgd": lambda f, **kw: f.optimizer.SGD(0.1, **kw),
    "momentum": lambda f, **kw: f.optimizer.Momentum(0.05, 0.9, **kw),
    "nesterov": lambda f, **kw: f.optimizer.Momentum(0.05, 0.9,
                                                     use_nesterov=True, **kw),
    "adagrad": lambda f, **kw: f.optimizer.Adagrad(0.1, **kw),
    "adam": lambda f, **kw: f.optimizer.Adam(0.01, **kw),
    "adamax": lambda f, **kw: f.optimizer.Adamax(0.01, **kw),
    "decayed_adagrad": lambda f, **kw: f.optimizer.DecayedAdagrad(0.1, **kw),
    "rmsprop": lambda f, **kw: f.optimizer.RMSProp(0.01, momentum=0.5, **kw),
    "adadelta": lambda f, **kw: f.optimizer.Adadelta(**kw),
}
# computes through f32 whatever the parameter's dtype
F32_STATE = ("momentum", "nesterov", "adam")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_with_decay_and_global_clip_matches_jax(name, dtype):
    """Each class with L2 decay and a global-norm clip small enough to
    clip every step."""
    def build(f):
        return _mlp(f, dtype, lambda f: OPTIMIZERS[name](
            f, regularization=f.regularizer.L2Decay(1e-2),
            global_clip_norm=0.05))

    tol = TOL["float32"] if name in F32_STATE else TOL[dtype]
    jl, tl, *_ = _assert_pair(build, dtype, tol)
    assert tl[-1] != tl[0]


OPTIONS = {
    "l1_decay": (dict(regularization="l1"), None),
    "l2_decay": (dict(regularization="l2"), None),
    "global_clip": (dict(global_clip_norm=0.05), None),
    "param_clip_by_value": ({}, lambda f: f.ParamAttr(
        gradient_clip=f.clip.GradientClipByValue(0.01))),
    "param_clip_by_norm": ({}, lambda f: f.ParamAttr(
        gradient_clip=f.clip.GradientClipByNorm(0.05))),
    "param_clip_by_global_norm": ({}, lambda f: f.ParamAttr(
        gradient_clip=f.clip.GradientClipByGlobalNorm(0.05))),
    "param_l1_over_global_l2": (dict(regularization="l2"), lambda f:
                                f.ParamAttr(regularizer=f.regularizer.L1Decay(
                                    1e-2))),
    "everything": (dict(regularization="l2", global_clip_norm=0.05),
                   lambda f: f.ParamAttr(
                       gradient_clip=f.clip.GradientClipByValue(0.01),
                       regularizer=f.regularizer.L1Decay(1e-2))),
}


def _regularizer(f, kind):
    return {"l1": f.regularizer.L1Decay, "l2": f.regularizer.L2Decay}[kind](
        1e-2)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_each_regularizer_and_clip_matches_jax(option, opt):
    kw, attr = OPTIONS[option]

    def build(f):
        okw = dict(kw)
        if "regularization" in okw:
            okw["regularization"] = _regularizer(f, okw["regularization"])
        return _mlp(f, "float32", lambda f: OPTIMIZERS[opt](f, **okw), attr)

    _assert_pair(build, "float32")


def test_per_parameter_l2_decay_is_applied():
    """A parameter's own regularizer (``ParamAttr(regularizer=...)``)
    decays its gradient as in JAX: the program holds its ``scale`` and
    ``sum``, and the weight after 3 SGD steps equals JAX's (which differs
    from the undecayed weight's)."""
    def build(f, coeff=0.5):
        attr = (lambda f: f.ParamAttr(
            regularizer=f.regularizer.L2Decay(coeff))) if coeff else None
        return _mlp(f, "float32", lambda f: f.optimizer.SGD(0.1), attr)

    _assert_pair(build, "float32")
    types = [op.type for op in tfluid.default_main_program()
             .global_block().ops]
    assert types.count("scale") == 1 and "sum" in types
    decayed = tfluid.global_scope().find_np("fc_0.w_0")
    _pair(lambda f: build(f, coeff=0), "float32")
    assert _rel(tfluid.global_scope().find_np("fc_0.w_0"), decayed) > 1e-3


def test_error_clip_matches_jax():
    """The hidden var's gradient clipped where it materializes, before the
    first layer's grads read it."""
    def build(f):
        def tweak(f, h):
            h.error_clip = f.clip.ErrorClipByValue(1e-3)
        return _mlp(f, "float32", lambda f: f.optimizer.SGD(0.5),
                    tweak=tweak)

    _assert_pair(build, "float32")
    block = tfluid.default_main_program().global_block()
    clips = [op for op in block.ops if op.type == "clip"]
    assert len(clips) == 1 and clips[0].inputs["X"] == clips[0].outputs["Out"]


def test_print_gradient_prints_each_step_and_matches_jax(capsys):
    def build(f):
        def tweak(f, h):
            h.print_gradient = True
        return _mlp(f, "float32", lambda f: f.optimizer.Adam(0.01),
                    tweak=tweak)

    _assert_pair(build, "float32")
    block = tfluid.default_main_program().global_block()
    prints = [op for op in block.ops if op.type == "print"]
    assert len(prints) == 1
    said = capsys.readouterr().out
    msg = prints[0].attrs["message"]
    assert said.count(msg) >= STEPS  # the JAX package prints too
    report = step_loop.safety_report(tfluid.default_main_program())
    assert not report["safe"] and "'print'" in report["reasons"][0]


# -- learning-rate schedules ------------------------------------------------------

SCHEDULES = {
    "exponential": lambda d: d.exponential_decay(0.1, 2, 0.5),
    "exponential_staircase": lambda d: d.exponential_decay(
        0.1, 2, 0.5, staircase=True),
    "natural_exp": lambda d: d.natural_exp_decay(0.1, 2, 0.5),
    "inverse_time": lambda d: d.inverse_time_decay(0.1, 2, 0.5),
    "polynomial": lambda d: d.polynomial_decay(0.1, 2, 0.01, power=2.0),
    "piecewise": lambda d: d.piecewise_decay([2, 3], [0.1, 0.05, 0.01]),
}


def _schedule_build(f, schedule):
    """The MLP with SGD at `schedule`'s rate; (loss, the rate's var)."""
    holder = {}

    def opt(f):
        holder["lr"] = SCHEDULES[schedule](f.learning_rate_decay)
        return f.optimizer.SGD(holder["lr"])

    loss, _, _ = _mlp(f, "float32", opt)
    return loss, holder["lr"]


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_schedule_matches_jax(schedule):
    """The fetched learning rate at each step (the step reads 1, 2, 3)
    within 1e-6 relative, and the state after 3 SGD steps."""
    lr_name = _schedule_build(jfluid, schedule)[1].name
    assert _schedule_build(tfluid, schedule)[1].name == lr_name
    _, _, jf, tf, *_ = _assert_pair(
        lambda f: _schedule_build(f, schedule), "float32", fetch=[lr_name])
    got = [float(v[0][0]) for v in tf]
    want = [float(v[0][0]) for v in jf]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert tfluid.global_scope().find_np("global_step_0")[0] == STEPS


def test_schedules_decay_as_their_formulas():
    """The port's schedules against their closed forms at steps 1..3."""
    steps = np.arange(1, STEPS + 1, dtype=np.float64)
    want = {
        "exponential": 0.1 * 0.5 ** (steps / 2),
        "exponential_staircase": 0.1 * 0.5 ** np.floor(steps / 2),
        "natural_exp": 0.1 * np.exp(-0.5 * steps / 2),
        "inverse_time": 0.1 / (1 + 0.5 * steps / 2),
        "polynomial": 0.09 * (1 - np.minimum(steps, 2) / 2) ** 2 + 0.01,
        "piecewise": np.array([0.1, 0.05, 0.01]),
    }
    for schedule, w in want.items():
        tfluid.reset()
        loss, lr = _schedule_build(tfluid, schedule)
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(tfluid.default_startup_program())
        got = [float(exe.run(feed=feed, fetch_list=[lr])[0][0])
               for feed in _feeds("float32")]
        np.testing.assert_allclose(got, w, rtol=1e-6, err_msg=schedule)


# -- the pruning hook -------------------------------------------------------------

def _pruned_build(f):
    return _mlp(f, "float32", lambda f: f.optimizer.SGD(0.5),
                lambda f: {"update_hooks": {"type": "pruning",
                                            "sparsity_ratio": 0.5}})


def test_pruning_hook_matches_jax_and_keeps_zeros():
    _assert_pair(_pruned_build, "float32")
    w = tfluid.global_scope().find_np("fc_0.w_0")
    mask = tfluid.global_scope().find_np("fc_0.w_0_prune_mask_0")
    assert mask.mean() == 0.5 and (w[mask == 0] == 0).all()


def test_pruning_hook_prunes_at_startup():
    """The port's own startup: exactly half of the weights zero (count
    based), and they stay zero through training while the rest move."""
    loss, _, _ = _pruned_build(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    w0 = tfluid.global_scope().find_np("fc_0.w_0")
    zero = w0 == 0
    assert zero.mean() == 0.5
    for feed in _feeds("float32"):
        exe.run(feed=feed, fetch_list=[loss])
    w = tfluid.global_scope().find_np("fc_0.w_0")
    assert (w[zero] == 0).all() and (w[~zero] != w0[~zero]).any()
    assert not (tfluid.global_scope().find_np("fc_1.w_0") == 0).all()


# -- ModelAverage -------------------------------------------------------------------

def _averaged_build(window):
    return lambda f: _mlp(f, "float32", lambda f: f.optimizer.SGD(0.05),
                          average=window)


@pytest.mark.parametrize("window", [100, 2])
def test_model_average_matches_jax(window):
    """The window sums and counts after 3 steps (with W = 2 the window
    rotates), and the applied averages, equal JAX's."""
    *_, names, jb, tb = _pair(_averaged_build(window), "float32")
    _assert_state_matches(names, TOL["float32"])
    params = ["fc_0.w_0", "fc_0.b_0", "fc_1.w_0", "fc_1.b_0"]
    with jb[2].apply(None), tb[2].apply(None):
        for n in params:
            assert _rel(tfluid.global_scope().find_np(n),
                        jfluid.global_scope().find_np(n)) <= TOL["float32"]
    _assert_state_matches(params, TOL["float32"])


def test_model_average_windowed_mean_and_rotation():
    """As ``tests/test_aux.py``: with W = 100 the average is the mean of
    the 6 post-update snapshots; with W = 4 after 10 steps (rotations at
    4 and 8) the mean of the last 6; restore gives the raw values back;
    a nested apply refuses."""
    for window, steps, keep in ((100, 6, 6), (4, 10, 6)):
        tfluid.reset()
        loss, _, ma = _averaged_build(window)(tfluid)
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(tfluid.default_startup_program())
        snaps = []
        for feed in _feeds("float32", steps):
            exe.run(feed=feed, fetch_list=[loss])
            snaps.append(tfluid.global_scope().find_np("fc_0.w_0").copy())
        raw = snaps[-1]
        with ma.apply(exe):
            avg = tfluid.global_scope().find_np("fc_0.w_0")
            np.testing.assert_allclose(avg, np.mean(snaps[-keep:], axis=0),
                                       rtol=1e-5, atol=1e-6)
            assert not np.allclose(avg, raw)
            with pytest.raises(RuntimeError, match="still active"):
                ma.apply(exe)
        np.testing.assert_array_equal(
            tfluid.global_scope().find_np("fc_0.w_0"), raw)


# -- K steps a dispatch ---------------------------------------------------------------

K = 2


def _stacked(seed):
    feeds = _feeds("float32", K, seed)
    return {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}


def _options_build(f):
    lr = f.learning_rate_decay.polynomial_decay(0.05, 3, 0.005, power=2.0)
    loss, _, ma = _mlp(f, "float32", lambda f: f.optimizer.Adam(
        learning_rate=lr, regularization=f.regularizer.L2Decay(1e-2),
        global_clip_norm=0.05), average=3)
    return loss, lr, ma


def _sequential(exe, main, fetch, stacked, scope):
    return [exe.run(main, feed={n: v[i] for n, v in stacked.items()},
                    fetch_list=fetch, scope=scope) for i in range(K)]


def test_k2_graph_body_with_options_is_bitwise(monkeypatch):
    """A schedule, a global-norm clip, L2 decay and ModelAverage under
    ``run(steps_per_dispatch=2)``, the graph's body standing in for the
    graph (first dispatch eager, second captured, then replays): the
    losses, learning rates and every persistable equal 2 eager steps per
    dispatch to the bit; the step counts 2 a dispatch.  Between two
    replays ``ModelAverage.apply`` and ``restore`` replace the scope's
    entries: the next replay trains from the raw parameters."""
    loss, lr, ma = _options_build(tfluid)
    main = tfluid.default_main_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    exe._captures = True
    monkeypatch.setattr(step_loop.CapturedLoop, "record_graph",
                        lambda loop, exe: _BodyGraph(loop, exe))
    twin = _copy_scope(main)
    eager = tfluid.Executor(tfluid.CPUPlace())
    for d in range(4):
        stacked = _stacked(seed=d)
        want = _sequential(eager, main, [loss, lr], stacked, twin)
        got = exe.run(main, feed=stacked, fetch_list=[loss, lr],
                      steps_per_dispatch=K)
        np.testing.assert_array_equal(got[0], np.stack([w[0] for w in want]))
        np.testing.assert_array_equal(got[1], np.stack([w[1] for w in want]))
        _assert_scopes_equal(main, tfluid.global_scope(), twin)
        assert tfluid.global_scope().find_np("global_step_0")[0] == K * (d + 1)
        if d == 2:
            raw = tfluid.global_scope().find_np("fc_0.w_0")
            with ma.apply(exe):
                assert not np.array_equal(
                    tfluid.global_scope().find_np("fc_0.w_0"), raw)
            np.testing.assert_array_equal(
                tfluid.global_scope().find_np("fc_0.w_0"), raw)
    (entry,) = exe._loops.values()
    assert entry.safety["safe"] and entry.loop is not None
    # the schedule's value at step K * 4, as eager steps computed it
    frac = 1 - min(K * 4, 3) / 3
    np.testing.assert_allclose(got[1][-1], 0.045 * frac ** 2 + 0.005,
                               rtol=1e-6)


def test_print_gradient_program_warns_and_runs_eagerly(monkeypatch, capsys):
    """A block holding ``print`` is loop-unsafe: K = 2 warns naming the op
    and runs 2 eager steps, equal to the bit to 2 sequential runs."""
    def tweak(f, h):
        h.print_gradient = True

    loss, _, _ = _mlp(tfluid, "float32", lambda f: f.optimizer.SGD(0.1),
                      tweak=tweak)
    main = tfluid.default_main_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    exe._captures = True
    monkeypatch.setattr(step_loop.CapturedLoop, "record_graph",
                        lambda loop, exe: _BodyGraph(loop, exe))
    twin = _copy_scope(main)
    stacked = _stacked(seed=0)
    want = _sequential(tfluid.Executor(tfluid.CPUPlace()), main, [loss],
                       stacked, twin)
    with pytest.warns(UserWarning, match="loop-unsafe.*'print'"):
        got = exe.run(main, feed=stacked, fetch_list=[loss],
                      steps_per_dispatch=K)[0]
    np.testing.assert_array_equal(got, np.stack([w[0] for w in want]))
    _assert_scopes_equal(main, tfluid.global_scope(), twin)
    assert all(e.loop is None for e in exe._loops.values())
    assert capsys.readouterr().out.count("@GRAD: ") == 2 * K
