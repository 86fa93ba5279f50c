"""The port's pipeline and expert-parallel executors
(``paddle_tpu_torch/parallel/pipeline.py``, ``program_pipeline.py``,
``moe.py``) on CPU mesh positions, against the JAX package's on its
8-device CPU mesh: the counterparts of ``tests/test_parallel.py``'s
pipeline and MoE tests.

- The functional GPipe and MoE steps start from JAX's
  ``init_*_params(PRNGKey)`` carried across as numpy (float32) and take
  the same batches: losses within 1e-5 relative, parameters within 1e-5
  of their largest |value| after every step.
- ``ProgramPipeline`` runs the same desc from JAX's startup state: its
  losses within 1e-5 relative of JAX's ``ProgramPipeline`` and its
  synced parameters within 1e-5 of each tensor's largest |value|; at
  ``n_micro`` 1 (where GPipe is plain SGD) also within 1e-5 of the port's
  single-device Executor.
- The staged GPT (``decoder_lm(stage_every=1)``: V 64, D 32, T 16, two
  blocks, one marker, ``n_micro`` 2, three SGD steps) is held to JAX's
  ``ProgramPipeline`` and to the port's single-device Executor the same
  way.
- ``run_mode("pp")`` and ``run_mode("pp_dp")`` run on eight CPU
  positions against JAX's ``ProgramPipeline`` over the mode's desc.

The collectives a step runs are counted: one hop a tick, and under dp
one psum of the stage gradients (never a sum autograd makes silently)."""

import numpy as np
import pytest
import torch

import jax
import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import transformer as jtr
from paddle_tpu.parallel import ProgramPipeline as JPP
from paddle_tpu.parallel import make_mesh as jmesh
from paddle_tpu.parallel import modes as jmodes
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.parallel import collectives as col
from paddle_tpu_torch.parallel import modes as tmodes
from paddle_tpu_torch.parallel.mesh import make_mesh
from paddle_tpu_torch.parallel.program_pipeline import ProgramPipeline

CPU = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    yield


def _mesh(axes):
    return make_mesh(axes, devices=CPU[:int(np.prod(list(axes.values())))])


def _close(got, want, what):
    for k in want:
        w = np.asarray(want[k], np.float64)
        g = np.asarray(got[k], np.float64)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30),
                                   err_msg=f"{what} {k}")


def _f32(params):
    return {k: torch.tensor(np.asarray(v, np.float32))
            for k, v in params.items()}


def test_functional_gpipe_matches_jax():
    from paddle_tpu.parallel.pipeline import (
        build_pipeline_train_step as jbuild, init_pipeline_params as jinit)
    from paddle_tpu_torch.parallel.pipeline import build_pipeline_train_step

    pp, dp, width, n_micro = 4, 2, 16, 4
    jp = jinit(jax.random.PRNGKey(0), pp, width)
    tp = _f32(jp)
    jp = jax.tree_util.tree_map(lambda a: a.astype(np.float32), jp)
    jstep, shard = jbuild(jmesh({"pp": pp, "dp": dp}), n_micro=n_micro,
                          width=width, lr=0.2)
    jp = jax.tree_util.tree_map(lambda p: jax.device_put(p, shard), jp)
    tstep, _ = build_pipeline_train_step(_mesh({"pp": pp, "dp": dp}),
                                         n_micro, width, lr=0.2)
    rng = np.random.RandomState(0)
    x = rng.randn(16, width).astype(np.float32)
    y = np.tanh(x @ rng.randn(width, width).astype(np.float32) * 0.3)
    losses = []
    for _ in range(6):
        jl, jp = jstep(jp, x, y)
        with col.record() as log:
            tl, tp = tstep(tp, x, y)
        losses.append(float(tl))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        _close(tp, jp, "gpipe")
    assert losses[-1] < losses[0]
    kinds = [k for k, *_ in log]
    # a hop a tick, the masked-output psum, two loss pmeans, a grad psum
    # a parameter over dp
    assert kinds.count("collective-permute") == n_micro + pp - 1
    assert kinds.count("all-reduce") == 1 + 2 + 2


def test_functional_moe_matches_jax():
    from paddle_tpu.parallel.moe import (build_moe_train_step as jbuild,
                                         init_moe_params as jinit)
    from paddle_tpu_torch.parallel.moe import build_moe_train_step

    ep, dp, D, H = 4, 2, 8, 16
    jp = jinit(jax.random.PRNGKey(1), ep, D, H)
    tp = _f32(jp)
    jp = jax.tree_util.tree_map(lambda a: a.astype(np.float32), jp)
    jstep = jbuild(jmesh({"ep": ep, "dp": dp}), d_model=D, d_hidden=H,
                   capacity=16)
    tstep = build_moe_train_step(_mesh({"ep": ep, "dp": dp}), D, H, 16)
    rng = np.random.RandomState(1)
    x = rng.randn(32, D).astype(np.float32)
    y = (x * 2.0 + 0.5).astype(np.float32)
    losses = []
    for _ in range(6):
        jl, jp = jstep(jp, x, y)
        with col.record() as log:
            tl, tp = tstep(tp, x, y)
        losses.append(float(tl))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        _close(tp, jp, "moe")
    assert losses[-1] < losses[0]
    assert [k for k, *_ in log].count("all-to-all") == 2


def _mlp4(fluid):
    x = fluid.layers.data(name="x", shape=[16], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    h = fluid.layers.fc(input=x, size=32, act="tanh")
    fluid.layers.pipeline_stage()
    h = fluid.layers.fc(input=h, size=24, act="tanh")   # heterogeneous
    fluid.layers.pipeline_stage()
    h = fluid.layers.fc(input=h, size=32, act="tanh")
    fluid.layers.pipeline_stage()
    logits = fluid.layers.fc(input=h, size=4)
    return fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, label))


def _mlp2(fluid):
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    h = fluid.layers.fc(input=x, size=16, act="tanh")
    fluid.layers.pipeline_stage()
    pred = fluid.layers.fc(input=h, size=1)
    return fluid.layers.mean(
        fluid.layers.square_error_cost(input=pred, label=y))


def _both(build, axes, n_micro, feeds, optimizer=("sgd", 0.1), seed=7):
    """The same desc pipelined by JAX and by the port from JAX's startup
    state: (jax losses, port losses, jax synced, port synced, port
    pipeline, the state)."""
    jfluid.reset()
    jfluid.default_startup_program().random_seed = seed
    jl = build(jfluid)
    jfluid.Executor(jfluid.CPUPlace()).run(jfluid.default_startup_program())
    state = {n: np.asarray(jfluid.global_scope().find_np(n), np.float32)
             for n in jfluid.global_scope().local_names()}
    jp = JPP(jfluid.default_main_program(), jl, jmesh(axes),
             n_micro=n_micro, optimizer=optimizer)
    jp.initialize()
    jlosses = [jp.run(f) for f in feeds]
    jp.sync_scope()
    jsync = {n: np.asarray(jfluid.global_scope().find_np(n)) for n in state}
    tfluid.reset()
    tl = build(tfluid)
    for n, v in state.items():
        tfluid.global_scope().set(n, v)
    tp = ProgramPipeline(tfluid.default_main_program(), tl, _mesh(axes),
                         n_micro=n_micro, optimizer=optimizer)
    tp.initialize()
    tlosses = [tp.run(f) for f in feeds]
    tp.sync_scope()
    tsync = {n: tfluid.global_scope().find_np(n) for n in state}
    return jlosses, tlosses, jsync, tsync, tp, state


def _single(build, state, feeds, lr=0.1):
    """The port's single-device Executor: SGD on the same desc (markers
    are no-ops) from `state`."""
    tfluid.reset()
    loss = build(tfluid)
    tfluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    for n, v in state.items():
        tfluid.global_scope().set(n, v)
    out = [float(np.asarray(exe.run(feed=f, fetch_list=[loss])[0])
                 .reshape(-1)[0]) for f in feeds]
    return out, {n: tfluid.global_scope().find_np(n) for n in state}


def _feeds_mlp4(n=6):
    rng = np.random.RandomState(0)
    xs = rng.rand(32, 16).astype(np.float32)
    ys = rng.randint(0, 4, (32, 1)).astype(np.int64)
    return [{"x": xs, "label": ys}] * n


def _feeds_mlp2(n, seed=1, bs=8):
    rng = np.random.RandomState(seed)
    return [{"x": rng.rand(bs, 8).astype(np.float32),
             "y": rng.rand(bs, 1).astype(np.float32)}] * n


@pytest.mark.parametrize("optimizer", [("sgd", 0.1), ("momentum", 0.1, 0.9)],
                         ids=["sgd", "momentum"])
def test_program_pipeline_matches_jax(optimizer):
    """The heterogeneous 4-stage MLP over pp=4, four microbatches."""
    feeds = _feeds_mlp4()
    jl, tl, js, ts, pipe, _ = _both(_mlp4, {"pp": 4}, 4, feeds,
                                    optimizer=optimizer)
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _close(ts, js, "synced")
    # the synced scope keeps training usable on an Executor
    exe = tfluid.Executor(tfluid.CPUPlace())
    (after,) = exe.run(pipe.program, feed=feeds[0],
                       fetch_list=[pipe.loss_name])
    assert abs(float(np.asarray(after).reshape(-1)[0]) - tl[-1]) < 0.2


def test_program_pipeline_exact_vs_single_device():
    """With one microbatch the schedule IS plain SGD on the same graph."""
    feeds = _feeds_mlp2(5)
    jl, tl, js, ts, _, state = _both(_mlp2, {"pp": 2}, 1, feeds, seed=11)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _close(ts, js, "synced")
    sl, ss = _single(_mlp2, state, feeds)
    np.testing.assert_allclose(tl, sl, rtol=1e-5)
    _close(ts, ss, "single")


def test_program_pipeline_second_batch_size():
    """A later partial batch (another feed shape) gets its own step plan;
    a batch n_micro does not divide raises."""
    rng = np.random.RandomState(5)
    feeds = [{"x": rng.rand(16, 8).astype(np.float32),
              "y": rng.rand(16, 1).astype(np.float32)},
             {"x": rng.rand(8, 8).astype(np.float32),
              "y": rng.rand(8, 1).astype(np.float32)}]
    jl, tl, js, ts, pipe, _ = _both(_mlp2, {"pp": 2}, 2, feeds,
                                    optimizer=("sgd", 0.05))
    assert np.isfinite(tl).all() and len(pipe._step_fns) == 2
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _close(ts, js, "synced")
    with pytest.raises(ValueError, match="not divisible"):
        pipe.run({"x": rng.rand(7, 8).astype(np.float32),
                  "y": rng.rand(7, 1).astype(np.float32)})


def test_program_pipeline_composes_with_dp():
    """pp × dp: microbatches split across dp, the stage gradients summed
    by a counted psum; at n_micro 1 equal to the single device, and at
    n_micro 2 to JAX."""
    feeds = _feeds_mlp2(4, seed=2)
    jl, tl, js, ts, pipe, state = _both(_mlp2, {"pp": 2, "dp": 2}, 1,
                                        feeds, seed=13)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _close(ts, js, "synced")
    sl, ss = _single(_mlp2, state, feeds)
    np.testing.assert_allclose(tl, sl, rtol=1e-5)
    _close(ts, ss, "single")
    with col.record() as log:
        pipe.run(feeds[0])
    grads = [e for e in log if e[0] == "all-reduce" and e[1] == ("dp",)
             and e[2] == pipe._rows[0].numel() * 4]
    assert len(grads) == 1  # the dp gradient sum, explicit and counted
    feeds = _feeds_mlp2(6, seed=2)
    jl, tl, js, ts, _, _ = _both(_mlp2, {"pp": 2, "dp": 2}, 2, feeds,
                                 seed=13)
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _close(ts, js, "synced")


def test_program_pipeline_refusals():
    """JAX's errors: a parameter shared by two stages, a variable that
    skips a boundary, a read nothing produces, the loss outside the last
    stage, a stage count other than pp, an unknown optimizer."""
    def shared(fluid):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        w = fluid.ParamAttr(name="shared_w")
        h = fluid.layers.fc(x, size=4, param_attr=w, bias_attr=False)
        fluid.layers.pipeline_stage()
        return fluid.layers.mean(fluid.layers.fc(h, size=4, param_attr=w,
                                                 bias_attr=False))

    def skipped(fluid):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        h = fluid.layers.fc(x, size=4)
        fluid.layers.pipeline_stage()
        g = fluid.layers.fc(h, size=4)
        fluid.layers.pipeline_stage()
        return fluid.layers.mean(fluid.layers.elementwise_add(g, h))

    def early_loss(fluid):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        loss = fluid.layers.mean(fluid.layers.fc(x, size=4))
        fluid.layers.pipeline_stage()
        fluid.layers.fc(x, size=4)
        return loss

    cases = [(shared, {"pp": 2}, "read by stages 0"),
             (skipped, {"pp": 3}, "crosses stage boundary 0->2"),
             (early_loss, {"pp": 2}, "LAST pipeline stage"),
             (_mlp2, {"pp": 4}, "2 pipeline stages")]
    for build, axes, msg in cases:
        tfluid.reset()
        loss = build(tfluid)
        with pytest.raises(ValueError, match=msg):
            ProgramPipeline(tfluid.default_main_program(), loss,
                            _mesh(axes), n_micro=1)
    tfluid.reset()
    loss = _mlp2(tfluid)
    with pytest.raises(ValueError, match="optimizer"):
        ProgramPipeline(tfluid.default_main_program(), loss,
                        _mesh({"pp": 2}), n_micro=1, optimizer=("adam", 1))
    # a read nothing produces: a persistable-less temp made outside
    prog = tfluid.default_main_program()
    block = prog.global_block()
    orphan = block.create_var(name="orphan_tmp", shape=[-1, 1],
                              dtype="float32")
    block.append_op(type="elementwise_add",
                    inputs={"X": [loss.name], "Y": [orphan.name]},
                    outputs={"Out": [loss.name]}, attrs={"axis": -1})
    with pytest.raises(ValueError, match="neither a feed nor a parameter"):
        ProgramPipeline(prog, loss, _mesh({"pp": 2}), n_micro=1)


def _staged_gpt_jax(V, D, T, L, H):
    layers = jfluid.layers
    tok = layers.data("tokens", shape=[T, 1], dtype="int64")
    tgt = layers.data("targets", shape=[T, 1], dtype="int64")
    x = layers.elementwise_add(layers.embedding(tok, size=[V, D]),
                               jtr._positions(tok, D, T, "float32"), axis=1)
    for i in range(L):
        if i:
            layers.pipeline_stage()
        h = layers.layer_norm(x, begin_norm_axis=2)
        x = layers.elementwise_add(x, layers.multi_head_attention(
            h, h, h, num_heads=H, causal=True, sp_mode="ring",
            sp_schedule="zigzag"))
        h = layers.layer_norm(x, begin_norm_axis=2)
        m = layers.fc(h, D * 4, num_flatten_dims=2, act="gelu")
        x = layers.elementwise_add(x, layers.fc(m, D, num_flatten_dims=2))
    x = layers.layer_norm(x, begin_norm_axis=2)
    return jtr.lm_loss(layers.fc(x, V, num_flatten_dims=2,
                                 bias_attr=False), tgt)


def test_staged_gpt_matches_jax_and_single_device():
    """The GPT of models/transformer (V 64, D 32, T 16, two blocks), one
    marker between the blocks, pp 2, n_micro 2, three SGD steps: the
    interface is the residual x alone, the untied head sits in stage 1.
    Held to JAX's ProgramPipeline and to the port's Executor."""
    V, D, T, L, H = 64, 32, 16, 2, 4

    def build(fluid):
        if fluid is jfluid:
            return _staged_gpt_jax(V, D, T, L, H)
        tok = fluid.layers.data("tokens", shape=[T, 1], dtype="int64")
        tgt = fluid.layers.data("targets", shape=[T, 1], dtype="int64")
        return ttr.lm_loss(ttr.decoder_lm(tok, V, D, L, H, T,
                                          stage_every=1), tgt)

    rng = np.random.RandomState(0)
    toks = rng.randint(0, V, (4, T, 1)).astype(np.int64)
    feeds = [{"tokens": toks, "targets": np.roll(toks, -1, axis=1)}] * 3
    jl, tl, js, ts, pipe, state = _both(build, {"pp": 2}, 2, feeds)
    assert sorted(state) == sorted(ts)
    assert pipe.stages[1].interface_in == [pipe.stages[0].ops[-1]
                                           .output_names()[0]]
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _close(ts, js, "synced")
    sl, ss = _single(build, state, feeds)
    np.testing.assert_allclose(tl, sl, rtol=1e-5)
    _close(ts, ss, "single")


@pytest.mark.parametrize("name", ["pp", "pp_dp"])
def test_run_mode_pipeline_modes(name):
    """The catalog's pipeline modes run through run_mode on eight CPU
    positions (a ProgramPipeline over the mode's mesh and desc) and equal
    JAX's ProgramPipeline on the same desc, state and feeds."""
    mode, pipe, prog, loss = tmodes.run_mode(name, devices=CPU)
    assert isinstance(pipe, ProgramPipeline)
    assert pipe.n_micro == mode.mesh_axes["pp"]
    rng = np.random.RandomState(3)
    feeds = [mode.feed_fn(rng, 16) for _ in range(3)]
    jmode, jprog, jloss = jmodes.build_mode(name)
    jfluid.Executor(jfluid.CPUPlace()).run(jfluid.default_startup_program())
    state = {n: np.asarray(jfluid.global_scope().find_np(n), np.float32)
             for n in jfluid.global_scope().local_names()}
    jp = JPP(jprog, jloss, jmesh(dict(jmode.mesh_axes)),
             n_micro=pipe.n_micro)
    jl = [jp.run(f) for f in feeds]
    for n, v in state.items():
        tfluid.global_scope().set(n, v)
    tl = [pipe.run(f) for f in feeds]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
