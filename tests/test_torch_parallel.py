"""The port's ``ParallelExecutor`` (``paddle_tpu_torch/parallel/``) on eight
CPU mesh positions, against the JAX package's ``ParallelExecutor`` on its
8-device CPU mesh and against the port's single-device ``Executor``: the
nine modes that run, three steps each from JAX's startup state carried in
with ``load_persistables``, with the same feeds at the modes' own sizes;
the hybrid mesh against flat dp-8 bit for bit; ``steps_per_dispatch=2``
against two runs; the collectives' semantics and counts; the collectives
one step ran beside ``comm_report``'s; the plan's layouts kept across
steps; the mesh and catalog contracts.

Tolerances (f32): losses within 1e-5 relative; written state within
1e-5 of each tensor's largest |value| (f32 reduction order).  Three
exceptions, each the program's own conditioning, not the port's: Adam
(``lm_dp_sp``) holds the first step's gradients within 1e-5 of their
largest |g| and the state after three steps within 1e-4 absolute and
relative, as ``test_torch_training.py`` holds three Adam steps (a unit
Adam step turns rounding in a near-zero gradient into a full step);
ResNet-8 under ``fsdp`` crosses a ReLU kink at its third update (the
JAX package's own fsdp and single-device runs part there by 1e-2, and a
1e-7 perturbation of the start does the same), so its state is held
after two steps and its three losses; ``ep_dp`` against ONE device uses
a capacity factor at which no member drops a token (capacity is per
member under the mesh, per batch on one device: the two agree exactly
when nothing is dropped), while against JAX it runs the mode as
declared."""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.parallel import ParallelExecutor as JPE
from paddle_tpu.parallel import modes as jmodes
from paddle_tpu_torch.analysis import equivalence as teq
from paddle_tpu_torch.analysis import sharding as tsharding
from paddle_tpu_torch.framework.scope import Scope
from paddle_tpu_torch.parallel import ParallelExecutor, make_mesh
from paddle_tpu_torch.parallel import collectives as col
from paddle_tpu_torch.parallel import mesh as tmesh
from paddle_tpu_torch.parallel import modes as tmodes
from paddle_tpu_torch.parallel.sharded import ShardedTensor

CPU = [torch.device("cpu")] * 8
RUNNING = tuple(m.name for m in tmodes.MODES if not m.pipeline)
STEPS = 3


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    yield


def _mesh(axes):
    return make_mesh(dict(axes), devices=CPU[:int(np.prod(list(
        axes.values())))])


def _feeds(mode, n=STEPS, bs=8):
    rng = np.random.RandomState(0)
    return [mode.feed_fn(rng, bs) for _ in range(n)]


def _scalar(x):
    return float(np.asarray(x).ravel()[0])


def _jax_start(name):
    """JAX's mode: its ParallelExecutor after the startup program, the
    program, the loss and the persistables' start values."""
    mode, prog, loss = jmodes.build_mode(name)
    jpe = JPE(axes=dict(mode.mesh_axes), **mode.executor_kwargs)
    jpe.run(jfluid.default_startup_program())
    persist = [n for n, v in prog.global_block().vars.items()
               if v.persistable]
    start = {n: np.asarray(jfluid.global_scope().find(n)) for n in persist}
    return mode, jpe, prog, loss, start


def _port(name, start):
    mode, prog, loss = tmodes.build_mode(name)
    tfluid.load_persistables(prog, start)
    pe = ParallelExecutor(mesh=_mesh(mode.mesh_axes),
                          **mode.executor_kwargs)
    return mode, pe, prog, loss


def _hold_state(got, want, names, adam=False):
    for n in names:
        a = np.asarray(got(n), np.float64)
        b = np.asarray(want(n), np.float64)
        if adam:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                       err_msg=n)
        else:
            np.testing.assert_allclose(
                a, b, rtol=0, atol=1e-5 * max(np.abs(b).max(), 1e-30),
                err_msg=n)


def _trainable_grads(prog):
    return [n + "@GRAD" for n, v in prog.global_block().vars.items()
            if v.persistable and getattr(v, "trainable", False)]


# -- the nine modes against JAX's ParallelExecutor ----------------------------

@pytest.mark.parametrize("name", RUNNING)
def test_mode_matches_jax_parallel_executor(name):
    """Three steps of each running mode: losses, the first step's
    gradients of the trainable parameters, and the written state."""
    mode, jpe, jprog, jloss, start = _jax_start(name)
    _, tpe, tprog, tloss = _port(name, start)
    grads = _trainable_grads(jprog)
    kept = STEPS - 1 if name == "fsdp" else STEPS
    jl, tl = [], []
    for step, feed in enumerate(_feeds(mode)):
        fetch = [jloss] + (grads if step == 0 else [])
        jo = jpe.run(jprog, feed=feed, fetch_list=fetch)
        to = tpe.run(tprog, feed=feed, fetch_list=[tloss] + fetch[1:])
        jl.append(_scalar(jo[0]))
        tl.append(_scalar(to[0]))
        for n, j, t in zip(fetch[1:], jo[1:], to[1:]):
            j = np.asarray(j)
            np.testing.assert_allclose(
                np.asarray(t), j, rtol=0,
                atol=1e-5 * max(float(np.abs(j).max()), 1e-30), err_msg=n)
        if step + 1 == kept:
            _hold_state(lambda n: tfluid.global_scope().find(n),
                        lambda n: jfluid.global_scope().find(n), start,
                        adam=name == "lm_dp_sp")
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


# -- the nine modes against the port's single-device Executor -----------------

def _capacity_for_no_drops(prog, factor):
    """The moe op's capacity factor, on the op and on its gradient op's
    copy of the forward attrs."""
    for op in prog.global_block().ops:
        if op.type == "moe":
            op.attrs["capacity_factor"] = factor
        elif op.type == "generic_grad" and \
                op.attrs["__fwd_type__"] == "moe":
            op.attrs["__fwd_attrs__"]["capacity_factor"] = factor


@pytest.mark.parametrize("name", RUNNING)
def test_mode_matches_single_device_executor(name):
    """The same three steps on the global batch: the mesh executor
    against the port's own Executor from the same state."""
    mode, prog, loss = tmodes.build_mode(name)
    if name == "ep_dp":
        _capacity_for_no_drops(prog, 4.0)
    startup = tfluid.default_startup_program()
    s1, s2 = Scope(), Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=s1)
    for n in s1.local_names():
        s2.set(n, s1.find(n).clone())
    pe = ParallelExecutor(mesh=_mesh(mode.mesh_axes), **mode.executor_kwargs)
    persist = [n for n, v in prog.global_block().vars.items()
               if v.persistable]
    kept = STEPS - 1 if name == "fsdp" else STEPS
    l1, l2 = [], []
    for step, feed in enumerate(_feeds(mode)):
        l1.append(_scalar(exe.run(prog, feed=feed, fetch_list=[loss],
                                  scope=s1)[0]))
        l2.append(_scalar(pe.run(prog, feed=feed, fetch_list=[loss],
                                 scope=s2)[0]))
        if step + 1 == kept:
            _hold_state(lambda n: s2.find(n), s1.find_np, persist,
                        adam=name == "lm_dp_sp")
    np.testing.assert_allclose(l2, l1, rtol=1e-5)


def test_dropout_under_the_mesh_draws_the_single_card_mask():
    """A dropout op has no local rule (it draws random numbers): it runs
    whole on the gathered input and its output and mask are sliced, so
    the mesh step draws the single-card mask.  Three dp steps of an MLP
    with dropout 0.5 against the port's Executor, losses within 1e-6."""
    x = tfluid.layers.data(name="x", shape=[16])
    y = tfluid.layers.data(name="y", shape=[1])
    h = tfluid.layers.dropout(tfluid.layers.fc(x, size=32, act="relu"),
                              0.5)
    loss = tfluid.layers.mean(tfluid.layers.square_error_cost(
        tfluid.layers.fc(h, size=1), y))
    tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    main = tfluid.default_main_program()
    s1, s2 = Scope(), Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program(), scope=s1)
    for n in s1.local_names():
        s2.set(n, s1.find(n).clone())
    pe = ParallelExecutor(mesh=_mesh({"dp": 8}))
    rng = np.random.RandomState(0)
    for step in range(3):
        feed = {"x": rng.rand(16, 16).astype(np.float32),
                "y": rng.rand(16, 1).astype(np.float32)}
        a = _scalar(exe.run(main, feed=feed, fetch_list=[loss], scope=s1,
                            rng_step=step)[0])
        b = _scalar(pe.run(main, feed=feed, fetch_list=[loss], scope=s2,
                           rng_step=step)[0])
        np.testing.assert_allclose(b, a, rtol=1e-6)


# -- hybrid mesh, K steps a dispatch -------------------------------------------

def test_hybrid_two_slice_mesh_bitwise_parity():
    """{dcn_dp: 2} x {dp: 4} against flat {dp: 8}, ZeRO-1 on both, to the
    bit; the analyzer's link bytes equal the JAX package's."""
    rep = teq.hybrid_parity_report(batch_size=8, place=tfluid.CPUPlace())
    assert rep["verdict"] == "PROVEN", rep["findings"]
    assert rep["bitwise"] is True
    for name, spec in rep["velocity_specs_hybrid"].items():
        assert spec and spec[0] == ["dcn_dp", "dp"], (name, spec)
    from paddle_tpu.analysis import equivalence as jeq

    jrep = jeq.hybrid_parity_report(batch_size=8)
    for side in ("single", "hybrid"):
        assert rep["comm"][side]["link_bytes"] == \
            jrep["comm"][side]["link_bytes"]
        assert rep["comm"][side]["per_kind"] == \
            jrep["comm"][side]["per_kind"]
    assert rep["velocity_specs_hybrid"] == jrep["velocity_specs_hybrid"]


def test_hybrid_and_flat_psum_add_in_one_order():
    """The psum over ('dcn_dp', 'dp') adds in flat position order, as a
    flat 'dp' psum does: the same bits."""
    flat = _mesh({"dp": 8})
    hyb = tmesh.make_hybrid_mesh({"dp": 4}, {"dcn_dp": 2}, devices=CPU)
    rng = np.random.RandomState(3)
    xs = [torch.tensor(rng.randn(5).astype(np.float32) * 10 ** i)
          for i in range(8)]
    a = col.psum(xs, flat, "dp")[0]
    b = col.psum(xs, hyb, ("dcn_dp", "dp"))[0]
    assert torch.equal(a, b)


def test_steps_per_dispatch_two_equals_two_runs():
    """run(steps_per_dispatch=2) on the CPU walks the two steps in
    sequence: the same bits as two run() calls, state included."""
    mode, prog, loss = tmodes.build_mode("dp")
    startup = tfluid.default_startup_program()
    s1, s2 = Scope(), Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=s1)
    for n in s1.local_names():
        s2.set(n, s1.find(n).clone())
    feeds = _feeds(mode, 2)
    pa = ParallelExecutor(mesh=_mesh(mode.mesh_axes), zero_dp_states=True)
    pb = ParallelExecutor(mesh=_mesh(mode.mesh_axes), zero_dp_states=True)
    two = [pa.run(prog, feed=f, fetch_list=[loss], scope=s1, rng_step=i)[0]
           for i, f in enumerate(feeds)]
    stacked = {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}
    fused = pb.run(prog, feed=stacked, fetch_list=[loss], scope=s2,
                   rng_step=0, steps_per_dispatch=2)[0]
    assert np.array_equal(np.stack(two), fused)
    for n, v in prog.global_block().vars.items():
        if v.persistable:
            assert np.array_equal(s1.find_np(n), s2.find_np(n)), n


# -- collectives ---------------------------------------------------------------

def _grid():
    mesh = _mesh({"a": 2, "b": 4})
    xs = [torch.full((2, 4), float(p)) + torch.arange(8.).reshape(2, 4)
          for p in range(8)]
    return mesh, xs


def test_collectives_semantics():
    """psum/pmean/all_gather/ppermute/all_to_all/axis_index over one axis
    of a {"a": 2, "b": 4} mesh, each against its numpy meaning."""
    mesh, xs = _grid()
    assert col.axis_index(mesh, "b") == [0, 1, 2, 3, 0, 1, 2, 3]
    assert col.axis_index(mesh, "a") == [0, 0, 0, 0, 1, 1, 1, 1]
    s = col.psum(xs, mesh, "b")
    for p in range(8):
        grp = range(4 * (p // 4), 4 * (p // 4) + 4)
        assert torch.equal(s[p], sum(xs[q] for q in grp))
    s = col.psum(xs, mesh, "a")
    assert torch.equal(s[1], xs[1] + xs[5])
    m = col.pmean(xs, mesh, ("a", "b"))
    assert torch.allclose(m[3], sum(xs) / 8)
    g = col.all_gather(xs, mesh, "b", dim=1)
    assert torch.equal(g[6], torch.cat(xs[4:8], 1))
    g = col.all_gather(xs, mesh, "a", dim=0, tiled=False)
    assert g[2].shape == (2, 2, 4) and torch.equal(g[2][1], xs[6])
    r = col.ppermute(xs, mesh, "b", [(i, (i + 1) % 4) for i in range(4)])
    assert torch.equal(r[1], xs[0]) and torch.equal(r[4], xs[7])
    r = col.ppermute(xs, mesh, "b", [(0, 1)])
    assert torch.equal(r[1], xs[0]) and not r[2].any()
    t = col.all_to_all(xs, mesh, "b", split_axis=1, concat_axis=0)
    for i in range(4):
        want = torch.cat([xs[j][:, i:i + 1] for j in range(4)], 0)
        assert torch.equal(t[i], want)
    u = [torch.arange(4.).reshape(4, 1) + 10 * p for p in range(8)]
    t = col.all_to_all(u, mesh, "b", split_axis=0, concat_axis=0,
                       tiled=False)
    assert torch.equal(t[2][:, 0], torch.tensor([2., 12., 22., 32.]))


def test_collectives_count_kind_and_bytes():
    """Each call counts once, its kind and its per-position output bytes,
    in the registry's counters and in record(); a one-position group and
    an uncounted() recompute count nothing."""
    mesh, xs = _grid()
    calls = col._CALLS.value(kind="all-reduce")
    nbytes = col._BYTES.value(kind="all-reduce")
    with col.record() as log:
        col.psum(xs, mesh, "b")
        col.all_gather(xs, mesh, "a", dim=0)
        with col.uncounted():
            col.psum(xs, mesh, "a")
        one = _mesh({"x": 1})
        col.psum(xs[:1], one, "x")
    assert [(k, a, b) for k, a, b, _ in log] == [
        ("all-reduce", ("b",), 32), ("all-gather", ("a",), 64)]
    assert col._CALLS.value(kind="all-reduce") == calls + 1
    assert col._BYTES.value(kind="all-reduce") == nbytes + 32


def test_collectives_are_differentiable():
    mesh, xs = _grid()
    leaves = [x.clone().requires_grad_() for x in xs]
    out = col.psum(leaves, mesh, "b")
    torch.autograd.grad(out[0].sum() + 2 * out[4].sum(), leaves)
    g = torch.autograd.grad(out[0].sum() + 2 * out[4].sum(), leaves)
    assert all(float(g[p][0, 0]) == (1.0 if p < 4 else 2.0)
               for p in range(8))


# -- what the executor ran, beside the analyzer --------------------------------

@pytest.mark.parametrize("name", ["dp", "lm_dp_sp"])
def test_step_collectives_beside_comm_report(name):
    """One step's collectives by kind and bytes beside ``comm_report``'s
    prediction for the same plan: the gradient all-reduces of the
    trainable parameters carry the same bytes (for dp, every collective
    agrees by kind, count and bytes)."""
    mode, prog, loss = tmodes.build_mode(name)
    exe = ParallelExecutor(mesh=_mesh(mode.mesh_axes),
                           **mode.executor_kwargs)
    exe.run(tfluid.default_startup_program())
    exe.run(prog, feed=_feeds(mode, 1)[0], fetch_list=[loss])
    prov = {}
    plan = exe.static_plan(prog, provenance=prov)
    ana = tsharding.propagate(prog, mesh=exe.mesh, plan=plan, batch_size=8,
                              provenance=prov)
    rep = tsharding.comm_report(ana, chip="cpu-host")
    grads = set(_trainable_grads(prog))
    ran = sum(b for k, _, b, tag in exe.last_step["collectives"]
              if k == "all-reduce" and tag in grads)
    want = sum(e["bytes"] for e in rep["breakdown"]
               if e["kind"] == "all-reduce" and e["var"] in grads)
    assert ran == want > 0
    if name == "dp":
        assert exe.comm_summary() == {
            k: {"count": v["count"], "bytes": v["bytes"]}
            for k, v in rep["per_kind"].items()}
        assert exe.last_step["reshards"] == 0


# -- layouts across steps, the catalog's contracts -----------------------------

@pytest.mark.parametrize("name,flag", [("dp_mp", "zero_dp_states"),
                                       ("fsdp", "fsdp_params")])
def test_written_state_keeps_its_planned_layout(name, flag):
    mode, prog, loss = tmodes.build_mode(name)
    exe = ParallelExecutor(mesh=_mesh(mode.mesh_axes),
                           **mode.executor_kwargs)
    exe.run(tfluid.default_startup_program())
    for feed in _feeds(mode, 2):
        exe.run(prog, feed=feed, fetch_list=[loss])
    scope = tfluid.global_scope()
    plan = exe.static_plan(prog)
    vel = [n for n in scope.local_names() if n.endswith("velocity_0")
           and n.startswith("conv2d_1")][0]
    v = scope.find(vel)
    assert isinstance(v, ShardedTensor) and v.spec[0] == ("dp",)
    assert v.shards[0].shape[0] * 4 == v.shape[0]
    w = scope.find("conv2d_1.w_0")
    if flag == "fsdp_params":
        assert isinstance(w, ShardedTensor) and w.spec[0] == ("dp",)
    else:
        assert not isinstance(w, ShardedTensor)
    assert tsharding.spec_of(plan[vel], 4)[0] == "dp"


def test_pipeline_modes_plan_but_do_not_run():
    """The pipeline modes plan like the others, and now also run:
    ``run_mode`` gives them a ProgramPipeline over the mode's mesh (held
    to JAX's in tests/test_torch_pipeline.py)."""
    from paddle_tpu_torch.parallel.program_pipeline import ProgramPipeline

    for name in ("pp", "pp_dp"):
        mode, prog, _ = tmodes.build_mode(name)
        mesh, plan, _ = tmodes.mode_plan(mode, prog)
        assert plan and dict(mode.mesh_axes) == tmesh.mesh_axis_sizes(mesh)
        mode, pipe, prog, loss = tmodes.run_mode(name, devices=CPU)
        assert isinstance(pipe, ProgramPipeline)
        assert tmesh.mesh_axis_sizes(pipe.mesh) == dict(mode.mesh_axes)
        tfluid.Executor(tfluid.CPUPlace()).run(
            tfluid.default_startup_program())
        feed = mode.feed_fn(np.random.RandomState(0), 8)
        assert np.isfinite(pipe.run(feed))


def test_catalog_matches_jax():
    assert tmodes.MODE_NAMES == jmodes.MODE_NAMES
    for t, j in zip(tmodes.MODES, jmodes.MODES):
        assert (t.name, t.doc, t.mesh_axes, t.feed_names,
                t.executor_kwargs, t.pipeline) == \
            (j.name, j.doc, j.mesh_axes, j.feed_names, j.executor_kwargs,
             j.pipeline)
    with pytest.raises(KeyError, match="unknown parallelism mode"):
        tmodes.get_mode("nope")


def test_run_mode_builds_the_declared_executor():
    mode, exe, prog, loss = tmodes.run_mode("dp_mp", devices=CPU)
    assert exe.zero_dp_states and not exe.fsdp_params
    assert tmesh.mesh_axis_sizes(exe.mesh) == {"dp": 4, "mp": 2}


def test_save_ops_raise_under_the_parallel_executor(tmp_path):
    x = tfluid.layers.data(name="x", shape=[4])
    tfluid.layers.fc(x, size=2)
    exe = ParallelExecutor(mesh=_mesh({"dp": 2}))
    prog = tfluid.default_main_program()
    prog.global_block().append_op(
        "save", inputs={"X": ["fc_0.w_0"]}, outputs={},
        attrs={"file_path": str(tmp_path / "w.npy")})
    with pytest.raises(NotImplementedError, match="save ops"):
        exe.run(prog, feed={"x": np.ones((2, 4), np.float32)})


def test_mesh_contracts():
    """make_mesh takes the visible CUDA devices unless given devices (it
    raises without enough); repeated devices are virtual positions;
    hybrid slice axes must carry the dcn prefix; positions are row-major;
    ensure_virtual_devices puts n positions on the asked place."""
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA devices"):
            make_mesh({"dp": 2})
        with pytest.raises(RuntimeError, match="CPUPlace"):
            tmodes.ensure_virtual_devices(8)
    mesh = _mesh({"dp": 2, "sp": 4})
    assert mesh.coords(5) == {"dp": 1, "sp": 1}
    assert tmesh.axis_size(mesh, "sp") == 4
    assert tmesh.axis_size(mesh, "mp") == 1
    assert tmesh.dcn_axes(tmesh.make_hybrid_mesh(
        {"dp": 4}, {"dcn_dp": 2}, devices=CPU)) == ("dcn_dp",)
    with pytest.raises(ValueError, match="dcn"):
        tmesh.make_hybrid_mesh({"dp": 4}, {"slice": 2}, devices=CPU)
    with pytest.raises(ValueError, match="needs 16"):
        make_mesh({"dp": 16}, devices=CPU)
    assert tmodes.ensure_virtual_devices(8, tfluid.CPUPlace()) == CPU
    assert tmesh.named(mesh, "dp") == tmesh.named(mesh, "dp", None)
    assert tmesh.replicated(mesh).spec == tmesh.pspec()


def test_shard_map_runs_each_position_on_its_shards():
    mesh = _mesh({"dp": 2, "sp": 4})
    x = torch.arange(64.).reshape(8, 8)
    spec = tmesh.pspec("dp", "sp")
    out = tmesh.shard_map(
        lambda ctx, b: b * 0 + ctx.axis_index("sp") + 10 * ctx.axis_index(
            "dp"), mesh, (spec,), spec)(x)
    want = np.add.outer(np.repeat([0, 10], 4), np.repeat(np.arange(4), 2))
    assert np.array_equal(out.numpy(), want)
