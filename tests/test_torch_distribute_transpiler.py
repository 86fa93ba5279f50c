"""The port's pserver DistributeTranspiler (``paddle_tpu_torch/
distributed/distribute_transpiler.py``) against the JAX package's: the
same program split the same way (trainer ops, pserver rules, endpoints),
and the same job trained through two loopback pservers from JAX's
startup state on the same batches gives the same losses (1e-5 relative)
and parameters (1e-5 of their largest |value|, f32).  The scenarios of
``tests/test_distribute_transpiler.py`` run on the port: roles, the
simple alias and its errors, nesterov and a static LR carried, the
trainer-count and stray-grad refusals, a pserver restarted from its
checkpoint mid-training, an LR schedule reaching the host optimizers, a
missing gradient warned about.  A small GPT with Adam through two
pservers is held to the port's single-device Executor with Adam (losses
1e-4 relative: the host Adam puts epsilon outside the bias correction,
the op inside)."""

import logging

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.distributed import pserver as jps
from paddle_tpu_torch.distributed import pserver as tps

PAIRS = ((tfluid, tps), (jfluid, jps))


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    yield


def _start_pserver(ps=tps, **kw):
    srv = ps.PServer(num_trainers=kw.pop("num_trainers", 1), **kw).start()
    host, port = srv.server_address
    return srv.service, srv, f"{host}:{port}"


def _regression(fluid, prefix, opt):
    x = fluid.layers.data(prefix + "x", shape=[4], dtype="float32")
    y = fluid.layers.data(prefix + "y", shape=[1], dtype="float32")
    h = fluid.layers.fc(x, size=3, act="tanh")
    cost = fluid.layers.mean(fluid.layers.square_error_cost(
        fluid.layers.fc(h, size=1), y))
    opt(fluid).minimize(cost)
    return cost


def _train_remote(fluid, ps, opt, steps, state=None, eps=2):
    """The regression job transpiled over `eps` loopback pservers of `ps`:
    (losses, final params)."""
    fluid.reset()
    cost = _regression(fluid, "dt", opt)
    servers = [_start_pserver(ps) for _ in range(eps)]
    try:
        t = fluid.DistributeTranspiler().transpile(
            0, pservers=",".join(s[2] for s in servers), trainers=1)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(fluid.default_startup_program())
        for n, v in (state or {}).items():
            fluid.global_scope().set(n, v)
        init = {n: np.asarray(fluid.global_scope().find_np(n))
                for n in fluid.global_scope().local_names()}
        upd = t.make_updater()
        upd.init_params()
        gvars = t.grad_fetch_list()
        gnames = [g.name for g in gvars]
        rng = np.random.RandomState(0)
        W = np.array([[1.0], [-2.0], [0.5], [3.0]], np.float32)
        losses = []
        for _ in range(steps):
            xv = rng.rand(32, 4).astype(np.float32)
            outs = exe.run(feed={"dtx": xv, "dty": xv @ W},
                           fetch_list=[cost] + gvars)
            losses.append(float(np.asarray(outs[0]).reshape(())))
            upd.step(dict(zip(gnames, outs[1:])))
        params = {n: np.asarray(upd.client.get_param(n))
                  for n in t.param_cfg}
        upd.close()
        return losses, params, init, t
    finally:
        for s in servers:
            s[1].stop()


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_transpile_splits_roles_and_trains(kind):
    opt = {"sgd": lambda f: f.optimizer.SGDOptimizer(learning_rate=0.1),
           "adam": lambda f: f.optimizer.AdamOptimizer(
               learning_rate=0.05)}[kind]
    jl, jp, init, jt = _train_remote(jfluid, jps, opt, 40)
    tl, tp, _, t = _train_remote(tfluid, tps, opt, 40, state=init)
    ops = [op.type for op in t.get_trainer_program().global_block().ops]
    assert kind not in ops
    assert ops == [op.type for op in
                   jt.get_trainer_program().global_block().ops]
    cfgs = {}
    for ep in t.endpoints:
        cfgs.update(t.get_pserver_program(ep))
    assert set(cfgs) == set(t.param_cfg)
    assert all(c["type"] == kind for c in cfgs.values())
    assert t.param_endpoint.keys() == jt.param_endpoint.keys()
    assert tl[-1] < tl[0] * 0.2, tl
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], rtol=0,
                                   atol=1e-5 * np.abs(jp[n]).max())


def test_simple_transpiler_alias_and_errors():
    x = tfluid.layers.data("stx", shape=[2], dtype="float32")
    cost = tfluid.layers.mean(tfluid.layers.fc(x, size=1))
    tfluid.optimizer.AdamOptimizer(learning_rate=0.01).minimize(cost)
    t = tfluid.SimpleDistributeTranspiler()
    with pytest.raises(ValueError, match="endpoint"):
        t.transpile(0, pservers="")
    t.transpile(0, pservers="127.0.0.1:1")  # no connection at transpile
    cfg = [c for c in t.param_cfg.values() if c["type"] == "adam"][0]
    assert {k: cfg[k] for k in ("beta1", "beta2", "epsilon")} == {
        "beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}


def test_transpile_carries_nesterov_and_static_lr():
    cfgs = []
    for fluid, _ in PAIRS:
        fluid.reset()
        x = fluid.layers.data("nvx", shape=[2], dtype="float32")
        cost = fluid.layers.mean(fluid.layers.fc(x, size=1))
        fluid.optimizer.MomentumOptimizer(
            learning_rate=0.05, momentum=0.9,
            use_nesterov=True).minimize(cost)
        t = fluid.DistributeTranspiler().transpile(0, pservers="h:1")
        cfgs.append(t.get_pserver_program("h:1"))
    cfg = list(cfgs[0].values())[0]
    assert cfg["use_nesterov"] is True and abs(cfg["lr"] - 0.05) < 1e-9
    assert cfgs[0] == cfgs[1]


def test_updater_rejects_mismatched_trainers_and_stray_grads():
    x = tfluid.layers.data("mmx", shape=[2], dtype="float32")
    cost = tfluid.layers.mean(tfluid.layers.fc(x, size=1))
    tfluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(cost)
    _, srv, ep = _start_pserver()
    try:
        t = tfluid.DistributeTranspiler().transpile(0, pservers=ep,
                                                    trainers=4)
        tfluid.Executor(tfluid.CPUPlace()).run(
            tfluid.default_startup_program())
        upd = t.make_updater()
        with pytest.raises(RuntimeError, match="BSP averaging"):
            upd.init_params()
        upd.close()
    finally:
        srv.stop()
    tfluid.reset()
    x = tfluid.layers.data("mmx2", shape=[2], dtype="float32")
    cost = tfluid.layers.mean(tfluid.layers.fc(x, size=1))
    tfluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(cost)
    _, srv, ep = _start_pserver()
    try:
        t = tfluid.DistributeTranspiler().transpile(0, pservers=ep,
                                                    trainers=1)
        tfluid.Executor(tfluid.CPUPlace()).run(
            tfluid.default_startup_program())
        upd = t.make_updater()
        upd.init_params()
        with pytest.raises(KeyError, match="match no transpiled"):
            upd.step({"not_a_grad": np.zeros(2, np.float32)})
        with pytest.raises(KeyError, match="match no transpiled"):
            upd.step({})
        upd.close()
    finally:
        srv.stop()


def test_elastic_pserver_restart_mid_training(tmp_path):
    """Kill the pserver mid-training, restart it on the same endpoint
    from its checkpoint: the SAME client keeps training through the
    outage."""
    rng = np.random.RandomState(1)
    cost = _regression(tfluid, "el", lambda f: f.optimizer.SGDOptimizer(
        learning_rate=0.1))
    ckpt = str(tmp_path)
    srv = tps.PServer(port=0, num_trainers=1, checkpoint_dir=ckpt).start()
    port = srv.server_address[1]
    t = tfluid.DistributeTranspiler().transpile(
        0, pservers=f"127.0.0.1:{port}", trainers=1)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    upd = t.make_updater()
    upd.init_params()
    W = np.array([[1.0], [-1.0], [2.0], [0.5]], np.float32)
    gvars = t.grad_fetch_list()
    gnames = [g.name for g in gvars]

    def steps(n):
        out = []
        for _ in range(n):
            xv = rng.rand(16, 4).astype(np.float32)
            res = exe.run(feed={"elx": xv, "ely": xv @ W},
                          fetch_list=[cost] + gvars)
            out.append(float(np.asarray(res[0]).reshape(())))
            upd.step(dict(zip(gnames, res[1:])))
        return out

    first = steps(20)
    srv.service.save_checkpoint()
    name = list(t.param_cfg)[0]
    param_at_kill = upd.client.get_param(name)
    srv.stop()
    srv2 = tps.PServer(port=port, num_trainers=1,
                       checkpoint_dir=ckpt).start()
    try:
        assert srv2.service.initialized()
        np.testing.assert_array_equal(srv2.service.get_param(name),
                                      param_at_kill)
        second = steps(20)
        assert second[-1] < first[0] * 0.5
        upd.close()
    finally:
        srv2.stop()


def test_lr_schedule_reaches_host_optimizers():
    seen_by = []
    for fluid, ps in PAIRS:
        fluid.reset()
        rng = np.random.RandomState(0)
        x = fluid.layers.data("lrx", shape=[4], dtype="float32")
        y = fluid.layers.data("lry", shape=[1], dtype="float32")
        cost = fluid.layers.mean(fluid.layers.square_error_cost(
            fluid.layers.fc(x, size=1), y))
        lr = fluid.learning_rate_decay.exponential_decay(
            learning_rate=0.5, decay_steps=1, decay_rate=0.5, staircase=True)
        fluid.optimizer.SGDOptimizer(learning_rate=lr).minimize(cost)
        svc, srv, ep = _start_pserver(ps)
        try:
            t = fluid.DistributeTranspiler().transpile(0, pservers=ep,
                                                       trainers=1)
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(fluid.default_startup_program())
            upd = t.make_updater()
            upd.init_params()
            gvars = t.grad_fetch_list()
            gnames = [g.name for g in gvars]
            seen = []
            for _ in range(3):
                xv = rng.rand(8, 4).astype(np.float32)
                outs = exe.run(feed={"lrx": xv, "lry": (xv @ np.ones(
                    (4, 1))).astype(np.float32)}, fetch_list=[cost] + gvars)
                upd.step(dict(zip(gnames, outs[1:])))
                seen.append({p: svc._opts[p].lr for p in t.param_cfg})
            upd.close()
        finally:
            srv.stop()
        seen_by.append(seen)
    for pname in seen_by[0][0]:
        np.testing.assert_allclose([s[pname] for s in seen_by[0]],
                                   [0.25, 0.125, 0.0625], rtol=1e-6)
    assert seen_by[0] == seen_by[1]


def test_step_warns_on_missing_expected_grad(caplog):
    rng = np.random.RandomState(0)
    cost = _regression(tfluid, "mg", lambda f: f.optimizer.SGDOptimizer(
        learning_rate=0.1))
    _, srv, ep = _start_pserver()
    try:
        t = tfluid.DistributeTranspiler().transpile(0, pservers=ep,
                                                    trainers=1)
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(tfluid.default_startup_program())
        upd = t.make_updater()
        upd.init_params()
        gvars = t.grad_fetch_list()
        gnames = [g.name for g in gvars]
        outs = exe.run(feed={"mgx": rng.rand(8, 4).astype(np.float32),
                             "mgy": rng.rand(8, 1).astype(np.float32)},
                       fetch_list=[cost] + gvars)
        grads = dict(zip(gnames, outs[1:]))
        partial = {k: v for k, v in grads.items() if k != gnames[0]}
        with caplog.at_level(logging.WARNING):
            upd.step(partial)
        assert any("no gradient for transpiled param" in r.message
                   for r in caplog.records)
        with pytest.raises(KeyError, match="no gradient for transpiled"):
            upd.step(partial, strict=True)
        upd.step(grads)
        upd.close()
    finally:
        srv.stop()


def test_gpt_through_pservers_matches_single_device_adam():
    """The GPT tower (V 64, D 32, T 16, two blocks) with Adam through two
    pservers and HostAdam, three steps: losses within 1e-4 relative of
    the single-device Executor's Adam from the same state."""
    from paddle_tpu_torch.models import transformer

    def build():
        tfluid.reset()
        main = tfluid.default_main_program()
        tfluid.default_startup_program().random_seed = 5
        loss = transformer.build_lm_train_program(
            seq_len=16, vocab_size=64, dim=32, n_layers=2, n_heads=4,
            dtype="float32", learning_rate=1e-2)
        return loss, main

    rng = np.random.RandomState(0)
    toks = rng.randint(0, 64, (4, 16, 1)).astype(np.int64)
    feed = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    loss, _ = build()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    state = {n: tfluid.global_scope().find_np(n)
             for n in tfluid.global_scope().local_names()}
    want = [float(np.asarray(exe.run(feed=feed, fetch_list=[loss])[0])
                  .reshape(-1)[0]) for _ in range(3)]
    loss, main = build()
    servers = [_start_pserver() for _ in range(2)]
    try:
        t = tfluid.DistributeTranspiler().transpile(
            0, program=main, pservers=",".join(s[2] for s in servers))
        assert {c["type"] for c in t.param_cfg.values()} == {"adam"}
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(tfluid.default_startup_program())
        for n, v in state.items():
            tfluid.global_scope().set(n, v)
        upd = t.make_updater()
        upd.init_params()
        gvars = t.grad_fetch_list()
        got = []
        for _ in range(3):
            outs = exe.run(feed=feed, fetch_list=[loss] + gvars)
            got.append(float(np.asarray(outs[0]).reshape(-1)[0]))
            upd.step(dict(zip([g.name for g in gvars], outs[1:])))
        upd.close()
    finally:
        for s in servers:
            s[1].stop()
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-4)
