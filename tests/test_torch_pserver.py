"""The port's host parameter service (``paddle_tpu_torch/distributed/
pserver.py``) against the JAX package's: each scenario of
``tests/test_pserver.py`` runs on both services with the same inputs and
must give the same arrays, bit for bit (the host optimizers are numpy in
both; bf16 runs through CPU torch tensors in the port and ``ml_dtypes``
in the JAX package, with the same roundings).  The cross-package wire
tests run either package's ``ParameterClient`` against the other's
``PServer`` on loopback: f32 and bf16 params, dense and sparse
gradients, the pass barrier — and must end where a same-package pair
ends, bit for bit.  Every thread join and barrier has its own timeout."""

import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu.distributed import pserver as jps
from paddle_tpu_torch.distributed import pserver as tps

BF16 = ml_dtypes.bfloat16
PKGS = (tps, jps)


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    yield


def _np(x):
    """A service value as numpy, bf16 as ml_dtypes bfloat16."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16).numpy().view(BF16)
    return np.asarray(x)


def _bf16_tensor(a):
    return torch.from_numpy(np.asarray(a, BF16).view(np.int16).copy()).view(
        torch.bfloat16)


def _same(a, b):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _join(*threads):
    for t in threads:
        t.join(timeout=20)
        assert not t.is_alive()


def test_init_barrier_and_get():
    for ps in PKGS:
        svc = ps.ParameterServerService(num_trainers=1)
        svc.init_param("w", np.ones((4, 2), np.float32))
        with pytest.raises(RuntimeError):
            svc.send_grad("0", {"w": np.zeros((4, 2), np.float32)})
        svc.finish_init_params()
        np.testing.assert_array_equal(svc.get_param("w"), np.ones((4, 2)))


def _bsp(ps):
    svc = ps.ParameterServerService(num_trainers=2, mode="bsp")
    svc.init_param("w", np.zeros(3, np.float32), {"type": "sgd", "lr": 1.0})
    svc.finish_init_params()
    g0 = np.array([1.0, 0.0, 0.0], np.float32)
    g1 = np.array([0.0, 1.0, 0.0], np.float32)
    t = threading.Thread(target=svc.send_grad, args=("t1", {"w": g1}),
                         kwargs={"timeout": 10})
    t.start()
    svc.send_grad("t0", {"w": g0}, timeout=10)
    _join(t)
    return svc.get_param("w")


def test_bsp_averages_across_trainers():
    got = _bsp(tps)
    np.testing.assert_allclose(got, [-0.5, -0.5, 0.0])
    _same(got, _bsp(jps))


def test_async_applies_immediately():
    out = []
    for ps in PKGS:
        svc = ps.ParameterServerService(num_trainers=2, mode="async")
        svc.init_param("w", np.zeros(2, np.float32),
                       {"type": "sgd", "lr": 1.0})
        svc.finish_init_params()
        svc.send_grad("t0", {"w": np.array([1.0, 0.0], np.float32)})
        out.append(svc.get_param("w"))
    np.testing.assert_allclose(out[0], [-1.0, 0.0])
    _same(*out)


def test_sparse_rows_update_and_prefetch():
    out = []
    for ps in PKGS:
        svc = ps.ParameterServerService(num_trainers=1)
        svc.init_param("emb", np.zeros((10, 4), np.float32),
                       {"type": "adagrad", "lr": 1.0})
        svc.finish_init_params()
        svc.send_sparse_grad("t0", "emb", np.array([2, 7, 2]),
                             np.ones((3, 4), np.float32))
        out.append((svc.get_param("emb"),
                    svc.get_param_rows("emb", np.array([2, 7]))))
    got, sub = out[0]
    assert np.all(got[[0, 1, 3, 4, 5, 6, 8, 9]] == 0)
    assert np.all(got[2] != 0) and np.all(got[7] != 0)
    np.testing.assert_allclose(sub, got[[2, 7]])
    for a, b in zip(*out):
        _same(a, b)


def test_checkpoint_roundtrip(tmp_path):
    for ps in PKGS:
        d = str(tmp_path / ps.__name__.split(".")[0])
        svc = ps.ParameterServerService(num_trainers=1, checkpoint_dir=d)
        svc.init_param("w", np.ones(4, np.float32),
                       {"type": "adam", "lr": 0.1})
        svc.finish_init_params()
        svc.send_grad("t0", {"w": np.ones(4, np.float32)})
        expect = svc.get_param("w")
        svc.save_checkpoint()
        svc2 = ps.ParameterServerService(num_trainers=1, checkpoint_dir=d)
        assert svc2.load_checkpoint()
        _same(svc2.get_param("w"), expect)
        assert svc2.initialized()
        src, dst = svc._opts["w"], svc2._opts["w"]
        assert dst.t == src.t == 1
        _same(dst.m, src.m)
        _same(dst.v, src.v)


def test_checkpoint_bf16_state_readable_by_either(tmp_path):
    """A bf16 table under adagrad keeps a bf16 moment; either package's
    checkpoint of it holds the same words, and the port's service loads
    both as bf16.  (The JAX service reloads a bf16 value as raw ``|V2``
    words, its own checkpoints included — ROADMAP.md Queue C; so on its
    side only the words are compared.)"""
    table = np.random.RandomState(0).randn(6, 3).astype(BF16)
    rows, vals = np.array([1, 4, 1]), np.ones((3, 3), BF16)
    saved = {}
    for ps, value, v in ((tps, _bf16_tensor(table), _bf16_tensor(vals)),
                         (jps, table, vals)):
        d = str(tmp_path / ps.__name__.split(".")[0])
        svc = ps.ParameterServerService(num_trainers=1, checkpoint_dir=d)
        svc.init_param("emb", value, {"type": "adagrad", "lr": 0.5})
        svc.finish_init_params()
        svc.send_sparse_grad("t0", "emb", rows, v)
        svc.save_checkpoint()
        saved[ps] = (d, svc.get_param("emb"), svc._opts["emb"].moment)
    _same(saved[tps][1], saved[jps][1])
    _same(saved[tps][2], saved[jps][2])
    for reader in PKGS:
        for writer in PKGS:
            svc = reader.ParameterServerService(
                num_trainers=1, checkpoint_dir=saved[writer][0])
            assert svc.load_checkpoint()
            got = (svc.get_param("emb"), svc._opts["emb"].moment)
            for a, b in zip(got, saved[writer][1:]):
                if reader is tps:
                    _same(a, b)
                else:
                    np.testing.assert_array_equal(
                        _np(a).view(np.uint8), _np(b).view(np.uint8))


def _tcp_round(ps_server, ps_client, dtype):
    """Two pservers, two BSP trainers, then the sparse path and the pass
    barrier over loopback; the params seen by trainer 0 after each."""
    s1 = ps_server.PServer(num_trainers=2).start()
    s2 = ps_server.PServer(num_trainers=2).start()
    eps = [s1.endpoint, s2.endpoint]
    seen = {}

    def val(a):
        return _bf16_tensor(a) if (dtype == "bfloat16"
                                   and ps_client is tps) else \
            np.asarray(a, BF16 if dtype == "bfloat16" else np.float32)

    try:
        c0 = ps_client.ParameterClient(eps, trainer_id="0")
        c1 = ps_client.ParameterClient(eps, trainer_id="1")
        c0.init_param("w1", val(np.linspace(-1, 1, 3)),
                      {"type": "sgd", "lr": 0.3})
        c0.init_param("w2", val(np.linspace(0.5, 2, 2)),
                      {"type": "adam", "lr": 0.1})
        c0.init_param("emb", val(np.arange(12).reshape(6, 2) / 7.0),
                      {"type": "adagrad", "lr": 0.5})
        c0.finish_init_params()
        assert c0.initialized()
        g = {"w1": val([0.7, -0.2, 0.1]), "w2": val([1.3, -0.6])}
        t = threading.Thread(target=c1.send_grads, args=(g,))
        t.start()
        c0.send_grads(g)
        _join(t)
        seen["dense"] = c0.get_params()
        c0.send_sparse_grad("emb", np.array([0, 3, 0]),
                            val(np.ones((3, 2)) * 0.37))
        seen["emb"] = c0.get_param("emb")
        seen["rows"] = c0.get_param_rows("emb", np.array([3, 1]))
        res = []
        t = threading.Thread(target=lambda: res.append(c1.pass_barrier()))
        t.start()
        res.append(c0.pass_barrier())
        _join(t)
        seen["pass"] = res
        c0.close()
        c1.close()
    finally:
        s1.stop()
        s2.stop()
    return seen


_JAX_ROUNDS = {}


def _jax_round(dtype):
    """The JAX-only pair's round (run once a dtype)."""
    if dtype not in _JAX_ROUNDS:
        _JAX_ROUNDS[dtype] = _tcp_round(jps, jps, dtype)
    return _JAX_ROUNDS[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tcp_two_servers_two_trainers(dtype):
    """End-to-end over loopback TCP with the port on both sides, against
    the JAX package on both sides."""
    got, want = _tcp_round(tps, tps, dtype), _jax_round(dtype)
    assert got["pass"] == want["pass"] == [1, 1]
    assert sorted(got["dense"]) == sorted(want["dense"])
    for n in want["dense"]:
        _same(got["dense"][n], want["dense"][n])
    _same(got["emb"], want["emb"])
    _same(got["rows"], want["rows"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("server,client", [(jps, tps), (tps, jps)],
                         ids=["port_client_jax_server",
                              "jax_client_port_server"])
def test_wire_across_packages(server, client, dtype):
    """Either package's client against the other's server ends where a
    JAX-only pair ends: the wire and the host optimizers agree."""
    got, want = _tcp_round(server, client, dtype), _jax_round(dtype)
    assert got["pass"] == want["pass"]
    for n in want["dense"]:
        _same(got["dense"][n], want["dense"][n])
    _same(got["emb"], want["emb"])
    _same(got["rows"], want["rows"])


@pytest.mark.parametrize("kind", ["sgd", "momentum", "nesterov", "adagrad",
                                  "adam"])
def test_host_optimizers_bf16_round_as_ml_dtypes(kind):
    """Three dense and two sparse steps of each host optimizer on a bf16
    parameter with bf16 gradients: the port (CPU torch tensors) gives the
    JAX package's ml_dtypes results bit for bit, dtype included."""
    rng = np.random.RandomState(3)
    p0 = rng.randn(5, 4).astype(BF16)
    gs = [rng.randn(5, 4).astype(BF16) for _ in range(3)]
    rows = np.array([0, 3, 3])
    vals = rng.randn(3, 4).astype(BF16)
    cfg = {"sgd": {"type": "sgd", "lr": 0.1},
           "momentum": {"type": "momentum", "lr": 0.1, "momentum": 0.9},
           "nesterov": {"type": "momentum", "lr": 0.1, "momentum": 0.9,
                        "use_nesterov": True},
           "adagrad": {"type": "adagrad", "lr": 0.1},
           "adam": {"type": "adam", "lr": 0.01}}[kind]
    jopt, topt = jps.make_optimizer(cfg), tps.make_optimizer(cfg)
    jp, tp = p0, _bf16_tensor(p0)
    for g in gs:
        jp, tp = jopt.update(jp, g), topt.update(tp, _bf16_tensor(g))
        _same(tp, jp)
    jq = jps.make_optimizer(cfg).update_rows(p0, rows, vals)
    tq = tps.make_optimizer(cfg).update_rows(_bf16_tensor(p0), rows,
                                             _bf16_tensor(vals))
    _same(tq, jq)
    jq, tq = jopt.update_rows(jp, rows, vals), topt.update_rows(
        tp, rows, _bf16_tensor(vals))
    _same(tq, jq)


def _dedup(ps):
    svc = ps.ParameterServerService(num_trainers=1, mode="bsp")
    svc.init_param("w", np.zeros(2, np.float32), {"type": "sgd", "lr": 1.0})
    svc.finish_init_params()
    g = {"w": np.array([1.0, 0.0], np.float32)}
    svc.send_grad("t0", g, seq=7)
    svc.send_grad("t0", g, seq=7)
    a = svc.get_param("w")
    svc.send_grad("t0", g, seq=8)
    b = svc.get_param("w")
    svc2 = ps.ParameterServerService(num_trainers=2, mode="async")
    svc2.init_param("w", np.zeros(2, np.float32), {"type": "sgd", "lr": 1.0})
    svc2.finish_init_params()
    svc2.send_grad("t0", g, seq=1)
    svc2.send_grad("t0", g, seq=1)
    svc3 = ps.ParameterServerService(num_trainers=1)
    svc3.init_param("emb", np.zeros((4, 2), np.float32),
                    {"type": "sgd", "lr": 1.0})
    svc3.finish_init_params()
    rows, vals = np.array([1]), np.ones((1, 2), np.float32)
    svc3.send_sparse_grad("t0", "emb", rows, vals, seq=3)
    svc3.send_sparse_grad("t0", "emb", rows, vals, seq=3)
    return a, b, svc2.get_param("w"), svc3.get_param("emb")


def test_send_grad_retry_dedup():
    got = _dedup(tps)
    np.testing.assert_allclose(got[0], [-1.0, 0.0])
    np.testing.assert_allclose(got[1], [-2.0, 0.0])
    np.testing.assert_allclose(got[2], [-1.0, 0.0])
    np.testing.assert_allclose(got[3][1], [-1.0, -1.0])
    for a, b in zip(got, _dedup(jps)):
        _same(a, b)


def test_pass_barrier_identity_dedup():
    svc = tps.ParameterServerService(num_trainers=2)
    svc.init_param("w", np.zeros(1, np.float32))
    svc.finish_init_params()
    results = []

    def arrive(tid):
        results.append(svc.wait_pass_barrier(timeout=10, trainer_id=tid))

    t_a = threading.Thread(target=arrive, args=("t0",))
    t_b = threading.Thread(target=arrive, args=("t0",))
    t_a.start()
    t_b.start()
    time.sleep(0.3)
    assert not results  # the duplicate must not release the barrier
    t_c = threading.Thread(target=arrive, args=("t1",))
    t_c.start()
    _join(t_a, t_b, t_c)
    assert results == [1, 1, 1]


def test_pass_barrier_completed_retry_returns_immediately():
    svc = tps.ParameterServerService(num_trainers=2)
    svc.init_param("w", np.zeros(1, np.float32))
    svc.finish_init_params()
    out = []

    def arrive(tid, seq):
        out.append(svc.wait_pass_barrier(timeout=10, trainer_id=tid,
                                         seq=seq))

    a = threading.Thread(target=arrive, args=("t0", "n0:1"))
    b = threading.Thread(target=arrive, args=("t1", "n1:1"))
    a.start()
    b.start()
    _join(a, b)
    assert out == [1, 1]
    assert svc.wait_pass_barrier(timeout=1, trainer_id="t0",
                                 seq="n0:1") == 1
    assert svc._pass_waiting == 0


def test_server_for_matches_jax():
    eps = ["127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3"]
    for n in ("fc_0.w_0", "fc_0.b_0", "emb", "x" * 40):
        assert tps.server_for(n, eps) == jps.server_for(n, eps)
