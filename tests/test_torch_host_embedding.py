"""The port's host-offloaded embedding (``paddle_tpu_torch/distributed/
host_embedding.py``) against the JAX package's: the CTR of
``tests/test_host_embedding.py`` trains with its table on each package's
parameter service, the dense tower from JAX's startup state and the same
batches, and the two runs' losses agree within 1e-5 relative and their
tables within 1e-5 of the largest |value| (f32; 1e-4 over the mesh,
whose 256-wide tower sums its gradients in another order than XLA's
mesh does, and 30 adagrad steps carry that).  The fed embedding's
``emb@GRAD`` is fetched from the port's Executor and from its
ParallelExecutor over a dp × mp mesh of eight CPU positions (the
``host_emb`` mode's layout)."""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.distributed import host_embedding as jhe
from paddle_tpu.distributed import pserver as jps
from paddle_tpu_torch.distributed import host_embedding as the
from paddle_tpu_torch.distributed import pserver as tps


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    yield


def _ctr(fluid, hidden=0):
    emb = fluid.layers.data(name="emb", shape=[emb_dim(hidden)],
                            dtype="float32")
    emb.stop_gradient = False
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    h = fluid.layers.fc(emb, size=hidden, act="relu") if hidden else emb
    pred = fluid.layers.fc(h, size=1, act="sigmoid")
    cost = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    fluid.optimizer.SGD(learning_rate=0.2).minimize(cost)
    return cost


def emb_dim(hidden):
    return 16 if hidden else 8


def _train(fluid, he, ps, exe_for, steps, vocab, hidden=0, state=None):
    svc = ps.ParameterServerService(num_trainers=1)
    table = he.HostEmbedding(svc, "emb_table", vocab, emb_dim(hidden),
                             optimizer={"type": "adagrad", "lr": 0.5})
    svc.finish_init_params()
    fluid.reset()
    cost = _ctr(fluid, hidden)
    exe = exe_for(fluid)
    exe.run(fluid.default_startup_program())
    for n, v in (state or {}).items():
        fluid.global_scope().set(n, v)
    init = {n: np.asarray(fluid.global_scope().find_np(n))
            for n in fluid.global_scope().local_names()}
    rng = np.random.RandomState(0)
    B, losses = 32, []
    for _ in range(steps):
        ids = rng.randint(0, vocab, size=B)
        labels = (ids % 2 == 0).astype(np.float32).reshape(B, 1)
        c, g = exe.run(feed={"emb": table.fetch(ids), "y": labels},
                       fetch_list=[cost, "emb@GRAD"])
        assert np.asarray(g).shape == (B, emb_dim(hidden))
        table.push_grad(ids, np.asarray(g))
        losses.append(float(np.asarray(c).ravel()[0]))
    return losses, np.asarray(svc.get_param("emb_table")), init, svc


def test_ctr_with_host_table_trains():
    def cpu(fluid):
        return fluid.Executor(fluid.CPUPlace())

    jl, jt, init, _ = _train(jfluid, jhe, jps, cpu, 60, 1000)
    tl, tt, _, svc = _train(tfluid, the, tps, cpu, 60, 1000, state=init)
    assert tl[-1] < tl[0] * 0.6, (tl[0], tl[-1])
    assert svc.get_param_rows("emb_table", np.array([999])).shape == (1, 8)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-5 * np.abs(jt).max())


def test_fetch_push_dedup_semantics():
    got = []
    for he, ps in ((the, tps), (jhe, jps)):
        svc = ps.ParameterServerService(num_trainers=1)
        t = he.HostEmbedding(svc, "t", 10, 2,
                             optimizer={"type": "sgd", "lr": 1.0},
                             init_scale=0.0)
        svc.finish_init_params()
        vecs = t.fetch(np.array([3, 3, 5]))
        assert vecs.shape == (3, 2)
        np.testing.assert_array_equal(vecs[0], vecs[1])
        t.push_grad(np.array([3, 3, 5]), np.ones((3, 2), np.float32))
        got.append(svc.get_param("t"))
    np.testing.assert_allclose(got[0][3], [-2.0, -2.0])
    np.testing.assert_allclose(got[0][5], [-1.0, -1.0])
    assert np.all(got[0][[0, 1, 2, 4, 6, 7, 8, 9]] == 0)
    np.testing.assert_array_equal(got[0], got[1])


def test_push_takes_a_torch_gradient():
    """A gradient fetched with ``return_numpy=False`` (a torch tensor)
    pushes like its numpy value."""
    out = []
    for grad in (np.full((2, 3), 0.5, np.float32),
                 torch.full((2, 3), 0.5)):
        svc = tps.ParameterServerService(num_trainers=1)
        t = the.HostEmbedding(svc, "t", 4, 3, seed=1,
                              optimizer={"type": "adagrad", "lr": 0.1})
        svc.finish_init_params()
        t.push_grad(np.array([1, 2]), grad)
        out.append(svc.get_param("t"))
    np.testing.assert_array_equal(out[0], out[1])


def test_host_table_composes_with_spmd_mesh():
    """The host table beside the dense tower over a dp × mp mesh of
    eight CPU positions (the port's ParallelExecutor): the fetched
    ``emb@GRAD`` goes back to the table, and the run equals the JAX
    package's ParallelExecutor on its 8-device mesh from the same
    state."""
    from paddle_tpu.parallel import ParallelExecutor as JPE
    from paddle_tpu_torch.parallel import ParallelExecutor, make_mesh

    def jexe(fluid):
        return JPE(axes={"dp": 4, "mp": 2})

    def texe(fluid):
        return ParallelExecutor(mesh=make_mesh(
            {"dp": 4, "mp": 2}, devices=[torch.device("cpu")] * 8))

    jl, jt, init, _ = _train(jfluid, jhe, jps, jexe, 30, 512, hidden=256)
    tl, tt, _, _ = _train(tfluid, the, tps, texe, 30, 512, hidden=256,
                          state=init)
    assert tl[-1] < tl[0] * 0.7, (tl[0], tl[-1])
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-4 * np.abs(jt).max())


def test_host_emb_mode_takes_its_embedding_from_the_host_table():
    """The catalog's ``host_emb`` mode made whole: run_mode's executor
    over eight CPU positions trains with the fed embedding fetched from a
    host table and its ``emb@GRAD`` pushed back."""
    from paddle_tpu_torch.parallel import modes as tmodes

    mode, exe, prog, loss = tmodes.run_mode(
        "host_emb", devices=[torch.device("cpu")] * 8)
    exe.run(tfluid.default_startup_program())
    svc = tps.ParameterServerService(num_trainers=1)
    table = the.HostEmbedding(svc, "emb_table", 256, 16,
                              optimizer={"type": "adagrad", "lr": 0.5})
    svc.finish_init_params()
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(20):
        ids = rng.randint(0, 256, size=32)
        labels = (ids % 2 == 0).astype(np.float32).reshape(32, 1)
        c, g = exe.run(prog, feed={"emb": table.fetch(ids), "y": labels},
                       fetch_list=[loss, "emb@GRAD"])
        table.push_grad(ids, np.asarray(g))
        losses.append(float(np.asarray(c).ravel()[0]))
    assert losses[-1] < losses[0], losses
