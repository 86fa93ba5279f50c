"""The port's sequence-parallel attention (``parallel/ring_attention.py``)
against the JAX package's on the 8-device CPU mesh and against dense
single-device attention: the plain ring, the flash ring (the plain
versions of K4–K6 on CPU tensors; JAX's Pallas kernels in interpret
mode), the zigzag schedule and Ulysses, causal and not, forward and the
three gradients, f32; the JAX cases of ``tests/test_ring_attention.py``
with their contract errors; and ``scaled_dot_product_attention``'s sp
dispatch training through the ``ParallelExecutor``.

Tolerances: 2e-5 absolute and relative against the JAX package and
against dense attention (f32 merge order and f32 CPU reduction order; the
worst seen is 1e-6); 5e-4 on the gradients of a squared loss as the JAX
case holds them."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu_torch as tfluid
from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu.parallel import ring_attention as jra
from paddle_tpu_torch.parallel import ParallelExecutor, make_mesh
from paddle_tpu_torch.parallel import collectives as col
from paddle_tpu_torch.parallel import ring_attention as tra
from paddle_tpu_torch.parallel.ring_attention import (
    attention, ring_attention, ulysses_attention, zigzag_permutation)

CPU8 = [torch.device("cpu")] * 8
TOL = dict(rtol=2e-5, atol=2e-5)


def _mesh(axes):
    n = int(np.prod(list(axes.values())))
    return make_mesh(axes, devices=CPU8[:n])


def _qkv(B=2, H=4, T=32, D=16, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, H, T, D).astype(np.float32) for _ in range(3))


def _t(*xs, grad=False):
    return [torch.tensor(x, requires_grad=grad) for x in xs]


def _port_fn(kind, mesh, causal):
    def f(q, k, v):
        if kind == "ulysses":
            return ulysses_attention(q, k, v, mesh, causal=causal)
        return ring_attention(
            q, k, v, mesh, causal=causal, use_flash=kind != "plain",
            is_train=True,
            schedule="zigzag" if kind == "zigzag" else "plain")
    return f


def _port_run(kind, S, causal, q, k, v, do):
    tq, tk, tv = _t(q, k, v, grad=True)
    to = _port_fn(kind, _mesh({"sp": S}), causal)(tq, tk, tv)
    return [to.detach().numpy()] + [g.numpy() for g in torch.autograd.grad(
        to, (tq, tk, tv), torch.tensor(do))]


def _inputs():
    q, k, v = _qkv()
    do = np.random.RandomState(9).randn(*q.shape).astype(np.float32)
    return q, k, v, do


@pytest.fixture(scope="module")
def jax_sp2_causal():
    """JAX's causal schedules on its sp=2 mesh, output and dQ, dK, dV of
    one cotangent: the plain ring, the flash ring (its Pallas kernels in
    interpret mode) and Ulysses.  Computed once: each costs seconds of
    tracing."""
    q, k, v, do = _inputs()
    mesh = jmake_mesh({"sp": 2})
    fns = {
        "plain": lambda q, k, v: jra.ring_attention(q, k, v, mesh,
                                                    causal=True),
        "flash": lambda q, k, v: jra.ring_attention(
            q, k, v, mesh, causal=True, use_flash=True, is_train=True,
            interpret=True),
        "ulysses": lambda q, k, v: jra.ulysses_attention(q, k, v, mesh,
                                                         causal=True),
    }
    out = {}
    for kind, fn in fns.items():
        o, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
        out[kind] = [np.asarray(o)] + [np.asarray(g) for g in
                                       vjp(jnp.asarray(do))]
    return out


@pytest.mark.parametrize("kind,ref", [
    ("plain", "plain"), ("flash", "flash"), ("zigzag", "flash"),
    ("ulysses", "ulysses")])
def test_schedule_matches_jax(jax_sp2_causal, kind, ref):
    """Each of the port's schedules at sp=2, causal, against JAX's
    ``ring_attention``/``ulysses_attention``: output and the three
    gradients (the zigzag schedule against JAX's flash ring, the same
    function in another block order)."""
    got = _port_run(kind, 2, True, *_inputs())
    for name, a, b in zip(("out", "dq", "dk", "dv"), got,
                          jax_sp2_causal[ref]):
        np.testing.assert_allclose(a, b, **TOL, err_msg=name)


@pytest.fixture(scope="module")
def jax_dense():
    """JAX's dense attention, output and gradients, causal and not."""
    q, k, v, do = _inputs()
    out = {}
    for causal in (False, True):
        o, vjp = jax.vjp(lambda q, k, v: jra.attention(q, k, v,
                                                       causal=causal),
                         *(jnp.asarray(x) for x in (q, k, v)))
        out[causal] = [np.asarray(o)] + [np.asarray(g) for g in
                                         vjp(jnp.asarray(do))]
    return out


CASES = [(S, causal, kind)
         for S in (2, 4, 8) for causal in (False, True)
         for kind in ("plain", "flash", "zigzag", "ulysses")
         if not (kind == "zigzag" and not causal)
         and not (kind == "ulysses" and 4 % S)]


@pytest.mark.parametrize("S,causal,kind", CASES)
def test_forward_and_grads_match_dense(jax_dense, S, causal, kind):
    """Every schedule at sp = 2, 4 and 8, causal and not: output and dQ,
    dK, dV against single-device attention (the JAX package's dense
    ``attention`` and the port's, under autograd)."""
    q, k, v, do = _inputs()
    got = _port_run(kind, S, causal, q, k, v, do)
    tq, tk, tv = _t(q, k, v, grad=True)
    dense = attention(tq, tk, tv, causal=causal)
    mine = [dense.detach().numpy()] + [g.numpy() for g in torch.autograd.grad(
        dense, (tq, tk, tv), torch.tensor(do))]
    for name, a, b, c in zip(("out", "dq", "dk", "dv"), got,
                             jax_dense[causal], mine):
        np.testing.assert_allclose(a, b, **TOL, err_msg=name)
        np.testing.assert_allclose(a, c, **TOL, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_dense(causal):
    q, k, v = _t(*_qkv())
    ring = ring_attention(q, k, v, _mesh({"sp": 8}), causal=causal)
    np.testing.assert_allclose(ring.numpy(), attention(
        q, k, v, causal=causal).numpy(), **TOL)


def test_ring_gradient_matches_dense():
    q, k, v = _t(*_qkv(T=16), grad=True)
    mesh = _mesh({"sp": 4})
    gd = torch.autograd.grad((attention(q, k, v, causal=True) ** 2).sum(),
                             (q, k, v))
    gr = torch.autograd.grad((ring_attention(q, k, v, mesh, causal=True)
                              ** 2).sum(), (q, k, v))
    for a, b in zip(gd, gr):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=5e-4,
                                   rtol=5e-4)


def test_ring_with_dp_mesh():
    """dp x sp mesh: the ring runs over 'sp' in each dp group."""
    q, k, v = _t(*_qkv(B=4, T=16))
    mesh = _mesh({"dp": 2, "sp": 4})
    np.testing.assert_allclose(
        ring_attention(q, k, v, mesh).numpy(),
        attention(q, k, v).numpy(), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_dense(causal):
    rng = np.random.RandomState(0)
    q, k, v = _t(*(rng.randn(2, 8, 16, 4).astype(np.float32)
                   for _ in range(3)))
    got = ulysses_attention(q, k, v, _mesh({"sp": 8}), causal=causal)
    np.testing.assert_allclose(got.numpy(), attention(
        q, k, v, causal=causal).numpy(), **TOL)


def test_ulysses_rejects_indivisible_heads():
    q = torch.tensor(np.random.RandomState(1).randn(1, 3, 16, 4)
                     .astype(np.float32))  # 3 heads, sp=8
    with pytest.raises(ValueError, match="head count"):
        ulysses_attention(q, q, q, _mesh({"sp": 8}))
    with pytest.raises(ValueError, match="sequence length"):
        ulysses_attention(q[:, :, :12].repeat(1, 8, 1, 1)[:, :8],
                          q[:, :, :12].repeat(1, 8, 1, 1)[:, :8],
                          q[:, :, :12].repeat(1, 8, 1, 1)[:, :8],
                          _mesh({"sp": 8}))


def test_zigzag_contract_errors():
    mesh = _mesh({"sp": 2})
    q, k, v = _t(*_qkv(B=1, H=2, T=512, D=32))
    with pytest.raises(ValueError, match="zigzag"):
        ring_attention(q, k, v, mesh, causal=False, use_flash=True,
                       schedule="zigzag")
    with pytest.raises(ValueError, match="zigzag"):
        ring_attention(q, k, v, mesh, causal=True, use_flash=False,
                       schedule="zigzag")
    bad = _t(*_qkv(B=1, H=2, T=258, D=32))  # 258 % (2*2) != 0
    with pytest.raises(ValueError, match="divisible"):
        ring_attention(*bad, mesh, causal=True, use_flash=True,
                       schedule="zigzag")


def test_zigzag_pre_permuted_path():
    """Permute once with zigzag_permutation, run pre_permuted, invert."""
    mesh = _mesh({"sp": 2})
    q, k, v = _qkv(B=1, H=2, T=64, D=32)
    perm, inv = zigzag_permutation(64, 2)
    zq, zk, zv = _t(*(np.take(a, perm, axis=2) for a in (q, k, v)))
    out = ring_attention(zq, zk, zv, mesh, causal=True, use_flash=True,
                         schedule="zigzag", pre_permuted=True)
    out = np.take(out.numpy(), inv, axis=2)
    np.testing.assert_allclose(out, attention(*_t(q, k, v),
                                              causal=True).numpy(),
                               atol=2e-5, rtol=2e-5)


def test_zigzag_permutation_roundtrip():
    perm, inv = zigzag_permutation(16, 2)
    x = np.arange(16)
    assert (x[perm][inv] == x).all()
    assert list(perm[:8]) == [0, 1, 2, 3, 12, 13, 14, 15]
    assert list(perm[8:]) == [4, 5, 6, 7, 8, 9, 10, 11]
    jp, ji = jra.zigzag_permutation(16, 2)
    assert (jp == perm).all() and (ji == inv).all()


def test_schedules_count_their_hops_and_blocks():
    """The ring's collectives as the schedule gives them: S-1 K/V hops
    forward (two tensors each) for the flash ring, plus S dK/dV hops in
    its backward; Ulysses is two all_to_all pairs (q, k, v in; out back);
    every block of the zigzag schedule is one flash call."""
    S = 4
    mesh = _mesh({"sp": S})
    q, k, v = _t(*_qkv(), grad=True)
    with col.record() as log:
        out = ring_attention(q, k, v, mesh, causal=True, use_flash=True,
                             is_train=True)
    assert [e[0] for e in log] == ["collective-permute"] * 2 * (S - 1)
    with col.record() as log:
        torch.autograd.grad(out.sum(), (q, k, v))
    assert [e[0] for e in log].count("collective-permute") \
        == 2 * (S - 1) + 2 * S
    with col.record() as log:
        ulysses_attention(q, k, v, mesh)
    assert [e[0] for e in log] == ["all-to-all"] * 4
    calls = []
    orig = tra.fa.flash_attention_fwd

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    tra.fa.flash_attention_fwd = counting
    try:
        ring_attention(q.detach(), k.detach(), v.detach(), mesh,
                       causal=True, use_flash=True, schedule="zigzag")
    finally:
        tra.fa.flash_attention_fwd = orig
    assert len(calls) == (2 * S + 1) * S  # 2S+1 blocks a position


def _block(sp_mode, num_heads, sp_schedule="plain"):
    T, D = 16, 32
    x = tfluid.layers.data(name="x", shape=[T, D], dtype="float32")
    y = tfluid.layers.data(name="y", shape=[1], dtype="int64")
    attn = tfluid.layers.multi_head_attention(
        x, x, x, num_heads=num_heads, causal=True, sp_mode=sp_mode,
        sp_schedule=sp_schedule)
    res = tfluid.layers.elementwise_add(x, attn)
    ln = tfluid.layers.layer_norm(res, begin_norm_axis=2)
    ff = tfluid.layers.fc(input=ln, size=D, num_flatten_dims=2,
                          act="relu")
    pooled = tfluid.layers.reshape(ff, [-1, T * D])
    logits = tfluid.layers.fc(input=pooled, size=2)
    loss = tfluid.layers.mean(
        tfluid.layers.softmax_with_cross_entropy(logits, y))
    tfluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return loss


@pytest.mark.parametrize("sp_mode,heads,sched", [
    ("ring", 4, "plain"), ("ring", 4, "zigzag"), ("alltoall", 8, "plain")])
def test_transformer_block_trains_sp_sharded(sp_mode, heads, sched):
    """multi_head_attention through the program IR on a dp x sp mesh of
    CPU positions: the attention op takes the ring (or Ulysses); ten
    Adam steps lower the loss, and the first step's loss equals the
    single-device Executor's within 1e-5."""
    tfluid.reset()
    loss = _block(sp_mode, heads, sched)
    main = tfluid.default_main_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    start = {n: tfluid.global_scope().find_np(n)
             for n, v in main.global_block().vars.items() if v.persistable}
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 2, (16, 1)).astype(np.int64)
    xs = rng.rand(16, 16, 32).astype(np.float32) + labels[:, :, None] * 0.3
    feed = {"x": xs, "y": labels}
    want = float(exe.run(main, feed=feed, fetch_list=[loss])[0][0])
    tfluid.load_persistables(main, start)
    pe = ParallelExecutor(mesh=_mesh({"dp": 2, "sp": 4}))
    with col.record() as log:
        losses = [float(np.asarray(pe.run(main, feed=feed,
                                          fetch_list=[loss])[0])[0])]
    kinds = {e[0] for e in log}
    assert ("all-to-all" if sp_mode == "alltoall"
            else "collective-permute") in kinds
    np.testing.assert_allclose(losses[0], want, rtol=1e-5)
    for _ in range(9):
        losses.append(float(np.asarray(
            pe.run(main, feed=feed, fetch_list=[loss])[0])[0]))
    assert losses[-1] < losses[0], losses
