"""``calc_gradient`` (vector-Jacobian products of arbitrary targets to
arbitrary inputs through the surrogate sum) and ``append_backward``'s
``extra_sources``, and the ``reduce_sum`` op it builds: the port against
the JAX package on the CPU, from the
JAX startup's state.  Programs compare by ``to_json``; gradients in f32
within 1e-5 of their max |value| (one backward, two frameworks'
reduction orders)."""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.framework.backward import calc_gradient as jcalc
from paddle_tpu_torch.framework.backward import calc_gradient as tcalc

FEED = {"x": np.random.RandomState(0).randn(3, 4).astype(np.float32),
        "seed": np.random.RandomState(1).randn(3, 2).astype(np.float32),
        "seed2": np.random.RandomState(2).randn(3, 5).astype(np.float32)}


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    jfluid.reset()
    yield


def _net(fl):
    x = fl.layers.data("x", shape=[4])
    h = fl.layers.fc(x, 5, act="tanh")
    y = fl.layers.fc(h, 2)
    return x, h, y


def _params(fl):
    return fl.default_main_program().global_block().all_parameters()


def _run_both(jfetch, tfetch):
    """Run the JAX program from its startup, the port's from the JAX
    startup's state; fetch by name."""
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    jmain = jfluid.default_main_program()
    state = {n: np.asarray(jfluid.global_scope().find_np(n))
             for n, v in jmain.global_block().vars.items() if v.persistable}
    tmain = tfluid.default_main_program()
    tfluid.load_persistables(tmain, state)
    jo = jexe.run(jmain, feed=FEED, fetch_list=jfetch)
    to = tfluid.Executor(tfluid.CPUPlace()).run(tmain, feed=FEED,
                                                fetch_list=tfetch)
    return [np.asarray(a) for a in jo], to


def _hold(jo, to, names):
    for name, j, t in zip(names, jo, to):
        assert t.shape == j.shape, name
        np.testing.assert_allclose(t, j, rtol=0,
                                   atol=1e-5 * float(np.abs(j).max()),
                                   err_msg=name)


@pytest.mark.parametrize("seeded", [False, True])
def test_calc_gradient_matches_jax(seeded):
    """d y / d [x, w1, h] with ones as the seed, and with a fed one."""
    grads = []
    for fl, calc in ((jfluid, jcalc), (tfluid, tcalc)):
        x, h, y = _net(fl)
        seed = fl.layers.data("seed", shape=[2]) if seeded else None
        w1 = _params(fl)[0]
        grads.append(calc(y, [x, w1, h], target_gradients=seed))
    assert tfluid.default_main_program().to_json() == \
        jfluid.default_main_program().to_json()
    assert all(g is not None for g in grads[1])
    jo, to = _run_both(grads[0], [g.name for g in grads[1]])
    _hold(jo, to, [g.name for g in grads[1]])
    # the x gradient is J^T s: with seed s, d<y, s>/dx
    assert float(np.abs(to[0]).max()) > 0


def test_calc_gradient_of_two_targets_sums_their_products():
    grads = []
    for fl, calc in ((jfluid, jcalc), (tfluid, tcalc)):
        x, h, y = _net(fl)
        seeds = [fl.layers.data("seed", shape=[2]),
                 fl.layers.data("seed2", shape=[5])]
        grads.append(calc([y, h], x, target_gradients=seeds))
    ops = [op.type for op in tfluid.default_main_program()
           .global_block().ops]
    assert ops.count("elementwise_mul") == 2 and "sum" in ops
    assert ops.count("reduce_sum") == 2
    assert tfluid.default_main_program().to_json() == \
        jfluid.default_main_program().to_json()
    jo, to = _run_both(grads[0], [g.name for g in grads[1]])
    _hold(jo, to, ["x@GRAD"])


def test_unreached_input_gives_none():
    got = []
    for fl, calc in ((jfluid, jcalc), (tfluid, tcalc)):
        x, h, y = _net(fl)
        other = fl.layers.fc(x, 3)
        got.append(calc(h, [other, x]))
    assert got[0][0] is None and got[1][0] is None
    assert got[0][1] is not None and got[1][1] is not None


def test_stop_gradient_is_restored_and_minimize_takes_no_extra_source():
    x, h, y = _net(tfluid)
    assert x.stop_gradient and not h.stop_gradient
    tcalc(y, [x, h])
    assert x.stop_gradient and not h.stop_gradient
    n_before = len(tfluid.default_main_program().global_block().ops)
    loss = tfluid.layers.mean(y)
    tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    new = tfluid.default_main_program().global_block().ops[n_before:]
    # the second backward takes no gradient to the feed
    assert not any(n.startswith("x@GRAD") for op in new
                   for n in op.output_names())


def test_intermediate_input_matches_jax():
    """An input that is neither a Parameter nor a feed: y = h·h, h = x·x,
    d y / d h = 2h."""
    grads = []
    for fl, calc in ((jfluid, jcalc), (tfluid, tcalc)):
        x = fl.layers.data("x", shape=[4])
        h = fl.layers.elementwise_mul(x, x)
        y = fl.layers.elementwise_mul(h, h)
        grads.append(calc(y, h))
    jo, to = _run_both(grads[0], [g.name for g in grads[1]])
    np.testing.assert_allclose(to[0], 2.0 * FEED["x"] ** 2, rtol=1e-6)
    np.testing.assert_array_equal(to[0], jo[0])


def test_mismatched_target_gradients_raise_as_jax():
    for fl, calc in ((jfluid, jcalc), (tfluid, tcalc)):
        x, h, y = _net(fl)
        with pytest.raises(ValueError, match="same number of "
                                             "target_gradients"):
            calc([y, h], x, target_gradients=[y])


# -- reduce_sum, which the surrogate sum reaches ----------------------------------

@pytest.mark.parametrize("attrs", [{"dim": None}, {"dim": 1},
                                   {"dim": [0, 2], "keep_dim": True},
                                   {"dim": -1, "reduce_all": True},
                                   {"dim": []}])
def test_reduce_sum_and_grad_match_jax(attrs):
    """Forward and ``generic_grad`` against the JAX emitters in f32, 1e-5
    (a full reduction is rank-1 [1], as reduce_op.cc makes it)."""
    op_type = "reduce_sum"
    import jax
    import jax.numpy as jnp
    import torch

    from paddle_tpu.ops import registry as jreg
    from paddle_tpu_torch.ops import registry as treg

    rng = np.random.RandomState(3)
    x = (rng.rand(2, 3, 4).astype(np.float32) + 0.5)
    jctx = jreg.EmitContext(jax.random.PRNGKey(0), is_test=False)
    tctx = treg.EmitContext(torch.device("cpu"), is_test=False)
    jo = jreg.get_op_info(op_type).emit(jctx, {"X": [jnp.asarray(x)]},
                                        attrs)["Out"][0]
    to = treg.get_op_info(op_type).emit(tctx, {"X": [torch.from_numpy(x)]},
                                        attrs)["Out"][0]
    assert tuple(to.shape) == tuple(jo.shape)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5)
    ct = rng.randn(*jo.shape).astype(np.float32)
    gattrs = {"__fwd_type__": op_type, "__fwd_attrs__": attrs,
              "__fwd_input_slots__": ["X"], "__fwd_output_slots__": ["Out"],
              "__uid__": 0, "__wanted__": {("X", 0)}}
    jg = jreg.get_op_info("generic_grad").emit(
        jctx, {"X": [jnp.asarray(x)], "Out": [jo],
               "Out@GRAD": [jnp.asarray(ct)]}, gattrs)["X@GRAD"][0]
    tg = treg.get_op_info("generic_grad").emit(
        tctx, {"X": [torch.from_numpy(x)], "Out": [to],
               "Out@GRAD": [torch.from_numpy(ct)]}, gattrs)["X@GRAD"][0]
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)
