"""The port's Executor and its metric ops against the JAX package on the CPU.

- Written state: a block that reads a non-persistable variable from the
  scope and then rewrites it advances the scope in both packages, run
  after run, fetched or not (the JAX executor returns every name of
  ``analysis/dataflow.state_classes``' written state from its step).
- ``top_k`` on ties: equal values keep the lowest indices, as
  ``jax.lax.top_k`` does, and ``accuracy`` reads those indices; both
  through each package's Executor.

Inputs come from numpy and cross between the packages as numpy; integer
results are compared exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.framework import executor as texecutor


@pytest.fixture(autouse=True)
def _fresh():
    tfluid.reset()
    jfluid.reset()
    yield


def _counter_program(fluid):
    """counter (f32 [1], not persistable, read from the scope) += 1, then
    y = counter."""
    block = fluid.default_main_program().global_block()
    for name in ("counter", "one", "y"):
        block.create_var(name=name, shape=(1,), dtype="float32")
    block.append_op("fill_constant", outputs={"Out": ["one"]},
                    attrs={"shape": [1], "value": 1.0, "dtype": "float32"})
    block.append_op("elementwise_add",
                    inputs={"X": ["counter"], "Y": ["one"]},
                    outputs={"Out": ["counter"]}, attrs={"axis": -1})
    block.append_op("assign", inputs={"X": ["counter"]},
                    outputs={"Out": ["y"]})
    fluid.global_scope().set("counter", np.array([5.0], np.float32))
    return fluid.default_main_program()


@pytest.mark.parametrize("fetch", [True, False])
def test_executor_writes_back_state_read_before_written(fetch):
    """Two runs: y is 6 then 7 and the scope holds 6 then 7 in both
    packages; without a fetch the scope still advances."""
    runs = {}
    for tag, fluid, place in (("jax", jfluid, jfluid.CPUPlace()),
                              ("torch", tfluid, tfluid.CPUPlace())):
        prog = _counter_program(fluid)
        assert not prog.global_block().var("counter").persistable
        exe = fluid.Executor(place)
        got = []
        for _ in range(2):
            out = exe.run(prog, fetch_list=["y"] if fetch else [])
            got.append((np.asarray(out[0]).copy() if fetch else None,
                        np.asarray(fluid.global_scope().find_np("counter"))
                        .copy()))
        runs[tag] = got
    for (jy, jc), (ty, tc), want in zip(runs["jax"], runs["torch"],
                                        (6.0, 7.0)):
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tc, np.array([want], np.float32))
        if fetch:
            np.testing.assert_array_equal(ty, jy)
            np.testing.assert_array_equal(ty, np.array([want], np.float32))


def test_writers_of_written_state_are_live():
    """The add that rewrites `counter` is live with no fetch at all; the
    assign to y, which nothing reads, is not."""
    block = _counter_program(tfluid).global_block()
    assert texecutor.written(block) == ["counter"]
    assert texecutor.live_ops(block, []) == [True, True, False]
    assert texecutor.live_ops(block, ["y"]) == [True, True, True]


def _tie_cases():
    rng = np.random.RandomState(0)
    return {
        "zeros_1x10_k3": (np.zeros((1, 10), np.float32), 3,
                          np.zeros((1, 1), np.int64)),
        # integer values in [0, 4): every row holds many ties
        "ints_16x40_k5": (rng.randint(0, 4, (16, 40)).astype(np.float32), 5,
                          rng.randint(0, 40, (16, 1)).astype(np.int64)),
        "ints_8x1000_k1": (rng.randint(0, 3, (8, 1000)).astype(np.float32), 1,
                           np.zeros((8, 1), np.int64)),
    }


_TIES = _tie_cases()


def _topk_program(fluid, shape, k):
    x = fluid.layers.data("x", shape=list(shape[1:]), dtype="float32")
    label = fluid.layers.data("label", shape=[1], dtype="int64")
    values, indices = fluid.layers.topk(x, k)
    acc = fluid.layers.accuracy(x, label, k=k)
    return values, indices, acc


@pytest.mark.parametrize("case", sorted(_TIES))
def test_top_k_keeps_lowest_indices_on_ties(case):
    """Values and indices of top_k, and accuracy, through both Executors:
    the indices equal jax.lax.top_k's exactly."""
    x, k, label = _TIES[case]
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(x), k)
    got = {}
    for tag, fluid in (("jax", jfluid), ("torch", tfluid)):
        fetches = _topk_program(fluid, x.shape, k)
        exe = fluid.Executor(fluid.CPUPlace())
        got[tag] = [np.asarray(a) for a in exe.run(
            feed={"x": x, "label": label}, fetch_list=list(fetches))]
    for tag in got:
        vals, idx, acc = got[tag]
        np.testing.assert_array_equal(idx, np.asarray(want_idx), err_msg=tag)
        np.testing.assert_array_equal(vals, np.asarray(want_vals),
                                      err_msg=tag)
    np.testing.assert_array_equal(got["torch"][2], got["jax"][2])
    if case == "zeros_1x10_k3":
        # label 0 is among the lowest indices of an all-equal row
        np.testing.assert_array_equal(got["torch"][1], [[0, 1, 2]])
        np.testing.assert_array_equal(got["torch"][2], [1.0])
