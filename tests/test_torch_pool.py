"""The port's ``pool2d`` against the JAX emitter on the CPU, forward and
``generic_grad``, over every attribute set of the sweep: max and average,
ksize 2 and 3, stride 1 and 2, padding 0 to 2, exclusive or not, global
or not, NCHW and NHWC.  Padding 2 is more than half of either window,
which ``jax.lax.reduce_window`` takes and torch's pooling refuses; a
window wholly in the padding gives -inf (max) or 0/0 (exclusive average)
in both.  f32, X [2, 3, 7, 6] from a numpy seed; 1e-5 covers summation
order in windows of at most 9 elements."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.ops import registry as treg


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    yield


_SWEEP = list(itertools.product(("max", "avg"), (2, 3), (1, 2), (0, 1, 2),
                                (True, False), (False, True),
                                ("NCHW", "NHWC")))


def _id(case):
    ptype, k, s, p, excl, glob, fmt = case
    return (f"{ptype}-k{k}-s{s}-p{p}-{'excl' if excl else 'incl'}"
            f"{'-global' if glob else ''}-{fmt}")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


@pytest.mark.parametrize("case", _SWEEP, ids=[_id(c) for c in _SWEEP])
def test_pool2d_matches_jax(case):
    ptype, k, s, p, excl, glob, fmt = case
    rng = np.random.RandomState(0)
    shape = (2, 3, 7, 6) if fmt == "NCHW" else (2, 7, 6, 3)
    x = rng.randn(*shape).astype(np.float32)
    attrs = {"pooling_type": ptype, "ksize": [k, k], "strides": [s, s],
             "paddings": [p, p], "exclusive": excl, "global_pooling": glob,
             "data_format": fmt}
    jctx = jreg.EmitContext(jax.random.PRNGKey(0), is_test=False)
    tctx = treg.EmitContext(torch.device("cpu"), is_test=False)
    jout = jreg.get_op_info("pool2d").emit(jctx, {"X": [jnp.asarray(x)]},
                                           attrs)["Out"][0]
    tout = treg.get_op_info("pool2d").emit(
        tctx, {"X": [torch.from_numpy(x)]}, attrs)["Out"][0]
    np.testing.assert_allclose(_np(tout), _np(jout), rtol=1e-5, atol=1e-5)
    # the gradient through each package's generic_grad
    ct = rng.randn(*_np(jout).shape).astype(np.float32)
    gattrs = {"__fwd_type__": "pool2d", "__fwd_attrs__": dict(attrs),
              "__fwd_input_slots__": ["X"], "__fwd_output_slots__": ["Out"],
              "__uid__": 0, "__wanted__": {("X", 0)}}
    jg = jreg.get_op_info("generic_grad").emit(
        jctx, {"X": [jnp.asarray(x)], "Out": [jout],
               "Out@GRAD": [jnp.asarray(ct)]}, gattrs)["X@GRAD"][0]
    tg = treg.get_op_info("generic_grad").emit(
        tctx, {"X": [torch.from_numpy(x)], "Out": [tout],
               "Out@GRAD": [torch.from_numpy(ct)]}, gattrs)["X@GRAD"][0]
    assert np.isfinite(_np(jg)).all()
    np.testing.assert_allclose(_np(tg), _np(jg), rtol=1e-5, atol=1e-5)
