"""Loading onto the card (``paddle_tpu_torch/io.py``): a loaded value lands
on the executor's device in the program's declared dtype, so the next run
computes there.  A CUDA executor has no CPU mode: every test here skips
without a CUDA device (decided in a fixture).  The file imports nothing of
JAX; on the chip machine run ``python -m pytest --noconftest
tests/test_torch_io_card.py``."""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import io


@pytest.fixture(autouse=True)
def _fresh():
    fluid.reset()
    yield


@pytest.fixture
def cuda_device():
    """The card, decided at test time; tests that need it skip here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the executor's place is the card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loaded_values_land_on_the_card_in_the_declared_dtype(cuda_device,
                                                              dtype,
                                                              tmp_path):
    x = fluid.layers.data("x", shape=[8], dtype=dtype)
    y = fluid.layers.fc(x, 4)
    cpu = fluid.Executor(fluid.CPUPlace())
    cpu.run(fluid.default_startup_program())
    feed = {"x": np.random.RandomState(0).rand(2, 8).astype(np.float32)}
    (want,) = cpu.run(feed=feed, fetch_list=[y])
    io.save_inference_model(str(tmp_path), ["x"], [y], cpu)
    card = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    prog, feeds, fetches = io.load_inference_model(str(tmp_path), card,
                                                   scope)
    for n in scope.local_names():
        t = scope.find(n)
        assert t.device == cuda_device, n
        assert t.dtype == getattr(torch, dtype), n
    (got,) = card.run(prog, feed=feed, fetch_list=fetches, scope=scope,
                      return_numpy=False)
    assert got.device == cuda_device
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy(), want, rtol=tol,
                               atol=tol)
