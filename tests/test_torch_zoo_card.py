"""One step of the model zoo on the card against an explicit-CPU executor:
fused VGG-19 (K13 and K15) in f32 at a small shape, the U-Net and
DeepFM.  A CUDA executor has no CPU mode: every test here skips without
a CUDA device (decided in a fixture).  The file imports nothing of JAX;
on the chip machine run ``python -m pytest --noconftest
tests/test_torch_zoo_card.py``."""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.models import zoo_bench as zb
from paddle_tpu_torch.ops.cuda_kernels import bn_conv


@pytest.fixture(autouse=True)
def _fresh():
    fluid.reset()
    yield


@pytest.fixture
def cuda_device():
    """The card, decided at test time, with f32 products in full f32;
    tests that need it skip here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the executor's place is the card")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32


def _one_step(build, feed, grads):
    """One step on the card and one on the CPU from the card's startup
    state: (card loss, CPU loss, card grads, CPU grads)."""
    loss = build()
    main = fluid.default_main_program()
    card = fluid.Executor(fluid.CUDAPlace(0))
    card.run(fluid.default_startup_program())
    state = {n: fluid.global_scope().find_np(n)
             for n, v in main.global_block().vars.items() if v.persistable}
    got = card.run(main, feed=feed, fetch_list=[loss] + grads)
    scope = fluid.Scope()
    fluid.load_persistables(main, state, scope)
    want = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feed, fetch_list=[loss] + grads, scope=scope)
    return got, want


def _hold(got, want):
    assert abs(got[0][0] - want[0][0]) <= 1e-4 * abs(want[0][0])
    for g, w in zip(got[1:], want[1:]):
        assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max()


def test_fused_vgg19_step_runs_k13_and_k15(cuda_device):
    before = (bn_conv.bn_conv3x3_fwd.launches,
              bn_conv.bn_conv3x3_bwd.launches)

    def build():
        loss, _ = zb.cnn_train_program("vgg", image=32, class_dim=10,
                                       dtype="float32", fuse_bn=True,
                                       dropout_prob=0.0, fc_dim=16)
        return loss

    got, want = _one_step(build, zb.cnn_feed(2, 32, 10), ["fc_2.w_0@GRAD"])
    _hold(got, want)
    assert (bn_conv.bn_conv3x3_fwd.launches - before[0],
            bn_conv.bn_conv3x3_bwd.launches - before[1]) == (22, 11)


def test_unet_step_on_the_card(cuda_device):
    got, want = _one_step(
        lambda: zb.unet_train_program(image=16, base_ch=8,
                                      ch_mults=(1, 2))[0],
        zb.unet_feed(2, 16), ["in_conv.w_0@GRAD", "out_conv.w_0@GRAD"])
    _hold(got, want)


def test_deepfm_step_on_the_card(cuda_device):
    nf, vocab, emb, hidden, lr, rows = zb.DEEPFM_CTR
    got, want = _one_step(
        lambda: zb.deepfm_train_program(nf, vocab, emb, hidden, lr)[0],
        zb.deepfm_feed(rows, nf, vocab), ["deepfm.emb@GRAD"])
    _hold(got, want)
