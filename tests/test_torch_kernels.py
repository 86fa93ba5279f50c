"""The port's kernel modules (paddle_tpu_torch/ops/cuda_kernels/) against
the JAX package's Pallas kernels and oracles.

On the CPU each wrapper takes its plain PyTorch version, which is what
these tests hold against the JAX kernels (run in interpret mode, as the
JAX package's own tests run them) and the JAX dense oracles.  The CUDA
kernels themselves run only on a card: their tests compare each kernel
with its plain version there and skip without one.  Inputs come from
numpy with a fixed seed and cross between the frameworks as numpy."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.ops import attention_ops as t_attn
from paddle_tpu_torch.ops.cuda_kernels import flash_attention as t_fa
from paddle_tpu_torch.ops.cuda_kernels import paged_attention as t_pa
from paddle_tpu_torch.serving import pages_needed


@pytest.fixture(autouse=True)
def _fresh_port():
    paddle_tpu_torch.reset()
    yield


@pytest.fixture
def jx():
    """The JAX side of the comparisons, imported at test time: the on-card
    tests at the bottom of this file also run where JAX is not installed
    (``pytest --noconftest tests/test_torch_kernels.py -k on_card``)."""
    import jax.numpy as jnp

    from paddle_tpu.ops import attention_ops
    from paddle_tpu.ops.pallas_kernels import flash_attention
    from paddle_tpu.ops.pallas_kernels import paged_attention
    from paddle_tpu.parallel.ring_attention import attention

    return SimpleNamespace(jnp=jnp, attn=attention_ops, fa=flash_attention,
                           pa=paged_attention, dense=attention)


@pytest.fixture
def cuda_device():
    """The card, decided at test time; tests that need it skip here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _qkv(T, B=2, H=2, D=16, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, T, D).astype(np.float32) for _ in range(3)]


# f32 on the CPU, two frameworks' reduction orders: 2e-5 covers the
# accumulation-order differences of a D=16, T<=37 softmax
@pytest.mark.parametrize("T", [16, 37])
def test_flash_ref_matches_jax_flash_and_dense(jx, T):
    jnp = jx.jnp
    q, k, v = _qkv(T)
    got = t_fa.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal=True).numpy()
    kern = np.asarray(jx.fa.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=True, interpret=True))
    dense = np.asarray(jx.dense(*(jnp.asarray(a) for a in (q, k, v)),
                               causal=True))
    np.testing.assert_allclose(got, kern, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, dense, atol=2e-5, rtol=2e-5)


def test_flash_wrapper_takes_plain_version_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(37))
    before = t_fa.flash_attention.launches
    out = t_fa.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(out, t_fa.flash_attention_ref(q, k, v))
    assert t_fa.flash_attention.launches == before


def _paged_fixture(seed=0, N=4, nh=2, dh=16, P=9, ps=8):
    """The ragged fixture of tests/test_serving.py: full pages, a partial
    page, a single token, null-page tails."""
    rng = np.random.RandomState(seed)
    q = rng.randn(N, nh, dh).astype(np.float32)
    kp = rng.randn(P, nh, ps, dh).astype(np.float32)
    vp = rng.randn(P, nh, ps, dh).astype(np.float32)
    pt = np.array([[1, 2, 3], [4, 0, 0], [5, 6, 0], [7, 8, 2]], np.int32)
    cl = np.array([20, 3, 16, 1], np.int32)
    return q, kp, vp, pt, cl, ps


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_paged_ref_matches_jax_ref_and_kernel(jx):
    q, kp, vp, pt, cl, _ = _paged_fixture()
    got = t_pa.paged_attention_ref(*_t(q, kp, vp, pt, cl)).numpy()
    j_in = [jx.jnp.asarray(a) for a in (q, kp, vp, pt, cl)]
    ref = np.asarray(jx.pa.paged_attention_ref(*j_in))
    kern = np.asarray(jx.pa.paged_attention(*j_in, interpret=True))
    np.testing.assert_allclose(got, ref, atol=2e-5)
    np.testing.assert_allclose(got, kern, atol=2e-5)
    # the wrapper, on CPU tensors, is the plain version
    before = t_pa.paged_attention.launches
    np.testing.assert_allclose(
        t_pa.paged_attention(*_t(q, kp, vp, pt, cl)).numpy(), got)
    assert t_pa.paged_attention.launches == before


def _poison_unseen(kp, vp, pt, cl, ps):
    """Copies of the pools with every slot no row can see set to 1e9."""
    kn, vn = kp.copy(), vp.copy()
    referenced = set()
    for n in range(pt.shape[0]):
        L = int(cl[n])
        for j, p in enumerate(pt[n][: pages_needed(L, ps)]):
            referenced.add((int(p), min(ps, L - j * ps)))
    for p in range(kn.shape[0]):
        valid = max((v for q_, v in referenced if q_ == p), default=0)
        kn[p, :, valid:, :] = 1e9
        vn[p, :, valid:, :] = 1e9
    return kn, vn


def test_paged_ref_ignores_pool_garbage():
    """Positions past ctx_len and pages outside the page table must not
    influence the output (what makes pad-tail writes and stale pages
    safe)."""
    q, kp, vp, pt, cl, ps = _paged_fixture()
    base = t_pa.paged_attention_ref(*_t(q, kp, vp, pt, cl)).numpy()
    kn, vn = _poison_unseen(kp, vp, pt, cl, ps)
    out = t_pa.paged_attention_ref(*_t(q, kn, vn, pt, cl)).numpy()
    np.testing.assert_allclose(out, base, atol=1e-5)


def test_pool_scatter_matches_jax(jx):
    """The explicit in-place scatter equals the JAX op's mixed advanced
    indexing pool.at[layer, pages, :, offsets, :].set(values)."""
    rng = np.random.RandomState(3)
    L, P, nh, ps, dh = 2, 6, 2, 4, 8
    pool = rng.randn(L, P, nh, ps, dh).astype(np.float32)
    pages = np.array([1, 1, 3, 5, 2], np.int64)
    offs = np.array([0, 3, 2, 1, 0], np.int64)
    vals = rng.randn(len(pages), nh, dh).astype(np.float32)
    jnp = jx.jnp
    want = np.asarray(jx.attn._paged_pools_write(
        jnp.asarray(pool), 1, jnp.asarray(pages), jnp.asarray(offs),
        jnp.asarray(vals)))
    tpool = torch.from_numpy(pool.copy())
    out = t_attn._paged_pools_write(tpool, 1, *_t(pages, offs, vals))
    assert out is tpool  # written in place
    np.testing.assert_array_equal(tpool.numpy(), want)


# -- on the card: each kernel against its plain version -------------------

# f32: FMA vs cuBLAS order, 1e-4; bf16: P rounded at other points, 2e-2
_CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,D,causal", [(40, 64, True), (128, 64, True),
                                        (200, 40, True), (77, 128, True),
                                        (100, 64, False)])
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype, T, D, causal):
    """The serving shapes (D 64), a head dim padded inside the kernel
    (40), the widest head (128, two output column groups) and the
    non-causal form."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _qkv(T, B=2, H=4, D=D))
    out = t_fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref = t_fa.flash_attention_ref(q, k, v, causal=causal)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= _CARD_TOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_matches_plain_on_card(cuda_device, dtype):
    q, kp, vp, pt, cl, ps = _paged_fixture(dh=64, ps=16, P=9)
    pt_ = np.array([[1, 2, 3], [4, 0, 0], [5, 6, 0], [7, 8, 2]], np.int32)
    cl_ = np.array([40, 3, 16, 1], np.int32)
    kn, vn = _poison_unseen(kp, vp, pt_, cl_, ps)
    args = [a.to(cuda_device) for a in _t(q, kn, vn, pt_, cl_)]
    args[:3] = [a.to(dtype) for a in args[:3]]
    out = t_pa.paged_attention(*args)
    torch.cuda.synchronize()
    ref = t_pa.paged_attention_ref(*args)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= _CARD_TOL[dtype], err
