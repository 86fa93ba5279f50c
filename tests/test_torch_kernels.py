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
from paddle_tpu_torch.ops.cuda_kernels import bn_conv as t_bnc
from paddle_tpu_torch.ops.cuda_kernels import bn_matmul as t_bnmm
from paddle_tpu_torch.ops.cuda_kernels import flash_attention as t_fa
from paddle_tpu_torch.ops.cuda_kernels import gru as t_gru
from paddle_tpu_torch.ops.cuda_kernels import lstm as t_lstm
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


# -- training: K4 forward with lse, K5 dQ, K6 dK/dV ---------------------------

def _train_case(jx, T, causal, seed=0, B=2, H=2, D=16):
    """q, k, v, dO from numpy, and the JAX kernels' (out, lse) and
    (dq, dk, dv) in interpret mode."""
    jnp, jfa = jx.jnp, jx.fa
    q, k, v = _qkv(T, B=B, H=H, D=D, seed=seed)
    do = np.random.RandomState(seed + 1).randn(B, H, T, D).astype(np.float32)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jout, jlse = jfa.flash_attention_fwd(jq, jk, jv, causal=causal,
                                         interpret=True)
    jgrads = jfa.flash_attention_bwd(jq, jk, jv, jout, jlse, jdo,
                                     causal=causal, interpret=True)
    return ([torch.from_numpy(a) for a in (q, k, v, do)],
            [np.asarray(a) for a in (jout, jlse)],
            [np.asarray(a) for a in jgrads])


# f32 on the CPU, two frameworks' reduction orders: 2e-5 as above
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [16, 37])
def test_flash_fwd_ref_matches_jax_kernel(jx, T, causal):
    (q, k, v, _), (jout, jlse), _ = _train_case(jx, T, causal)
    out, lse = t_fa.flash_attention_fwd_ref(q, k, v, causal=causal)
    assert lse.shape == (q.shape[0] * q.shape[1], T)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), jout, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=2e-5, rtol=2e-5)
    # the serving plain version computes the same attention
    np.testing.assert_allclose(
        out.numpy(), t_fa.flash_attention_ref(q, k, v, causal).numpy(),
        atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [16, 37])
def test_flash_bwd_ref_matches_jax_kernel_and_autograd(jx, T, causal):
    """The FA-2 plain backward against the JAX dQ and dK/dV kernels and
    against torch.autograd through dense f32 attention."""
    (q, k, v, do), _, jgrads = _train_case(jx, T, causal)
    out, lse = t_fa.flash_attention_fwd_ref(q, k, v, causal=causal)
    got = t_fa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal)
    for g, j in zip(got, jgrads):
        np.testing.assert_allclose(g.numpy(), j, atol=2e-5, rtol=2e-5)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    dense = t_fa.flash_attention_ref(*leaves, causal=causal)
    auto = torch.autograd.grad(dense, leaves, do)
    for g, a in zip(got, auto):
        np.testing.assert_allclose(g.numpy(), a.numpy(), atol=2e-5,
                                   rtol=2e-5)


def _launch_counts():
    return [f.launches for f in (t_fa.flash_attention, t_fa.flash_attention_fwd,
                                 t_fa.flash_attention_dq,
                                 t_fa.flash_attention_dkv)]


def test_flash_train_function_takes_plain_versions_on_cpu():
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _qkv(37))
    do = torch.from_numpy(
        np.random.RandomState(5).randn(*q.shape).astype(np.float32))
    before = _launch_counts()
    out = t_fa.FlashAttentionTrain.apply(q, k, v, True, None)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert _launch_counts() == before
    ref_out, lse = t_fa.flash_attention_fwd_ref(q.detach(), k.detach(),
                                                v.detach())
    torch.testing.assert_close(out.detach(), ref_out)
    for g, r in zip(grads, t_fa.flash_attention_bwd_ref(
            q.detach(), k.detach(), v.detach(), ref_out, lse, do)):
        torch.testing.assert_close(g, r)


def _rel_to_max(got, ref):
    return ((got - ref).abs().max() / ref.abs().max()).item()


def test_split_p_dv_product_keeps_the_f32_rounding_point():
    """The bf16 K6 kernel forms dV = Pᵀ·dO on the tensor cores as two bf16
    products, hi = bf16(P) and lo = bf16(P − hi), into one f32 sum; the
    reference takes P and dO in f32.  Emulated here with f32 products:
    with dO exactly bf16 each product is exact, so the split agrees with
    the f32 Pᵀ·dO to about 2⁻¹⁶ of P, while bf16(P) alone is ~2⁻⁹ off."""
    T, D = 128, 64
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).float()
               for a in _qkv(T, B=1, H=1, D=D, seed=3))
    do = torch.from_numpy(np.random.RandomState(4).randn(1, 1, T, D)
                          .astype(np.float32)).to(torch.bfloat16).float()
    _, lse = t_fa.flash_attention_fwd_ref(q, k, v, causal=True)
    p, _ = t_fa._probs_and_ds(q, k, v, do, lse, torch.zeros_like(lse),
                              True, 1.0 / D ** 0.5)
    p, do = p[0, 0], do[0, 0]
    ref = p.t() @ do
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    split = hi.t() @ do + lo.t() @ do
    assert _rel_to_max(split, ref) <= 1e-5
    assert _rel_to_max(hi.t() @ do, ref) > 1e-4


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


def _mq_fixture(seed=0, C=5, nh=2, dh=16, P=10, ps=8):
    """Multi-query rows over a ragged paged context: a chunk from position
    0, a chunk that starts mid-page after a prefix hit and crosses a page
    boundary, an idle lane (ctx_lens 1, all-null table row) whose rows
    all sit past its context, and a verify-like chunk at the end of a
    long context — rows past a lane's valid chunk included."""
    rng = np.random.RandomState(seed)
    q = rng.randn(4, nh, C, dh).astype(np.float32)
    kp = rng.randn(P, nh, ps, dh).astype(np.float32)
    vp = rng.randn(P, nh, ps, dh).astype(np.float32)
    pt = np.array([[1, 2, 0, 0], [3, 4, 5, 0], [0, 0, 0, 0],
                   [6, 7, 8, 9]], np.int32)
    q0 = np.array([0, 11, 0, 27], np.int32)
    # chunk lengths 3 (rows 3.. past it), C, idle, 2
    cl = np.maximum(q0 + np.array([3, C, 0, 2], np.int32), 1)
    return q, kp, vp, pt, cl, q0, ps


@pytest.mark.parametrize("C", [1, 5])
def test_paged_mq_ref_matches_jax_ref_and_kernel(jx, C):
    """The plain multi-query version against the JAX oracle and the JAX
    Pallas kernel (interpret mode), on the ragged fixture with every
    unseen pool slot poisoned to 1e9."""
    q, kp, vp, pt, cl, q0, ps = _mq_fixture(C=C)
    kn, vn = _poison_unseen(kp, vp, pt, cl, ps)
    got = t_pa.paged_attention_mq_ref(*_t(q, kn, vn, pt, cl, q0)).numpy()
    assert np.isfinite(got).all()
    j_in = [jx.jnp.asarray(a) for a in (q, kn, vn, pt, cl, q0)]
    ref = np.asarray(jx.pa.paged_attention_mq_ref(*j_in))
    kern = np.asarray(jx.pa.paged_attention_mq(*j_in, interpret=True))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, kern, atol=1e-5, rtol=1e-5)
    # the poison is invisible: the clean pools give the same rows
    clean = t_pa.paged_attention_mq_ref(*_t(q, kp, vp, pt, cl, q0)).numpy()
    np.testing.assert_allclose(got, clean, atol=1e-5)


def test_paged_mq_single_row_is_the_decode_walk():
    """C = 1 with q_starts = ctx_lens - 1 is the decode kernel's
    contract: the two plain versions agree."""
    q, kp, vp, pt, cl, _ = _paged_fixture()
    q0 = cl - 1
    mq = t_pa.paged_attention_mq_ref(
        *_t(q[:, :, None, :], kp, vp, pt, cl, q0)).numpy()
    one = t_pa.paged_attention_ref(*_t(q, kp, vp, pt, cl)).numpy()
    np.testing.assert_allclose(mq[:, :, 0, :], one, atol=1e-6)


def test_paged_mq_wrapper_takes_plain_version_on_cpu():
    q, kp, vp, pt, cl, q0, _ = _mq_fixture()
    args = _t(q, kp, vp, pt, cl, q0)
    before = t_pa.paged_attention_mq.launches
    np.testing.assert_array_equal(
        t_pa.paged_attention_mq(*args).numpy(),
        t_pa.paged_attention_mq_ref(*args).numpy())
    assert t_pa.paged_attention_mq.launches == before


# -- on the card: each kernel against its plain version -------------------

# f32: FMA vs cuBLAS order, 1e-4; bf16: P rounded at other points, 2e-2
_CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,D,causal", [(40, 64, True), (128, 64, True),
                                        (200, 40, True), (77, 128, True),
                                        (100, 64, False), (300, 128, True),
                                        (90, 38, True), (150, 100, False)])
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype, T, D, causal):
    """The serving shapes (D 64), a head dim padded inside the kernel
    (40), the widest head (128) in one and in several K tiles, the
    non-causal form, and head dims that are no whole number of 16-byte
    chunks (38 in both dtypes, 100 in bf16), which the kernels stage
    element by element."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _qkv(T, B=2, H=4, D=D))
    out = t_fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref = t_fa.flash_attention_ref(q, k, v, causal=causal)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= _CARD_TOL[dtype], err


# K2 on the card: (maxp, ps, dh, ctx_lens).  The small fixture; the
# serving decode shape with ctx 1024 (maxp * ps) and contexts ending on,
# just before and just after a split boundary (128 keys: 8 pages of 16);
# one slot alone at ctx 1024; a context past maxp * ps; a padded head dim
# (40) at page 8 and one that is no whole number of 16-byte chunks (38)
_PAGED_CARD = {
    "fixture": None,
    "ctx1024": (64, 16, 64, [1, 17, 1024, 300, 64, 999, 5, 512]),
    "split_boundary": (64, 16, 64, [128, 127, 129, 256, 1, 1024, 136, 8]),
    "long_alone": (64, 16, 64, [1024]),
    "past_table": (20, 8, 40, [200, 1, 161, 159]),
    "odd_dh": (12, 16, 38, [100, 17, 192, 1]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(_PAGED_CARD))
def test_paged_kernel_matches_plain_on_card(cuda_device, dtype, case):
    if _PAGED_CARD[case] is None:
        q, kp, vp, pt, cl, ps = _paged_fixture(dh=64, ps=16, P=9)
        pt_ = np.array([[1, 2, 3], [4, 0, 0], [5, 6, 0], [7, 8, 2]],
                       np.int32)
        cl_ = np.array([40, 3, 16, 1], np.int32)
    else:
        maxp, ps, dh, ctx = _PAGED_CARD[case]
        rng = np.random.RandomState(len(ctx) + dh)
        N, nh = len(ctx), 4
        P = N * maxp + 1
        q = rng.randn(N, nh, dh).astype(np.float32)
        kp = rng.randn(P, nh, ps, dh).astype(np.float32)
        vp = rng.randn(P, nh, ps, dh).astype(np.float32)
        pt_ = np.zeros((N, maxp), np.int32)
        pages = iter(rng.permutation(np.arange(1, P)))
        for n, L in enumerate(ctx):
            for j in range(min(pages_needed(L, ps), maxp)):
                pt_[n, j] = next(pages)
        cl_ = np.array(ctx, np.int32)
    kn, vn = _poison_unseen(kp, vp, pt_, np.minimum(cl_, pt_.shape[1] * ps),
                            ps)
    args = [a.to(cuda_device) for a in _t(q, kn, vn, pt_, cl_)]
    args[:3] = [a.to(dtype) for a in args[:3]]
    out = t_pa.paged_attention(*args)
    torch.cuda.synchronize()
    ref = t_pa.paged_attention_ref(*args)
    assert torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= _CARD_TOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,dh,ps", [(5, 64, 16), (32, 64, 16), (1, 64, 16),
                                     (70, 40, 8), (9, 128, 16), (64, 64, 16),
                                     (48, 38, 16)])
@pytest.mark.parametrize("maxp", [12, 64])
def test_paged_mq_kernel_matches_plain_on_card(cuda_device, dtype, C, dh,
                                               ps, maxp):
    """The verify shape (C 5) and the chunk shape (C 32) at the serving
    head dim, the decode-like C 1, more rows than one row tile at a
    padded head dim (C 70, dh 40, page 8), the widest head (128), a block
    of 64 rows, 48 rows (three m-tiles, taken as four) at a head dim that
    is no whole number of 16-byte chunks (38), with a mid-page start, a
    chunk across a page boundary, an idle lane and a poisoned pool.  At
    maxp 64 (the serving table) two more lanes start just before the
    split boundary at 8 pages and near 1024, where ctx passes maxp * ps
    and is clamped."""
    rng = np.random.RandomState(C + dh + maxp)
    nh = 4
    q0 = [0, 11, 0, 3 * ps - 2, 5 * ps + 1]
    rows = [C, C, 0, min(C, 4), C]
    if maxp == 64:
        q0 += [8 * ps - 3, 64 * ps - 10]
        rows += [C, C]
    N = len(q0)
    P = N * maxp + 1
    q = rng.randn(N, nh, C, dh).astype(np.float32)
    kp = rng.randn(P, nh, ps, dh).astype(np.float32)
    vp = rng.randn(P, nh, ps, dh).astype(np.float32)
    q0 = np.array(q0, np.int32)
    cl = np.maximum(q0 + np.array(rows), 1).astype(np.int32)
    if maxp == 12:
        cl = np.minimum(cl, maxp * ps).astype(np.int32)
    pt = np.zeros((N, maxp), np.int32)
    pages = iter(rng.permutation(np.arange(1, P)))
    for n in range(N):
        if n == 2:
            continue  # the idle lane keeps an all-null row
        for j in range(min(pages_needed(int(cl[n]), ps), maxp)):
            pt[n, j] = next(pages)
    kn, vn = _poison_unseen(kp, vp, pt, np.minimum(cl, maxp * ps), ps)
    args = [a.to(cuda_device) for a in _t(q, kn, vn, pt, cl, q0)]
    args[:3] = [a.to(dtype) for a in args[:3]]
    out = t_pa.paged_attention_mq(*args)
    torch.cuda.synchronize()
    ref = t_pa.paged_attention_mq_ref(*args)
    assert torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= _CARD_TOL[dtype], err


# K4-K6 (B, H, T, D, causal): the bench head dim (64), a padded head dim
# (40) across a ragged edge, the widest head (128) and the non-causal form;
# the GPT training bench shape; a single short ragged row block; a long
# ragged non-causal T; D 128 across several tiles, also with a ragged T;
# and head dims that are no whole number of 16-byte chunks (36, 100 and,
# for f32 too, 38), which the tensor-core kernels stage element by element
_TRAIN_SHAPES = [(2, 4, 40, 64, True), (2, 4, 200, 40, True),
                 (2, 4, 77, 128, True), (2, 4, 100, 64, False),
                 (2, 4, 130, 64, False), (8, 8, 1024, 64, True),
                 (1, 1, 37, 40, True), (2, 4, 1000, 64, False),
                 (2, 4, 512, 128, True), (1, 2, 50, 36, True),
                 (2, 2, 70, 100, False), (1, 2, 300, 128, True),
                 (2, 2, 190, 100, True), (1, 2, 90, 38, True)]


def _rel_err(got, ref):
    """max |got - ref| over max |ref|: bf16 gradients are compared
    relative to each tensor's scale."""
    ref = ref.float()
    return ((got.float() - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,T,D,causal", _TRAIN_SHAPES)
def test_flash_fwd_kernel_matches_plain_on_card(cuda_device, dtype, B, H, T,
                                                D, causal):
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _qkv(T, B=B, H=H, D=D))
    out, lse = t_fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref, ref_lse = t_fa.flash_attention_fwd_ref(q, k, v, causal=causal)
    assert (out.float() - ref.float()).abs().max().item() <= _CARD_TOL[dtype]
    # lse is f32 in both: only the summation order differs
    assert (lse - ref_lse).abs().max().item() <= 1e-4


# bf16 backward: dS and the outputs are rounded to bf16 (8 bits), so the
# gradients are held to 2e-2 of each tensor's max |value|
_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,T,D,causal", _TRAIN_SHAPES)
def test_flash_bwd_kernels_match_plain_on_card(cuda_device, dtype, B, H, T,
                                               D, causal):
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _qkv(T, B=B, H=H, D=D))
    do = torch.from_numpy(np.random.RandomState(7).randn(
        *q.shape).astype(np.float32)).to(cuda_device, dtype)
    out, lse = t_fa.flash_attention_fwd_ref(q, k, v, causal=causal)
    delta = (out.float() * do.float()).sum(-1).reshape(-1, T)
    dq = t_fa.flash_attention_dq(q, k, v, do, lse, delta, causal=causal)
    dk, dv = t_fa.flash_attention_dkv(q, k, v, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    rq = t_fa.flash_attention_dq_ref(q, k, v, do, lse, delta, causal=causal)
    rk, rv = t_fa.flash_attention_dkv_ref(q, k, v, do, lse, delta,
                                          causal=causal)
    for name, got, ref in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        assert got.dtype == dtype
        assert _rel_err(got, ref) <= _BWD_TOL[dtype], name


def test_flash_train_function_launches_kernels_on_card(cuda_device):
    """FlashAttentionTrain on CUDA tensors: one K4 launch forward, one K5
    and one K6 backward, and the plain versions' gradients."""
    q, k, v = (torch.from_numpy(a).to(cuda_device).requires_grad_(True)
               for a in _qkv(70, B=2, H=4, D=64))
    do = torch.randn(q.shape, device=cuda_device)
    before = _launch_counts()
    out = t_fa.FlashAttentionTrain.apply(q, k, v, True, None)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launch_counts(), before)] == [0, 1, 1, 1]
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    ref_out, lse = t_fa.flash_attention_fwd_ref(qd, kd, vd)
    for g, r in zip(grads, t_fa.flash_attention_bwd_ref(qd, kd, vd, ref_out,
                                                        lse, do)):
        assert _rel_err(g, r) <= 1e-4


# K7-K10: a lane-friendly shape, an awkward one with a row of length 0, a
# single row, and a width past one tile in every direction
_RNN_SHAPES = [(8, 6, 128, [6, 6, 4, 6, 2, 6, 6, 5]), (3, 5, 20, [5, 0, 3]),
               (1, 9, 96, [7]), (37, 4, 200, None)]


def _rnn_case(device, dtype, gates, B, T, H, lengths):
    rng = np.random.RandomState(B + T + H)
    if lengths is None:
        lengths = rng.randint(0, T + 1, (B,))

    def f(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32)).to(device, dtype)

    return {"x": f(B, T, gates * H, scale=0.3), "h0": f(B, H, scale=0.2),
            "c0": f(B, H, scale=0.2), "w": f(H, gates * H, scale=0.1),
            "lengths": torch.tensor(lengths, dtype=torch.int32,
                                    device=device),
            "dhs": f(B, T, H), "dcs": f(B, T, H)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,lengths", _RNN_SHAPES)
def test_lstm_kernels_match_plain_on_card(cuda_device, dtype, B, T, H,
                                          lengths):
    a = _rnn_case(cuda_device, dtype, 4, B, T, H, lengths)
    args = [a[k] for k in ("x", "h0", "c0", "w", "lengths")]
    before = (t_lstm.lstm_forward.launches, t_lstm.lstm_backward.launches)
    got = t_lstm.lstm_forward(*args)
    torch.cuda.synchronize()
    ref = t_lstm.lstm_forward_ref(*args)
    for name, g, r in zip(("hs", "cs", "hT", "cT"), got, ref):
        assert g.dtype == dtype
        assert (g.float() - r.float()).abs().max().item() \
            <= _CARD_TOL[dtype], name
    grads = t_lstm.lstm_backward(*args, ref[0], ref[1], a["dhs"], a["dcs"])
    torch.cuda.synchronize()
    ref_g = t_lstm.lstm_backward_ref(*args, ref[0], ref[1], a["dhs"],
                                     a["dcs"])
    for name, g, r in zip(("dx", "dh0", "dc0", "dw"), grads, ref_g):
        assert g.dtype == dtype
        assert _rel_err(g, r) <= _BWD_TOL[dtype], name
    assert (t_lstm.lstm_forward.launches - before[0],
            t_lstm.lstm_backward.launches - before[1]) == (1, 1)


# B 160 at H 512: more batch groups than the persistent grid runs at once;
# H 528 and H 1152: W slices that do not fit a block's shared memory on an
# H100 (the f32 backward at 528; both directions, both dtypes at 1152)
_LSTM_ROUTE_SHAPES = [*_RNN_SHAPES, (160, 3, 512, None), (4, 3, 528, None),
                      (4, 3, 1152, None)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_routes_by_shape_and_both_match_plain_on_card(cuda_device,
                                                           dtype):
    """lstm.route's shape rule against the card's own capacity query: the
    persistent loop where one block of each of the ceil(H/16) column
    slices fits at once, whatever B, else the step kernels; at every
    shape the kernels the library counted as launched are that body's,
    and its results match the plain versions."""
    dw = "lstm_dw_mma" if dtype == torch.bfloat16 else "rnn_dw_kernel"
    ran_by_route = {
        False: {"persistent": {"lstm_fwd_persistent"},
                "steps": {"lstm_fwd_step"}},
        True: {"persistent": {"lstm_bwd_persistent", dw},
               "steps": {"lstm_bwd_gates", "lstm_bwd_dh", "rnn_dw_kernel"}}}

    def ran(fn):
        before = t_lstm.device_launches(cuda_device)
        out = fn()
        after = t_lstm.device_launches(cuda_device)
        return out, {k for k, n in after.items() if n > before[k]}

    for B, T, H, lengths in _LSTM_ROUTE_SHAPES:
        a = _rnn_case(cuda_device, dtype, 4, B, T, H, lengths)
        routes = {}
        for back in (False, True):
            fits = t_lstm.capacity(cuda_device, H, dtype, back) >= -(-H // 16)
            routes[back] = t_lstm.route(a["x"], backward=back)
            assert routes[back] == ("persistent" if fits else "steps"), \
                (B, T, H, back)
        args = [a[k] for k in ("x", "h0", "c0", "w", "lengths")]
        got, kernels = ran(lambda: t_lstm.lstm_forward(*args))
        assert kernels == ran_by_route[False][routes[False]], (B, T, H)
        ref = t_lstm.lstm_forward_ref(*args)
        for g, r in zip(got, ref):
            assert (g.float() - r.float()).abs().max().item() \
                <= _CARD_TOL[dtype], (B, T, H)
        grads, kernels = ran(lambda: t_lstm.lstm_backward(
            *args, ref[0], ref[1], a["dhs"], a["dcs"]))
        assert kernels == ran_by_route[True][routes[True]], (B, T, H)
        ref_g = t_lstm.lstm_backward_ref(*args, ref[0], ref[1], a["dhs"],
                                         a["dcs"])
        for g, r in zip(grads, ref_g):
            assert _rel_err(g, r) <= _BWD_TOL[dtype], (B, T, H)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,lengths", _RNN_SHAPES)
def test_gru_kernels_match_plain_on_card(cuda_device, dtype, B, T, H,
                                         lengths):
    a = _rnn_case(cuda_device, dtype, 3, B, T, H, lengths)
    args = [a[k] for k in ("x", "h0", "w", "lengths")]
    hs, hT = t_gru.gru_forward(*args)
    torch.cuda.synchronize()
    ref_hs, ref_hT = t_gru.gru_forward_ref(*args)
    assert (hs.float() - ref_hs.float()).abs().max().item() \
        <= _CARD_TOL[dtype]
    assert (hT.float() - ref_hT.float()).abs().max().item() \
        <= _CARD_TOL[dtype]
    grads = t_gru.gru_backward(*args, ref_hs, a["dhs"])
    torch.cuda.synchronize()
    ref_g = t_gru.gru_backward_ref(*args, ref_hs, a["dhs"])
    for name, g, r in zip(("dx", "dh0", "dw"), grads, ref_g):
        assert g.dtype == dtype
        assert _rel_err(g, r) <= _BWD_TOL[dtype], name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_routes_by_shape_and_both_match_plain_on_card(cuda_device,
                                                          dtype):
    """gru.route's shape rule against the card's own capacity query: the
    persistent loop where one block of each of the ceil(H/16) column
    slices fits at once, whatever B, else the step kernels; at every
    shape the device launches the library counted are that body's (K9
    persistent 1, steps 2T; K10 persistent 1 and dW's 2, steps 4T + 2),
    and its results match the plain versions.  B 160 at H 512 has more
    batch groups than the persistent grid runs at once."""
    def want(route, back, T):
        if not back:
            return ({"gru_fwd_persistent": 1} if route == "persistent" else
                    {"gru_gates": T, "gru_fwd_cand": T})
        return ({"gru_bwd_persistent": 1, "rnn_dw_kernel": 2}
                if route == "persistent" else
                {"gru_gates": T, "gru_bwd_cand": T, "gru_bwd_drh": T,
                 "gru_bwd_dh": T, "rnn_dw_kernel": 2})

    def ran(fn):
        before = t_gru.device_launches(cuda_device)
        out = fn()
        after = t_gru.device_launches(cuda_device)
        return out, {k: n - before[k] for k, n in after.items()
                     if n > before[k]}

    some, none = t_gru.steps_widths(cuda_device)
    taken = set()
    for B, T, H, lengths in [*_RNN_SHAPES, (160, 3, 512, None),
                             (4, 3, some, None), (4, 3, none, None)]:
        a = _rnn_case(cuda_device, dtype, 3, B, T, H, lengths)
        routes = {}
        for back in (False, True):
            fits = t_gru.capacity(cuda_device, H, dtype, back) >= -(-H // 16)
            routes[back] = t_gru.route(a["x"], backward=back)
            assert routes[back] == ("persistent" if fits else "steps"), \
                (B, T, H, back)
            taken.add(routes[back])
        args = [a[k] for k in ("x", "h0", "w", "lengths")]
        got, counts = ran(lambda: t_gru.gru_forward(*args))
        assert counts == want(routes[False], False, T), (B, T, H)
        ref = t_gru.gru_forward_ref(*args)
        for g, r in zip(got, ref):
            assert (g.float() - r.float()).abs().max().item() \
                <= _CARD_TOL[dtype], (B, T, H)
        grads, counts = ran(lambda: t_gru.gru_backward(*args, ref[0],
                                                       a["dhs"]))
        assert counts == want(routes[True], True, T), (B, T, H)
        ref_g = t_gru.gru_backward_ref(*args, ref[0], a["dhs"])
        for g, r in zip(grads, ref_g):
            assert _rel_err(g, r) <= _BWD_TOL[dtype], (B, T, H)
    assert taken == {"persistent", "steps"}


def test_recurrent_train_functions_launch_kernels_on_card(cuda_device):
    """LSTMTrain and GRUTrain on CUDA tensors: one forward launch, one
    backward launch each; a missing cell cotangent counts as zeros."""
    a = _rnn_case(cuda_device, torch.float32, 4, 5, 7, 96, None)
    leaves = [a[k].requires_grad_(True) for k in ("x", "h0", "c0", "w")]
    before = (t_lstm.lstm_forward.launches, t_lstm.lstm_backward.launches)
    hs, cs = t_lstm.LSTMTrain.apply(*leaves, a["lengths"])
    grads = torch.autograd.grad([hs], leaves, [a["dhs"]])
    torch.cuda.synchronize()
    assert (t_lstm.lstm_forward.launches - before[0],
            t_lstm.lstm_backward.launches - before[1]) == (1, 1)
    plain = [t.detach() for t in leaves]
    ref = t_lstm.lstm_backward_ref(*plain, a["lengths"], hs.detach(),
                                   cs.detach(), a["dhs"],
                                   torch.zeros_like(a["dcs"]))
    for g, r in zip(grads, ref):
        assert _rel_err(g, r) <= 1e-4
    a = _rnn_case(cuda_device, torch.float32, 3, 5, 7, 96, None)
    leaves = [a[k].requires_grad_(True) for k in ("x", "h0", "w")]
    before = (t_gru.gru_forward.launches, t_gru.gru_backward.launches)
    hs = t_gru.GRUTrain.apply(*leaves, a["lengths"])
    grads = torch.autograd.grad([hs], leaves, [a["dhs"]])
    torch.cuda.synchronize()
    assert (t_gru.gru_forward.launches - before[0],
            t_gru.gru_backward.launches - before[1]) == (1, 1)
    ref = t_gru.gru_backward_ref(*[t.detach() for t in leaves], a["lengths"],
                                 hs.detach(), a["dhs"])
    for g, r in zip(grads, ref):
        assert _rel_err(g, r) <= 1e-4


# K11-K15 (the fused BatchNorm -> 1x1 and 3x3 convolutions): odd widths
# and channel counts, with and without the residual and the ReLU, stride
# 2 with odd H and W, and a border case whose mean and beta lie far from 0
# (a zero-padded raw input would normalize to relu(beta - mean * gi) > 0)
_BN1_SHAPES = [(200, 64, 96, True, "relu", False),
               (1000, 256, 128, False, "relu", False),
               (37, 20, 5, True, None, False),
               (130, 128, 64, False, "relu", True)]
_BN3_SHAPES = [(2, 7, 7, 64, 96, 2, True, "relu", False),
               (3, 8, 8, 128, 128, 1, False, "relu", False),
               (1, 5, 9, 20, 33, 2, False, None, False),
               (2, 6, 6, 64, 64, 1, True, "relu", True),
               (2, 4, 4, 64, 256, 1, False, "relu", False)]
# ResNet-50's four 3x3 shapes (K = O = 64, 128, 256, 512 at 56, 28, 14 and
# 7 pixels square) at batch 2, and 1x1s of the same widths over as many
# pixels: the tensor-core tiles at every channel count the main path runs
_BN_RESNET_C = [(56, 64), (28, 128), (14, 256), (7, 512)]
_BN1_SHAPES += [(2 * hw * hw, c, c, False, "relu", False)
                for hw, c in _BN_RESNET_C]
_BN3_SHAPES += [(2, hw, hw, c, c, 1, False, "relu", False)
                for hw, c in _BN_RESNET_C]
_BN_GRADS = ("dx", "dgamma", "dbeta", "dmean", "dvar", "dw", "dr")


def _bn_case(device, dtype, xshape, has_r, border, seed):
    """(x, gamma, beta, mean, var, r): statistics f32, x and r in dtype."""
    rng = np.random.RandomState(seed)
    K = xshape[-1]

    def t(a, dt=dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dt)

    return (t(rng.randn(*xshape) * 1.5 + 0.3),
            t(rng.rand(K) + 0.5, torch.float32),
            t(rng.randn(K) * 0.3 + (5.0 if border else 0.0), torch.float32),
            t(rng.randn(K) * 0.1 + (3.0 if border else 0.3), torch.float32),
            t(rng.rand(K) + 2.0, torch.float32),
            t(rng.randn(*xshape)) if has_r else None)


@pytest.fixture
def exact_f32(cuda_device, monkeypatch):
    """The card with float32 convolutions and products exact: cuDNN's
    default TF32 would put the plain versions' own error (about 1e-3) into
    the comparison."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return cuda_device


def _check_bn(dtype, out, ref, grads, ref_g):
    assert out.dtype == dtype
    assert (out.float() - ref.float()).abs().max().item() <= _CARD_TOL[dtype]
    assert len(grads) == len(ref_g)
    for name, g, r in zip(_BN_GRADS, grads, ref_g):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert _rel_err(g, r) <= _BWD_TOL[dtype], name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,has_r,act,border", _BN1_SHAPES)
def test_bn_matmul_kernels_match_plain_on_card(exact_f32, dtype, M, K, N,
                                               has_r, act, border):
    cuda_device = exact_f32
    x, g, b, mu, var, r = _bn_case(cuda_device, dtype, (M, K), has_r, border,
                                   M + K)
    rng = np.random.RandomState(N)
    w = torch.from_numpy((rng.randn(K, N) / np.sqrt(K)).astype(
        np.float32)).to(cuda_device, dtype)
    do = torch.from_numpy(rng.randn(M, N).astype(np.float32)).to(
        cuda_device, dtype)
    before = (t_bnmm.bn_matmul_fwd.launches, t_bnmm.bn_matmul_bwd.launches)
    out = t_bnmm.bn_matmul_fwd(x, g, b, mu, var, w, r, act)
    grads = t_bnmm.bn_matmul_bwd(x, g, b, mu, var, w, do, r, act)
    torch.cuda.synchronize()
    _check_bn(dtype, out, t_bnmm.bn_matmul_fwd_ref(x, g, b, mu, var, w, r,
                                                    act),
              grads, t_bnmm.bn_matmul_bwd_ref(x, g, b, mu, var, w, do, r,
                                              act))
    assert (t_bnmm.bn_matmul_fwd.launches - before[0],
            t_bnmm.bn_matmul_bwd.launches - before[1]) == (1, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,H,W,K,O,stride,has_r,act,border", _BN3_SHAPES)
def test_bn_conv_kernels_match_plain_on_card(exact_f32, dtype, N, H, W, K,
                                             O, stride, has_r, act, border):
    """K13 and K14 (at O 128 one block owns the O axis, at O 256 two
    blocks share it, at O 512 each walks 256 channels in two passes)
    against the plain forward, K15 against the plain backward."""
    cuda_device = exact_f32
    x, g, b, mu, var, r = _bn_case(cuda_device, dtype, (N, H, W, K), has_r,
                                   border, N + H + K)
    rng = np.random.RandomState(O)
    w = torch.from_numpy((rng.randn(3, 3, K, O) / np.sqrt(9 * K)).astype(
        np.float32)).to(cuda_device, dtype)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    do = torch.from_numpy(rng.randn(N, Ho, Wo, O).astype(np.float32)).to(
        cuda_device, dtype)
    fns = (t_bnc.bn_conv3x3_fwd, t_bnc.bn_conv3x3_fwd_v2,
           t_bnc.bn_conv3x3_bwd)
    before = [f.launches for f in fns]
    args = (x, g, b, mu, var, w)
    out = t_bnc.bn_conv3x3_fwd(*args, r, act, stride=stride)
    grads = t_bnc.bn_conv3x3_bwd(*args, do, r, act, stride=stride)
    torch.cuda.synchronize()
    ref = t_bnc.bn_conv3x3_fwd_ref(*args, r, act, stride=stride)
    _check_bn(dtype, out, ref, grads,
              t_bnc.bn_conv3x3_bwd_ref(*args, do, r, act, stride=stride))
    out2 = t_bnc.bn_conv3x3_fwd_v2(*args, r, act, stride=stride)
    torch.cuda.synchronize()
    assert (out2.float() - ref.float()).abs().max().item() \
        <= _CARD_TOL[dtype]
    assert [f.launches - n for f, n in zip(fns, before)] == [1, 1, 1]


@pytest.mark.parametrize("kind,shape", [
    ("1x1", (200, 64, 96, True)), ("1x1", (37, 20, 5, True)),
    ("3x3", (2, 7, 7, 64, 96, 2, True)), ("3x3", (1, 5, 9, 20, 33, 2, True)),
    ("3x3", (2, 14, 14, 256, 256, 1, False))])
def test_bn_bwd_kernels_rerun_bit_identical_on_card(cuda_device, kind,
                                                    shape):
    """K12 and K15 in bf16: two calls on the same inputs give the same
    bits in every output (fixed-order sums, no atomics)."""
    dtype = torch.bfloat16
    rng = np.random.RandomState(7)
    if kind == "1x1":
        M, K, N, has_r = shape
        xs, ws, dos, extra = (M, K), (K, N), (M, N), {}
        fn = t_bnmm.bn_matmul_bwd
    else:
        n, H, W, K, O, stride, has_r = shape
        Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
        xs, ws, dos, extra = (n, H, W, K), (3, 3, K, O), (n, Ho, Wo, O), \
            {"stride": stride}
        fn = t_bnc.bn_conv3x3_bwd
    x, g, b, mu, var, r = _bn_case(cuda_device, dtype, xs, has_r, False, 3)
    w = torch.from_numpy((rng.randn(*ws) / np.sqrt(K)).astype(
        np.float32)).to(cuda_device, dtype)
    do = torch.from_numpy(rng.randn(*dos).astype(np.float32)).to(
        cuda_device, dtype)
    first = fn(x, g, b, mu, var, w, do, r, "relu", **extra)
    second = fn(x, g, b, mu, var, w, do, r, "relu", **extra)
    torch.cuda.synchronize()
    for name, a, c in zip(_BN_GRADS, first, second):
        assert torch.equal(a, c), name


def _off_alignment(t):
    """t's values in a tensor whose data lies one element past a 16-byte
    boundary: the kernels then stage element by element."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


# The f32 backwards on the tensor cores in 3xTF32 (K12, K15; csrc/bn_mma.cuh):
# element-wise staging (a channel count off 16 bytes, or x and r off
# 16-byte alignment), odd H and W at stride 2, a residual, the border case
@pytest.mark.parametrize("kind,shape,has_r,act,border,unaligned", [
    ("1x1", (37, 18, 22), True, "relu", False, False),
    ("1x1", (200, 64, 96), True, "relu", True, True),
    ("1x1", (130, 128, 64), False, None, False, False),
    ("3x3", (1, 5, 9, 18, 33, 2), False, None, False, False),
    ("3x3", (2, 7, 7, 64, 96, 2), True, "relu", False, True),
    ("3x3", (2, 9, 5, 16, 24, 2), True, "relu", True, False)])
def test_bn_bwd_tf32_bodies_match_plain_on_card(exact_f32, kind, shape,
                                                has_r, act, border,
                                                unaligned):
    """f32 K12 and K15 against their plain versions (relative to each
    tensor's max |value|), one launch a call, the same bits on a rerun."""
    cuda_device = exact_f32
    dtype = torch.float32
    rng = np.random.RandomState(17)
    if kind == "1x1":
        M, K, N = shape
        xs, ws, dos, extra = (M, K), (K, N), (M, N), {}
        fn, ref_fn = t_bnmm.bn_matmul_bwd, t_bnmm.bn_matmul_bwd_ref
    else:
        n, H, W, K, O, stride = shape
        Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
        xs, ws, dos = (n, H, W, K), (3, 3, K, O), (n, Ho, Wo, O)
        extra = {"stride": stride}
        fn, ref_fn = t_bnc.bn_conv3x3_bwd, t_bnc.bn_conv3x3_bwd_ref
    x, g, b, mu, var, r = _bn_case(cuda_device, dtype, xs, has_r, border,
                                   sum(shape))
    if unaligned:
        x = _off_alignment(x)
        r = None if r is None else _off_alignment(r)
    w = torch.from_numpy((rng.randn(*ws) / np.sqrt(np.prod(ws[:-1])))
                         .astype(np.float32)).to(cuda_device, dtype)
    do = torch.from_numpy(rng.randn(*dos).astype(np.float32)).to(
        cuda_device, dtype)
    before = fn.launches
    grads = fn(x, g, b, mu, var, w, do, r, act, **extra)
    again = fn(x, g, b, mu, var, w, do, r, act, **extra)
    torch.cuda.synchronize()
    assert fn.launches - before == 2
    ref_g = ref_fn(x, g, b, mu, var, w, do, r, act, **extra)
    assert len(grads) == len(ref_g)
    for name, got, want, rerun in zip(_BN_GRADS, grads, ref_g, again):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert _rel_err(got, want) <= _BWD_TOL[dtype], name
        assert torch.equal(got, rerun), name


# The bf16 forwards' tensor-core bodies (K11, K13): element-wise staging
# (a channel count not a multiple of 8, or x and r off 16-byte alignment),
# odd H and W at stride 2, a residual, a ragged K with the border case
# (a channel past K must contribute nothing)
@pytest.mark.parametrize("kind,shape,has_r,act,border,unaligned", [
    ("1x1", (37, 20, 5), True, "relu", False, False),
    ("1x1", (70, 20, 16), False, "relu", True, False),
    ("1x1", (200, 64, 96), True, "relu", False, True),
    ("3x3", (1, 5, 9, 20, 33, 2), False, None, False, False),
    ("3x3", (2, 7, 7, 64, 96, 2), True, "relu", False, False),
    ("3x3", (2, 9, 5, 16, 24, 2), True, "relu", True, True)])
def test_bn_fwd_mma_bodies_match_plain_on_card(cuda_device, kind, shape,
                                               has_r, act, border,
                                               unaligned):
    """bf16 K11 and K13 against their plain versions in bf16 (relative to
    max |value|), one launch a call, and the same bits on a rerun."""
    dtype = torch.bfloat16
    rng = np.random.RandomState(11)
    if kind == "1x1":
        M, K, N = shape
        xs, ws, extra = (M, K), (K, N), {}
        fn, ref_fn = t_bnmm.bn_matmul_fwd, t_bnmm.bn_matmul_fwd_ref
    else:
        n, H, W, K, O, stride = shape
        xs, ws, extra = (n, H, W, K), (3, 3, K, O), {"stride": stride}
        fn, ref_fn = t_bnc.bn_conv3x3_fwd, t_bnc.bn_conv3x3_fwd_ref
    x, g, b, mu, var, r = _bn_case(cuda_device, dtype, xs, has_r, border,
                                   sum(shape))
    if unaligned:
        x = _off_alignment(x)
        r = None if r is None else _off_alignment(r)
    w = torch.from_numpy((rng.randn(*ws) / np.sqrt(np.prod(ws[:-1])))
                         .astype(np.float32)).to(cuda_device, dtype)
    before = fn.launches
    out = fn(x, g, b, mu, var, w, r, act, **extra)
    again = fn(x, g, b, mu, var, w, r, act, **extra)
    torch.cuda.synchronize()
    assert fn.launches - before == 2
    ref = ref_fn(x, g, b, mu, var, w, r, act, **extra)
    assert out.dtype == dtype and out.shape == ref.shape
    assert _rel_err(out, ref) <= _CARD_TOL[dtype]
    assert torch.equal(out, again)


# The f32 forward on the tensor cores in 3xTF32 (K11, csrc/bn_matmul.cu
# bnmm_fwd_mma<float>): element-wise staging (a channel count off 16
# bytes, K or N % 4 != 0, or x and r off 16-byte alignment), a residual,
# the border case (a channel past K must contribute nothing, and a row
# past M, whose A row is act(beta - mean * gi), must not be stored), N < 64
# and N = 96 (a partial second N tile)
@pytest.mark.parametrize("shape,has_r,act,border,unaligned", [
    ((37, 18, 22), True, "relu", False, False),
    ((70, 20, 16), False, "relu", True, False),
    ((130, 64, 30), True, None, False, False),
    ((200, 64, 96), True, "relu", False, True),
    ((130, 128, 64), False, "relu", True, True),
    ((1000, 256, 96), True, "relu", True, False)])
def test_bn_fwd_tf32_body_matches_plain_on_card(exact_f32, shape, has_r,
                                                act, border, unaligned):
    """f32 K11 against its plain version in f32 (relative to max
    |value|), one launch a call, and the same bits on a rerun."""
    cuda_device = exact_f32
    dtype = torch.float32
    M, K, N = shape
    rng = np.random.RandomState(19)
    x, g, b, mu, var, r = _bn_case(cuda_device, dtype, (M, K), has_r,
                                   border, sum(shape))
    if unaligned:
        x = _off_alignment(x)
        r = None if r is None else _off_alignment(r)
    w = torch.from_numpy((rng.randn(K, N) / np.sqrt(K)).astype(
        np.float32)).to(cuda_device, dtype)
    fn = t_bnmm.bn_matmul_fwd
    before = fn.launches
    out = fn(x, g, b, mu, var, w, r, act)
    again = fn(x, g, b, mu, var, w, r, act)
    torch.cuda.synchronize()
    assert fn.launches - before == 2
    ref = t_bnmm.bn_matmul_fwd_ref(x, g, b, mu, var, w, r, act)
    assert out.dtype == dtype and out.shape == ref.shape == (M, N)
    assert _rel_err(out, ref) <= _CARD_TOL[dtype]
    assert torch.equal(out, again)


# The wide tap product (K14 in both dtypes, f32 K13; csrc/bn_conv.cu
# bnc_fwd_wide): element-wise staging (a channel count off 16 bytes, or x
# and r off 16-byte alignment), odd H and W at stride 2, a 200-wide O
# block walked as 128 + 72 channels, a 256-wide block of O 512
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,has_r,border,unaligned", [
    ((1, 5, 9, 20, 33, 2), False, False, False),
    ((2, 9, 5, 16, 24, 2), True, True, True),
    ((2, 6, 6, 64, 200, 1), True, False, False),
    ((1, 7, 7, 64, 512, 1), False, False, True)])
def test_bn_conv_wide_bodies_match_plain_on_card(exact_f32, dtype, shape,
                                                 has_r, border, unaligned):
    """K14 (and K13 in f32) against the plain forward, one launch a call,
    the same bits on a rerun; K13 and K14 sum each output element in one
    order, so in f32 they give the same bits."""
    cuda_device = exact_f32
    n, H, W, K, O, stride = shape
    rng = np.random.RandomState(13)
    x, g, b, mu, var, r = _bn_case(cuda_device, dtype, (n, H, W, K), has_r,
                                   border, sum(shape))
    if unaligned:
        x = _off_alignment(x)
        r = None if r is None else _off_alignment(r)
    w = torch.from_numpy((rng.randn(3, 3, K, O) / np.sqrt(9 * K)).astype(
        np.float32)).to(cuda_device, dtype)
    args = (x, g, b, mu, var, w, r, "relu")
    before = t_bnc.bn_conv3x3_fwd_v2.launches
    out = t_bnc.bn_conv3x3_fwd_v2(*args, stride=stride)
    again = t_bnc.bn_conv3x3_fwd_v2(*args, stride=stride)
    v1 = t_bnc.bn_conv3x3_fwd(*args, stride=stride)
    torch.cuda.synchronize()
    assert t_bnc.bn_conv3x3_fwd_v2.launches - before == 2
    ref = t_bnc.bn_conv3x3_fwd_ref(*args, stride=stride)
    assert out.dtype == dtype and out.shape == ref.shape
    assert _rel_err(out, ref) <= _CARD_TOL[dtype]
    assert torch.equal(out, again)
    if dtype == torch.float32:
        assert torch.equal(out, v1)


def test_bn_train_functions_launch_kernels_on_card(exact_f32):
    """BNMatmulTrain and BNConv3x3Train (v1 and v2) on CUDA tensors: one
    forward and one backward launch each, gradients as the plain
    backward's."""
    cuda_device = exact_f32
    x, g, b, mu, var, r = _bn_case(cuda_device, torch.float32, (96, 64),
                                   True, False, 1)
    w = torch.randn(64, 32, device=cuda_device) / 8
    leaves = [t.requires_grad_(True) for t in (x, g, b, mu, var, w, r)]
    before = (t_bnmm.bn_matmul_fwd.launches, t_bnmm.bn_matmul_bwd.launches)
    out = t_bnmm.BNMatmulTrain.apply(*leaves, "relu", 1e-5)
    do = torch.randn_like(out)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (t_bnmm.bn_matmul_fwd.launches - before[0],
            t_bnmm.bn_matmul_bwd.launches - before[1]) == (1, 1)
    ref = t_bnmm.bn_matmul_bwd_ref(*[t.detach() for t in leaves[:6]], do,
                                   r.detach(), "relu")
    for name, gk, gr in zip(_BN_GRADS, grads, ref):
        assert _rel_err(gk, gr) <= 1e-4, name
    for variant, fwd in (("v1", t_bnc.bn_conv3x3_fwd),
                         ("v2", t_bnc.bn_conv3x3_fwd_v2)):
        x, g, b, mu, var, _ = _bn_case(cuda_device, torch.float32,
                                       (2, 7, 7, 64), False, False, 2)
        w = torch.randn(3, 3, 64, 48, device=cuda_device) / 24
        leaves = [t.requires_grad_(True) for t in (x, g, b, mu, var, w)]
        before = (fwd.launches, t_bnc.bn_conv3x3_bwd.launches)
        out = t_bnc.BNConv3x3Train.apply(*leaves, None, "relu", 1e-5, 2,
                                         variant)
        do = torch.randn_like(out)
        grads = torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
        assert (fwd.launches - before[0],
                t_bnc.bn_conv3x3_bwd.launches - before[1]) == (1, 1)
        ref = t_bnc.bn_conv3x3_bwd_ref(*[t.detach() for t in leaves], do,
                                       None, "relu", stride=2)
        for name, gk, gr in zip(_BN_GRADS, grads, ref):
            assert _rel_err(gk, gr) <= 1e-4, (variant, name)
