"""The arithmetic and fragment maps of the tensor-core flash kernels
(``paddle_tpu_torch/ops/cuda_kernels/csrc/flash_attention*.cu``,
``csrc/mma.cuh``), emulated in numpy on the CPU.

The kernels themselves run only on a card (``test_torch_kernels.py``
holds them against their plain versions there).  What can be checked
here is what they compute and how each lane's registers map onto the
matrices:

- the 3xTF32 split of the f32 forward: an f32 product as three TF32
  products of split operands, against the f32 product and against
  one-pass TF32;
- a flash forward built from those products, tile by tile with the
  kernel's online softmax, against the function in float64 and the JAX
  package's ``flash_attention`` (interpret mode, as its own tests run it);
- the m16n8k8 TF32 fragment maps: Q and K through ldmatrix, P passed from
  the score accumulators to the A operand with its keys permuted, V's B
  registers read from key rows (2t, 2t + 1), and the bank of every load;
- the m16n8k16 bf16 maps of the dQ kernel: dS from the accumulators into
  the A operand of dQ += dS K, with K through ldmatrix.trans.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda_kernels import flash_attention as t_fa


def tf32(x):
    """Round float32 to TF32 as ``cvt.rna.tf32.f32``: to nearest, ties
    away from zero, 10 mantissa bits kept, the low 13 bits zero."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(x):
    """x = big + small: big = tf32(x), small = tf32(x - big)."""
    x = np.asarray(x, np.float32)
    big = tf32(x)
    return big, tf32(x - big)


def mm_3xtf32(a, b):
    """a @ b as the kernel forms it: a_small b_big + a_big b_small +
    a_big b_big, each product of TF32 values (exact in f32) summed in f32,
    small terms first; a_small b_small is dropped."""
    ab, as_ = split(a)
    bb, bs = split(b)
    return (as_ @ bb + ab @ bs) + ab @ bb


def mm_tf32(a, b):
    """One-pass TF32: both operands rounded once."""
    return tf32(a) @ tf32(b)


def _rel_to_max(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _case(T=128, D=64, B=1, H=2, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, T, D).astype(np.float32) for _ in range(3)]


def test_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # the TF32 step at 1
    half = np.float32(2.0 ** -11)
    x = np.array([one + half, -(one + half), one + half * np.float32(0.99),
                  one + ulp + half, np.float32(3.0)], np.float32)
    np.testing.assert_array_equal(
        tf32(x), np.array([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0],
                          np.float32))
    assert (tf32(x).view(np.uint32) & 0x1FFF == 0).all()


def test_split_product_keeps_f32_accuracy_and_one_pass_does_not():
    """On the two products of the forward, S = Q Kᵀ and P·V at T 128,
    D 64: 3xTF32 within 1e-6 of max |value| of the f32 product, one-pass
    TF32 beyond 1e-4."""
    q, k, v = (a[0, 0] for a in _case(seed=1))
    s64 = q.astype(np.float64) @ k.T.astype(np.float64)
    s = q @ k.T
    assert _rel_to_max(mm_3xtf32(q, k.T), s) <= 1e-6
    assert _rel_to_max(mm_tf32(q, k.T), s) > 1e-4
    s64 = s64 / np.sqrt(64.0)
    s64 = np.where(np.tril(np.ones_like(s64, bool)), s64, -np.inf)
    p = np.exp(s64 - s64.max(-1, keepdims=True)).astype(np.float32)
    pv = p @ v
    assert _rel_to_max(mm_3xtf32(p, v), pv) <= 1e-6
    assert _rel_to_max(mm_tf32(p, v), pv) > 1e-4


def flash_fwd_3xtf32(q, k, v, causal=True, mm=mm_3xtf32, bk=64):
    """The f32 kernel's forward in numpy: 64-key tiles, raw-score running
    max, p = exp2(s·c − m·c) in f32 with c = scale·log2(e), the row sum
    and the accumulator rescaled per tile, O = acc / l.  q, k, v [T, D]."""
    T, D = q.shape
    c = np.float32(1.0 / np.sqrt(D) * np.log2(np.e))
    m = np.full((T, 1), -np.inf, np.float32)
    l = np.zeros((T, 1), np.float32)
    acc = np.zeros((T, D), np.float32)
    rows = np.arange(T)[:, None]
    for k0 in range(0, T, bk):
        kt, vt = k[k0:k0 + bk], v[k0:k0 + bk]
        s = mm(q, kt.T).astype(np.float32)
        keys = k0 + np.arange(kt.shape[0])[None, :]
        if causal:
            s = np.where(keys <= rows, s, np.float32(-np.inf))
        m_new = np.maximum(m, s.max(-1, keepdims=True))
        m_use = np.where(m_new == -np.inf, np.float32(0), m_new)
        corr = np.exp2((m - m_use) * c).astype(np.float32)
        p = np.exp2(s * c - m_use * c).astype(np.float32)
        l = l * corr + p.sum(-1, keepdims=True, dtype=np.float32)
        acc = acc * corr + mm(p, vt).astype(np.float32)
        m = m_new
    return acc / l


def _attention_f64(q, k, v, causal=True):
    q, k, v = (a.astype(np.float64) for a in (q, k, v))
    s = q @ k.T / np.sqrt(q.shape[-1])
    if causal:
        s = np.where(np.tril(np.ones_like(s, bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)) @ v


@pytest.mark.parametrize("T,causal", [(128, True), (200, True),
                                      (130, False)])
def test_emulated_3xtf32_forward_within_1e4_of_float64_and_jax(T, causal):
    """The forward from emulated 3xTF32 products against the function in
    float64 and the JAX flash_attention (interpret mode) at 1e-4, the f32
    kernels' tolerance; T 200 and 130 end in a ragged tile."""
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas_kernels import flash_attention as jfa

    q, k, v = _case(T=T, seed=T)
    got = np.stack([np.stack([flash_fwd_3xtf32(q[b, h], k[b, h], v[b, h],
                                                causal)
                              for h in range(q.shape[1])])
                    for b in range(q.shape[0])])
    x64 = np.stack([np.stack([_attention_f64(q[b, h], k[b, h], v[b, h],
                                             causal)
                              for h in range(q.shape[1])])
                    for b in range(q.shape[0])])
    jax_out = np.asarray(jfa.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal,
        interpret=True))
    assert np.abs(got - x64).max() <= 1e-4
    assert np.abs(got - jax_out).max() <= 1e-4
    # one TF32 pass would not hold the f32 tolerance
    one_pass = flash_fwd_3xtf32(q[0, 0], k[0, 0], v[0, 0], causal,
                                mm=mm_tf32)
    assert np.abs(one_pass - x64[0, 0]).max() > 1e-4
    # and the port's plain version, the kernel's yardstick on the card
    plain = t_fa.flash_attention_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal).numpy()
    assert np.abs(got - plain).max() <= 1e-4


# -- lane-level emulation of ldmatrix and mma.sync ---------------------------

LANES = np.arange(32)
G, TQ = LANES >> 2, LANES & 3  # lane l = 4 g + t


# mma.cuh's ldmatrix address maps for lanes l (columns in 16-byte units)
def a_row(l):
    return l & 15


def a_col16(l):
    return l >> 4


def b_row(l):
    return (l & 7) + ((l >> 4) << 3)


def b_col16(l):
    return (l >> 3) & 1


def bt_row(l):
    return (l & 7) + (((l >> 3) & 1) << 3)


def bt_col16(l):
    return l >> 4


def ldmatrix_x4_f32(smem, ld, rows, cols4):
    """ldmatrix.x4 over an f32 tile (row stride `ld` floats): lane j names
    the 16-byte row (rows[j], cols4[j] .. + 3) of matrix j // 8; lane l
    gets from each matrix i the 32-bit word (l // 4, l % 4), here one f32.
    Returns regs [32, 4]."""
    regs = np.empty((32, 4), np.float32)
    for i in range(4):
        for l in range(32):
            j = 8 * i + l // 4
            regs[l, i] = smem[rows[j] * ld + cols4[j] + l % 4]
    return regs


def ldmatrix_x4_b16(smem, ld, rows, cols8, trans=False):
    """ldmatrix.x4 over a 16-bit tile: lane l gets from matrix i the pair
    (row l // 4, columns 2 (l % 4), + 1), or with .trans the pair (rows
    2 (l % 4), + 1; column l // 4).  Returns regs [32, 4, 2]."""
    regs = np.empty((32, 4, 2), smem.dtype)
    for i in range(4):
        for l in range(32):
            for h in range(2):
                if trans:
                    r, c = 2 * (l % 4) + h, l // 4
                else:
                    r, c = l // 4, 2 * (l % 4) + h
                j = 8 * i + r
                regs[l, i, h] = smem[rows[j] * ld + cols8[j] + c]
    return regs


def mma_m16n8k8_tf32(a, b):
    """The product of mma.m16n8k8 .tf32 from per-lane registers: a [32, 4]
    (a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)), b [32, 2] (b0
    (t, g), b1 (t+4, g)).  Returns the C fragment [32, 4]: c0 c1 (g,
    2t..2t+1), c2 c3 (g+8, 2t..2t+1)."""
    A = np.zeros((16, 8))
    B = np.zeros((8, 8))
    A[G, TQ], A[G + 8, TQ], A[G, TQ + 4], A[G + 8, TQ + 4] = a.T
    B[TQ, G], B[TQ + 4, G] = b.T
    C = A @ B
    return np.stack([C[G, 2 * TQ], C[G, 2 * TQ + 1], C[G + 8, 2 * TQ],
                     C[G + 8, 2 * TQ + 1]], 1)


def mma_m16n8k16_bf16(a, b):
    """mma.m16n8k16 .bf16 from per-lane registers: a [32, 4, 2] (a0 (g,
    2t..), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)), b [32, 2, 2]
    (b0 (2t..2t+1, g), b1 (2t+8.., g)).  Returns C [32, 4]."""
    A = np.zeros((16, 16))
    B = np.zeros((16, 8))
    for h in range(2):
        A[G, 2 * TQ + h] = a[:, 0, h]
        A[G + 8, 2 * TQ + h] = a[:, 1, h]
        A[G, 2 * TQ + 8 + h] = a[:, 2, h]
        A[G + 8, 2 * TQ + 8 + h] = a[:, 3, h]
        B[2 * TQ + h, G] = b[:, 0, h]
        B[2 * TQ + 8 + h, G] = b[:, 1, h]
    C = A @ B
    return np.stack([C[G, 2 * TQ], C[G, 2 * TQ + 1], C[G + 8, 2 * TQ],
                     C[G + 8, 2 * TQ + 1]], 1)


def c_to_matrix(c, n_tiles):
    """Per-lane C fragments [n_tiles, 32, 4] → the [16, 8 n_tiles] tile."""
    out = np.zeros((16, 8 * n_tiles))
    for n in range(n_tiles):
        out[G, 8 * n + 2 * TQ] = c[n][:, 0]
        out[G, 8 * n + 2 * TQ + 1] = c[n][:, 1]
        out[G + 8, 8 * n + 2 * TQ] = c[n][:, 2]
        out[G + 8, 8 * n + 2 * TQ + 1] = c[n][:, 3]
    return out


@pytest.mark.parametrize("DP", [64, 128])
def test_tf32_fragment_maps_multiply_q_k_then_p_v(DP):
    """One warp's 16 Q rows against a 64-key tile at head dim DP, lane by
    lane as flash_fwd_tf32_kernel does it: S = Q Kᵀ from ldmatrix
    fragments (Q as A, K as B from its [key][d] tile), then P = S taken
    from the accumulators as the A operand with the keys of each 8-key
    chunk permuted (A = c0, c2, c1, c3) and V's B registers read from key
    rows 2t and 2t + 1.  Every product is exact in float64 (the operands
    are small integers), so the maps must give Q Kᵀ and P V exactly."""
    rng = np.random.RandomState(DP)
    LD = DP + 4
    q = rng.randint(-4, 5, (16, DP)).astype(np.float32)
    k = rng.randint(-4, 5, (64, DP)).astype(np.float32)
    v = rng.randint(-4, 5, (64, DP)).astype(np.float32)
    qs, ks, vs = (np.zeros(r * LD, np.float32) for r in (16, 64, 64))
    for smem, x in ((qs, q), (ks, k), (vs, v)):
        smem.reshape(-1, LD)[:, :DP] = x

    s = np.zeros((8, 32, 4))
    for c in range(DP // 8):
        a = ldmatrix_x4_f32(qs, LD, a_row(LANES),
                            4 * a_col16(LANES) + 8 * c)
        for np_ in range(4):
            b = ldmatrix_x4_f32(ks, LD, np_ * 16 + b_row(LANES),
                                4 * b_col16(LANES) + 8 * c)
            s[2 * np_] += mma_m16n8k8_tf32(a, b[:, 0:2])
            s[2 * np_ + 1] += mma_m16n8k8_tf32(a, b[:, 2:4])
    np.testing.assert_array_equal(c_to_matrix(s, 8), q @ k.T)

    p = s  # the score accumulators, used as they are
    o = np.zeros((DP // 8, 32, 4))
    for kc in range(8):
        a = p[kc][:, [0, 2, 1, 3]]  # acc_to_a_tf32
        for n in range(DP // 8):
            # ld_v_tf32: lane (g, t) reads key rows kc·8 + 2t, + 1, col n·8 + g
            addr = (kc * 8 + 2 * TQ) * LD + n * 8 + G
            b = np.stack([vs[addr], vs[addr + LD]], 1)
            o[n] += mma_m16n8k8_tf32(a, b)
    np.testing.assert_array_equal(c_to_matrix(o, DP // 8),
                                  c_to_matrix(p, 8) @ v)


@pytest.mark.parametrize("DP", [64, 128])
def test_tf32_loads_are_free_of_bank_conflicts(DP):
    """Row stride DP + 4 f32: each 8-row phase of an ldmatrix covers the
    32 banks once, and so do the 32 lanes of a V load (rows 2t, 2t + 1,
    column g of an n-tile)."""
    LD = DP + 4
    for rows, cols in ((a_row(LANES), 4 * a_col16(LANES)),
                       (b_row(LANES), 4 * b_col16(LANES))):
        for i in range(4):
            j = np.arange(8 * i, 8 * i + 8)
            words = (rows[j] * LD + cols[j])[:, None] + np.arange(4)
            assert len(set((words % 32).ravel())) == 32
    for kc in range(8):
        for n in range(DP // 8):
            for dr in (0, 1):
                addr = (kc * 8 + 2 * TQ + dr) * LD + n * 8 + G
                assert len(set(addr % 32)) == 32


def test_bf16_dq_fragment_maps_multiply_ds_k():
    """flash_dq_mma_kernel's last product, lane by lane: dS (the
    accumulators of eight key n-tiles) packed into the A operand of two
    16-key chunks (acc_to_a), K's B registers from its row-major
    [key][d] tile by ldmatrix.trans (bt_row, bt_col), dQ = dS K exactly;
    and S = Q Kᵀ with K through plain ldmatrix (b_row, b_col)."""
    rng = np.random.RandomState(5)
    DP, LD = 64, 72
    q = rng.randint(-4, 5, (16, DP)).astype(np.float64)
    k = rng.randint(-4, 5, (64, DP)).astype(np.float64)
    ds = rng.randint(-4, 5, (16, 64)).astype(np.float64)
    qs, ks = np.zeros(16 * LD), np.zeros(64 * LD)
    qs.reshape(-1, LD)[:, :DP] = q
    ks.reshape(-1, LD)[:, :DP] = k

    s = np.zeros((8, 32, 4))
    for c in range(DP // 16):
        a = ldmatrix_x4_b16(qs, LD, a_row(LANES), 8 * a_col16(LANES) + 16 * c)
        for np_ in range(4):
            b = ldmatrix_x4_b16(ks, LD, np_ * 16 + b_row(LANES),
                                8 * b_col16(LANES) + 16 * c)
            s[2 * np_] += mma_m16n8k16_bf16(a, b[:, 0:2])
            s[2 * np_ + 1] += mma_m16n8k16_bf16(a, b[:, 2:4])
    np.testing.assert_array_equal(c_to_matrix(s, 8), q @ k.T)

    # dS as accumulators of eight n-tiles (C layout)
    acc_ds = np.stack([np.stack([ds[G, 8 * n + 2 * TQ],
                                 ds[G, 8 * n + 2 * TQ + 1],
                                 ds[G + 8, 8 * n + 2 * TQ],
                                 ds[G + 8, 8 * n + 2 * TQ + 1]], 1)
                       for n in range(8)])
    dq = np.zeros((DP // 8, 32, 4))
    for j in range(4):
        a = np.stack([acc_ds[2 * j][:, 0:2], acc_ds[2 * j][:, 2:4],
                      acc_ds[2 * j + 1][:, 0:2], acc_ds[2 * j + 1][:, 2:4]],
                     1)  # acc_to_a
        for np_ in range(DP // 16):
            b = ldmatrix_x4_b16(ks, LD, j * 16 + bt_row(LANES),
                                8 * bt_col16(LANES) + 16 * np_, trans=True)
            dq[2 * np_] += mma_m16n8k16_bf16(a, b[:, 0:2])
            dq[2 * np_ + 1] += mma_m16n8k16_bf16(a, b[:, 2:4])
    np.testing.assert_array_equal(c_to_matrix(dq, DP // 8), ds @ k)
