"""The f32 flash backward's tensor-core bodies (``flash_dq_tf32_kernel``,
K5, and ``flash_dkv_tf32_kernel``, K6, in
``paddle_tpu_torch/ops/cuda_kernels/csrc/flash_attention_bwd.cu``),
emulated in numpy on the CPU.

The kernels run only on a card (``test_torch_kernels.py`` holds them
against their plain versions there).  What is checked here:

- the arithmetic: the backward from 3xTF32 products (small halves
  passed unrounded, as the kernels pass them), 64-row tile by tile
  in the kernels' order (K5 walks the K tiles of each Q tile up to the
  diagonal, K6 the Q tiles of each K tile from the diagonal), against the
  function in float64 and the JAX ``flash_attention_bwd`` in interpret
  mode at the f32 tolerance 1e-4 of max |g|, where one TF32 pass misses
  it;
- the lane maps: each warp's seven products built from per-lane
  registers exactly as the kernels load them (ldmatrix for S, dP and
  their transposes; the score accumulators as the A operand and rows 2t,
  2t + 1 of a tile as B for dQ += dS K, dV += Pᵀ dO and dK += dSᵀ Q),
  equal to the matrix products;
- the banks of every shared-memory load the two kernels issue.

The lane helpers are ``test_torch_flash_mma.py``'s.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda_kernels import flash_attention as t_fa
from test_torch_flash_mma import (G, LANES, TQ, a_col16, a_row, b_col16,
                                  b_row, c_to_matrix, ldmatrix_x4_f32,
                                  mma_m16n8k8_tf32, tf32)

BT = 64  # rows of a Q tile and of a K tile (kB)
LOG2E = np.float32(np.log2(np.e))
TOL = 1e-4  # the f32 kernels' tolerance, relative to max |g|


def split_raw(x):
    """The backward's split (mma.cuh split_tf32<true>): big = tf32(x), and
    small = x - big passed unrounded, which mma.sync reads as TF32 by
    dropping its low 13 bits."""
    x = np.asarray(x, np.float32)
    big = tf32(x)
    small = (x - big).view(np.uint32) & np.uint32(0xFFFFE000)
    return big, small.view(np.float32)


def mm_3xtf32_chunks(a, b):
    """a @ b as mma_3xtf32 issues it on split_raw operands, from zero: for
    each 8-deep chunk of the inner dimension a_small b_big, a_big b_small,
    then a_big b_big, each added to the f32 accumulator in turn.  The
    kernels sum each tile's products so, and add the sum to the walk's
    accumulator in f32, as the emulations below do."""
    ab, as_ = split_raw(a)
    bb, bs = split_raw(b)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for c in range(0, a.shape[1], 8):
        for x, y in ((as_, bb), (ab, bs), (ab, bb)):
            acc = acc + x[:, c:c + 8] @ y[c:c + 8]
    return acc


def mm_tf32_chunks(a, b):
    """One TF32 pass over the same chunks."""
    ta, tb = tf32(a), tf32(b)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for c in range(0, a.shape[1], 8):
        acc = acc + ta[:, c:c + 8] @ tb[c:c + 8]
    return acc


def _probs(s, lse_rows, rows, keys, causal, c):
    """exp2(s·c − lse·log2 e) in f32, zero where a key lies past its row."""
    p = np.exp2(s * c - lse_rows * LOG2E).astype(np.float32)
    if causal:
        p = np.where(keys <= rows, p, np.float32(0))
    return p


def dq_3xtf32(q, k, v, do, lse, delta, causal, mm=mm_3xtf32_chunks):
    """flash_dq_tf32_kernel on one (b, h): for each 64-row Q tile, the K
    tiles up to the diagonal (all when non-causal): S, P, dP, dS, then
    dQ += dS K into the tile's f32 accumulator."""
    T, D = q.shape
    scale = np.float32(1 / np.sqrt(D))
    c = np.float32(scale * LOG2E)
    n_t = -(-T // BT)
    dq = np.zeros((T, D), np.float32)
    for qt in range(n_t):
        rows = np.arange(qt * BT, min(qt * BT + BT, T))
        acc = np.zeros((len(rows), D), np.float32)
        for kt in range(min(n_t, qt + 1) if causal else n_t):
            keys = np.arange(kt * BT, min(kt * BT + BT, T))
            p = _probs(mm(q[rows], k[keys].T), lse[rows, None], rows[:, None],
                       keys[None], causal, c)
            dp = mm(do[rows], v[keys].T)
            ds = p * (dp - delta[rows, None]) * scale
            acc = acc + mm(ds, k[keys])
        dq[rows] = acc
    return dq


def dkv_3xtf32(q, k, v, do, lse, delta, causal, mm=mm_3xtf32_chunks):
    """flash_dkv_tf32_kernel on one (b, h): for each 64-row K tile, the Q
    tiles from the diagonal (all when non-causal): Sᵀ, Pᵀ, dV += Pᵀ dO,
    dPᵀ, dSᵀ, dK += dSᵀ Q."""
    T, D = q.shape
    scale = np.float32(1 / np.sqrt(D))
    c = np.float32(scale * LOG2E)
    n_t = -(-T // BT)
    dk = np.zeros((T, D), np.float32)
    dv = np.zeros((T, D), np.float32)
    for kt in range(n_t):
        keys = np.arange(kt * BT, min(kt * BT + BT, T))
        dk_acc = np.zeros((len(keys), D), np.float32)
        dv_acc = np.zeros((len(keys), D), np.float32)
        for qt in range(kt if causal else 0, n_t):
            rows = np.arange(qt * BT, min(qt * BT + BT, T))
            pt = _probs(mm(k[keys], q[rows].T), lse[None, rows],
                        rows[None], keys[:, None], causal, c)
            dv_acc = dv_acc + mm(pt, do[rows])
            dpt = mm(v[keys], do[rows].T)
            dst = pt * (dpt - delta[None, rows]) * scale
            dk_acc = dk_acc + mm(dst, q[rows])
        dk[keys] = dk_acc
        dv[keys] = dv_acc
    return dk, dv


def bwd_f64(q, k, v, do, lse, delta, causal):
    """(dq, dk, dv) in float64 from the same lse and delta."""
    q, k, v, do, lse, delta = (np.asarray(a, np.float64)
                               for a in (q, k, v, do, lse, delta))
    scale = 1 / np.sqrt(q.shape[-1])
    s = q @ k.T * scale
    if causal:
        s = np.where(np.tril(np.ones_like(s, bool)), s, -np.inf)
    p = np.exp(s - lse[:, None])
    ds = p * (do @ v.T - delta[:, None]) * scale
    return ds @ k, ds.T @ q, p.T @ do


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _emulate(q, k, v, do, lse, delta, causal, mm):
    """(dq, dk, dv) [B, H, T, D] of both kernels, head by head."""
    B, H, T, D = q.shape
    out = [np.zeros_like(q) for _ in range(3)]
    for b in range(B):
        for h in range(H):
            args = (q[b, h], k[b, h], v[b, h], do[b, h], lse[b * H + h],
                    delta[b * H + h], causal)
            out[0][b, h] = dq_3xtf32(*args, mm=mm)
            out[1][b, h], out[2][b, h] = dkv_3xtf32(*args, mm=mm)
    return out


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [128, 200])
def test_emulated_3xtf32_backward_within_1e4_of_float64_and_jax(T, causal):
    """The backward from emulated 3xTF32 products at D 64 against float64
    and the JAX dQ and dK/dV kernels (interpret mode, as their own tests
    run them) at 1e-4 of each gradient's max |value|; T 200 ends in a
    ragged tile.  One TF32 pass over the same tiles misses 1e-4."""
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas_kernels import flash_attention as jfa

    B, H, D = 1, 2, 64
    rng = np.random.RandomState(T + causal)
    q, k, v, do = (rng.randn(B, H, T, D).astype(np.float32)
                   for _ in range(4))
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jout, jlse = jfa.flash_attention_fwd(jq, jk, jv, causal=causal,
                                         interpret=True)
    jgrads = [np.asarray(g) for g in jfa.flash_attention_bwd(
        jq, jk, jv, jout, jlse, jdo, causal=causal, interpret=True)]
    lse = np.array(jlse, np.float32)
    delta = (np.asarray(jout) * do).sum(-1, dtype=np.float32).reshape(
        B * H, T)

    got = _emulate(q, k, v, do, lse, delta, causal, mm_3xtf32_chunks)
    x64 = [np.zeros(q.shape) for _ in range(3)]
    for b in range(B):
        for h in range(H):
            for x, g in zip(x64, bwd_f64(q[b, h], k[b, h], v[b, h],
                                         do[b, h], lse[b * H + h],
                                         delta[b * H + h], causal)):
                x[b, h] = g
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tl, td = torch.from_numpy(lse), torch.from_numpy(delta)
    plain = [t_fa.flash_attention_dq_ref(tq, tk, tv, tdo, tl, td, causal),
             *t_fa.flash_attention_dkv_ref(tq, tk, tv, tdo, tl, td, causal)]
    for name, g, x, j, pl in zip(("dq", "dk", "dv"), got, x64, jgrads,
                                 plain):
        assert _rel(g, x) <= TOL, (name, _rel(g, x))
        assert _rel(g, j) <= TOL, (name, _rel(g, j))
        assert _rel(g, pl.numpy()) <= TOL, (name, _rel(g, pl.numpy()))
    one_pass = _emulate(q, k, v, do, lse, delta, causal, mm_tf32_chunks)
    assert max(_rel(g, x) for g, x in zip(one_pass, x64)) > TOL


# -- lane level: the seven products as the kernels load their registers -----

def _mma_3xtf32(c, a, b):
    """c += a b as mma_3xtf32: per-lane registers split into big and small,
    three m16n8k8 TF32 products, small terms first."""
    ab, as_ = split_raw(a)
    bb, bs = split_raw(b)
    for x, y in ((as_, bb), (ab, bs), (ab, bb)):
        c = c + mma_m16n8k8_tf32(x, y)
    return c


def scores_3xtf32(a_smem, warp, b_smem, DP):
    """scores_3xtf32: the warp's 16 A rows (ldmatrix at (warp·16 +
    a_row) · LD + tf32_a_col + 8c) against the 64 rows of B (ldmatrix at
    (16 np + b_row) · LD + tf32_b_col + 8c); C fragments [8, 32, 4]."""
    LD = DP + 4
    s = np.zeros((BT // 8, 32, 4))
    for c in range(DP // 8):
        a = ldmatrix_x4_f32(a_smem, LD, warp * 16 + a_row(LANES),
                            4 * a_col16(LANES) + 8 * c)
        for np_ in range(BT // 16):
            b = ldmatrix_x4_f32(b_smem, LD, np_ * 16 + b_row(LANES),
                                4 * b_col16(LANES) + 8 * c)
            s[2 * np_] = _mma_3xtf32(s[2 * np_], a, b[:, 0:2])
            s[2 * np_ + 1] = _mma_3xtf32(s[2 * np_ + 1], a, b[:, 2:4])
    return s


def accumulate_3xtf32(acc, p, m_smem, DP, fresh):
    """accumulate_3xtf32: A from the score accumulators p (acc_to_a_tf32:
    c0, c2, c1, c3), B from rows 2t and 2t + 1 of each 8-row chunk of the
    tile, column 8n + g (ld_v_tf32); `fresh`: 8 n-tiles a pass summed into
    zeroed fragments, then added to acc, else straight into acc."""
    LD = DP + 4
    NG = 8 if fresh else DP // 8
    for n0 in range(0, DP // 8, NG):
        part = np.zeros((NG, 32, 4)) if fresh else acc[n0:n0 + NG]
        for kc in range(BT // 8):
            a = p[kc][:, [0, 2, 1, 3]]
            for n in range(NG):
                addr = (kc * 8 + 2 * TQ) * LD + (n0 + n) * 8 + G
                b = np.stack([m_smem[addr], m_smem[addr + LD]], 1)
                part[n] = _mma_3xtf32(part[n], a, b)
        if fresh:
            acc[n0:n0 + NG] += part
    return acc


def _smem(x, DP):
    """A 64-row tile in shared memory: f32 rows of stride DP + 4, zero
    padded past the head dim."""
    LD = DP + 4
    s = np.zeros(x.shape[0] * LD, np.float32)
    s.reshape(-1, LD)[:, :x.shape[1]] = x
    return s


def _c_frags(x):
    """A [16, 8 n] matrix as n C fragments [n, 32, 4]: lane (g, t) holds
    (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) of each 8 columns."""
    return np.stack([np.stack([x[G, 8 * n + 2 * TQ], x[G, 8 * n + 2 * TQ + 1],
                               x[G + 8, 8 * n + 2 * TQ],
                               x[G + 8, 8 * n + 2 * TQ + 1]], 1)
                     for n in range(x.shape[1] // 8)])


@pytest.mark.parametrize("DP", [64, 128])
def test_dq_kernel_lane_maps_give_the_matrix_products(DP):
    """flash_dq_tf32_kernel, each of its 4 warps: S = Q Kᵀ and dP = dO Vᵀ
    from ldmatrix fragments, dQ += dS K with dS taken from the
    accumulators and K by key rows.  The operands are small integers, so
    every product is exact and the maps must give the matrix products."""
    rng = np.random.RandomState(DP)
    D = DP - 3  # zero padding past d inside the tile
    q, k, v, do = (rng.randint(-4, 5, (BT, D)).astype(np.float32)
                   for _ in range(4))
    qs, ks, vs, dos = (_smem(x, DP) for x in (q, k, v, do))
    for warp in range(4):
        w = slice(warp * 16, warp * 16 + 16)
        s = scores_3xtf32(qs, warp, ks, DP)
        np.testing.assert_array_equal(c_to_matrix(s, 8), q[w] @ k.T)
        dp = scores_3xtf32(dos, warp, vs, DP)
        np.testing.assert_array_equal(c_to_matrix(dp, 8), do[w] @ v.T)
        ds = rng.randint(-4, 5, (16, BT)).astype(np.float64)
        acc = accumulate_3xtf32(np.zeros((DP // 8, 32, 4)), _c_frags(ds),
                                ks, DP, fresh=True)
        np.testing.assert_array_equal(c_to_matrix(acc, DP // 8)[:, :D],
                                      ds @ k)


@pytest.mark.parametrize("DP", [64, 128])
def test_dkv_kernel_lane_maps_give_the_matrix_products(DP):
    """flash_dkv_tf32_kernel, each warp's 16 K rows: Sᵀ = K Qᵀ and dPᵀ =
    V dOᵀ from ldmatrix fragments, dV += Pᵀ dO and dK += dSᵀ Q from the
    accumulators and dO or Q by query rows; and the lse (and delta) each
    lane reads as a float2 at 8n + 2t is its elements' column's."""
    rng = np.random.RandomState(DP + 1)
    D = DP - 3
    q, k, v, do = (rng.randint(-4, 5, (BT, D)).astype(np.float32)
                   for _ in range(4))
    qs, ks, vs, dos = (_smem(x, DP) for x in (q, k, v, do))
    lse = rng.randn(BT)
    fresh = DP == 64  # flash_dkv_tf32_kernel's kFresh
    for warp in range(4):
        w = slice(warp * 16, warp * 16 + 16)
        st = scores_3xtf32(ks, warp, qs, DP)
        np.testing.assert_array_equal(c_to_matrix(st, 8), k[w] @ q.T)
        dpt = scores_3xtf32(vs, warp, dos, DP)
        np.testing.assert_array_equal(c_to_matrix(dpt, 8), v[w] @ do.T)
        pt, dst = (rng.randint(-4, 5, (16, BT)).astype(np.float64)
                   for _ in range(2))
        dv = accumulate_3xtf32(np.zeros((DP // 8, 32, 4)), _c_frags(pt),
                               dos, DP, fresh)
        np.testing.assert_array_equal(c_to_matrix(dv, DP // 8)[:, :D],
                                      pt @ do)
        dk = accumulate_3xtf32(np.zeros((DP // 8, 32, 4)), _c_frags(dst),
                               qs, DP, fresh)
        np.testing.assert_array_equal(c_to_matrix(dk, DP // 8)[:, :D],
                                      dst @ q)
    # element e of n-tile n takes lv.x (e even) or lv.y of lb[8n + 2t]
    lanes = np.stack([np.stack([lse[8 * n + 2 * TQ + (e & 1)]
                                for e in range(4)], 1)
                      for n in range(BT // 8)])
    np.testing.assert_array_equal(c_to_matrix(lanes, 8),
                                  np.broadcast_to(lse, (16, BT)))


# -- shared-memory banks -----------------------------------------------------

def _assert_ldmatrix_free(addr):
    """ldmatrix.x4: each 8-lane phase reads eight 16-byte rows, which must
    cover the 32 banks once."""
    for i in range(4):
        words = addr[8 * i:8 * i + 8, None] + np.arange(4)
        assert len(set((words % 32).ravel())) == 32, addr


def _assert_lds_free(words, width=1):
    """A 4-byte (or 8-byte, width 2) load of a warp: distinct addresses of
    one phase (32 lanes, or each half-warp for 8 bytes) lie in distinct
    banks; equal addresses are a broadcast."""
    lanes = 32 // width
    for h in range(0, 32, lanes):
        seen = {}
        for w0 in set(words[h:h + lanes].tolist()):
            for w in range(w0, w0 + width):
                assert seen.setdefault(w % 32, w) == w, words
    return True


def _kernel_loads(kind, DP):
    """Every shared-memory load of one kernel, per warp and ring slot:
    ('ldsm', lane row addresses), ('lds', lane words) or ('lds2', lane
    words of a float2), in f32 words from the start of dynamic shared
    memory, the layouts of dq_tf32_smem_bytes and dkv_tf32_smem_bytes."""
    LD = DP + 4
    tile = BT * LD
    if kind == "dq":
        a_tiles = [0, tile]                           # Q, dO
        b_tiles = [2 * tile + s * tile for s in range(2)]  # K ring
        b_tiles += [4 * tile + s * tile for s in range(2)]  # V ring
        row_tiles = b_tiles[:2]                       # K by key rows
        lse_rows = []
    else:
        a_tiles = [0, tile]                           # K, V
        b_tiles = [2 * tile + s * tile for s in range(2)]  # Q ring
        b_tiles += [4 * tile + s * tile for s in range(2)]  # dO ring
        row_tiles = b_tiles                           # Q and dO by rows
        lse_rows = [6 * tile + s * BT for s in range(4)]  # lse, delta
    loads = []
    for warp in range(4):
        for c in range(DP // 8):
            for base in a_tiles:
                loads.append(("ldsm", base + (warp * 16 + a_row(LANES)) * LD
                              + 4 * a_col16(LANES) + 8 * c))
            for base in b_tiles:
                for np_ in range(BT // 16):
                    loads.append(("ldsm", base + (np_ * 16 + b_row(LANES))
                                  * LD + 4 * b_col16(LANES) + 8 * c))
        for base in row_tiles:
            for kc in range(BT // 8):
                for n in range(DP // 8):
                    for dr in (0, 1):
                        loads.append(("lds", base + (kc * 8 + 2 * TQ + dr)
                                      * LD + n * 8 + G))
        for base in lse_rows:
            for n in range(BT // 8):
                loads.append(("lds2", base + n * 8 + 2 * TQ))
    return loads


@pytest.mark.parametrize("kind", ["dq", "dkv"])
@pytest.mark.parametrize("DP", [64, 128])
def test_backward_tf32_loads_are_free_of_bank_conflicts(kind, DP):
    """Row stride DP + 4 f32 and tiles that start on a bank boundary:
    every ldmatrix phase, every ld_v_tf32 row read (rows 2t, 2t + 1,
    column 8n + g: banks 8t + g) and every float2 read of lse and delta
    is free of bank conflicts, in every warp and ring slot."""
    loads = _kernel_loads(kind, DP)
    assert len(loads) > 0
    for op, addr in loads:
        if op == "ldsm":
            _assert_ldmatrix_free(addr)
        else:
            _assert_lds_free(addr, 2 if op == "lds2" else 1)
    # the layouts' byte sizes, as the launchers compute them
    tile_bytes = BT * (DP + 4) * 4
    assert {"dq": 6 * tile_bytes, "dkv": 6 * tile_bytes + 4 * BT * 4}[kind] \
        <= 232448
