"""The f32 backwards of the fused BatchNorm -> convolution kernels on the
tensor cores in 3xTF32 (K12 ``bn_matmul_bwd``, ``csrc/bn_matmul.cu``
``bnmm_bwd_da_mma`` / ``bnmm_bwd_dw_mma``; K15 ``bn_conv3x3_bwd``,
``csrc/bn_conv.cu`` ``bnc_bwd_da_mma`` / ``bnc_pad_prep`` /
``bnc_bwd_dw_mma``; the tile loop and epilogue of ``csrc/bn_mma.cuh``),
emulated in numpy on the CPU.

The kernels run only on a card (``test_torch_kernels.py`` holds them
against their plain versions there).  What is checked here:

- the grid and split maps: dX, dR and dW written once each, K15's
  transposed taps taking each output pixel's dO once for every input
  pixel it reaches (stride 2 by the parity test, odd H), every split of
  the dW reduction covering the output pixels once, every staged chunk
  inside its tensor, for K, O in {64, 96, 128, 256, 512}, stride 1 and 2,
  with and without a residual;
- the f32 staging maps (16-byte chunks of 4 f32: [64][BK] tiles of
  BK 16 and 32, [BK][64] tiles) and the epilogue's thread map (4-channel
  chunks, rows tid / 16 + 8 i) covering each tile once;
- the lane maps of both products: dA's A (gathered dO rows) and B (W
  rows k) by ldmatrix as 8 x 4 f32 matrices, dW's transposed A (X or
  apad rows, contiguous along k) and B (dO rows) by 32-bit lane loads,
  each warp's 3xTF32 fragments giving the tile's product, every load free
  of bank conflicts;
- the f32 split rule (eight 128-thread blocks an SM, chunks of 32):
  the reduction covered once, from the shapes alone;
- the arithmetic: both backwards from 3xTF32 products (small halves
  unrounded), each reduction step summed from zero and added in f32,
  the splits summed in ``sum_splits``' order, the dgamma / dbeta tile
  sums in the epilogue's order and over tiles in f64; within 1e-5 of the
  plain version in float64 and 1e-4 of the JAX package's
  ``bn_matmul_bwd`` and ``bn_conv3x3_bwd`` in interpret mode, where one
  TF32 pass misses 1e-4.

The lane helpers are ``test_torch_flash_mma.py``'s, ``split_raw``
``test_torch_flash_bwd_tf32.py``'s and the ldmatrix bank check
``test_torch_bn_conv_tf32.py``'s.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda_kernels import bn_conv as t_bnc
from paddle_tpu_torch.ops.cuda_kernels import bn_matmul as t_bnmm
from test_torch_bn_conv_tf32 import _ldmatrix_free
from test_torch_flash_bwd_tf32 import split_raw
from test_torch_flash_mma import (G, LANES, TQ, a_col16, a_row, b_col16,
                                  b_row, c_to_matrix, ldmatrix_x4_f32,
                                  mma_m16n8k8_tf32, tf32)

BM = BN = 64      # the tile
THREADS = 128     # 4 warps of 32 x 32
E = 4             # f32 elements a 16-byte chunk
LD_RM = BM + 8    # a [reduction][row] tile's row stride (72 words)
# the reduction steps of the f32 bodies: a step is 64 bytes of a row in
# K12 (16 f32) and 128 in K15 (32 f32), as in bf16
BK_K12, BK_K15 = 16, 32
SMEM_STATIC = 48 * 1024  # static shared memory a block
TOL = 1e-4  # the f32 kernels' tolerance, relative to max |value|


def cdiv(a, b):
    return -(-a // b)


def ld_rr(bk):
    """A [row][reduction] tile's row stride in f32: BK + 16 bytes."""
    return bk + E


# -- staging and epilogue maps ----------------------------------------------

def rr_chunks(bk):
    """(row, col) of every 16-byte chunk of a [64][bk] f32 tile: thread
    tid takes chunks tid, tid + 128, ...; bk / 4 chunks a row."""
    e = np.arange(BM * bk // E)
    return e // (bk // E), (e % (bk // E)) * E


def rm_chunks(bk):
    """(row, col) of every chunk of a [bk][64] f32 tile, 16 a row."""
    e = np.arange(bk * BM // E)
    return e // (BM // E), (e % (BM // E)) * E


@pytest.mark.parametrize("bk", [BK_K12, BK_K15])
def test_f32_chunk_maps_cover_each_tile_once(bk):
    """Each thread stages tile_chunks = 64 bk / 512 whole chunks (2 at
    16, 4 at 32); the chunks cover a [64][bk] and a [bk][64] tile once."""
    for (r, c), shape in ((rr_chunks(bk), (BM, bk)),
                          (rm_chunks(bk), (bk, BM))):
        assert r.size % THREADS == 0
        assert r.size // THREADS == BM * bk * 4 // (16 * THREADS)
        seen = np.zeros(shape, int)
        for u in range(E):
            np.add.at(seen, (r, c + u), 1)
        assert (seen == 1).all()


def epilogue_cells():
    """bn_mma.cuh da_epilogue in f32: thread tid, chunk (tid % 16) * 4,
    rows tid / 16 + 8 i, i < 8."""
    for tid in range(THREADS):
        cc = (tid % 16) * E
        for i in range(8):
            yield tid, tid // 16 + 8 * i, cc


def test_f32_epilogue_map_covers_the_tile_once_and_sums_by_chunk():
    """The epilogue's 16-byte chunks cover the 64 x 64 C tile once; the
    xor-16 shuffle pairs the two lanes of a warp that hold one chunk; each
    8-lane phase of a float4 read lies in one row (32 distinct banks)."""
    seen = np.zeros((BM, BN), int)
    for _, r, cc in epilogue_cells():
        seen[r, cc:cc + E] += 1
    assert (seen == 1).all()
    for tid in range(THREADS):
        other = (tid & ~31) | ((tid & 31) ^ 16)
        assert other % 16 == tid % 16 and other // 32 == tid // 32
    ld = BN + 8
    for i in range(8):
        for q in range(0, THREADS, 8):
            words = np.array([(t // 16 + 8 * i) * ld + (t % 16) * E
                              for t in range(q, q + 8)])
            banks = (words[:, None] + np.arange(E)) % 32
            assert len(set(banks.ravel())) == 32


def test_f32_rings_fit_static_shared_memory():
    """The f32 rings take the bf16 ones' bytes: K12's dA two [64][20]
    tiles and dW three [16][72] a stage, K15's two [64][36] or two
    [32][72], all under the 48 KB of static shared memory with the
    epilogue's C tile over the dA ring and its column sums beside it."""
    c_tile = BM * (BN + 8) * 4
    extras = 4 * BN * 4 + 2 * 4 * BN * 4
    k12_da = 3 * 2 * BM * ld_rr(BK_K12) * 4
    k12_dw = 3 * 3 * BK_K12 * LD_RM * 4
    k15_da = 2 * 2 * BM * ld_rr(BK_K15) * 4
    k15_dw = 2 * 2 * BK_K15 * LD_RM * 4
    assert (k12_da, k12_dw, k15_da, k15_dw) == (30720, 41472, 36864, 36864)
    for ring in (k12_da, k15_da):
        assert max(ring, c_tile) + extras <= SMEM_STATIC
    assert max(k12_dw, k15_dw) <= SMEM_STATIC


# -- the grid and split maps ---------------------------------------------------

def chunk_len(c, n):
    return np.clip(n - c, 0, E)


def k12_maps(M, K, N):
    """K12's grids: dX (and dR) from the dA grid's epilogue map, dW from
    the (K tile, N tile, split) grid's store map; every staged chunk of
    dO, W, X, R inside its tensor."""
    tiles_m, tiles_k = cdiv(M, BM), cdiv(K, BN)
    dx = np.zeros((M, K), int)
    ar, ac = rr_chunks(BK_K12)
    for b in range(tiles_m * tiles_k):
        mt, kt = divmod(b, tiles_k)
        row0, col0 = mt * BM, kt * BN
        for n0 in range(0, N, BK_K12):
            m, k = row0 + ar, col0 + ar
            na = np.where(m < M, chunk_len(n0 + ac, N), 0)
            nb = np.where(k < K, chunk_len(n0 + ac, N), 0)
            for idx, n, size in (((m * N + n0 + ac), na, M * N),
                                 ((k * N + n0 + ac), nb, K * N)):
                assert ((idx + n <= size) & (idx >= 0))[n > 0].all()
        for _, r, cc in epilogue_cells():
            nk = chunk_len(col0 + cc, K)
            if row0 + r < M:
                dx[row0 + r, col0 + cc:col0 + cc + nk] += 1
    assert (dx == 1).all()
    s, chunk = t_bnmm.splits(cdiv(K, BM) * cdiv(N, BN), M, torch.float32)
    red = np.zeros(M, int)
    dw = np.zeros((s, K, N), int)
    xr, xc = rm_chunks(BK_K12)
    for z in range(s):
        r_begin, r_end = z * chunk, min(M, z * chunk + chunk)
        red[r_begin:r_end] += 1
        for kt in range(cdiv(K, BM)):
            for nt in range(cdiv(N, BN)):
                row0, col0 = kt * BM, nt * BN
                for m0 in range(r_begin, r_end, BK_K12):
                    m = m0 + xr
                    nx = np.where(m < r_end, chunk_len(row0 + xc, K), 0)
                    nd = np.where(m < r_end, chunk_len(col0 + xc, N), 0)
                    for idx, n, size in ((m * K + row0 + xc, nx, M * K),
                                         (m * N + col0 + xc, nd, M * N)):
                        assert ((idx + n <= size) & (idx >= 0))[n > 0].all()
                dw[z, row0:row0 + BM, col0:col0 + BN] += 1
    assert (red == 1).all()
    assert (dw == 1).all()
    return dx


@pytest.mark.parametrize("C", [64, 96, 128, 256, 512])
def test_k12_grid_and_splits_cover_dx_dr_dw_once(C):
    """K12 at K = N = C over a ragged M (two tiles and a tail), and at
    K 512, N = C: dX (and dR, written by the same map, its R chunks
    staged at X's offsets) and every split's dW once."""
    for M, K, N in ((2 * BM + 37, C, C), (BM + 5, 512, C)):
        k12_maps(M, K, N)


def k15_maps(N, H, W, K, O, s):
    """K15's grids: the dA grid's gathered taps as (input pixel, tap,
    output pixel) triples and its epilogue map over dX; the dW grid's
    splits and apad / dO chunks per tap."""
    Ho, Wo = (H - 1) // s + 1, (W - 1) // s + 1
    P, M_out = N * H * W, N * Ho * Wo
    tiles_k = cdiv(K, BN)
    ar, ac = rr_chunks(BK_K15)
    triples = set()
    dx = np.zeros((P, K), int)
    for b in range(cdiv(P, BM) * tiles_k):
        mt, kt = divmod(b, tiles_k)
        row0, col0 = mt * BM, kt * BN
        p = row0 + ar[::8]  # a thread's four pixels (one chunk a row)
        n, t = divmod(p, H * W)
        h, w = divmod(t, W)
        for tap in range(9):
            dy, dxx = divmod(tap, 3)
            ho, wo = h + 1 - dy, w + 1 - dxx
            v = (p < P) & (ho >= 0) & (wo >= 0)
            if s == 2:
                v &= ((ho | wo) & 1) == 0
                ho, wo = ho >> 1, wo >> 1
            v &= (ho < Ho) & (wo < Wo)
            if kt == 0:
                for pi, q in zip(p[v], ((n * Ho + ho) * Wo + wo)[v]):
                    triples.add((int(pi), tap, int(q)))
            for o0 in range(0, O, BK_K15):
                na = chunk_len(o0 + ac[:8], O)
                src = ((n * Ho + ho) * Wo + wo)[:, None] * O + o0 + ac[:8]
                ok = v[:, None] & (na > 0)[None]
                assert (src[ok] >= 0).all()
                assert (src + na[None] <= M_out * O)[ok].all()
        for _, r, cc in epilogue_cells():
            nk = chunk_len(col0 + cc, K)
            if row0 + r < P:
                dx[row0 + r, col0 + cc:col0 + cc + nk] += 1
    assert (dx == 1).all()
    # the convolution's adjacency: output pixel q takes input pixel
    # (ho s - 1 + ky, wo s - 1 + kx) through tap (ky, kx), where inside
    want = set()
    for q in range(M_out):
        n, t = divmod(q, Ho * Wo)
        ho, wo = divmod(t, Wo)
        for tap in range(9):
            dy, dxx = divmod(tap, 3)
            hi, wi = ho * s - 1 + dy, wo * s - 1 + dxx
            if 0 <= hi < H and 0 <= wi < W:
                want.add(((n * H + hi) * W + wi, tap, q))
    assert triples == want
    s_, chunk = t_bnmm.splits(9 * cdiv(K, BM) * cdiv(O, BN), M_out,
                              torch.float32)
    xr, xc = rm_chunks(BK_K15)
    apad_size = N * (H + 2) * (W + 2) * K
    for tap in range(9):
        dy, dxx = divmod(tap, 3)
        red = np.zeros(M_out, int)
        for z in range(s_):
            r_begin, r_end = z * chunk, min(M_out, z * chunk + chunk)
            red[r_begin:r_end] += 1
            for m0 in range(r_begin, r_end, BK_K15):
                m = m0 + xr
                ok = m < r_end
                n, t = divmod(m, Ho * Wo)
                ho, wo = divmod(t, Wo)
                base = ((n * (H + 2) + ho * s + dy) * (W + 2) + wo * s +
                        dxx) * K
                for row0 in range(0, K, BM):
                    na = np.where(ok, chunk_len(row0 + xc, K), 0)
                    off = base + row0 + xc
                    assert ((off >= 0) & (off + na <= apad_size))[na > 0].all()
                for col0 in range(0, O, BN):
                    nd = np.where(ok, chunk_len(col0 + xc, O), 0)
                    off = m * O + col0 + xc
                    assert ((off >= 0) &
                            (off + nd <= M_out * O))[nd > 0].all()
        assert (red == 1).all()


@pytest.mark.parametrize("C", [64, 96, 128, 256, 512])
@pytest.mark.parametrize("H,W,s", [(6, 6, 1), (7, 5, 2), (8, 8, 2)])
def test_k15_grid_taps_and_splits_cover_once(C, H, W, s):
    """K15 at K = O = C and at K 64, O = C: each output pixel's dO reaches
    each input pixel it touches once, through the right tap (odd H and W
    at stride 2: the parity test); dX (and dR, same map) written once;
    each tap's splits cover the output pixels once; chunks in bounds."""
    for K, O in ((C, C), (64, C)):
        k15_maps(2, H, W, K, O, s)


def test_f32_split_rule_covers_the_reduction_from_the_shapes():
    """splits() for f32: about eight blocks an SM of 132, chunks a
    multiple of 32 (so of K15's 32-row and K12's 16-row steps), the
    splits covering the reduction once; the same answer on every call
    (reruns sum alike)."""
    for tiles in (1, 4, 9, 36, 144, 576, 2304):
        for red in (1, 31, 32, 255, 4096, 12544, 100352, 401408):
            s, chunk = t_bnmm.splits(tiles, red, torch.float32)
            assert (s, chunk) == t_bnmm.splits(tiles, red, torch.float32)
            assert chunk % 32 == 0 and s >= 1
            assert (s - 1) * chunk < red <= s * chunk
            assert s <= max(1, cdiv(132 * 8, tiles))
    # stage 2's shapes: K15 (K = O = 128) and K12 (K 512, N 128)
    assert t_bnmm.splits(9 * 2 * 2, 128 * 28 * 28, torch.float32) == \
        (30, 3360)
    assert t_bnmm.splits(8 * 2, 128 * 28 * 28, torch.float32) == (66, 1536)


# -- the lane maps ----------------------------------------------------------

def warps():
    """(wr, wc) of the 2 x 2 warps of the 64 x 64 tile."""
    return [((w >> 1) * 32, (w & 1) * 32) for w in range(4)]


def frag_a_rr(sa, ld, wr, kk):
    """f32 A from a [64][ld] tile by ldmatrix: rows wr + 16 mi + a_row,
    columns kk + tf32_a_col (a0..a3 = (g, t), (g+8, t), (g, t+4),
    (g+8, t+4))."""
    return [ldmatrix_x4_f32(sa, ld, wr + 16 * mi + a_row(LANES),
                            kk + 4 * a_col16(LANES)) for mi in range(2)]


def frag_b_rr(sb, ld, wc, kk):
    """f32 B of four n-tiles from a [n][k] tile by ldmatrix (b_row,
    tf32_b_col): registers 0, 1 of n-tile 2p, 2, 3 of 2p + 1."""
    out = []
    for p in range(2):
        r = ldmatrix_x4_f32(sb, ld, wc + 16 * p + b_row(LANES),
                            kk + 4 * b_col16(LANES))
        out += [r[:, 0:2], r[:, 2:4]]
    return out


def a_rm_words(wr, kk, mi):
    """Word of each A register of a lane from a [k][m] tile: rows kk + t,
    kk + t + 4, columns wr + 16 mi + g, + 8."""
    c = wr + 16 * mi + G
    return np.stack([(kk + TQ) * LD_RM + c, (kk + TQ) * LD_RM + c + 8,
                     (kk + TQ + 4) * LD_RM + c,
                     (kk + TQ + 4) * LD_RM + c + 8], 1)


def b_rm_words(wc, kk, nj):
    """Word of b0, b1 of a lane from a [k][n] tile: rows kk + t, kk + t +
    4, column wc + 8 nj + g."""
    c = wc + 8 * nj + G
    return np.stack([(kk + TQ) * LD_RM + c, (kk + TQ + 4) * LD_RM + c], 1)


def warp_products(layout, sa, sb, ld, bk):
    """The 64 x 64 tile from each warp's 3xTF32 fragments (split_raw, as
    mma_3xtf32 issues them), placed by the C map, each cell once."""
    C = np.full((BM, BN), np.nan)
    for wr, wc in warps():
        part = np.zeros((2, 4, 32, 4))
        for kk in range(0, bk, 8):
            if layout == "da":
                a = frag_a_rr(sa, ld, wr, kk)
                b = frag_b_rr(sb, ld, wc, kk)
            else:
                a = [sa[a_rm_words(wr, kk, mi)] for mi in range(2)]
                b = [sb[b_rm_words(wc, kk, nj)] for nj in range(4)]
            for mi in range(2):
                ab, as_ = split_raw(a[mi])
                for nj in range(4):
                    bb, bs = split_raw(b[nj])
                    for x, y in ((as_, bb), (ab, bs), (ab, bb)):
                        part[mi, nj] += mma_m16n8k8_tf32(x, y)
        for mi in range(2):
            rows = slice(wr + 16 * mi, wr + 16 * mi + 16)
            assert np.isnan(C[rows, wc:wc + 32]).all()
            C[rows, wc:wc + 32] = c_to_matrix(part[mi], 4)
    return C


@pytest.mark.parametrize("bk", [BK_K12, BK_K15])
def test_da_lane_maps_give_the_tile_product(bk):
    """dA's product, one step: A = dO rows [64][bk + 4] by ldmatrix, B = W
    rows k [64][bk + 4] (B(o, k) = W[k][o]) by ldmatrix; dA = A Bᵀ
    exactly (small integers: the small halves are 0)."""
    ld = ld_rr(bk)
    rng = np.random.RandomState(bk)
    A = rng.randint(-4, 5, (BM, bk)).astype(np.float32)
    Wk = rng.randint(-4, 5, (BN, bk)).astype(np.float32)
    sa, sb = np.zeros(BM * ld, np.float32), np.zeros(BN * ld, np.float32)
    sa.reshape(BM, ld)[:, :bk] = A
    sb.reshape(BN, ld)[:, :bk] = Wk
    np.testing.assert_array_equal(warp_products("da", sa, sb, ld, bk),
                                  A.astype(np.float64) @ Wk.T)


@pytest.mark.parametrize("bk", [BK_K12, BK_K15])
def test_dw_lane_maps_give_the_tile_product(bk):
    """dW's product, one step: the transposed A (X or apad rows m,
    contiguous along k: a [bk][72] tile) and B = dO rows m ([bk][72]) by
    32-bit lane loads; dW = Aᵀ B exactly."""
    rng = np.random.RandomState(bk + 1)
    X = rng.randint(-4, 5, (bk, BM)).astype(np.float32)
    D = rng.randint(-4, 5, (bk, BN)).astype(np.float32)
    sa, sb = np.zeros(bk * LD_RM, np.float32), np.zeros(bk * LD_RM,
                                                         np.float32)
    sa.reshape(bk, LD_RM)[:, :BM] = X
    sb.reshape(bk, LD_RM)[:, :BN] = D
    np.testing.assert_array_equal(warp_products("dw", sa, sb, LD_RM, bk),
                                  X.T.astype(np.float64) @ D)


@pytest.mark.parametrize("bk", [BK_K12, BK_K15])
def test_f32_loads_are_free_of_bank_conflicts(bk):
    """Every warp, every 8-deep step: dA's ldmatrix phases (row stride
    bk + 4 words: 20 or 36) each cover the 32 banks once; each lane load
    of dW's A (a0..a3) and B (b0, b1) from the 72-word rows names 32
    distinct banks (8 t + g plus a constant); the in-place prologue's
    float2 pairs of one row in two phases of 16 lanes."""
    ld = ld_rr(bk)
    for wr, wc in warps():
        for kk in range(0, bk, 8):
            for mi in range(2):
                _ldmatrix_free((wr + 16 * mi + a_row(LANES)) * ld + kk +
                               4 * a_col16(LANES))
                words = a_rm_words(wr, kk, mi)
                for j in range(4):
                    assert len(set(words[:, j] % 32)) == 32
            for p in range(2):
                _ldmatrix_free((wc + 16 * p + b_row(LANES)) * ld + kk +
                               4 * b_col16(LANES))
            for nj in range(4):
                words = b_rm_words(wc, kk, nj)
                for j in range(2):
                    assert len(set(words[:, j] % 32)) == 32
    # K12's post(): lane l of a warp takes channels 2 l, 2 l + 1 of one row
    for half in (slice(0, 16), slice(16, 32)):
        w = 2 * LANES[half]
        assert len(set(np.concatenate([w, w + 1]) % 32)) == 32


# -- the arithmetic -----------------------------------------------------------

def mm_step(a, b, one_pass=False):
    """One reduction step's products from zero: for each 8-deep chunk,
    a_small b_big, a_big b_small, a_big b_big (split_raw), each added in
    f32 (one TF32 pass with `one_pass`)."""
    part = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for c in range(0, a.shape[1], 8):
        x, y = a[:, c:c + 8], b[c:c + 8]
        if one_pass:
            part = part + tf32(x) @ tf32(y)
            continue
        xb, xs = split_raw(x)
        yb, ys = split_raw(y)
        for p, q in ((xs, yb), (xb, ys), (xb, yb)):
            part = part + p @ q
    return part


def walk(steps, one_pass=False):
    """The running sums of a block: each step's products from zero, then
    added in f32.  `steps` yields (a, b) per step, in the kernel's order."""
    acc = None
    for a, b in steps:
        part = mm_step(a, b, one_pass)
        acc = part if acc is None else acc + part
    return acc


def sum_splits(part, dtype=np.float32):
    """launch_sum_splits / sum_tiles_f64 over the first axis: lane y sums
    s = y, y + 16, ... in order, then the 16 lane sums in order."""
    lanes = []
    for y in range(16):
        s = np.zeros(part.shape[1:], dtype)
        for i in range(y, part.shape[0], 16):
            s = s + part[i].astype(dtype)
        lanes.append(s)
    t = np.zeros(part.shape[1:], dtype)
    for s in lanes:
        t = t + s
    return t.astype(np.float32)


def epilogue(dA, x, r, mu, inv, gam, b, act):
    """da_epilogue in f32 over dA [P, K]: the mask from pre_act's
    separately rounded chain, dX = dpre gi, dR = dpre, and each 64-row
    tile's column sums in the kernel's order (a thread over its rows tid /
    16 + 8 i in order, the xor-16 pair, the four warps in order), then
    over tiles in f64."""
    gi = inv * gam
    pre = (x - mu) * gi + b
    if r is not None:
        pre = pre + r
    dpre = np.where(pre > 0, dA, np.float32(0)) if act == "relu" else dA
    xhat = (x - mu) * inv
    P, K = dA.shape
    tiles = cdiv(P, BM)
    gb = np.zeros((tiles, 2, K), np.float32)
    for t in range(tiles):
        rows = np.arange(t * BM, min(P, t * BM + BM))
        for which, v in ((0, dpre[rows] * xhat[rows]), (1, dpre[rows])):
            full = np.zeros((BM, K), np.float32)
            full[:len(rows)] = v
            thread = np.zeros((8, K), np.float32)  # tid / 16
            for i in range(8):
                thread = thread + full[np.arange(8) + 8 * i]
            warp = thread[0::2] + thread[1::2]
            s = np.zeros(K, np.float32)
            for w in range(4):
                s = s + warp[w]
            gb[t, which] = s
    dgb = sum_splits(gb, np.float64)
    return dpre * gi, dgb[0], dgb[1], dpre


def closed_forms(inv, gam, dgamma, dbeta):
    return -inv * gam * dbeta, np.float32(-0.5) * inv * inv * gam * dgamma


def prologue_f32(x, r, mu, gi, b, act):
    v = (x - mu) * gi + b
    if r is not None:
        v = v + r
    return np.maximum(v, np.float32(0)) if act == "relu" else v


def k12_tf32(x, r, mu, inv, gam, b, w, do, act, one_pass=False):
    """K12's f32 body on f32 inputs: (dx, dγ, dβ, dmean, dvar, dw, dr)."""
    M, K = x.shape
    N = w.shape[1]
    dA = walk(((do[:, n0:n0 + BK_K12], w[:, n0:n0 + BK_K12].T)
               for n0 in range(0, N, BK_K12)), one_pass)
    dx, dgamma, dbeta, dpre = epilogue(dA, x, r, mu, inv, gam, b, act)
    a = prologue_f32(x, r, mu, inv * gam, b, act)
    s, chunk = t_bnmm.splits(cdiv(K, BM) * cdiv(N, BN), M, torch.float32)
    part = np.stack([walk(((a[m0:min(m0 + BK_K12, z * chunk + chunk)].T,
                            do[m0:min(m0 + BK_K12, z * chunk + chunk)])
                           for m0 in range(z * chunk, min(M, z * chunk +
                                                          chunk), BK_K12)),
                          one_pass) for z in range(s)])
    dmean, dvar = closed_forms(inv, gam, dgamma, dbeta)
    return dx, dgamma, dbeta, dmean, dvar, sum_splits(part), dpre


def gather_taps(do, H, W, s):
    """dA's A per tap: [N H W, O], the output pixel an input pixel takes
    through the tap ((h + 1 - ky) / s where whole and inside), else 0."""
    N, Ho, Wo, O = do.shape
    n, h, w = np.meshgrid(np.arange(N), np.arange(H), np.arange(W),
                          indexing="ij")
    out = []
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        ho, wo = h + 1 - dy, w + 1 - dx
        ok = (ho >= 0) & (wo >= 0)
        if s == 2:
            ok &= ((ho | wo) & 1) == 0
            ho, wo = ho // 2, wo // 2
        ok &= (ho < Ho) & (wo < Wo)
        g = np.where(ok[..., None], do[n, np.clip(ho, 0, Ho - 1),
                                       np.clip(wo, 0, Wo - 1)],
                     np.float32(0))
        out.append(g.reshape(-1, O))
    return out


def k15_tf32(x, r, mu, inv, gam, b, w, do, act, s, one_pass=False):
    """K15's f32 body on f32 inputs: dA over (tap, 32-channel o step),
    the epilogue, the prep pass, dW per tap over each split's 32-pixel
    steps, the fixed-order sums."""
    N, H, W, K = x.shape
    O = w.shape[3]
    Ho, Wo = do.shape[1:3]
    taps = gather_taps(do, H, W, s)
    dA = walk(((taps[t][:, o0:o0 + BK_K15],
                w[t // 3, t % 3][:, o0:o0 + BK_K15].T)
               for t in range(9) for o0 in range(0, O, BK_K15)), one_pass)
    flat = lambda v: None if v is None else v.reshape(-1, K)  # noqa: E731
    dx, dgamma, dbeta, dpre = epilogue(dA, flat(x), flat(r), mu, inv, gam,
                                       b, act)
    v = prologue_f32(x, r, mu, inv * gam, b, act)
    apad = np.zeros((N, H + 2, W + 2, K), np.float32)
    apad[:, 1:H + 1, 1:W + 1] = v
    d2 = do.reshape(-1, O)
    M_out = d2.shape[0]
    sp, chunk = t_bnmm.splits(9 * cdiv(K, BM) * cdiv(O, BN), M_out,
                              torch.float32)
    dw = np.zeros((3, 3, K, O), np.float32)
    for tap in range(9):
        dy, dxx = divmod(tap, 3)
        A = apad[:, dy:dy + s * (Ho - 1) + 1:s,
                 dxx:dxx + s * (Wo - 1) + 1:s].reshape(-1, K)
        part = []
        for z in range(sp):
            end = min(M_out, z * chunk + chunk)
            part.append(walk(((A[m0:min(m0 + BK_K15, end)].T,
                               d2[m0:min(m0 + BK_K15, end)])
                              for m0 in range(z * chunk, end, BK_K15)),
                             one_pass))
        dw[dy, dxx] = sum_splits(np.stack(part))
    dmean, dvar = closed_forms(inv, gam, dgamma, dbeta)
    shape = x.shape
    return (dx.reshape(shape), dgamma, dbeta, dmean, dvar, dw,
            dpre.reshape(shape))


KINK = 1e-3  # the least |ReLU input| of a case held to float64


def _case(xshape, wshape, doshape, has_r, seed):
    """f32 inputs; the f32 statistics as the wrapper computes them; x
    moved clear of the ReLU's kink (each |pre| >= KINK, as
    ``chip_smoke.bn_clear_of_kinks``), so that float64 and the f32 chain
    take the same mask."""
    rng = np.random.RandomState(seed)
    K = xshape[-1]
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    a = {"x": f(rng.randn(*xshape) * 1.5 + 0.3),
         "gamma": f(rng.rand(K) + 0.5), "beta": f(rng.randn(K) * 0.3),
         "mean": f(rng.randn(K) * 0.1 + 0.3), "var": f(rng.rand(K) + 2.0),
         "w": f(rng.randn(*wshape) / np.sqrt(np.prod(wshape[:-1]))),
         "do": f(rng.randn(*doshape)),
         "r": f(rng.randn(*xshape)) if has_r else None}
    gi = a["gamma"].astype(np.float64) / np.sqrt(a["var"] + 1e-5)
    pre = (a["x"] - a["mean"].astype(np.float64)) * gi + a["beta"]
    if has_r:
        pre = pre + a["r"]
    step = np.where(pre >= 0, 2 * KINK, -2 * KINK) / gi
    a["x"] = f(np.where(np.abs(pre) < KINK, a["x"] + step, a["x"]))
    mu, inv, g, b, _ = t_bnmm.stats(*(torch.from_numpy(a[k]) for k in (
        "gamma", "beta", "mean", "var")), 1e-5, torch.float32)
    return a, tuple(t.numpy() for t in (mu, inv, g, b))


def _torch(a, dtype=torch.float64):
    return [None if a[k] is None else torch.from_numpy(a[k]).to(dtype)
            for k in ("x", "gamma", "beta", "mean", "var", "w", "do", "r")]


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


NAMES = ("dx", "dgamma", "dbeta", "dmean", "dvar", "dw", "dr")


def _dists(got, want, has_r):
    """{name: distance} over the outputs (dr only with a residual)."""
    n = 7 if has_r else 6
    return {k: _rel(g, w) for k, g, w in zip(NAMES[:n], got[:n], want[:n])}


@pytest.mark.parametrize("M,K,N,has_r,act", [
    (200, 64, 96, True, "relu"), (130, 128, 64, False, None),
    (256, 512, 128, True, "relu"), (37, 18, 22, False, "relu")])
def test_emulated_k12_within_1e5_of_float64(M, K, N, has_r, act):
    """K12's f32 body against the plain version in float64 from the same
    f32 inputs, each tensor within 1e-5 of its max |value| (ragged M, K
    18 and N 22 not whole chunks, stage 2's K 512); one TF32 pass
    misses 1e-4 once the reduction is 128 deep or more."""
    a, (mu, inv, g, b) = _case((M, K), (K, N), (M, N), has_r, M + K + N)
    got = k12_tf32(a["x"], a["r"], mu, inv, g, b, a["w"], a["do"], act)
    t = _torch(a)
    ref = t_bnmm.bn_matmul_bwd_ref(*t[:7], t[7], act)
    ref = [v.numpy() for v in ref]
    d = _dists(got, ref, has_r)
    assert max(d.values()) <= 1e-5, d
    if min(M, N) >= 128:
        one = k12_tf32(a["x"], a["r"], mu, inv, g, b, a["w"], a["do"], act,
                       one_pass=True)
        assert max(_dists(one, ref, has_r).values()) > TOL


@pytest.mark.parametrize("N,H,W,K,O,s,has_r,act", [
    (2, 8, 8, 64, 96, 1, True, "relu"), (2, 7, 5, 18, 33, 2, False, None),
    (1, 9, 9, 128, 64, 2, True, "relu"), (2, 6, 6, 128, 128, 1, False,
                                           "relu")])
def test_emulated_k15_within_1e5_of_float64(N, H, W, K, O, s, has_r, act):
    """K15's f32 body against the plain version in float64 from the same
    f32 inputs, within 1e-5 (odd H and W at stride 2, K 18 and O 33 not
    whole chunks, O 96); one TF32 pass misses 1e-4 at K = O = 128."""
    Ho, Wo = (H - 1) // s + 1, (W - 1) // s + 1
    a, (mu, inv, g, b) = _case((N, H, W, K), (3, 3, K, O), (N, Ho, Wo, O),
                               has_r, N + H + K + O)
    got = k15_tf32(a["x"], a["r"], mu, inv, g, b, a["w"], a["do"], act, s)
    t = _torch(a)
    ref = t_bnc.bn_conv3x3_bwd_ref(*t[:7], t[7], act, stride=s)
    ref = [v.numpy() for v in ref]
    d = _dists(got, ref, has_r)
    assert max(d.values()) <= 1e-5, d
    if K == O == 128:
        one = k15_tf32(a["x"], a["r"], mu, inv, g, b, a["w"], a["do"], act,
                       s, one_pass=True)
        assert max(_dists(one, ref, has_r).values()) > TOL


@pytest.mark.parametrize("act,has_r", [("relu", False), (None, False),
                                       ("relu", True), (None, True)])
def test_emulated_k12_matches_jax(act, has_r):
    """At the JAX tests' K12 shape (M 64, K 128, N 256) the f32 body
    against the JAX ``bn_matmul_bwd`` in interpret mode, each output
    within 1e-4 of its max |value|."""
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas_kernels import bn_matmul as jbm

    a, (mu, inv, g, b) = _case((64, 128), (128, 256), (64, 256), has_r,
                               5 + has_r)
    got = k12_tf32(a["x"], a["r"], mu, inv, g, b, a["w"], a["do"], act)
    j = [None if a[k] is None else jnp.asarray(a[k])
         for k in ("x", "gamma", "beta", "mean", "var", "w", "do", "r")]
    want = jbm.bn_matmul_bwd(*j[:7], r=j[7], act=act, interpret=True)
    d = _dists(got, [np.asarray(v) for v in want], has_r)
    assert max(d.values()) <= TOL, d


@pytest.mark.parametrize("act,has_r,s", [
    ("relu", False, 1), (None, False, 1), ("relu", True, 1), (None, True, 1),
    ("relu", False, 2), ("relu", True, 2)])
def test_emulated_k15_matches_jax(act, has_r, s):
    """At the JAX tests' K15 shape (N 2, 6 x 6, K = O = 128; even H and W,
    where the JAX kernels' Ho = H // stride is the convolution's) the f32
    body against the JAX ``bn_conv3x3_bwd`` in interpret mode, each
    output within 1e-4 of its max |value|."""
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas_kernels import bn_conv as jbc

    Ho = 6 // s
    a, (mu, inv, g, b) = _case((2, 6, 6, 128), (3, 3, 128, 128),
                               (2, Ho, Ho, 128), has_r, 9 + s + has_r)
    got = k15_tf32(a["x"], a["r"], mu, inv, g, b, a["w"], a["do"], act, s)
    j = [None if a[k] is None else jnp.asarray(a[k])
         for k in ("x", "gamma", "beta", "mean", "var", "w", "do", "r")]
    want = jbc.bn_conv3x3_bwd(*j[:7], r=j[7], act=act, stride=s,
                              interpret=True)
    d = _dists(got, [np.asarray(v) for v in want], has_r)
    assert max(d.values()) <= TOL, d
