"""The wide tap product of the 3x3 forwards (``bnc_fwd_wide`` in
``paddle_tpu_torch/ops/cuda_kernels/csrc/bn_conv.cu``: K14 in bf16 and
f32, and f32 K13), emulated in numpy on the CPU.

The kernels run only on a card (``test_torch_kernels.py`` holds them
against their plain versions there).  What is checked here:

- the grid and pass map: a block owns 64 output pixels x its O block
  (f32 K13: 128 channels, 64 when O is; K14: ``_v2_block_o``), walked in
  passes of 64 or 128 channels; the store map covers each (pixel,
  channel) of the output once, and every staged chunk lies inside apad
  and W, for O in {64, 96, 128, 256, 512}, stride 1 and 2, odd H;
- the whole forward tile by tile in float64: the prep pass (16-byte
  chunks of 8 bf16 or 4 f32 channels), the A chunks of each (pixel, tap,
  step), W's [k][o] chunks zero past K and past the block, the store map,
  against the port's plain version within 1e-12;
- the lane maps: bf16 A by ldmatrix and B by ldmatrix.trans, f32 A by
  ldmatrix as 8 x 4 f32 matrices and B by 32-bit lane loads, each warp of
  the 2 x (BN / WN) grid giving its part of the tile's matrix product, and
  the C fragments covering the tile once;
- the banks: A's row stride of 144 bytes and B's of BN + 8 elements keep
  every ldmatrix phase and every f32 B lane load (bank 8 t + g) free of
  conflicts, and so do the C tile's float2 stores;
- the arithmetic of the f32 body: the forward from 3xTF32 products (small
  halves passed unrounded), each 32-channel step summed from zero and
  added to the running sums in f32, within 1e-5 of the function in
  float64 and within 1e-4 of the JAX package's ``bn_conv3x3_fwd`` and
  ``bn_conv3x3_fwd_v2`` (interpret mode); one TF32 pass misses 1e-4.

The lane helpers are ``test_torch_flash_mma.py``'s.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda_kernels import bn_conv as t_bnc
from paddle_tpu_torch.ops.cuda_kernels import bn_matmul as t_bnmm
from test_torch_flash_bwd_tf32 import split_raw
from test_torch_flash_mma import (G, LANES, TQ, a_col16, a_row, bt_col16,
                                  bt_row, c_to_matrix, ldmatrix_x4_b16,
                                  ldmatrix_x4_f32, mma_m16n8k8_tf32,
                                  mma_m16n8k16_bf16, tf32)

BM = 64  # output pixels a block
# per element type: elements a 16-byte chunk, the reduction step, A's row
# stride (144 bytes in both)
LAYOUT = {"bf16": {"E": 8, "BK": 64, "LDA": 72},
          "f32": {"E": 4, "BK": 32, "LDA": 36}}
SMEM_LIMIT = 232448  # the card's opt-in shared memory a block
SMEM_SM = 233472     # shared memory an SM; each block reserves 1 KB more
STAGES = 3           # the ring's depth


def cdiv(a, b):
    return -(-a // b)


def tiling(BN, layout):
    """(WN, warps along N, threads) of a pass BN wide: warps 2 x (BN / WN),
    each 32 x WN; WN 64 for an f32 128-wide pass."""
    WN = 64 if BN == 128 and layout == "f32" else 32
    return WN, BN // WN, 64 * (BN // WN)


def pass_width(block_o):
    """fwd_wide's pass width for a block of block_o channels."""
    return 64 if block_o <= 64 else 128


def chunk_maps(n, per_row, threads):
    """(row, first element / E) of chunks e = tid + i * threads, i < n /
    threads, of a tile whose rows are per_row chunks."""
    assert n % threads == 0
    e = np.arange(n)  # e = tid + i * threads covers 0..n-1 once
    return e // per_row, e % per_row


def chunk_len(c, n, E):
    return np.clip(n - c, 0, E)


def blocks(rows, O, block_o):
    """The flattened grid: (row0, c_begin, c_end, passes [(col0, BN)])."""
    for b in range(cdiv(rows, BM) * cdiv(O, block_o)):
        mt, ob = divmod(b, cdiv(O, block_o))
        c_begin, c_end = ob * block_o, min(O, ob * block_o + block_o)
        BN = pass_width(block_o)
        yield mt * BM, c_begin, c_end, [(c, BN) for c in
                                         range(c_begin, c_end, BN)]


def k14_block_o(O):
    return t_bnc._v2_block_o(O)


def k13_block_o(O):
    """f32 K13's O block (ptt_bn_conv3x3_fwd): 128, 64 when O <= 64."""
    return 64 if O <= 64 else 128


# -- the grid, the passes and the store map ----------------------------------

@pytest.mark.parametrize("layout", ["bf16", "f32"])
@pytest.mark.parametrize("O", [64, 96, 128, 256, 512])
@pytest.mark.parametrize("H,W,s", [(6, 6, 1), (7, 5, 2), (9, 9, 1)])
def test_k14_grid_and_passes_cover_the_output_once(layout, O, H, W, s):
    """Every (pixel, channel) of K14's output stored once, masked at the
    block's end (O 96: one 128-wide pass with 32 zero columns); the
    staged chunks of every pass and step inside apad and W; the f32 K13
    grid (128-channel blocks, 64 at O 64) likewise."""
    E, BK, _ = LAYOUT[layout].values()
    N, K = 2, 40
    Ho, Wo = (H - 1) // s + 1, (W - 1) // s + 1
    rows = N * Ho * Wo
    kinds = [k14_block_o(O)] + ([k13_block_o(O)] if layout == "f32"
                                else [])
    apad_size, w_size = N * (H + 2) * (W + 2) * K, 9 * K * O
    for block_o in kinds:
        written = np.zeros((rows, O), int)
        for row0, c_begin, c_end, passes in blocks(rows, O, block_o):
            assert c_end - c_begin <= block_o
            for col0, BN in passes:
                _, _, T = tiling(BN, layout)
                # the store map: 16-byte chunks of the f32 C tile's rows
                r, cc = chunk_maps(BM * BN // E, BN // E, T)
                cc = cc * E
                n = chunk_len(col0 + cc, c_end, E)
                for u in range(E):
                    ok = (row0 + r < rows) & (u < n)
                    np.add.at(written, (row0 + r[ok], col0 + cc[ok] + u), 1)
                # B chunks: W[tap] rows k0 + kr, columns col0 + oc..
                kr, oc = chunk_maps(BK * BN // E, BN // E, T)
                oc = oc * E
                for k0 in range(0, K, BK):
                    nb = np.where(k0 + kr < K,
                                  chunk_len(col0 + oc, c_end, E), 0)
                    assert (col0 + oc + nb <= c_end)[nb > 0].all()
                    for tap in range(9):
                        off = ((tap * K + k0 + kr) * O + col0 + oc)[nb > 0]
                        assert (off >= 0).all()
                        assert (off + nb[nb > 0] <= w_size).all()
            # A chunks: the pixel's top-left tap plus the tap's offset
            p = row0 + np.arange(BM)
            wo, t = p % Wo, p // Wo
            n_, ho = t // Ho, t % Ho
            base = ((n_ * (H + 2) + ho * s) * (W + 2) + wo * s) * K
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                for k0 in range(0, K, BK):
                    for c in range(0, BK, E):
                        m = chunk_len(k0 + c, K, E)
                        if m == 0:
                            continue
                        off = (base + (dy * (W + 2) + dx) * K + k0 + c)[
                            p < rows]
                        assert (off >= 0).all() and \
                            (off + m <= apad_size).all()
        assert (written == 1).all(), block_o


@pytest.mark.parametrize("layout,BN", [("bf16", 64), ("bf16", 128),
                                       ("f32", 64), ("f32", 128)])
def test_wide_ring_fits_and_chunks_divide(layout, BN):
    """Each thread stages whole chunks of A and B, and the ring (3 stages
    of A [64][BK + pad] and B [BK][BN + 8]) with the C tile over it fits
    the card; a stage of 64 x 128 is 26,624 bytes in both dtypes.  The
    blocks an SM that __launch_bounds__ sizes the registers for (two of a
    128-wide pass, three of a 64-wide one) fit an SM's shared memory
    together and leave each thread the registers named there."""
    E, BK, LDA = LAYOUT[layout].values()
    size = 2 if layout == "bf16" else 4
    WN, _, T = tiling(BN, layout)
    assert (BM * BK // E) % T == 0 and (BK * BN // E) % T == 0
    stage = (BM * LDA + BK * (BN + 8)) * size
    if BN == 128:
        assert stage == 26624
    smem = max(STAGES * stage, BM * (BN + 8) * 4)
    assert smem <= SMEM_LIMIT
    min_blocks = 3 if BN == 64 else 2
    assert min_blocks * (smem + 1024) <= SMEM_SM, (min_blocks, smem)
    regs = 168 if BN == 64 else 255 if WN == 64 else 128
    assert 65536 // (min_blocks * T) >= regs
    # 16-byte cp.async destinations: row strides and tile bases
    assert LDA * size % 16 == 0 and (BN + 8) * size % 16 == 0
    assert BM * LDA * size % 16 == 0 and stage % 16 == 0


# -- the whole forward, tile by tile, in float64 ------------------------------

def prologue(x, r, mu, gi, b, act):
    v = (x - mu) * gi + b
    if r is not None:
        v = v + r
    return np.maximum(v, 0.0) if act == "relu" else v


def pad_prep(x, r, mu, gi, b, act, E):
    """bnc_pad_prep: apad [N, H+2, W+2, K] flat, one padded row a block,
    E-channel chunks, the prologue inside and 0 on the border."""
    N, H, W, K = x.shape
    apad = np.full((N, H + 2, W + 2, K), np.nan)
    kc = cdiv(K, E)
    for blk in range(N * (H + 2)):
        n, hp = divmod(blk, H + 2)
        for e in range((W + 2) * kc):
            wp, k0 = e // kc, (e % kc) * E
            ks = np.arange(k0, min(K, k0 + E))
            if 1 <= hp <= H and 1 <= wp <= W:
                apad[n, hp, wp, ks] = prologue(
                    x[n, hp - 1, wp - 1, ks],
                    None if r is None else r[n, hp - 1, wp - 1, ks],
                    mu[ks], gi[ks], b[ks], act)
            else:
                apad[n, hp, wp, ks] = 0.0
    assert not np.isnan(apad).any()
    return apad.ravel()


def wide_emulated(x, r, mu, gi, b, w, act, s, layout, block_o):
    """bnc_pad_prep + bnc_fwd_wide in float64: per block of the flattened
    grid and pass, per (tap, BK step), the A and B tiles staged through
    the chunk maps (zero fill past K, past the block and for rows past
    the last pixel), summed, then stored through the store map."""
    E, BK, LDA = LAYOUT[layout].values()
    N, H, W, K = x.shape
    O = w.shape[3]
    Ho, Wo = (H - 1) // s + 1, (W - 1) // s + 1
    rows = N * Ho * Wo
    apad = pad_prep(x, r, mu, gi, b, act, E)
    wf = w.ravel()
    out = np.zeros((rows, O))
    written = np.zeros((rows, O), int)
    for row0, _, c_end, passes in blocks(rows, O, block_o):
        for col0, BN in passes:
            _, _, T = tiling(BN, layout)
            # A chunk i of a thread: its pixel decoded once a block
            ar, ac = chunk_maps(BM * BK // E, BK // E, T)
            ac = ac * E
            p = row0 + ar
            wo, t = p % Wo, p // Wo
            n_, ho = t // Ho, t % Ho
            base = ((n_ * (H + 2) + ho * s) * (W + 2) + wo * s) * K
            br, bc = chunk_maps(BK * BN // E, BN // E, T)
            bc = bc * E
            acc = np.zeros((BM, BN))
            for step in range(9 * cdiv(K, BK)):
                tap, ks = divmod(step, cdiv(K, BK))
                k0 = ks * BK
                dy, dx = divmod(tap, 3)
                toff = (dy * (W + 2) + dx) * K + k0
                sa = np.full((BM, LDA), np.nan)
                sb = np.full((BK, BN + 8), np.nan)
                na = np.where(p < rows, chunk_len(k0 + ac, K, E), 0)
                nb = np.where(k0 + br < K, chunk_len(col0 + bc, c_end, E),
                              0)
                for u in range(E):
                    ia = base + toff + ac + u
                    sa[ar, ac + u] = np.where(
                        u < na, apad[np.where(u < na, ia, 0)], 0.0)
                    ib = (tap * K + k0 + br) * O + col0 + bc + u
                    sb[br, bc + u] = np.where(
                        u < nb, wf[np.where(u < nb, ib, 0)], 0.0)
                acc += sa[:, :BK] @ sb[:, :BN]
            r_, cc = chunk_maps(BM * BN // E, BN // E, T)
            cc = cc * E
            m = chunk_len(col0 + cc, c_end, E)
            for u in range(E):
                ok = (row0 + r_ < rows) & (u < m)
                out[row0 + r_[ok], col0 + cc[ok] + u] = acc[r_[ok],
                                                            cc[ok] + u]
                np.add.at(written, (row0 + r_[ok], col0 + cc[ok] + u), 1)
    assert (written == 1).all()
    return out.reshape(N, Ho, Wo, O)


def _inputs(xshape, O, has_r, border, seed, dtype=np.float64):
    rng = np.random.RandomState(seed)
    K = xshape[-1]
    t = lambda a: torch.from_numpy(np.asarray(a, dtype))  # noqa: E731
    return {"x": t(rng.randn(*xshape) * 1.5 + 0.3),
            "gamma": t(rng.rand(K) + 0.5),
            "beta": t(rng.randn(K) * 0.3 + (5.0 if border else 0.0)),
            "mean": t(rng.randn(K) * 0.1 + (3.0 if border else 0.3)),
            "var": t(rng.rand(K) + 2.0),
            "w": t(rng.randn(3, 3, K, O) / np.sqrt(9 * K)),
            "r": t(rng.randn(*xshape)) if has_r else None}


def _args(a):
    return (a["x"], a["gamma"], a["beta"], a["mean"], a["var"], a["w"])


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


# (N, H, W, K, O, stride, residual, act, border): stride 1 and 2, odd H and
# W, a ragged K 20 / O 33 (element-wise chunks), two K steps a tap, O 96
# (one 128-wide pass, 32 zero columns), O 200 (128 + 72), O 512 (two
# 256-wide blocks of two passes each), two pixel tiles, the border
@pytest.mark.parametrize("layout", ["bf16", "f32"])
@pytest.mark.parametrize("N,H,W,K,O,s,has_r,act,border", [
    (2, 5, 7, 16, 8, 1, True, "relu", False),
    (1, 5, 9, 20, 33, 2, False, None, False),
    (1, 6, 6, 72, 96, 1, False, "relu", True),
    (2, 7, 5, 16, 200, 2, True, "relu", False),
    (1, 9, 9, 8, 512, 1, False, "relu", False)])
def test_emulated_wide_forward_matches_plain_float64(layout, N, H, W, K, O,
                                                     s, has_r, act, border):
    """K14 (its O block) and, in f32, K13 (128-channel blocks) through
    the prep pass and the wide tile's staging, summation and store maps,
    against the plain version in float64."""
    Ho, Wo = (H - 1) // s + 1, (W - 1) // s + 1
    a = _inputs((N, H, W, K), O, has_r, border, N + H + K + O)
    ref = t_bnc.bn_conv3x3_fwd_ref(*_args(a), a["r"], act,
                                   stride=s).numpy()
    mu, _, _, b, gi = t_bnmm.stats(a["gamma"], a["beta"], a["mean"],
                                   a["var"], 1e-5, torch.float64)
    r = None if a["r"] is None else a["r"].numpy()
    emu = (a["x"].numpy(), r, mu.numpy(), gi.numpy(), b.numpy(),
           a["w"].numpy(), act, s, layout)
    runs = [k14_block_o(O)] + ([k13_block_o(O)] if layout == "f32" else [])
    for block_o in runs:
        out = wide_emulated(*emu, block_o)
        assert out.shape == (N, Ho, Wo, O)
        assert _rel(out, ref) <= 1e-12, block_o


# -- the lane maps -----------------------------------------------------------

def warps(BN, layout):
    """(wr, wc, WN) of each warp of a BN-wide pass."""
    WN, wn, _ = tiling(BN, layout)
    return [((w // wn) * 32, (w % wn) * WN, WN) for w in range(2 * wn)]


@pytest.mark.parametrize("BN", [64, 128])
def test_f32_lane_maps_give_the_tile_product(BN):
    """wide_products in f32, one BK-deep step, every warp: A [64][36] by
    ldmatrix as 8 x 4 f32 matrices (rows wr + 16 mi + a_row, column kk +
    tf32_a_col), B [32][BN + 8] by lanes (g, t) at rows kk + t and kk + t
    + 4, column wc + 8 nj + g, each fragment split into big and small
    and multiplied as mma_3xtf32 does; the C fragments placed by the
    C map give the tile's product exactly (small integers: the small
    halves are 0) and cover the 64 x BN tile once."""
    _, BK, LDA = LAYOUT["f32"].values()
    LDB = BN + 8
    rng = np.random.RandomState(BN)
    A = rng.randint(-4, 5, (BM, BK)).astype(np.float32)
    B = rng.randint(-4, 5, (BK, BN)).astype(np.float32)
    sa = np.zeros(BM * LDA, np.float32)
    sb = np.zeros(BK * LDB, np.float32)
    sa.reshape(BM, LDA)[:, :BK] = A
    sb.reshape(BK, LDB)[:, :BN] = B
    C = np.full((BM, BN), np.nan)
    for wr, wc, WN in warps(BN, "f32"):
        part = np.zeros((2, WN // 8, 32, 4))
        for kk in range(0, BK, 8):
            a = [ldmatrix_x4_f32(sa, LDA, wr + 16 * mi + a_row(LANES),
                                 kk + 4 * a_col16(LANES)) for mi in range(2)]
            for nj in range(WN // 8):
                col = wc + 8 * nj + G
                b = np.stack([sb[(kk + TQ) * LDB + col],
                              sb[(kk + TQ + 4) * LDB + col]], 1)
                bb, bs = split_raw(b)
                for mi in range(2):
                    ab, as_ = split_raw(a[mi])
                    for x, y in ((as_, bb), (ab, bs), (ab, bb)):
                        part[mi, nj] += mma_m16n8k8_tf32(x, y)
        for mi in range(2):
            tile = c_to_matrix(part[mi], WN // 8)
            rows = slice(wr + 16 * mi, wr + 16 * mi + 16)
            assert np.isnan(C[rows, wc:wc + WN]).all()
            C[rows, wc:wc + WN] = tile
    np.testing.assert_array_equal(C, A.astype(np.float64) @ B)


@pytest.mark.parametrize("BN", [64, 128])
def test_bf16_lane_maps_give_the_tile_product(BN):
    """wide_products in bf16, one 64-deep step, every warp: A [64][72] by
    ldmatrix (a_row, a_col), B [64][BN + 8] by ldmatrix.trans (bt_row,
    bt_col), m16n8k16 products; the tile's product exactly, each cell of
    the 64 x BN tile once."""
    _, BK, LDA = LAYOUT["bf16"].values()
    LDB = BN + 8
    rng = np.random.RandomState(BN + 1)
    A = rng.randint(-4, 5, (BM, BK)).astype(np.float64)
    B = rng.randint(-4, 5, (BK, BN)).astype(np.float64)
    sa, sb = np.zeros(BM * LDA), np.zeros(BK * LDB)
    sa.reshape(BM, LDA)[:, :BK] = A
    sb.reshape(BK, LDB)[:, :BN] = B
    C = np.full((BM, BN), np.nan)
    for wr, wc, WN in warps(BN, "bf16"):
        part = np.zeros((2, WN // 8, 32, 4))
        for kk in range(0, BK, 16):
            a = [ldmatrix_x4_b16(sa, LDA, wr + 16 * mi + a_row(LANES),
                                 kk + 8 * a_col16(LANES)) for mi in range(2)]
            for p in range(WN // 16):
                b = ldmatrix_x4_b16(sb, LDB, kk + bt_row(LANES),
                                    wc + 16 * p + 8 * bt_col16(LANES),
                                    trans=True)
                for mi in range(2):
                    part[mi, 2 * p] += mma_m16n8k16_bf16(a[mi], b[:, 0:2])
                    part[mi, 2 * p + 1] += mma_m16n8k16_bf16(a[mi],
                                                             b[:, 2:4])
        for mi in range(2):
            rows = slice(wr + 16 * mi, wr + 16 * mi + 16)
            assert np.isnan(C[rows, wc:wc + WN]).all()
            C[rows, wc:wc + WN] = c_to_matrix(part[mi], WN // 8)
    np.testing.assert_array_equal(C, A @ B)


# -- the banks ---------------------------------------------------------------

def _ldmatrix_free(words):
    """Each 8-lane phase of an ldmatrix names eight 16-byte rows (start
    words), which must cover the 32 banks once."""
    for i in range(4):
        w = words[8 * i:8 * i + 8, None] + np.arange(4)
        assert len(set((w % 32).ravel())) == 32, words


@pytest.mark.parametrize("layout", ["bf16", "f32"])
@pytest.mark.parametrize("BN", [64, 128])
def test_wide_loads_are_free_of_bank_conflicts(layout, BN):
    """A's row stride of 144 bytes (36 f32, 72 bf16) and B's of BN + 8
    elements, every warp of the pass: each ldmatrix phase (A in both
    dtypes, B's .trans rows in bf16) covers the 32 banks once, each f32 B
    lane load (rows kk + t, kk + t + 4, column wc + 8 nj + g: bank 8 t +
    g) names 32 banks, and the C tile's float2 stores (row stride BN + 8
    f32) fall in distinct banks in each half-warp."""
    _, BK, LDA = LAYOUT[layout].values()
    LDB = BN + 8
    for wr, wc, WN in warps(BN, layout):
        # A by ldmatrix: the start word of each lane's 16-byte row
        for mi in range(2):
            for kk in range(0, BK, 8 if layout == "f32" else 16):
                if layout == "f32":
                    words = (wr + 16 * mi + a_row(LANES)) * LDA + kk + \
                        4 * a_col16(LANES)
                else:
                    words = ((wr + 16 * mi + a_row(LANES)) * LDA + kk +
                             8 * a_col16(LANES)) // 2
                _ldmatrix_free(words)
        if layout == "bf16":  # B by ldmatrix.trans
            for kk in range(0, BK, 16):
                for p in range(WN // 16):
                    words = ((kk + bt_row(LANES)) * LDB + wc + 16 * p +
                             8 * bt_col16(LANES)) // 2
                    _ldmatrix_free(words)
        else:  # B by 32-bit lane loads
            for kk in range(0, BK, 8):
                for nj in range(WN // 8):
                    for dk in (0, 4):
                        words = (kk + TQ + dk) * LDB + wc + 8 * nj + G
                        assert len(set(words % 32)) == 32
        # the C tile's float2 stores: (row wr + 16 mi + g + 8 h, column
        # wc + 8 nj + 2 t), 16 lanes a phase
        for mi in range(2):
            for h in range(2):
                for nj in range(WN // 8):
                    words = (wr + 16 * mi + G + 8 * h) * LDB + wc + \
                        8 * nj + 2 * TQ
                    for half in (slice(0, 16), slice(16, 32)):
                        banks = set()
                        for w0 in words[half]:
                            banks |= {w0 % 32, (w0 + 1) % 32}
                        assert len(banks) == 32


# -- the arithmetic of the f32 body -------------------------------------------

def _prep_f32(x, r, mu, gi, b, act):
    """The prep pass in f32 (each step rounded, as the kernel's _rn
    chain)."""
    v = ((x - mu) * gi) + b
    if r is not None:
        v = v + r
    if act == "relu":
        v = np.maximum(v, np.float32(0))
    N, H, W, K = x.shape
    apad = np.zeros((N, H + 2, W + 2, K), np.float32)
    apad[:, 1:H + 1, 1:W + 1] = v
    return apad


def fwd_tf32(x, r, mu, gi, b, w, act, s, one_pass=False):
    """The f32 body's arithmetic on f32 inputs: for each tap and
    32-channel step, the 8-deep chunks' products in 3xTF32 (split_raw;
    a_small b_big, a_big b_small, a_big b_big, each added in f32) summed
    into a zeroed partial, then added to the running sum in f32 (one TF32
    pass with `one_pass`).  Every output element is summed in this order
    whatever its block, pass and warp."""
    N, H, W, K = x.shape
    O = w.shape[3]
    Ho, Wo = (H - 1) // s + 1, (W - 1) // s + 1
    apad = _prep_f32(x, r, mu, gi, b, act)
    acc = np.zeros((N * Ho * Wo, O), np.float32)
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        A = apad[:, dy:dy + s * (Ho - 1) + 1:s, dx:dx + s * (Wo - 1) + 1:s]
        A = A.reshape(-1, K)
        for k0 in range(0, K, LAYOUT["f32"]["BK"]):
            part = np.zeros_like(acc)
            for c in range(k0, min(K, k0 + LAYOUT["f32"]["BK"]), 8):
                a, bm = A[:, c:c + 8], w[dy, dx, c:c + 8]
                if one_pass:
                    part = part + tf32(a) @ tf32(bm)
                    continue
                ab, as_ = split_raw(a)
                bb, bs = split_raw(bm)
                for p, q in ((as_, bb), (ab, bs), (ab, bb)):
                    part = part + p @ q
            acc = acc + part
    return acc.reshape(N, Ho, Wo, O)


def _f32_case(xshape, O, has_r, seed):
    """f32 inputs (numpy), their stats in f32 as the wrapper computes
    them, and the function in float64 from the same f32 inputs."""
    a = _inputs(xshape, O, has_r, False, seed, np.float32)
    mu, _, _, b, gi = t_bnmm.stats(a["gamma"], a["beta"], a["mean"],
                                   a["var"], 1e-5, torch.float32)
    stats = tuple(t.numpy() for t in (mu, gi, b))
    return a, stats


@pytest.mark.parametrize("N,H,W,K,O,s,has_r", [
    (2, 8, 8, 128, 256, 1, False),
    (2, 8, 8, 128, 256, 2, True),
    (1, 7, 9, 64, 96, 2, True),
    (2, 5, 5, 20, 33, 1, False)])
def test_emulated_3xtf32_forward_within_1e5_of_float64(N, H, W, K, O, s,
                                                       has_r):
    """The f32 body's sums against the plain version in float64 from the
    same f32 inputs, at 1e-5 of max |value| (odd H and W, a ragged K);
    one TF32 pass over the same steps misses 1e-4."""
    a, (mu, gi, b) = _f32_case((N, H, W, K), O, has_r, N + H + K + O + s)
    x, w = a["x"].numpy(), a["w"].numpy()
    r = None if a["r"] is None else a["r"].numpy()
    a64 = {k: None if v is None else v.double() for k, v in a.items()}
    ref = t_bnc.bn_conv3x3_fwd_ref(*_args(a64), a64["r"], "relu",
                                   stride=s).numpy()
    got = fwd_tf32(x, r, mu, gi, b, w, "relu", s)
    assert _rel(got, ref) <= 1e-5, _rel(got, ref)
    if K >= 64:
        one = fwd_tf32(x, r, mu, gi, b, w, "relu", s, one_pass=True)
        assert _rel(one, ref) > 1e-4, _rel(one, ref)


@pytest.mark.parametrize("s,has_r", [(1, False), (1, True), (2, False),
                                     (2, True)])
def test_emulated_3xtf32_forward_matches_jax(s, has_r):
    """At the JAX tests' K14 shape (N 2, 8 x 8, K 128, O 256; even H and
    W, where the JAX kernels' Ho = H // stride is the convolution's), the
    f32 body's sums against the JAX ``bn_conv3x3_fwd`` and
    ``bn_conv3x3_fwd_v2`` in interpret mode, at 1e-4 of max |value|."""
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas_kernels import bn_conv as jbc

    a, (mu, gi, b) = _f32_case((2, 8, 8, 128), 256, has_r, 7 + s)
    x, w = a["x"].numpy(), a["w"].numpy()
    r = None if a["r"] is None else a["r"].numpy()
    got = fwd_tf32(x, r, mu, gi, b, w, "relu", s)
    jargs = [jnp.asarray(t.numpy()) for t in _args(a)]
    jr = None if r is None else jnp.asarray(r)
    for fn in (jbc.bn_conv3x3_fwd, jbc.bn_conv3x3_fwd_v2):
        want = np.asarray(fn(*jargs, r=jr, stride=s, interpret=True))
        assert want.shape == got.shape
        assert _rel(got, want) <= 1e-4, (fn.__name__, _rel(got, want))
