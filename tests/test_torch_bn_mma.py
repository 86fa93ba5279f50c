"""The block, staging and fragment maps of the tensor-core kernels K11 and
K12 (``csrc/bn_matmul.cu``, bf16) and K13 and K15 (``csrc/bn_conv.cu``,
bf16), built on ``csrc/bn_mma.cuh``, emulated in numpy on the CPU.

The kernels run only on a card (``test_torch_kernels.py`` holds them
against their plain versions there).  What can be checked here is how
they cut the work and where each thread's data goes:

- the ldmatrix maps of both tile layouts (a [row][reduction] tile read
  as A or B, a [reduction][row] tile read as A or B through ``.trans``)
  feeding m16n8k16 products, against the tile's matrix product; the C
  fragment lane map and the forward's output store map each covering
  each (row, column) of a 64 x 64 tile once; the shared-memory rows of
  each ldmatrix phase in distinct banks;
- the whole backward, tile by tile, in float64: the flattened dA grid,
  the chunk staging maps with their zero fill and ragged channel tails,
  K15's transposed taps with the stride-2 parity rule, its prep pass
  (padding after the prologue) and the tap offsets into it, K12's
  in-place prologue with rows past the split zeroed, the splits and
  ``sum_splits``' fixed order, the epilogue's thread / shuffle / warp
  order of the dgamma and dbeta column sums and their sum over tiles,
  against the port's plain versions in float64 within 1e-12 of each
  tensor's max |value|;
- the whole forward the same way: K13's prep pass and its (output pixel,
  tap) rows of the padded activation at stride 1 and 2, never out of
  bounds, W's [k][o] tiles, the ragged channel tails; K11's raw X and R
  tiles, its in-place prologue with the step's channels and the K tail
  zeroed; both grids with the blocks of one row tile adjacent, and the
  output store map.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda_kernels import bn_conv as t_bnc
from paddle_tpu_torch.ops.cuda_kernels import bn_matmul as t_bnmm

BM = BN = 64
THREADS = 128
LD_RM = BM + 8  # a [reduction][row] tile's row stride in bf16
# the reduction step of each product: K12's dA and dW 32 (in dW the raw R
# tile takes the room), K15's dA and dW 64, K11 32 (the raw R tile again),
# K13 64
BK_K12_DA, BK_K12_DW, BK_K15 = 32, 32, 64
BK_K11, BK_K13 = 32, 64


def ld_rr(bk):
    """A [row][reduction] tile's row stride in bf16."""
    return bk + 8


def cdiv(a, b):
    return -(-a // b)


# -- chunk maps (bn_mma.cuh rr_row/rr_col, rm_row/rm_col) -------------------

def rr_chunks(bk):
    """(row, col) of every 16-byte chunk of a [64][bk] tile: thread tid
    takes chunks tid, tid + 128, ..., bk / 8 chunks a row."""
    for i in range(bk // 16):
        for tid in range(THREADS):
            e = tid + i * THREADS
            yield e // (bk // 8), (e % (bk // 8)) * 8


def rm_chunks(bk):
    """(row, col) of every chunk of a [bk][64] tile, 8 chunks a row."""
    for i in range(bk // 16):
        for tid in range(THREADS):
            e = tid + i * THREADS
            yield e >> 3, (e & 7) << 3


def test_chunk_maps_cover_each_tile_once():
    for bk in (32, 64):
        for chunks, shape in ((rr_chunks(bk), (BM, bk)),
                              (rm_chunks(bk), (bk, BM))):
            seen = np.zeros(shape, int)
            for r, c in chunks:
                seen[r, c:c + 8] += 1
            assert (seen == 1).all()


def chunk_len(c, n):
    return max(0, min(8, n - c))


def fast_div(d):
    """bn_mma.cuh fast_div: (mul, s) with n / d = (umulhi(n, mul) + n) >> s
    for 0 <= n < 2^31."""
    s = 0
    while (1 << s) < d:
        s += 1
    return ((1 << 32) * ((1 << s) - d)) // d + 1, s


def fdiv(n, md):
    mul, s = md
    return (((n * mul) >> 32) + n) >> s


def test_fast_div_matches_integer_division():
    rng = np.random.RandomState(0)
    ns = np.concatenate([np.arange(5000), rng.randint(0, 2 ** 31, 5000),
                         [2 ** 31 - 1, 2 ** 31 - 2]]).tolist()
    for d in list(range(1, 130)) + [224, 1000, 12544, 65535, 2 ** 30 + 3]:
        md = fast_div(d)
        assert md[0] < 2 ** 32
        for n in ns:
            assert fdiv(n, md) == n // d, (n, d)


def get8(flat, off, n):
    """A staged chunk: the first n elements from flat[off:], zeros after;
    a chunk with elements to load lies inside its tensor."""
    assert n == 0 or 0 <= off <= flat.size - n, (off, n, flat.size)
    out = np.zeros(8)
    out[:n] = flat[off:off + n]
    return out


# -- ldmatrix and mma.m16n8k16 ----------------------------------------------

def a_row(l):
    return l & 15


def a_col(l):
    return (l >> 4) << 3


def b_row(l):
    return (l & 7) + ((l >> 4) << 3)


def b_col(l):
    return ((l >> 3) & 1) << 3


def bt_row(l):
    return (l & 7) + (((l >> 3) & 1) << 3)


def bt_col(l):
    return (l >> 4) << 3


at_row, at_col = b_row, b_col  # bn_mma.cuh: A from a [k][m] tile


def ldmatrix_x4(smem, rows, cols, trans=False):
    """regs[lane][j] = the two elements lane gets of matrix j, whose eight
    rows are addressed by lanes 8j..8j+7."""
    regs = np.zeros((32, 4, 2))
    for j in range(4):
        mat = np.stack([smem[rows[8 * j + i], cols[8 * j + i]:
                             cols[8 * j + i] + 8] for i in range(8)])
        if trans:
            mat = mat.T
        for l in range(32):
            regs[l, j] = mat[l >> 2, 2 * (l & 3):2 * (l & 3) + 2]
    return regs


def mma(a, b0, b1):
    """One m16n8k16 product from the lanes' registers: a [32][4][2],
    b0, b1 [32][2]; returns c [32][4] (c0 c1 at (g, 2t..), c2 c3 at g+8)."""
    A, B = np.zeros((16, 16)), np.zeros((16, 8))
    for l in range(32):
        g, t = l >> 2, l & 3
        A[g, 2 * t:2 * t + 2] = a[l, 0]
        A[g + 8, 2 * t:2 * t + 2] = a[l, 1]
        A[g, 2 * t + 8:2 * t + 10] = a[l, 2]
        A[g + 8, 2 * t + 8:2 * t + 10] = a[l, 3]
        B[2 * t:2 * t + 2, g] = b0[l]
        B[2 * t + 8:2 * t + 10, g] = b1[l]
    C = A @ B
    return np.array([[C[l >> 2, 2 * (l & 3)], C[l >> 2, 2 * (l & 3) + 1],
                      C[(l >> 2) + 8, 2 * (l & 3)],
                      C[(l >> 2) + 8, 2 * (l & 3) + 1]] for l in range(32)])


def frag_cells():
    """(warp, lane, mi, nj, e) -> (row, col) of the 64 x 64 C tile."""
    for warp in range(4):
        wr, wc = (warp >> 1) * 32, (warp & 1) * 32
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for mi in range(2):
                for nj in range(4):
                    for e in range(4):
                        yield (warp, lane, mi, nj, e,
                               wr + mi * 16 + g + 8 * (e >> 1),
                               wc + nj * 8 + 2 * t + (e & 1))


def test_c_fragment_map_covers_the_tile_once():
    seen = np.zeros((BM, BN), int)
    for *_, row, col in frag_cells():
        seen[row, col] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("bk", [32, 64])
@pytest.mark.parametrize("a_layout,b_layout",
                         [("rr", "rr"), ("rm", "rm"), ("rr", "rm")])
def test_fragment_maps_multiply_the_staged_tiles(a_layout, b_layout, bk):
    """One bk-deep stage through mma_loop's loads: A from a [64][bk] tile
    (a_row/a_col) or a [bk][64] tile (at_row/at_col, .trans), B from a
    [64][bk] tile (b_row/b_col) or a [bk][64] tile (bt_row/bt_col,
    .trans); the accumulators, placed by the C map, equal the product.
    rr/rr is the dA products', rm/rm the dW products', rr/rm the
    forwards' (A rows of pixels, B = W [k][o])."""
    rng = np.random.RandomState(0)
    ta = rng.randint(-4, 5, (BM, ld_rr(bk)) if a_layout == "rr"
                     else (bk, LD_RM)).astype(np.float64)
    tb = rng.randint(-4, 5, (BN, ld_rr(bk)) if b_layout == "rr"
                     else (bk, LD_RM)).astype(np.float64)
    A = ta[:, :bk] if a_layout == "rr" else ta[:, :BM].T   # [64][bk]
    B = tb[:, :bk].T if b_layout == "rr" else tb[:, :BN]   # [bk][64]
    C = np.zeros((BM, BN))
    lanes = range(32)
    for warp in range(4):
        wr, wc = (warp >> 1) * 32, (warp & 1) * 32
        acc = np.zeros((2, 4, 32, 4))
        for kk in range(0, bk, 16):
            a = []
            for mi in range(2):
                if a_layout == "rr":
                    a.append(ldmatrix_x4(
                        ta, [wr + mi * 16 + a_row(l) for l in lanes],
                        [kk + a_col(l) for l in lanes]))
                else:
                    a.append(ldmatrix_x4(
                        ta, [kk + at_row(l) for l in lanes],
                        [wr + mi * 16 + at_col(l) for l in lanes],
                        trans=True))
            b = []
            for p in range(2):
                if b_layout == "rr":
                    r = ldmatrix_x4(tb, [wc + p * 16 + b_row(l)
                                         for l in lanes],
                                    [kk + b_col(l) for l in lanes])
                else:
                    r = ldmatrix_x4(tb, [kk + bt_row(l) for l in lanes],
                                    [wc + p * 16 + bt_col(l)
                                     for l in lanes], trans=True)
                b += [(r[:, 0], r[:, 1]), (r[:, 2], r[:, 3])]
            for mi in range(2):
                for nj in range(4):
                    acc[mi, nj] += mma(a[mi], *b[nj])
        for w, lane, mi, nj, e, row, col in frag_cells():
            if w == warp:
                C[row, col] = acc[mi, nj, lane, e]
    np.testing.assert_array_equal(C, A @ B)


def store_cells():
    """bn_mma.cuh store_tile: (tid, row, first column) of each 8-column
    chunk of the C tile a thread stores: chunk (tid % 8) * 8 of rows
    tid / 8 + 16 i, i < 4."""
    for tid in range(THREADS):
        for i in range(BM * 8 // THREADS):
            yield tid, (tid >> 3) + 16 * i, (tid & 7) * 8


def test_store_tile_map_covers_the_tile_once():
    seen = np.zeros((BM, BN), int)
    for _, row, col in store_cells():
        seen[row, col:col + 8] += 1
    assert (seen == 1).all()
    # a warp's lanes store whole 128-byte rows: 8 neighbouring lanes a row
    for warp in range(THREADS // 32):
        for i in range(BM * 8 // THREADS):
            rows = {}
            for tid in range(32 * warp, 32 * warp + 32):
                rows.setdefault((tid >> 3) + 16 * i, []).append(tid)
            assert all(len(t) == 8 and t == list(range(t[0], t[0] + 8))
                       for t in rows.values())


@pytest.mark.parametrize("ld", [ld_rr(32), ld_rr(64), LD_RM])
def test_ldmatrix_rows_fall_in_distinct_banks(ld):
    """Each 8-lane phase of an ldmatrix names eight 16-byte rows; at a
    row stride of 80 or 144 bytes they lie in distinct 16-byte bank
    groups of the 128-byte line, for every row map the kernels use."""
    maps = [(a_row, a_col), (b_row, b_col), (bt_row, bt_col)]
    for rows, cols in maps:
        for j in range(4):
            groups = {((rows(l) * ld + cols(l)) * 2 // 16) % 8
                      for l in range(8 * j, 8 * j + 8)}
            assert len(groups) == 8


# -- the kernels, tile by tile ------------------------------------------------

def prologue(x, r, mu, gi, b, act):
    v = (x - mu) * gi + b
    if r is not None:
        v = v + r
    return np.maximum(v, 0.0) if act == "relu" else v


def sum_splits(part, splits):
    """launch_sum_splits: out[g][e] = sum over s of part[g * splits + s][e]
    in its fixed order: lane y sums s = y, y + 16, ..., then lane 0 adds
    the 16 lane sums in order."""
    groups = part.shape[0] // splits
    flat = part.reshape(groups, splits, -1)
    out = np.zeros((groups, flat.shape[2]))
    for g in range(groups):
        lanes = np.zeros((16, flat.shape[2]))
        for y in range(16):
            for s in range(y, splits, 16):
                lanes[y] += flat[g, s]
        t = np.zeros(flat.shape[2])
        for y in range(16):
            t += lanes[y]
        out[g] = t
    return out


def sum_tiles(gb_part):
    """bn_mma.cuh sum_tiles_f64: the tiles' column sums [tiles, 2, K] in
    sum_splits' lane order (in f64 on the card too), as [2, K]."""
    tiles, _, K = gb_part.shape
    return sum_splits(gb_part, tiles)[0].reshape(2, K)


def da_epilogue(acc, x, r, prm4, act, row0, rows, col0, K, dx, dr, gb_part,
                tile):
    """bn_mma.cuh da_epilogue on a 64 x 64 accumulator: the fragments
    placed in the shared C tile by the C map, then thread tid takes the
    8-channel chunk (tid % 8) * 8 of rows tid / 8 + 16 i; the column sums
    per thread over its rows, then xor shuffles 8, 16 over the warp's
    lanes, then the four warps in order."""
    c = np.full((BM, BN), np.nan)
    for *_, row, col in frag_cells():
        c[row, col] = acc[row, col]
    mu, inv, gam, b = (np.zeros(BN) for _ in range(4))
    ks = np.arange(col0, col0 + BN)
    ok = ks < K
    mu[ok], inv[ok], gam[ok], b[ok] = (prm4[i, ks[ok]] for i in range(4))
    gi = inv * gam
    sx = np.zeros((THREADS, 8))
    sd = np.zeros((THREADS, 8))
    for tid in range(THREADS):
        cc = (tid & 7) * 8
        nk = max(0, min(8, K - (col0 + cc)))
        for i in range(BM * 8 // THREADS):
            rr = (tid >> 3) + 16 * i
            m = row0 + rr
            if m >= rows:
                continue
            for u in range(nk):
                col, k = cc + u, col0 + cc + u
                xv = x[m, k]
                pre = (xv - mu[col]) * gi[col] + b[col]
                if r is not None:
                    pre = pre + r[m, k]
                dpre = 0.0 if act == "relu" and not pre > 0 else c[rr, col]
                dx[m, k] = dpre * gi[col]
                if dr is not None:
                    dr[m, k] = dpre
                sx[tid, u] += dpre * ((xv - mu[col]) * inv[col])
                sd[tid, u] += dpre
    for o in (8, 16):
        idx = np.array([(t & ~31) | ((t & 31) ^ o) for t in range(THREADS)])
        sx = sx + sx[idx]
        sd = sd + sd[idx]
    es_x, es_d = np.zeros((THREADS // 32, BN)), np.zeros((THREADS // 32, BN))
    for tid in range(THREADS):
        if tid & 31 < 8:
            cc = (tid & 7) * 8
            es_x[tid >> 5, cc:cc + 8] = sx[tid]
            es_d[tid >> 5, cc:cc + 8] = sd[tid]
    for col in range(BN):
        if col0 + col < K:
            a = bb = 0.0
            for w in range(THREADS // 32):
                a += es_x[w, col]
                bb += es_d[w, col]
            gb_part[tile, 0, col0 + col] = a
            gb_part[tile, 1, col0 + col] = bb


def store_part(acc, part, row0, rows, col0, cols):
    nr, nc = min(BM, rows - row0), min(BN, cols - col0)
    part[row0:row0 + nr, col0:col0 + nc] = acc[:nr, :nc]


def k12_emulated(x, r, mu, inv, gam, b, w, do, act):
    """K12 bf16's four launches, in float64."""
    M, K = x.shape
    N = w.shape[1]
    gi = inv * gam
    prm4 = np.stack([mu, inv, gam, b])
    xf, wf, dof = x.ravel(), w.ravel(), do.ravel()
    rf = None if r is None else r.ravel()
    tiles_m, tiles_k = cdiv(M, BM), cdiv(K, BN)
    dx = np.zeros((M, K))
    dr = None if r is None else np.zeros((M, K))
    gb_part = np.zeros((tiles_m, 2, K))
    for blk in range(tiles_m * tiles_k):  # (a) the flattened grid
        mt, kt = divmod(blk, tiles_k)
        row0, col0 = mt * BM, kt * BN
        acc = np.zeros((BM, BN))
        for step in range(cdiv(N, BK_K12_DA)):
            n0 = step * BK_K12_DA
            ta = np.zeros((BM, ld_rr(BK_K12_DA)))
            tb = np.zeros((BN, ld_rr(BK_K12_DA)))
            for rr, c in rr_chunks(BK_K12_DA):
                m, k = row0 + rr, col0 + rr
                na = chunk_len(n0 + c, N) if m < M else 0
                ta[rr, c:c + 8] = get8(dof, m * N + n0 + c, na)
                nb = chunk_len(n0 + c, N) if k < K else 0
                tb[rr, c:c + 8] = get8(wf, k * N + n0 + c, nb)
            acc += ta[:, :BK_K12_DA] @ tb[:, :BK_K12_DA].T
        da_epilogue(acc, x, r, prm4, act, row0, M, col0, K, dx, dr, gb_part,
                    mt)
    splits, chunk = t_bnmm.splits(cdiv(K, BM) * cdiv(N, BN), M,
                                  torch.bfloat16)
    part = np.zeros((splits, K, N))
    for z in range(splits):  # (b) grid (K tiles, N tiles, splits)
        r_begin, r_end = z * chunk, min(M, z * chunk + chunk)
        for nt in range(cdiv(N, BN)):
            for kt in range(cdiv(K, BM)):
                row0, col0 = kt * BM, nt * BN
                acc = np.zeros((BM, BN))
                for step in range(cdiv(r_end - r_begin, BK_K12_DW)):
                    m0 = r_begin + step * BK_K12_DW
                    tx, tr, td = (np.zeros((BK_K12_DW, LD_RM))
                                  for _ in range(3))
                    for rr, c in rm_chunks(BK_K12_DW):
                        m = m0 + rr
                        ok = m < r_end
                        nx = chunk_len(row0 + c, K) if ok else 0
                        tx[rr, c:c + 8] = get8(xf, m * K + row0 + c, nx)
                        if r is not None:
                            tr[rr, c:c + 8] = get8(rf, m * K + row0 + c, nx)
                        nd = chunk_len(col0 + c, N) if ok else 0
                        td[rr, c:c + 8] = get8(dof, m * N + col0 + c, nd)
                    # post(): thread tid, channels row0 + 2 (tid % 32) + u,
                    # rows tid / 32 + 4 i
                    for tid in range(THREADS):
                        cp = 2 * (tid & 31)
                        for i in range(BK_K12_DW // 4):
                            rr = (tid >> 5) + 4 * i
                            for u in range(2):
                                k = row0 + cp + u
                                if m0 + rr >= r_end or k >= K:
                                    tx[rr, cp + u] = 0.0
                                    continue
                                tx[rr, cp + u] = prologue(
                                    tx[rr, cp + u],
                                    None if r is None else tr[rr, cp + u],
                                    mu[k], gi[k], b[k], act)
                    acc += tx[:, :BM].T @ td[:, :BN]
                store_part(acc, part[z], row0, K, col0, N)
    dw = sum_splits(part, splits)[0].reshape(K, N)
    dgb = sum_tiles(gb_part)
    return dx, dgb[0], dgb[1], dw, dr


def pad_prep(x, r, mu, gi, b, act):
    """bn_conv.cu bnc_pad_prep (K13 and K15 bf16, launch 1): apad [N, H+2,
    W+2, K] flat, one padded row a block, 8-channel chunks, the prologue
    inside and 0 on the border (padding after the prologue)."""
    N, H, W, K = x.shape
    xf = x.ravel()
    rf = None if r is None else r.ravel()
    apad = np.full(N * (H + 2) * (W + 2) * K, np.nan)
    kc = cdiv(K, 8)
    for blk in range(N * (H + 2)):
        n, hp = divmod(blk, H + 2)
        for e in range((W + 2) * kc):
            wp, k0 = e // kc, (e % kc) * 8
            inside = 1 <= hp <= H and 1 <= wp <= W
            for u in range(8):
                k = k0 + u
                if k >= K:
                    continue
                v = 0.0
                if inside:
                    off = ((n * H + hp - 1) * W + wp - 1) * K + k
                    v = prologue(xf[off], None if r is None else rf[off],
                                 mu[k], gi[k], b[k], act)
                apad[(blk * (W + 2) + wp) * K + k] = v
    assert not np.isnan(apad).any()  # every element written
    return apad


def store_tile(acc, out, written, row0, rows, col0, cols):
    """bn_mma.cuh store_tile: the accumulators placed in the shared C tile
    by the C fragment map, then each thread's 8-column chunks of its four
    rows, the first chunk_len of each (all 8 when VEC); `written` counts
    each output element's stores."""
    c = np.full((BM, BN), np.nan)
    for *_, row, col in frag_cells():
        c[row, col] = acc[row, col]
    for _, rr, cc in store_cells():
        row = row0 + rr
        n = chunk_len(col0 + cc, cols)
        if row >= rows or n == 0:
            continue
        out[row, col0 + cc:col0 + cc + n] = c[rr, cc:cc + n]
        written[row, col0 + cc:col0 + cc + n] += 1


def k13_emulated(x, r, mu, inv, gam, b, w, act, s):
    """K13 bf16's two launches, in float64: the prep pass, then the
    implicit GEMM over (tap, 64-channel step) with A rows of output pixels
    read from apad, B = W[tap] [k][o], the flattened grid (the O tiles of
    one pixel tile adjacent)."""
    N, H, W, K = x.shape
    O = w.shape[3]
    Ho, Wo = (H - 1) // s + 1, (W - 1) // s + 1
    apad = pad_prep(x, r, mu, inv * gam, b, act)
    wf = w.ravel()
    rows = N * Ho * Wo
    tiles_m, tiles_o = cdiv(rows, BM), cdiv(O, BN)
    ksteps = cdiv(K, BK_K13)
    out = np.zeros((rows, O))
    written = np.zeros((rows, O), int)
    for blk in range(tiles_m * tiles_o):
        mt, ot = divmod(blk, tiles_o)
        row0, col0 = mt * BM, ot * BN
        base = {}  # each tile row's top-left tap in apad, decoded once
        for rr in range(BM):
            p = row0 + rr
            wo, t = p % Wo, p // Wo
            n, ho = t // Ho, t % Ho
            base[rr] = (((n * (H + 2) + ho * s) * (W + 2) + wo * s) * K
                        if p < rows else None)
        acc = np.zeros((BM, BN))
        for step in range(9 * ksteps):
            tap, kstep = divmod(step, ksteps)
            k0 = kstep * BK_K13
            dy, dxx = divmod(tap, 3)
            toff = (dy * (W + 2) + dxx) * K + k0
            ta = np.zeros((BM, ld_rr(BK_K13)))
            tb = np.zeros((BK_K13, LD_RM))
            for rr, c in rr_chunks(BK_K13):
                na = chunk_len(k0 + c, K) if base[rr] is not None else 0
                ta[rr, c:c + 8] = get8(apad, (base[rr] or 0) + toff + c, na)
            for kr, oc in rm_chunks(BK_K13):
                k = k0 + kr
                nb = chunk_len(col0 + oc, O) if k < K else 0
                tb[kr, oc:oc + 8] = get8(wf, (tap * K + k) * O + col0 + oc,
                                         nb)
            acc += ta[:, :BK_K13] @ tb[:, :BN]
        store_tile(acc, out, written, row0, rows, col0, O)
    assert (written == 1).all()
    return out.reshape(N, Ho, Wo, O)


def k11_table(prm, k0, K):
    """MmFwd's parameter table of the step at k0: [3][32] f32, row j the
    channels k0.. of prm[j] in 16-byte chunks of 4, zero past K."""
    table = np.full((3, BK_K11), np.nan)
    for tid in range(3 * BK_K11 // 4):
        j, c = divmod(tid, BK_K11 // 4)
        c *= 4
        n = max(0, min(4, K - (k0 + c)))
        table[j, c:c + 4] = 0.0
        table[j, c:c + n] = prm[j, k0 + c:k0 + c + n]
    return table


def k11_post(tx, tr, table, act):
    """MmFwd::post on one staged [64][32] X tile (and R), in place: thread
    tid takes the channel pair 2 (tid % 16) of rows tid / 16 + 8 i, i < 8,
    with the pair's (mean, gi, beta) from the step's table.  Returns how
    often each element was visited."""
    seen = np.zeros((BM, BK_K11), int)
    for tid in range(THREADS):
        cp = 2 * (tid & 15)
        for u in range(2):
            mu, gi, b = table[:, cp + u]
            for i in range(BM * BK_K11 // (2 * THREADS)):
                rr = (tid >> 4) + 8 * i
                tx[rr, cp + u] = prologue(
                    tx[rr, cp + u], None if tr is None else tr[rr, cp + u],
                    mu, gi, b, act)
                seen[rr, cp + u] += 1
    return seen


def k11_emulated(x, r, mu, inv, gam, b, w, act):
    """K11 bf16 in float64: per (M tile, N tile) of the flattened grid, X
    and R staged raw with the step's parameter table, the prologue in
    place, B = W [k][n], the store map.  Also returns each step's A and B
    tiles after the prologue."""
    M, K = x.shape
    N = w.shape[1]
    prm = np.stack([mu, inv * gam, b])
    xf, wf = x.ravel(), w.ravel()
    rf = None if r is None else r.ravel()
    tiles_m, tiles_n = cdiv(M, BM), cdiv(N, BN)
    out = np.zeros((M, N))
    written = np.zeros((M, N), int)
    a_tiles = []
    for blk in range(tiles_m * tiles_n):
        mt, nt = divmod(blk, tiles_n)
        row0, col0 = mt * BM, nt * BN
        acc = np.zeros((BM, BN))
        for step in range(cdiv(K, BK_K11)):
            k0 = step * BK_K11
            tx = np.zeros((BM, ld_rr(BK_K11)))
            tr = None if r is None else np.zeros((BM, ld_rr(BK_K11)))
            tw = np.zeros((BK_K11, LD_RM))
            for rr, c in rr_chunks(BK_K11):
                m = row0 + rr
                nx = chunk_len(k0 + c, K) if m < M else 0
                tx[rr, c:c + 8] = get8(xf, m * K + k0 + c, nx)
                if r is not None:
                    tr[rr, c:c + 8] = get8(rf, m * K + k0 + c, nx)
            for kr, nc in rm_chunks(BK_K11):
                k = k0 + kr
                nw = chunk_len(col0 + nc, N) if k < K else 0
                tw[kr, nc:nc + 8] = get8(wf, k * N + col0 + nc, nw)
            seen = k11_post(tx, tr, k11_table(prm, k0, K), act)
            assert (seen[:, :BK_K11] == 1).all()
            a_tiles.append((k0, tx[:, :BK_K11].copy(), tw[:, :BN].copy()))
            acc += tx[:, :BK_K11] @ tw[:, :BN]
        store_tile(acc, out, written, row0, M, col0, N)
    assert (written == 1).all()
    return out, a_tiles


def k15_emulated(x, r, mu, inv, gam, b, w, do, act, s):
    """K15 bf16's five launches, in float64."""
    N, H, W, K = x.shape
    O = w.shape[3]
    Ho, Wo = (H - 1) // s + 1, (W - 1) // s + 1
    gi = inv * gam
    prm4 = np.stack([mu, inv, gam, b])
    rows = N * H * W
    xf, wf, dof = x.ravel(), w.ravel(), do.ravel()
    rf = None if r is None else r.ravel()
    x2 = x.reshape(rows, K)
    r2 = None if r is None else r.reshape(rows, K)
    # (1) prep: apad
    apad = pad_prep(x, r, mu, gi, b, act)
    # (2) dA: rows input pixels, the reduction (tap, o)
    tiles_m, tiles_k = cdiv(rows, BM), cdiv(K, BN)
    osteps = cdiv(O, BK_K15)
    dx = np.zeros((rows, K))
    dr = None if r is None else np.zeros((rows, K))
    gb_part = np.zeros((tiles_m, 2, K))
    for blk in range(tiles_m * tiles_k):
        mt, kt = divmod(blk, tiles_k)
        row0, col0 = mt * BM, kt * BN
        acc = np.zeros((BM, BN))
        for step in range(9 * osteps):
            tap, o_step = divmod(step, osteps)
            o0 = o_step * BK_K15
            dy, dxx = divmod(tap, 3)
            ta = np.zeros((BM, ld_rr(BK_K15)))
            tb = np.zeros((BN, ld_rr(BK_K15)))
            for rr, c in rr_chunks(BK_K15):
                p = row0 + rr  # decoded once per thread in the kernel
                wq, t = p % W, p // W
                n, h = t // H, t % H
                ho, wo = h + 1 - dy, wq + 1 - dxx
                v = p < rows and ho >= 0 and wo >= 0
                if s == 2:
                    v = v and not ((ho | wo) & 1)
                    ho, wo = ho >> 1, wo >> 1
                v = v and ho < Ho and wo < Wo
                na = chunk_len(o0 + c, O) if v else 0
                ta[rr, c:c + 8] = get8(
                    dof, ((n * Ho + ho) * Wo + wo) * O + o0 + c, na)
                k = col0 + rr
                nb = chunk_len(o0 + c, O) if k < K else 0
                tb[rr, c:c + 8] = get8(wf, (tap * K + k) * O + o0 + c, nb)
            acc += ta[:, :BK_K15] @ tb[:, :BK_K15].T
        da_epilogue(acc, x2, r2, prm4, act, row0, rows, col0, K, dx, dr,
                    gb_part, mt)
    # (3) dW per (K tile, O tile, tap x split) from apad
    m_out = N * Ho * Wo
    splits, chunk = t_bnmm.splits(9 * cdiv(K, BM) * cdiv(O, BN), m_out,
                                  torch.bfloat16)
    part = np.zeros((9 * splits, K, O))
    div_wo, div_ho = fast_div(Wo), fast_div(Ho)
    for z in range(9 * splits):
        tap, sp = divmod(z, splits)
        dy, dxx = divmod(tap, 3)
        r_begin, r_end = sp * chunk, min(m_out, sp * chunk + chunk)
        for ot in range(cdiv(O, BN)):
            for kt in range(cdiv(K, BM)):
                row0, col0 = kt * BM, ot * BN
                acc = np.zeros((BM, BN))
                for step in range(cdiv(r_end - r_begin, BK_K15)):
                    m0 = r_begin + step * BK_K15
                    ta = np.zeros((BK_K15, LD_RM))
                    tb = np.zeros((BK_K15, LD_RM))
                    for rr, c in rm_chunks(BK_K15):
                        m = m0 + rr
                        if m >= r_end:
                            continue
                        t = fdiv(m, div_wo)
                        wo = m - t * Wo
                        n = fdiv(t, div_ho)
                        ho = t - n * Ho
                        off = ((n * (H + 2) + ho * s + dy) * (W + 2)
                               + wo * s + dxx) * K + row0 + c
                        ta[rr, c:c + 8] = get8(apad, off,
                                               chunk_len(row0 + c, K))
                        tb[rr, c:c + 8] = get8(dof, m * O + col0 + c,
                                               chunk_len(col0 + c, O))
                    acc += ta[:, :BM].T @ tb[:, :BN]
                store_part(acc, part[z], row0, K, col0, O)
    dw = sum_splits(part, splits).reshape(3, 3, K, O)
    dgb = sum_tiles(gb_part)
    shape = (N, H, W, K)
    return (dx.reshape(shape), dgb[0], dgb[1], dw,
            None if dr is None else dr.reshape(shape))


def _inputs(xshape, wshape, doshape, has_r, border, seed):
    rng = np.random.RandomState(seed)
    K = xshape[-1]
    t = lambda a: torch.from_numpy(np.asarray(a, np.float64))  # noqa: E731
    return {"x": t(rng.randn(*xshape) * 1.5 + 0.3),
            "gamma": t(rng.rand(K) + 0.5),
            "beta": t(rng.randn(K) * 0.3 + (5.0 if border else 0.0)),
            "mean": t(rng.randn(K) * 0.1 + (3.0 if border else 0.3)),
            "var": t(rng.rand(K) + 2.0),
            "w": t(rng.randn(*wshape) / np.sqrt(np.prod(wshape[:-1]))),
            "do": t(rng.randn(*doshape)),
            "r": t(rng.randn(*xshape)) if has_r else None}


def _check(got, ref, names):
    for name, g, r in zip(names, got, ref):
        r = r.numpy()
        assert g.shape == r.shape, name
        err = np.abs(g - r).max() / max(np.abs(r).max(), 1e-300)
        assert err <= 1e-12, (name, err)


def _emulate(fn, a, act, *extra):
    mu, inv, gam, b, _ = t_bnmm.stats(a["gamma"], a["beta"], a["mean"],
                                      a["var"], 1e-5, torch.float64)
    r = None if a["r"] is None else a["r"].numpy()
    return fn(a["x"].numpy(), r, mu.numpy(), inv.numpy(), gam.numpy(),
              b.numpy(), a["w"].numpy(), a["do"].numpy(), act, *extra)


# (M, K, N, residual, act, border): three M splits with a partial last
# step, a ragged K 20 / N 5, two K tiles with the border case
@pytest.mark.parametrize("M,K,N,has_r,act,border", [
    (600, 24, 40, True, "relu", False),
    (37, 20, 5, True, None, False),
    (130, 72, 16, False, "relu", True),
    (200, 64, 96, False, "relu", False)])
def test_emulated_k12_matches_plain_float64(M, K, N, has_r, act, border):
    a = _inputs((M, K), (K, N), (M, N), has_r, border, M + K)
    ref = t_bnmm.bn_matmul_bwd_ref(a["x"], a["gamma"], a["beta"], a["mean"],
                                   a["var"], a["w"], a["do"], a["r"], act)
    dx, dg, db, dw, dr = _emulate(k12_emulated, a, act)
    got = [dx, dg, db, dw] + ([dr] if has_r else [])
    want = [ref[0], ref[1], ref[2], ref[5]] + ([ref[6]] if has_r else [])
    _check(got, want, ("dx", "dgamma", "dbeta", "dw", "dr"))


# (N, H, W, K, O, stride, residual, act, border): stride 1 and 2, odd H
# and W, the ragged K 20 / O 33, two pixel and two K tiles, the border
@pytest.mark.parametrize("N,H,W,K,O,stride,has_r,act,border", [
    (2, 5, 7, 16, 8, 1, True, "relu", False),
    (2, 7, 5, 16, 16, 2, True, "relu", False),
    (1, 5, 9, 20, 33, 2, False, None, False),
    (1, 6, 6, 16, 16, 1, False, "relu", True),
    (1, 9, 9, 72, 40, 1, False, "relu", False)])
def test_emulated_k15_matches_plain_float64(N, H, W, K, O, stride, has_r,
                                            act, border):
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    a = _inputs((N, H, W, K), (3, 3, K, O), (N, Ho, Wo, O), has_r, border,
                N + H + K)
    ref = t_bnc.bn_conv3x3_bwd_ref(a["x"], a["gamma"], a["beta"], a["mean"],
                                   a["var"], a["w"], a["do"], a["r"], act,
                                   stride=stride)
    dx, dg, db, dw, dr = _emulate(k15_emulated, a, act, stride)
    got = [dx, dg, db, dw] + ([dr] if has_r else [])
    want = [ref[0], ref[1], ref[2], ref[5]] + ([ref[6]] if has_r else [])
    _check(got, want, ("dx", "dgamma", "dbeta", "dw", "dr"))


def _emulate_fwd(fn, a, act, *extra):
    mu, inv, gam, b, _ = t_bnmm.stats(a["gamma"], a["beta"], a["mean"],
                                      a["var"], 1e-5, torch.float64)
    r = None if a["r"] is None else a["r"].numpy()
    return fn(a["x"].numpy(), r, mu.numpy(), inv.numpy(), gam.numpy(),
              b.numpy(), a["w"].numpy(), act, *extra)


# (M, K, N, residual, act, border): a partial M tile, two K steps and two
# N tiles; the ragged K 20 / N 5; a ragged K tail with the border case
# (act(beta - mean * gi) > 0 past K unless zeroed); K 64 N 96
@pytest.mark.parametrize("M,K,N,has_r,act,border", [
    (130, 64, 72, True, "relu", False),
    (37, 20, 5, True, None, False),
    (70, 20, 16, False, "relu", True),
    (64, 64, 96, False, "relu", False)])
def test_emulated_k11_matches_plain_float64(M, K, N, has_r, act, border):
    a = _inputs((M, K), (K, N), (M, N), has_r, border, M + K)
    ref = t_bnmm.bn_matmul_fwd_ref(a["x"], a["gamma"], a["beta"], a["mean"],
                                   a["var"], a["w"], a["r"], act)
    out, _ = _emulate_fwd(k11_emulated, a, act)
    _check([out], [ref], ("out",))


def test_emulated_k11_zeroes_the_k_tail_of_a():
    """Channels past K contribute nothing, and A's tail is itself zero:
    with the border case's statistics the prologue of a zero-filled
    element, act(beta - mean * gi), is far from 0, yet A's tail columns
    are 0 after post() because a channel past K takes zero parameters
    (the table's zero fill; act(0) = 0); W's tail rows are zero-filled as
    well.  So neither
    operand's tail carries a value, and a non-finite one cannot reach the
    sums."""
    M, K, N = 70, 20, 16
    a = _inputs((M, K), (K, N), (M, N), False, True, 1)
    mu, _, _, b, gi = t_bnmm.stats(a["gamma"], a["beta"], a["mean"],
                                   a["var"], 1e-5, torch.float64)
    assert (torch.relu(b - mu * gi) > 1.0).all()
    _, tiles = _emulate_fwd(k11_emulated, a, "relu")
    for k0, ta, tw in tiles:
        tail = max(0, K - k0)
        if tail < BK_K11:
            assert (ta[:, tail:] == 0).all()
            assert (tw[tail:] == 0).all()
        assert (ta[:, :tail] != 0).any()


# (N, H, W, K, O, stride, residual, act, border): stride 1 and 2, odd H
# and W, the ragged K 20 / O 33, two K steps a tap and two O tiles, two
# pixel tiles, the border (zero padding after the prologue)
@pytest.mark.parametrize("N,H,W,K,O,stride,has_r,act,border", [
    (2, 5, 7, 16, 8, 1, True, "relu", False),
    (2, 7, 5, 16, 16, 2, True, "relu", False),
    (1, 5, 9, 20, 33, 2, False, None, False),
    (1, 6, 6, 16, 16, 1, False, "relu", True),
    (1, 5, 5, 72, 80, 1, False, "relu", False),
    (1, 9, 9, 8, 16, 1, True, "relu", True)])
def test_emulated_k13_matches_plain_float64(N, H, W, K, O, stride, has_r,
                                            act, border):
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    a = _inputs((N, H, W, K), (3, 3, K, O), (N, Ho, Wo, O), has_r, border,
                N + H + K)
    ref = t_bnc.bn_conv3x3_fwd_ref(a["x"], a["gamma"], a["beta"], a["mean"],
                                   a["var"], a["w"], a["r"], act,
                                   stride=stride)
    out = _emulate_fwd(k13_emulated, a, act, stride)
    _check([out], [ref], ("out",))
