"""The f32 forward of the fused BatchNorm -> 1x1 convolution on the tensor
cores in 3xTF32 (K11 ``bn_matmul_fwd``, ``csrc/bn_matmul.cu``
``bnmm_fwd_mma<float>``: ``MmFwd``'s staging and in-place prologue, the
tile loop and ``store_tile`` of ``csrc/bn_mma.cuh``), emulated in numpy on
the CPU.

The kernel runs only on a card (``test_torch_kernels.py`` holds it
against its plain version there).  What is checked here:

- the f32 staging maps (16-byte chunks of 4 f32): X and R as [64][16]
  tiles, W as a [16][64] tile and the step's [3][16] parameter table,
  each covered once;
- ``post()``'s pair map and ``store_tile``'s f32 map (4-column chunks,
  rows tid / 16 + 8 i) covering their tiles once;
- the grid: the blocks of one M tile adjacent, Out written once, every
  staged chunk inside its tensor, for K, N in {20, 64, 96, 128, 256, 512};
- the ring within the 48 KB of static shared memory, under the C tile;
- the lane maps: A (X rows) by ldmatrix as 8 x 4 f32 matrices and B (W
  rows k) by 32-bit lane loads give the tile's product, every fragment
  load and the epilogue's accesses free of bank conflicts, and
  ``post()``'s float2 accesses with a 2-way conflict on 4 banks, named
  here (rows 4 apart would remove it; on the card that map was level in
  f32 and lost up to 7.5% in bf16);
- the K tail: a channel past K contributes 0;
- the arithmetic: 3xTF32 products (small halves unrounded), each 16-deep
  step summed from zero and added in f32; within 1e-5 of the plain
  version in float64 and 1e-4 of the JAX package's ``bn_matmul_fwd`` in
  interpret mode, where one TF32 pass misses 1e-4 (at K 512 too).

The lane helpers, ``split_raw``'s rule and the 3xTF32 step are
``test_torch_bn_bwd_tf32.py``'s, the ldmatrix bank check
``test_torch_bn_conv_tf32.py``'s.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda_kernels import bn_matmul as t_bnmm
from test_torch_bn_bwd_tf32 import (BM, BN, E, LD_RM, SMEM_STATIC,
                                    THREADS, TOL, _case, _rel, b_rm_words,
                                    cdiv, chunk_len, frag_a_rr, ld_rr,
                                    prologue_f32, rm_chunks, rr_chunks,
                                    split_raw, walk, warps)
from test_torch_bn_conv_tf32 import _ldmatrix_free
from test_torch_flash_mma import (LANES, a_col16, a_row, c_to_matrix,
                                  mma_m16n8k8_tf32)

BK = 16                 # f32 K11's step: 64 bytes of a row, as bf16's 32
LD_RR = ld_rr(BK)       # the X and R tiles' row stride: 20 words
PAIRS = BK // 2         # channel pairs of a step: lanes of a post() row
ROWS = 256 // BK        # rows of a post() pass
STAGES = 3


# -- staging, prologue and epilogue maps ---------------------------------------

def table_chunks():
    """(row j, column c) of the [3][16] table's 16-byte chunks: thread
    tid < 3 BK / 4 takes row tid / (BK / 4), column (tid % (BK / 4)) 4."""
    tid = np.arange(3 * BK // 4)
    return tid // (BK // 4), (tid % (BK // 4)) * 4


def test_f32_staging_maps_cover_x_r_w_and_the_table_once():
    """Each thread stages tile_chunks = 2 chunks of the [64][16] X tile
    (R by the same map) and 2 of the [16][64] W tile; 12 threads stage the
    [3][16] table, one chunk each; each covers its tile once."""
    for (r, c), shape in ((rr_chunks(BK), (BM, BK)),
                          (rm_chunks(BK), (BK, BN)),
                          (table_chunks(), (3, BK))):
        seen = np.zeros(shape, int)
        for u in range(E):
            np.add.at(seen, (r, c + u), 1)
        assert (seen == 1).all()
    assert rr_chunks(BK)[0].size == rm_chunks(BK)[0].size == 2 * THREADS
    assert table_chunks()[0].size == 12


def post_cells(apart=False):
    """MmFwd::post in f32: thread tid takes the channel pair cp = 2 (tid %
    8) of rows tid / 8 + 16 i, i < 4; ``apart`` is the alternative that
    gives warp w rows w, w + 4, w + 8, w + 12 of each pass ((tid / 32) +
    4 (lane / 8)).  Yields (tid, i, row, cp)."""
    for tid in range(THREADS):
        lane = tid & 31
        cp = 2 * (lane % PAIRS)
        r0 = (tid >> 5) + 4 * (lane // PAIRS) if apart else tid // PAIRS
        for i in range(BM // ROWS):
            yield tid, i, r0 + ROWS * i, cp


def post_index():
    """(rows, columns) of the elements post() visits, both of each pair."""
    cells = np.array([(r, cp) for _, _, r, cp in post_cells()])
    return (np.concatenate([cells[:, 0], cells[:, 0]]),
            np.concatenate([cells[:, 1], cells[:, 1] + 1]))


def store_cells():
    """store_tile in f32: thread tid stores the 4-column chunk (tid % 16) 4
    of rows tid / 16 + 8 i, i < 8.  Yields (tid, i, row, col)."""
    for tid in range(THREADS):
        for i in range(8):
            yield tid, i, tid // 16 + 8 * i, (tid % 16) * E


def test_post_and_store_maps_cover_their_tiles_once():
    """post() visits each element of the [64][16] step tile once (both
    maps); store_tile's 16-byte chunks cover the 64 x 64 C tile once, a
    row's 256 bytes by 16 neighbouring lanes."""
    for apart in (False, True):
        seen = np.zeros((BM, BK), int)
        for _, _, r, cp in post_cells(apart):
            seen[r, cp:cp + 2] += 1
        assert (seen == 1).all()
    seen = np.zeros((BM, BN), int)
    lanes_of_row = {}
    for tid, i, r, cc in store_cells():
        seen[r, cc:cc + E] += 1
        lanes_of_row.setdefault((i, r), []).append(tid)
    assert (seen == 1).all()
    for t in lanes_of_row.values():
        assert t == list(range(t[0], t[0] + 16)) and t[0] % 16 == 0


def test_f32_ring_fits_static_shared_memory():
    """Three stages of X, R ([64][20]), W ([16][72]) and the [3][16] table:
    45,120 B (bf16 45,696 B), under the 48 KB of static shared memory; the
    C tile of store_tile (64 x 72 f32) overlays it."""
    stage = 2 * BM * LD_RR * 4 + BK * LD_RM * 4
    ring = STAGES * stage + STAGES * 3 * BK * 4
    bf16 = STAGES * (2 * BM * 40 * 2 + 32 * LD_RM * 2) + STAGES * 3 * 32 * 4
    assert (ring, bf16) == (45120, 45696)
    assert max(ring, BM * (BN + 8) * 4) <= SMEM_STATIC
    assert max(bf16, BM * (BN + 8) * 4) <= SMEM_STATIC


# -- the grid ------------------------------------------------------------------

def k11_grid(M, K, N):
    """The flattened grid: block b is M tile b // tiles_n, N tile b %
    tiles_n; every staged chunk of X, R, W and the table inside its tensor;
    Out written once by store_tile's map with its row guard."""
    tiles_m, tiles_n = cdiv(M, BM), cdiv(N, BN)
    out = np.zeros((M, N), int)
    order = []
    xr, xc = rr_chunks(BK)
    wr, wc = rm_chunks(BK)
    tj, tc = table_chunks()
    for b in range(tiles_m * tiles_n):
        mt, nt = divmod(b, tiles_n)
        order.append(mt)
        row0, col0 = mt * BM, nt * BN
        for k0 in range(0, K, BK):
            m = row0 + xr
            nx = np.where(m < M, chunk_len(k0 + xc, K), 0)
            k = k0 + wr
            nw = np.where(k < K, chunk_len(col0 + wc, N), 0)
            nt_ = np.clip(K - (k0 + tc), 0, 4)
            for idx, n, size in ((m * K + k0 + xc, nx, M * K),
                                 (k * N + col0 + wc, nw, K * N),
                                 (tj * K + k0 + tc, nt_, 3 * K)):
                assert ((idx >= 0) & (idx + n <= size))[n > 0].all()
        for _, _, r, cc in store_cells():
            n = chunk_len(col0 + cc, N)
            if row0 + r < M:
                out[row0 + r, col0 + cc:col0 + cc + n] += 1
    assert (out == 1).all()
    # the blocks of one M tile sit next to each other
    assert order == sorted(order)
    assert all(order.count(mt) == tiles_n for mt in range(tiles_m))


@pytest.mark.parametrize("K", [20, 64, 96, 128, 256, 512])
@pytest.mark.parametrize("N", [20, 64, 96, 128, 256, 512])
def test_k11_grid_writes_out_once(K, N):
    """At a ragged M (two tiles and a tail)."""
    k11_grid(2 * BM + 37, K, N)


# -- the lane maps -------------------------------------------------------------

def warp_products(sa, sb):
    """The 64 x 64 tile from each warp's 3xTF32 fragments of one 16-deep
    step: A from the [64][20] X tile by ldmatrix (frag_a_rr), B from the
    [16][72] W tile by lanes (rows kk + t, kk + t + 4, column wc + 8 nj +
    g), placed by the C map, each cell once."""
    C = np.full((BM, BN), np.nan)
    for wr, wc in warps():
        part = np.zeros((2, 4, 32, 4))
        for kk in range(0, BK, 8):
            a = frag_a_rr(sa, LD_RR, wr, kk)
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


def test_lane_maps_give_the_tile_product():
    """One step: A = the prologue's X tile [64][16] (row stride 20), B = W
    [16][64] (row stride 72); the warps' fragments give A W exactly (small
    integers: the small halves are 0)."""
    rng = np.random.RandomState(3)
    A = rng.randint(-4, 5, (BM, BK)).astype(np.float32)
    W = rng.randint(-4, 5, (BK, BN)).astype(np.float32)
    sa, sb = np.zeros(BM * LD_RR, np.float32), np.zeros(BK * LD_RM,
                                                        np.float32)
    sa.reshape(BM, LD_RR)[:, :BK] = A
    sb.reshape(BK, LD_RM)[:, :BN] = W
    np.testing.assert_array_equal(warp_products(sa, sb),
                                  A.astype(np.float64) @ W)


def post_conflicts(apart):
    """The largest number of distinct words that one bank serves in one
    float2 phase (a half warp) of post()'s X (and R) accesses."""
    worst = 1
    cells = {}
    for tid, i, r, cp in post_cells(apart):
        cells.setdefault((tid >> 5, i, (tid & 31) >> 4), []).append(
            r * LD_RR + cp)
    for words in cells.values():
        w = np.array(words)[:, None] + np.arange(2)
        banks = {}
        for word in w.ravel():
            banks.setdefault(word % 32, set()).add(word)
        worst = max(worst, max(len(s) for s in banks.values()))
    return worst


def test_bank_conflicts_of_the_loads_post_and_epilogue():
    """Every warp, every 8-deep step: A's ldmatrix phases (row stride 20
    words) each cover the 32 banks once; each lane load of B (b0, b1)
    from the 72-word rows names 32 distinct banks (8 t + g plus a
    constant).  post()'s float2 pairs: a half warp's 16 lanes take two
    adjacent rows (20 words apart), which share 4 banks, two words each
    (a 2-way conflict); rows 4 apart (80 words, 16 banks on) would cover
    the 32 banks once.  The table's pairs: 8 distinct words a phase, in
    distinct banks.  The epilogue: the C tile's float2 stores (row stride
    72) and store_tile's float4 reads (one row's 8 chunks a quarter warp)
    fall in distinct banks."""
    for wr, wc in warps():
        for kk in range(0, BK, 8):
            for mi in range(2):
                _ldmatrix_free((wr + 16 * mi + a_row(LANES)) * LD_RR + kk +
                               4 * a_col16(LANES))
            for nj in range(4):
                words = b_rm_words(wc, kk, nj)
                for j in range(2):
                    assert len(set(words[:, j] % 32)) == 32
    assert post_conflicts(apart=False) == 2
    assert post_conflicts(apart=True) == 1
    for half in (slice(0, 16), slice(16, 32)):
        cp = 2 * (LANES[half] % PAIRS)
        words = set(np.concatenate([cp, cp + 1]))
        assert len({w % 32 for w in words}) == len(words) == 16
    g, t = LANES >> 2, LANES & 3
    ld_c = BN + 8
    for wr, wc in warps():
        for mi in range(2):
            for h in range(2):
                for nj in range(4):
                    w = (wr + 16 * mi + g + 8 * h) * ld_c + wc + 8 * nj + 2 * t
                    for half in (slice(0, 16), slice(16, 32)):
                        ww = np.concatenate([w[half], w[half] + 1])
                        assert len(set(ww % 32)) == 32
    for i in range(8):
        for q in range(0, THREADS, 8):
            words = np.array([(u // 16 + 8 * i) * ld_c + (u % 16) * E
                              for u in range(q, q + 8)])
            assert len(set(((words[:, None] + np.arange(E)) % 32).ravel())) \
                == 32


# -- the kernel, block by block ------------------------------------------------

def get4(flat, off, n):
    """A staged chunk: the first n elements at off, zeros after."""
    v = np.zeros(E, np.float32)
    v[:n] = flat[off:off + n]
    return v


def k11_emulated(x, r, mu, gi, b, w, act, one_pass=False):
    """f32 K11 on f32 inputs, block by block: X (and R) staged raw by the
    chunk map with zeros past M and K, the step's parameter table with
    zeros past K, post() over its map in f32 (pre_act's separately rounded
    chain), W staged as [16][64] with zeros past K and N; each step's
    3xTF32 products from zero, added in f32 (one TF32 pass with
    `one_pass`); store_tile's map with its row guard.  Returns (out, each
    step's (k0, A tile, W tile) of the first block)."""
    M, K = x.shape
    N = w.shape[1]
    prm = np.stack([mu, gi, b]).astype(np.float32)
    xf, wf = x.ravel(), w.ravel()
    rf = None if r is None else r.ravel()
    tiles_n = cdiv(N, BN)
    out = np.full((M, N), np.nan, np.float32)
    xr, xc = rr_chunks(BK)
    wr, wc = rm_chunks(BK)
    tj, tc = table_chunks()
    pr, pc = post_index()
    first = []
    for blk in range(cdiv(M, BM) * tiles_n):
        mt, nt = divmod(blk, tiles_n)
        row0, col0 = mt * BM, nt * BN
        steps = []
        for k0 in range(0, K, BK):
            tx = np.zeros((BM, BK), np.float32)
            tr = None if r is None else np.zeros((BM, BK), np.float32)
            tw = np.zeros((BK, BN), np.float32)
            table = np.zeros((3, BK), np.float32)
            for rr, c in zip(xr, xc):
                m = row0 + rr
                nx = chunk_len(k0 + c, K) if m < M else 0
                tx[rr, c:c + E] = get4(xf, m * K + k0 + c, nx)
                if r is not None:
                    tr[rr, c:c + E] = get4(rf, m * K + k0 + c, nx)
            for kr, nc in zip(wr, wc):
                k = k0 + kr
                nw = chunk_len(col0 + nc, N) if k < K else 0
                tw[kr, nc:nc + E] = get4(wf, k * N + col0 + nc, nw)
            for j, c in zip(tj, tc):
                n = max(0, min(4, K - (k0 + c)))
                table[j, c:c + n] = prm[j, k0 + c:k0 + c + n]
            tx[pr, pc] = prologue_f32(
                tx[pr, pc], None if r is None else tr[pr, pc],
                table[0, pc], table[1, pc], table[2, pc], act)
            steps.append((k0, tx, tw))
        acc = walk(((tx, tw) for _, tx, tw in steps), one_pass)
        if blk == 0:
            first = steps
        for _, _, rr, cc in store_cells():
            n = chunk_len(col0 + cc, N)
            if row0 + rr < M:
                out[row0 + rr, col0 + cc:col0 + cc + n] = acc[rr, cc:cc + n]
    assert not np.isnan(out).any()
    return out, first


def _run(M, K, N, has_r, act, seed, one_pass=False):
    """(emulated out, the case, its f32 statistics) on f32 inputs clear
    of the ReLU's kink."""
    a, (mu, inv, g, b) = _case((M, K), (K, N), (M, N), has_r, seed)
    out, tiles = k11_emulated(a["x"], a["r"], mu, inv * g, b, a["w"], act,
                              one_pass)
    return out, tiles, a


def _plain64(a, act):
    t = {k: None if a[k] is None else torch.from_numpy(a[k]).double()
         for k in ("x", "gamma", "beta", "mean", "var", "w", "r")}
    return t_bnmm.bn_matmul_fwd_ref(t["x"], t["gamma"], t["beta"],
                                    t["mean"], t["var"], t["w"], t["r"],
                                    act).numpy()


def test_emulated_k11_zeroes_the_k_tail_of_a():
    """Channels past K contribute nothing, and A's tail is itself zero:
    with the border case's statistics the prologue of a zero-filled
    element, act(beta - mean * gi), is far from 0, yet A's tail columns
    are 0 after post() because a channel past K takes zero parameters
    (the table's zero fill; act(0) = 0); W's tail rows are zero-filled
    too, so neither operand's tail carries a value."""
    M, K, N = 70, 20, 16
    a, (mu, inv, g, b) = _case((M, K), (K, N), (M, N), False, 1)
    a["beta"] = (a["beta"] + 5.0).astype(np.float32)
    a["mean"] = (a["mean"] + 3.0).astype(np.float32)
    mu, inv, g, b, gi = (v.numpy() for v in t_bnmm.stats(
        *(torch.from_numpy(a[k]) for k in ("gamma", "beta", "mean", "var")),
        1e-5, torch.float32))
    assert (np.maximum(b - mu * gi, 0) > 1.0).all()
    out, tiles = k11_emulated(a["x"], None, mu, gi, b, a["w"], "relu")
    for k0, ta, tw in tiles:
        tail = max(0, K - k0)
        if tail < BK:
            assert (ta[:, tail:] == 0).all()
            assert (tw[tail:] == 0).all()
        assert (ta[:, :tail] != 0).any()
    assert _rel(out, _plain64(a, "relu")) <= 1e-5


@pytest.mark.parametrize("M,K,N,has_r,act", [
    (200, 64, 96, True, "relu"), (130, 128, 64, False, None),
    (256, 512, 128, True, "relu"), (37, 18, 22, False, "relu"),
    (100, 96, 20, True, None)])
def test_emulated_k11_within_1e5_of_float64(M, K, N, has_r, act):
    """f32 K11's body against the plain version in float64 from the same
    f32 inputs, within 1e-5 of max |value| (ragged M, K 18 and N 22 not
    whole chunks, N 20 and 96 partial N tiles, stage 2's K 512 with a
    residual; 1.2e-7 to 2.1e-7).  One TF32 pass misses 1e-4 at each of
    these shapes, stage 2's K 512 included (3.0e-4 to 5.1e-4)."""
    out, _, a = _run(M, K, N, has_r, act, M + K + N)
    ref = _plain64(a, act)
    assert _rel(out, ref) <= 1e-5
    one, _, _ = _run(M, K, N, has_r, act, M + K + N, one_pass=True)
    assert _rel(one, ref) > TOL


@pytest.mark.parametrize("act,has_r", [("relu", False), (None, False),
                                       ("relu", True), (None, True)])
def test_emulated_k11_matches_jax(act, has_r):
    """At the JAX tests' shape (M 64, K 128, N 256) the f32 body against
    the JAX ``bn_matmul_fwd`` in interpret mode, within 1e-4 of max
    |value|."""
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas_kernels import bn_matmul as jbm

    out, _, a = _run(64, 128, 256, has_r, act, 5 + has_r)
    j = {k: None if a[k] is None else jnp.asarray(a[k])
         for k in ("x", "gamma", "beta", "mean", "var", "w", "r")}
    want = jbm.bn_matmul_fwd(j["x"], j["gamma"], j["beta"], j["mean"],
                             j["var"], j["w"], r=j["r"], act=act,
                             interpret=True)
    assert _rel(out, np.asarray(want)) <= TOL
