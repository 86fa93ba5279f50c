// The fused BatchNorm(+residual)+act -> 3x3 convolution (pad 1, stride 1
// or 2, NHWC, HWIO weights) for Hopper (sm_90a): the forward (K13), its
// O-blocked variant (K14) and the backward (K15).
//
// Replaces the Pallas TPU kernels bn_conv3x3_fwd, bn_conv3x3_fwd_v2 and
// bn_conv3x3_bwd (paddle_tpu/ops/pallas_kernels/bn_conv.py: _fwd_body,
// _fwd_body_v2, _bwd_body).  Those hold a whole image and the whole weight
// in VMEM and sum nine shifted [H*W, K] x [K, O] products per image.  Here
// the convolution is an implicit GEMM: rows are output pixels, columns
// output channels, and the reduction runs over the nine taps x K input
// channels.
//
// Bound on an H100: 18 M_out K O flops forward and 36 backward, far above
// the bytes at ResNet's shapes: compute-bound on paper, at the bf16
// tensor-core rate in bf16 and, in f32, at the TF32 rate times three
// (3xTF32, below).  Every forward and the backward begin with one prep
// pass (bnc_pad_prep) that writes the padded, normalized activation apad
// [N, H+2, W+2, K] in the input's type, the prologue evaluated once per
// element of X (zero on the border: padding after the prologue), 16 bytes
// a thread.  That one tensor (29.5 MB in bf16 at stage 2, 59 MB in f32,
// written and read back) is what the kernels write beyond their outputs:
// no tap copy is ever written.
//
// K13 bf16, two launches: (1) the prep pass; (2) bnc_fwd_mma, an implicit
// GEMM on bn_mma.cuh's 64 x 64 tiles (4 warps) whose A rows are output
// pixels: each (pixel, tap) is a contiguous run of K channels of apad at
// ((n (H+2) + ho s + ky) (W+2) + wo s + kx) K, staged 16 bytes a chunk by
// cp.async with no bounds test, the pixel decoded once per block and the
// tap's offset once per step; B is W[ky,kx] as a [k][o] tile
// (ldmatrix.trans); the blocks of one pixel tile adjacent in the grid (its
// apad rows come from L2 for the second O tile); the output leaves 16
// bytes a thread through shared memory (bn_mma.cuh store_tile).
// K14 (bf16 and f32) and f32 K13, two launches: (1) the prep pass; (2)
// bnc_fwd_wide, the same implicit GEMM with a block owning 64 pixels x
// its O block (f32 K13: 128 channels, 64 when O <= 64; K14:
// _v2_block_o, 128 or 256, else O), walked in passes of up to 128
// channels (bf16: 8 warps of 32 x 32; f32: 4 warps of 32 x 64, which
// split each A fragment once for 8 n-tiles; 4 warps of 32 x 32 at 64
// wide), so each staged A chunk serves all 128 channels of a pass; the
// reduction in 64-channel (bf16) or 32-channel (f32) steps through a ring
// of three cp.async stages in dynamic shared memory.  bf16 runs
// mma.sync m16n8k16; f32 runs m16n8k8 TF32 products in 3xTF32 (mma.cuh:
// each operand x = big + small, three products a b = a_small b_big +
// a_big b_small + a_big b_big, small passed unrounded), A read by
// ldmatrix as 8 x 4 f32 matrices and B by 32-bit lane loads (ldmatrix
// cannot transpose 32-bit elements), each fragment split as it is read.
// One TF32 product keeps 11 bits and would miss the f32 tolerance 1e-4.
// Each step's products are summed into zeroed registers and added to the
// running sums in f32 (bn_mma.cuh's rule against the tensor cores'
// truncating accumulation), so every output element is summed in one
// order whatever the block's width: f32 K13 and K14 give the same bits.
// K15 (bf16 and f32), five launches on bn_mma.cuh's 64 x 64 tiles (bf16
// m16n8k16; f32 m16n8k8 in 3xTF32 under the rules above: fragments split
// as read, small halves unrounded, each step's products summed from zero
// and added in f32): (1) dA, an implicit GEMM whose A rows are input
// pixels: each (pixel, tap) is a contiguous run of O channels of dO at
// ((h+1-ky)/s, (w+1-kx)/s) or zero (stride 2: the parity test; stride 2 is
// computed directly, no dilated dO), staged 16 bytes a chunk by cp.async
// with zero fill, the pixel decoded once per block and the tap's source
// once per stage; B is W[ky,kx] as a [k][o] tile; the epilogue is K12's
// (bn_mma.cuh da_epilogue: pre recomputed with pre_act's rounding chain,
// dX, dR 16 bytes a thread, the dgamma / dbeta column sums per tile in a
// fixed order); (2) the prep pass; (3) dW[ky,kx] = apad(tap)^T dO per (K
// tile, O tile, tap x M split): both operands plain 16-byte rows of apad
// and dO, an output pixel decoded once per staged chunk by multiplies
// (bn_mma.cuh FastDiv), read as fragments by ldmatrix.trans (bf16) or
// 32-bit lane loads (f32); (4) the splits summed in a fixed order into
// HWIO dW, cast once; (5) dgamma, dbeta from the tile sums in f64.  A step
// is 128 bytes of a row in both dtypes (64 bf16, 32 f32), so the rings
// take the same shared memory.  The TPU design's resident dW / dgamma /
// dbeta accumulators became those second passes, so reruns are
// bit-reproducible.  The whole prologue's cost is one pass over X, not
// one per tap and O tile, and the one extra tensor is apad (read by dW
// nine times over, once per tap, mostly from L2).

#include <algorithm>

#include "bn_mma.cuh"

namespace ptt {
namespace {

struct Geom {
  int N, H, W, K, O, Ho, Wo, s;
};

// K13, K14 and K15 on the tensor cores (bn_mma.cuh, mma.cuh).
using bnmma::TileRM;
using bnmma::TileRR;
using bf16 = __nv_bfloat16;

// The first launch of K13 and K14, the second of K15 (both dtypes): apad[n, hp,
// wp, k] = prologue(X[n, hp-1, wp-1, k]) inside, 0 on the border, in T.
// grid: N * (H + 2), one padded row a block; a thread takes 16-byte chunks
// of the row (8 bf16 or 4 f32 channels; loaded and stored as one uint4
// when VEC, element by element otherwise).
template <typename T, bool VEC>
__global__ void __launch_bounds__(256)
bnc_pad_prep(const T* __restrict__ x, const T* __restrict__ res,
             const float* __restrict__ prm, T* __restrict__ apad, Geom g,
             int act) {
  constexpr int E = 16 / sizeof(T);  // channels a chunk
  const int hp = blockIdx.x % (g.H + 2), n = blockIdx.x / (g.H + 2);
  const int kc = (g.K + E - 1) / E, wpad = g.W + 2;
  const bool row_in = hp >= 1 && hp <= g.H;
  T* out = apad + (size_t)blockIdx.x * wpad * g.K;
  for (int e = threadIdx.x; e < wpad * kc; e += blockDim.x) {
    const int wp = e / kc, k0 = (e - wp * kc) * E;
    const bool in = row_in && wp >= 1 && wp <= g.W;
    const size_t off =
        ((size_t)(n * g.H + hp - 1) * g.W + wp - 1) * g.K + k0;
    uint4 xr = make_uint4(0, 0, 0, 0), rr = xr, orr;
    T* xv = reinterpret_cast<T*>(&xr);
    T* rv = reinterpret_cast<T*>(&rr);
    T* ov = reinterpret_cast<T*>(&orr);
    if (in) {
      if constexpr (VEC) {
        xr = *reinterpret_cast<const uint4*>(x + off);
        if (res != nullptr) rr = *reinterpret_cast<const uint4*>(res + off);
      } else {
#pragma unroll
        for (int u = 0; u < E; ++u)
          if (k0 + u < g.K) {
            xv[u] = x[off + u];
            if (res != nullptr) rv[u] = res[off + u];
          }
      }
    }
#pragma unroll
    for (int u = 0; u < E; ++u) {
      float v = 0.f;
      if (in && k0 + u < g.K) {
        const Chan c = chan(prm, g.K, k0 + u);
        v = pre_act(to_f(xv[u]), c.mu, c.gi, c.b);
        if (res != nullptr) v = __fadd_rn(v, to_f(rv[u]));
        if (act == 1) v = fmaxf(v, 0.f);
      }
      ov[u] = from_f<T>(v);
    }
    T* o = out + (size_t)wp * g.K + k0;
    if constexpr (VEC) {
      *reinterpret_cast<uint4*>(o) = orr;
    } else {
#pragma unroll
      for (int u = 0; u < E; ++u)
        if (k0 + u < g.K) o[u] = ov[u];
    }
  }
}

// K13 bf16 (2): A rows are output pixels (this thread's four decoded once
// to the apad offset of their top-left tap), the reduction (tap, k) in
// steps of 64 channels k within each tap through a ring of two: a chunk of
// A is 8 channels of apad at the row's offset plus the tap's, never out of
// bounds (the border is apad's zeros); B = W[tap] [K][O] as a [k][o]
// tile.  Channels past K are zero in both (the chunks' zero fill).
template <bool VEC>
struct ConvFwd {
  static constexpr bool kPost = false;
  static constexpr int kBK = 64, kStages = 2, kRows = kBK / 16;
  struct Ring {
    TileRR<kBK> a[kStages];
    TileRM<kBK> b[kStages];
  };
  TileRR<kBK>* sa;
  TileRM<kBK>* sb;
  const bf16* apad;
  const bf16* w;
  int K, O, wpad, col0, ksteps;
  size_t base[kRows];
  bool pok[kRows];
  __device__ void stage(int buf, int step) const {
    const int tap = step / ksteps;
    const int k0 = (step - tap * ksteps) * kBK;
    const int dy = tap / 3, dxx = tap - 3 * dy;
    const size_t toff = ((size_t)dy * wpad + dxx) * K + k0;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = bnmma::rr_row<kBK>(i), c = bnmma::rr_col<kBK>(i);
      const int na = pok[i] ? bnmma::chunk_len(k0 + c, K) : 0;
      bnmma::stage_chunk<VEC>(&sa[buf].v[r][c],
                              na ? apad + base[i] + toff + c : apad, na);
      const int kr = bnmma::rm_row(i), oc = bnmma::rm_col(i);
      const int k = k0 + kr;
      const int nb = k < K ? bnmma::chunk_len(col0 + oc, O) : 0;
      bnmma::stage_chunk<VEC>(
          &sb[buf].v[kr][oc],
          nb ? w + ((size_t)tap * K + k) * O + col0 + oc : w, nb);
    }
  }
  __device__ const TileRR<kBK>& a(int buf) const { return sa[buf]; }
  __device__ const TileRM<kBK>& b(int buf) const { return sb[buf]; }
};

// K15 (2), both dtypes: A rows are input pixels (this thread's four
// decoded once), the reduction (tap, o) in steps of 128 bytes of channels
// o (64 bf16, 32 f32) within each tap through a ring of two; B = W[tap]
// [K][O] rows k.
template <typename T, bool VEC>
struct ConvDA {
  static constexpr bool kPost = false;
  static constexpr int E = 16 / sizeof(T);
  static constexpr int kBK = 8 * E, kStages = 2;
  static constexpr int kRows = bnmma::tile_chunks<kBK, T>();
  TileRR<kBK, T>* sa;
  TileRR<kBK, T>* sb;
  const T* dout;
  const T* w;
  Geom g;
  int col0, osteps;
  int pn[kRows], ph[kRows], pw[kRows];
  bool pok[kRows];
  __device__ void stage(int buf, int step) const {
    const int tap = step / osteps;
    const int o0 = (step - tap * osteps) * kBK;
    const int dy = tap / 3, dxx = tap - 3 * dy;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = bnmma::rr_row<kBK, T>(i), c = bnmma::rr_col<kBK, T>(i);
      int ho = ph[i] + 1 - dy, wo = pw[i] + 1 - dxx;
      bool v = pok[i] && ho >= 0 && wo >= 0;
      if (g.s == 2) {
        v = v && !((ho | wo) & 1);
        ho >>= 1;
        wo >>= 1;
      }
      v = v && ho < g.Ho && wo < g.Wo;
      const int na = v ? bnmma::chunk_len<E>(o0 + c, g.O) : 0;
      bnmma::stage_chunk<VEC>(
          &sa[buf].v[r][c],
          na ? dout + ((size_t)(pn[i] * g.Ho + ho) * g.Wo + wo) * g.O + o0 + c
             : dout,
          na);
      const int k = col0 + r;
      const int nb = k < g.K ? bnmma::chunk_len<E>(o0 + c, g.O) : 0;
      bnmma::stage_chunk<VEC>(
          &sb[buf].v[r][c],
          nb ? w + ((size_t)tap * g.K + k) * g.O + o0 + c : w, nb);
    }
  }
  __device__ const TileRR<kBK, T>& a(int buf) const { return sa[buf]; }
  __device__ const TileRR<kBK, T>& b(int buf) const { return sb[buf]; }
};

// K15 (3), both dtypes: A^T rows are output pixels m of one tap, read
// from apad at (n, ho*s + ky, wo*s + kx), B = dO [m][o]; the reduction m
// in [r_begin, r_end), 64 bf16 or 32 f32 rows a step (the same bytes)
// through a ring of two.
template <typename T, bool VEC>
struct ConvDW {
  static constexpr bool kPost = false;
  static constexpr int E = 16 / sizeof(T);
  static constexpr int kBK = 8 * E, kStages = 2;
  TileRM<kBK, T>* sa;
  TileRM<kBK, T>* sb;
  const T* apad;
  const T* dout;
  Geom g;
  bnmma::FastDiv div_wo, div_ho;
  int dy, dxx, row0, col0, r_begin, r_end;
  __device__ void stage(int buf, int step) const {
    const int m0 = r_begin + step * kBK;
#pragma unroll
    for (int i = 0; i < bnmma::tile_chunks<kBK, T>(); ++i) {
      const int r = bnmma::rm_row<T>(i), c = bnmma::rm_col<T>(i);
      const int m = m0 + r;
      const bool ok = m < r_end;
      int na = 0, nd = 0;
      const T* pa = apad;
      const T* pd = dout;
      if (ok) {
        const int t = div_wo.div(m), wo = m - t * g.Wo;
        const int n = div_ho.div(t), ho = t - n * g.Ho;
        na = bnmma::chunk_len<E>(row0 + c, g.K);
        pa = apad + ((size_t)(n * (g.H + 2) + ho * g.s + dy) * (g.W + 2) +
                     wo * g.s + dxx) * g.K + row0 + c;
        nd = bnmma::chunk_len<E>(col0 + c, g.O);
        pd = dout + (size_t)m * g.O + col0 + c;
      }
      bnmma::stage_chunk<VEC>(&sa[buf].v[r][c], na ? pa : apad, na);
      bnmma::stage_chunk<VEC>(&sb[buf].v[r][c], nd ? pd : dout, nd);
    }
  }
  __device__ const TileRM<kBK, T>& a(int buf) const { return sa[buf]; }
  __device__ const TileRM<kBK, T>& b(int buf) const { return sb[buf]; }
};

// K13 bf16 (2). grid: ceil(N*Ho*Wo / 64) * ceil(O / 64), block b = pixel
// tile b / tiles_o, O tile b % tiles_o.
template <bool VEC>
__global__ void __launch_bounds__(bnmma::kThreads)
bnc_fwd_mma(const bf16* __restrict__ apad, const bf16* __restrict__ w,
            bf16* __restrict__ out, Geom g) {
  using Op = ConvFwd<VEC>;
  __shared__ __align__(16) bnmma::OutSmem<typename Op::Ring> sm;
  const int rows = g.N * g.Ho * g.Wo;
  const int tiles_o = (g.O + bnmma::kBN - 1) / bnmma::kBN;
  const int mt = blockIdx.x / tiles_o, ot = blockIdx.x - mt * tiles_o;
  const int row0 = mt * bnmma::kBM, col0 = ot * bnmma::kBN;
  const int ksteps = (g.K + Op::kBK - 1) / Op::kBK;
  Op op{sm.ring.a, sm.ring.b, apad, w, g.K, g.O, g.W + 2, col0, ksteps,
        {}, {}};
#pragma unroll
  for (int i = 0; i < Op::kRows; ++i) {
    const int p = row0 + bnmma::rr_row<Op::kBK>(i);
    const int wo = p % g.Wo, t = p / g.Wo;
    const int n = t / g.Ho, ho = t - n * g.Ho;
    op.base[i] =
        ((size_t)(n * (g.H + 2) + ho * g.s) * (g.W + 2) + wo * g.s) * g.K;
    op.pok[i] = p < rows;
  }
  float acc[2][4][4];
  bnmma::mma_loop(acc, op, 9 * ksteps);
  bnmma::store_tile<VEC>(acc, sm.c, out, row0, rows, col0, g.O);
}

// K15 (2). grid: ceil(N*H*W / 64) * ceil(K / 64), block b = pixel tile
// b / tiles_k, K tile b % tiles_k.
template <typename T, bool VEC>
__global__ void __launch_bounds__(bnmma::kThreads)
bnc_bwd_da_mma(const T* __restrict__ x, const T* __restrict__ res,
               const float* __restrict__ prm4, const T* __restrict__ w,
               const T* __restrict__ dout, T* __restrict__ dx,
               T* __restrict__ dr, float* __restrict__ gb_part, Geom g,
               int act) {
  using Op = ConvDA<T, VEC>;
  __shared__ __align__(16) bnmma::DaSmem<Op::kBK, Op::kStages, T> sm;
  const int rows = g.N * g.H * g.W;
  const int tiles_k = (g.K + bnmma::kBN - 1) / bnmma::kBN;
  const int mt = blockIdx.x / tiles_k, kt = blockIdx.x - mt * tiles_k;
  const int row0 = mt * bnmma::kBM, col0 = kt * bnmma::kBN;
  const int osteps = (g.O + Op::kBK - 1) / Op::kBK;
  Op op{sm.ring.a, sm.ring.b, dout, w, g, col0, osteps, {}, {}, {}, {}};
#pragma unroll
  for (int i = 0; i < Op::kRows; ++i) {
    const int p = row0 + bnmma::rr_row<Op::kBK, T>(i);
    const int wq = p % g.W, t = p / g.W;
    op.pn[i] = t / g.H;
    op.ph[i] = t % g.H;
    op.pw[i] = wq;
    op.pok[i] = p < rows;
  }
  float acc[2][4][4];
  bnmma::mma_loop(acc, op, 9 * osteps);
  bnmma::da_epilogue<VEC>(acc, x, res, prm4, dx, dr, gb_part, mt, row0,
                          rows, col0, g.K, act, sm);
}

// K15 (3). grid: (ceil(K / 64), ceil(O / 64), 9 * splits); z = tap *
// splits + split sums output pixels [split * chunk, ...) into
// part[z][K][O].
template <typename T, bool VEC>
__global__ void __launch_bounds__(bnmma::kThreads)
bnc_bwd_dw_mma(const T* __restrict__ apad, const T* __restrict__ dout,
               float* __restrict__ part, Geom g, bnmma::FastDiv div_wo,
               bnmma::FastDiv div_ho, int splits, int chunk) {
  using Op = ConvDW<T, VEC>;
  __shared__ __align__(16) TileRM<Op::kBK, T> sa[Op::kStages];
  __shared__ __align__(16) TileRM<Op::kBK, T> sb[Op::kStages];
  const int z = blockIdx.z, tap = z / splits, sp = z - tap * splits;
  const int m_out = g.N * g.Ho * g.Wo;
  const int r_begin = sp * chunk, r_end = min(m_out, r_begin + chunk);
  const int row0 = blockIdx.x * bnmma::kBM, col0 = blockIdx.y * bnmma::kBN;
  Op op{sa, sb, apad, dout, g, div_wo, div_ho, tap / 3, tap % 3, row0,
        col0, r_begin, r_end};
  float acc[2][4][4];
  bnmma::mma_loop(acc, op, (r_end - r_begin + Op::kBK - 1) / Op::kBK);
  bnmma::store_part<VEC>(acc, part + (size_t)z * g.K * g.O, row0, g.K, col0,
                         g.O);
}

// -- K14 (bf16 and f32) and f32 K13: the wide tap product -------------------

// The tiling of bnc_fwd_wide for element type T and a pass BN channels
// wide (64 or 128): 64 output pixels x BN channels a pass, warps 2 x (BN /
// WN), each 32 x WN (WN 64 for an f32 128-wide pass, so each split A
// fragment serves 8 n-tiles; else 32); the reduction (tap, k) in steps of
// BK channels (64 bf16 or 32 f32: a 16-byte chunk is 8 or 4 of them, so an
// A row of a step is 8 chunks in both); A [64][BK + LDA pad] rows of apad, B
// [BK][BN + 8] rows of W[tap] (contiguous along O).  A's row stride is 144
// bytes in both dtypes, so the 8 rows of an ldmatrix phase fall in
// distinct 16-byte bank groups; B's is BN + 8 elements: for bf16 the
// .trans rows likewise, for f32 a lane (g, t) reads word (kk + t) (BN + 8)
// + n + g, bank 8 t + g, all 32 distinct.
template <typename T, int BN>
struct Wide {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int E = 16 / sizeof(T);  // elements a chunk
  static constexpr int BK = kF32 ? 32 : 64;
  static constexpr int WN = kF32 && BN == 128 ? 64 : 32;
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kThreads = 64 * kWarpsN;  // 2 warp rows
  // blocks an SM the registers are sized for (__launch_bounds__): two of
  // a 128-wide pass (f32: 8 warps of 32 x 64, up to 255 registers a
  // thread for their 128 accumulators; bf16: 16 warps of 32 x 32, up to
  // 128), three of a 64-wide one (12 warps, up to 168; at four it spilled,
  // and bf16 ran 1.7% slower at ResNet-50's stage 1, f32 0.5% faster)
  static constexpr int kMinBlocks = BN == 64 ? 3 : 2;
  static constexpr int LDA = BK + (kF32 ? 4 : 8);
  static constexpr int LDB = BN + 8;
  static constexpr int LDC = BN + 8;  // the f32 C tile of the epilogue
  static constexpr int kStages = 3;  // the ring's depth
  static constexpr int kAChunks = 64 * (BK / E) / kThreads;  // a thread's
  static constexpr int kBChunks = BK * (BN / E) / kThreads;
  static constexpr int kStage = 64 * LDA + BK * LDB;  // elements a stage
  static constexpr size_t kRing = (size_t)kStages * kStage * sizeof(T);
  static constexpr size_t kCTile = (size_t)64 * LDC * sizeof(float);
  static constexpr size_t kSmem = kRing > kCTile ? kRing : kCTile;
  static_assert(kAChunks * kThreads == 64 * (BK / E), "whole A chunks");
  static_assert(kBChunks * kThreads == BK * (BN / E), "whole B chunks");
};

// The loads of reduction step `step` = (tap, k0) into ring stage `buf`:
// A chunk i of this thread is 8 bf16 or 4 f32 channels of apad at its
// pixel's top-left tap (base[i], decoded once) plus the tap's offset,
// never out of bounds (the border is apad's zeros); B is W[tap] rows k0..
// columns col0.., zero past K and past the block's c_end.
template <typename T, int BN, bool VEC>
__device__ __forceinline__ void wide_stage(
    T* __restrict__ buf, const T* __restrict__ apad,
    const T* __restrict__ w, const size_t (&base)[Wide<T, BN>::kAChunks],
    const Geom& g, int col0, int c_end, int ksteps, int step) {
  using L = Wide<T, BN>;
  constexpr int E = L::E;
  const int tap = step / ksteps;
  const int k0 = (step - tap * ksteps) * L::BK;
  const int dy = tap / 3, dxx = tap - 3 * dy;
  const size_t toff = ((size_t)dy * (g.W + 2) + dxx) * g.K + k0;
  T* sa = buf;
  T* sb = buf + 64 * L::LDA;
#pragma unroll
  for (int i = 0; i < L::kAChunks; ++i) {
    const int e = threadIdx.x + i * L::kThreads;
    const int r = e / (L::BK / E), c = (e % (L::BK / E)) * E;
    const int n =
        base[i] != ~(size_t)0 ? bnmma::chunk_len<E>(k0 + c, g.K) : 0;
    bnmma::stage_chunk<VEC>(sa + r * L::LDA + c,
                            n ? apad + base[i] + toff + c : apad, n);
  }
#pragma unroll
  for (int i = 0; i < L::kBChunks; ++i) {
    const int e = threadIdx.x + i * L::kThreads;
    const int kr = e / (BN / E), oc = (e % (BN / E)) * E;
    const int k = k0 + kr;
    const int n = k < g.K ? bnmma::chunk_len<E>(col0 + oc, c_end) : 0;
    bnmma::stage_chunk<VEC>(
        sb + kr * L::LDB + oc,
        n ? w + ((size_t)tap * g.K + k) * g.O + col0 + oc : w, n);
  }
}

// One step's products of a warp (rows wr.., columns wc..) into `part`,
// from zero.  bf16: m16n8k16, A by ldmatrix (a_row/a_col), B by
// ldmatrix.trans from the [k][o] tile (bt_row/bt_col), the first product
// of the step with C = 0.  f32: m16n8k8 in 3xTF32, A by ldmatrix as 8 x 4
// f32 matrices (a_row/tf32_a_col: a0..a3 = (g, t), (g+8, t), (g, t+4),
// (g+8, t+4)), B by 32-bit loads of rows kk + t and kk + t + 4, column g
// of each n-tile (b0, b1); every fragment is split into big and small as
// it is read (small unrounded, mma.cuh split_tf32<true>).
template <typename T, int BN>
__device__ __forceinline__ void wide_products(
    float (&part)[2][Wide<T, BN>::WN / 8][4], const T* __restrict__ sa,
    const T* __restrict__ sb, int wr, int wc, int lane) {
  using L = Wide<T, BN>;
  constexpr int NT = L::WN / 8;  // n-tiles of the warp
  if constexpr (L::kF32) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < NT; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mi][nj][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < L::BK; kk += 8) {
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        uint32_t x[4];
        mma::ldsm_x4(x, sa + (wr + mi * 16 + mma::a_row(lane)) * L::LDA +
                            kk + mma::tf32_a_col(lane));
        mma::split_tf32<true>(x, ab[mi], as[mi]);
      }
      const float* bp = sb + (kk + t) * L::LDB + wc + g;
#pragma unroll
      for (int nj = 0; nj < NT; ++nj) {
        uint32_t bb0, bs0, bb1, bs1;
        mma::split_tf32<true>(bp[nj * 8], bb0, bs0);
        mma::split_tf32<true>(bp[4 * L::LDB + nj * 8], bb1, bs1);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          mma::mma_3xtf32(part[mi][nj], ab[mi], as[mi], bb0, bb1, bs0, bs1);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < L::BK; kk += 16) {
      uint32_t a[2][4], b[NT][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        mma::ldsm_x4(a[mi], sa + (wr + mi * 16 + mma::a_row(lane)) * L::LDA +
                                kk + mma::a_col(lane));
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t r[4];
        mma::ldsm_x4_trans(r, sb + (kk + mma::bt_row(lane)) * L::LDB + wc +
                                  p * 16 + mma::bt_col(lane));
        b[2 * p][0] = r[0];
        b[2 * p][1] = r[1];
        b[2 * p + 1][0] = r[2];
        b[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < NT; ++nj) {
          if (kk == 0)
            bnmma::mma_bf16_first(part[mi][nj], a[mi], b[nj][0], b[nj][1]);
          else
            mma::mma_bf16(part[mi][nj], a[mi], b[nj][0], b[nj][1]);
        }
    }
  }
}

// K14 (2), both dtypes, and f32 K13 (2): the tap product from apad.
// grid: ceil(N*Ho*Wo / 64) * ceil(O / block_o), block b = pixel tile b /
// blocks_o, O block b % blocks_o (the O blocks of one pixel tile
// adjacent, so its apad rows come from L2 after the first).  The block
// walks its O block [c_begin, c_end) in passes of BN channels; a pass
// sums the 9 * ceil(K / BK) steps through a ring of kStages cp.async
// stages (the next kStages - 1 steps' loads in flight while one is
// summed), each step's products into zeroed registers and then added to
// the running sums in f32 (bn_mma.cuh: the tensor cores' accumulation
// truncates), so every output element is summed in the same order
// whatever BN, block_o or the warp that holds it: K13 and K14 give the
// same bits.  The pass's accumulators go through the f32 C tile (over the
// ring) to 16-byte stores, a row's chunks by neighbouring threads, masked
// at c_end.
template <typename T, int BN, bool VEC>
__global__ void __launch_bounds__(Wide<T, BN>::kThreads,
                                  Wide<T, BN>::kMinBlocks)
bnc_fwd_wide(const T* __restrict__ apad, const T* __restrict__ w,
             T* __restrict__ out, Geom g, int block_o) {
  using L = Wide<T, BN>;
  constexpr int E = L::E, S = L::kStages, NT = L::WN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* ct = reinterpret_cast<float*>(smem);
  const int rows = g.N * g.Ho * g.Wo;
  const int blocks_o = (g.O + block_o - 1) / block_o;
  const int mt = blockIdx.x / blocks_o, ob = blockIdx.x - mt * blocks_o;
  const int row0 = mt * 64;
  const int c_begin = ob * block_o, c_end = min(g.O, c_begin + block_o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = (warp / L::kWarpsN) * 32, wc = (warp % L::kWarpsN) * L::WN;
  size_t base[L::kAChunks];  // ~0: a row past the last pixel
#pragma unroll
  for (int i = 0; i < L::kAChunks; ++i) {
    const int p = row0 + (threadIdx.x + i * L::kThreads) / (L::BK / E);
    const int wo = p % g.Wo, t = p / g.Wo;
    const int n = t / g.Ho, ho = t - n * g.Ho;
    base[i] = p < rows ? ((size_t)(n * (g.H + 2) + ho * g.s) * (g.W + 2) +
                          wo * g.s) * g.K
                       : ~(size_t)0;
  }
  const int ksteps = (g.K + L::BK - 1) / L::BK, nsteps = 9 * ksteps;
  for (int col0 = c_begin; col0 < c_end; col0 += BN) {
    float acc[2][NT][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < NT; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
      if (s < nsteps)
        wide_stage<T, BN, VEC>(ring + s * L::kStage, apad, w, base, g, col0,
                               c_end, ksteps, s);
      mma::cp_async_commit();
    }
    for (int step = 0; step < nsteps; ++step) {
      mma::cp_async_wait<S - 2>();
      __syncthreads();
      const int nxt = step + S - 1;
      if (nxt < nsteps)
        wide_stage<T, BN, VEC>(ring + (nxt % S) * L::kStage, apad, w, base,
                               g, col0, c_end, ksteps, nxt);
      mma::cp_async_commit();
      const T* sa = ring + (step % S) * L::kStage;
      float part[2][NT][4];
      wide_products<T, BN>(part, sa, sa + 64 * L::LDA, wr, wc, lane);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < NT; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][nj][e] += part[mi][nj][e];
    }
    mma::cp_async_wait<0>();
    __syncthreads();  // every warp's last reads of the ring are done
    const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nj = 0; nj < NT; ++nj)
          *reinterpret_cast<float2*>(
              &ct[(wr + mi * 16 + gq + 8 * h) * L::LDC + wc + nj * 8 +
                  2 * tq]) =
              make_float2(acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 64 * (BN / E) / L::kThreads; ++i) {
      const int e = threadIdx.x + i * L::kThreads;
      const int r = e / (BN / E), cc = (e % (BN / E)) * E;
      const int row = row0 + r;
      const int n = bnmma::chunk_len<E>(col0 + cc, c_end);
      if (row >= rows || n == 0) continue;
      uint4 v;
      T* vv = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int q = 0; q < E / 4; ++q) {
        const float4 c =
            *reinterpret_cast<const float4*>(ct + r * L::LDC + cc + 4 * q);
        vv[4 * q] = from_f<T>(c.x);
        vv[4 * q + 1] = from_f<T>(c.y);
        vv[4 * q + 2] = from_f<T>(c.z);
        vv[4 * q + 3] = from_f<T>(c.w);
      }
      T* o = out + (size_t)row * g.O + col0 + cc;
      if constexpr (VEC) {
        *reinterpret_cast<uint4*>(o) = v;
      } else {
#pragma unroll
        for (int u = 0; u < E; ++u)
          if (u < n) o[u] = vv[u];
      }
    }
    __syncthreads();  // the C tile is read before the next pass stages
  }
}

Geom geom(int N, int H, int W, int K, int O, int s) {
  return {N, H, W, K, O, (H - 1) / s + 1, (W - 1) / s + 1, s};
}

template <bool VEC>
cudaError_t fwd_mma(const void* x, const void* r, const void* prm,
                    const void* w, void* apad, void* out, Geom g, int act,
                    cudaStream_t stream) {
  bf16* ap = static_cast<bf16*>(apad);
  bnc_pad_prep<bf16, VEC><<<g.N * (g.H + 2), 256, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(r),
      static_cast<const float*>(prm), ap, g, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)ceil_div(g.N * g.Ho * g.Wo, bnmma::kBM) *
                           ceil_div(g.O, bnmma::kBN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  bnc_fwd_mma<VEC><<<(int)blocks, bnmma::kThreads, 0, stream>>>(
      ap, static_cast<const bf16*>(w), static_cast<bf16*>(out), g);
  return cudaGetLastError();
}

// The tap product of K13 (f32) and K14 at the pass width BN.  Past the
// card's opt-in shared-memory limit the attribute call fails and its
// error is returned.
template <typename T, int BN, bool VEC>
cudaError_t launch_wide(const T* apad, const T* w, T* out, Geom g,
                        int block_o, cudaStream_t stream) {
  using L = Wide<T, BN>;
  auto kern = bnc_fwd_wide<T, BN, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)ceil_div(g.N * g.Ho * g.Wo, 64) *
                           ceil_div(g.O, block_o);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kern<<<(int)blocks, L::kThreads, L::kSmem, stream>>>(apad, w, out, g,
                                                       block_o);
  return cudaGetLastError();
}

// K14 (both dtypes) and f32 K13: the prep pass, then the wide tap product
// with a block owning block_o channels (K13: 128), in passes of 64 channels
// when block_o <= 64 (O = 64), else 128 (O = 96 takes one pass with its
// last 32 columns zero; a 256-wide block two).
template <typename T, bool VEC>
cudaError_t fwd_wide(const void* x, const void* r, const void* prm,
                     const void* w, void* apad, void* out, Geom g,
                     int block_o, int act, cudaStream_t stream) {
  T* ap = static_cast<T*>(apad);
  bnc_pad_prep<T, VEC><<<g.N * (g.H + 2), 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const float*>(prm), ap, g, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  if (block_o <= 64)
    return launch_wide<T, 64, VEC>(ap, wt, ot, g, block_o, stream);
  return launch_wide<T, 128, VEC>(ap, wt, ot, g, block_o, stream);
}

// 16-byte staging, prep and stores when every row is whole 16-byte chunks
// of T (K and O multiples of 8 bf16 or 4 f32) and every tensor is 16-byte
// aligned
bool vec_ok(int dtype, int K, int O, const void* x, const void* r,
            const void* w, const void* apad, const void* out) {
  const int e = dtype == kBFloat16 ? 8 : 4;
  return K % e == 0 && O % e == 0 && mma::aligned16(x) &&
         (r == nullptr || mma::aligned16(r)) && mma::aligned16(w) &&
         mma::aligned16(apad) && mma::aligned16(out);
}

template <typename T>
cudaError_t dispatch_wide(const void* x, const void* r, const void* prm,
                          const void* w, void* apad, void* out, Geom g,
                          int block_o, int act, int dtype,
                          cudaStream_t stream) {
  if (vec_ok(dtype, g.K, g.O, x, r, w, apad, out))
    return fwd_wide<T, true>(x, r, prm, w, apad, out, g, block_o, act,
                             stream);
  return fwd_wide<T, false>(x, r, prm, w, apad, out, g, block_o, act,
                            stream);
}

template <typename T, bool VEC>
cudaError_t bwd_mma(const void* x, const void* r, const void* prm,
                    const void* prm4, const void* w, const void* dout,
                    void* dx, void* dr, void* dw, float* dw_part,
                    float* gb_part, float* dgb, void* apad, Geom g,
                    int splits, int chunk, int act, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(r);
  const T* dot = static_cast<const T*>(dout);
  T* ap = static_cast<T*>(apad);
  const int tiles_m = ceil_div(g.N * g.H * g.W, bnmma::kBM);
  const long long blocks = (long long)tiles_m * ceil_div(g.K, bnmma::kBN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  bnc_bwd_da_mma<T, VEC><<<(int)blocks, bnmma::kThreads, 0, stream>>>(
      xt, rt, static_cast<const float*>(prm4), static_cast<const T*>(w), dot,
      static_cast<T*>(dx), static_cast<T*>(dr), gb_part, g, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bnc_pad_prep<T, VEC><<<g.N * (g.H + 2), 256, 0, stream>>>(
      xt, rt, static_cast<const float*>(prm), ap, g, act);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bnc_bwd_dw_mma<T, VEC><<<dim3(ceil_div(g.K, bnmma::kBM),
                                ceil_div(g.O, bnmma::kBN), 9 * splits),
                           bnmma::kThreads, 0, stream>>>(
      ap, dot, dw_part, g, bnmma::fast_div(g.Wo), bnmma::fast_div(g.Ho),
      splits, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = launch_sum_splits<T>(dw_part, static_cast<T*>(dw), 9, splits,
                             g.K * g.O, stream);
  if (err != cudaSuccess) return err;
  return bnmma::launch_sum_tiles_f64(gb_part, dgb, tiles_m, 2 * g.K, stream);
}

// K15 in T: 16-byte staging, prep and stores when every row is whole
// 16-byte chunks of T and every tensor is 16-byte aligned
template <typename T>
cudaError_t dispatch_bwd(const void* x, const void* r, const void* prm,
                         const void* prm4, const void* w, const void* dout,
                         void* dx, void* dr, void* dw, float* dw_part,
                         float* gb_part, float* dgb, void* apad, Geom g,
                         int splits, int chunk, int act, int dtype,
                         cudaStream_t stream) {
  if (vec_ok(dtype, g.K, g.O, x, r, w, apad, dout))
    return bwd_mma<T, true>(x, r, prm, prm4, w, dout, dx, dr, dw, dw_part,
                            gb_part, dgb, apad, g, splits, chunk, act,
                            stream);
  return bwd_mma<T, false>(x, r, prm, prm4, w, dout, dx, dr, dw, dw_part,
                           gb_part, dgb, apad, g, splits, chunk, act, stream);
}

}  // namespace
}  // namespace ptt

// x, r [N, H, W, K] (r may be null), prm [3, K] f32 (mean, gamma * inv,
// beta), w [3, 3, K, O] (HWIO), out [N, Ho, Wo, O]; act 1 = relu; apad
// [N, H+2, W+2, K] scratch in x's type.
extern "C" int ptt_bn_conv3x3_fwd(const void* x, const void* r,
                                  const void* prm, const void* w, void* apad,
                                  void* out, int N, int H, int W, int K,
                                  int O, int stride, int act, int dtype,
                                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const ptt::Geom g = ptt::geom(N, H, W, K, O, stride);
  if (dtype == ptt::kBFloat16) {
    if (ptt::vec_ok(dtype, K, O, x, r, w, apad, out))
      return ptt::fwd_mma<true>(x, r, prm, w, apad, out, g, act, s);
    return ptt::fwd_mma<false>(x, r, prm, w, apad, out, g, act, s);
  }
  // f32: 128-channel blocks (64 when O <= 64), faster than 64-channel
  // ones at ResNet-50's 3x3 shapes and summed in the same order
  return ptt::dispatch_wide<float>(x, r, prm, w, apad, out, g,
                                   O <= 64 ? 64 : 128, act, dtype, s);
}

// As ptt_bn_conv3x3_fwd, a block owning block_o output channels.
extern "C" int ptt_bn_conv3x3_fwd_v2(const void* x, const void* r,
                                     const void* prm, const void* w,
                                     void* apad, void* out, int N, int H,
                                     int W, int K, int O, int stride,
                                     int block_o, int act, int dtype,
                                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const ptt::Geom g = ptt::geom(N, H, W, K, O, stride);
  if (block_o <= 0) return cudaErrorInvalidValue;
  if (dtype == ptt::kBFloat16)
    return ptt::dispatch_wide<__nv_bfloat16>(x, r, prm, w, apad, out, g,
                                             block_o, act, dtype, s);
  return ptt::dispatch_wide<float>(x, r, prm, w, apad, out, g, block_o, act,
                                   dtype, s);
}

// As the forward, plus prm4 [4, K] f32 (mean, inv, gamma, beta), dO [N,
// Ho, Wo, O]; writes dx, dr (when r is given) [N, H, W, K], dw [3, 3, K, O]
// in w's type and dgb [2, K] f32 (dgamma, dbeta), using dw_part [9,
// splits, K, O] and gb_part [ceil(N*H*W / 64), 2, K] f32 scratch and apad
// [N, H+2, W+2, K] scratch in x's type.
extern "C" int ptt_bn_conv3x3_bwd(const void* x, const void* r,
                                  const void* prm, const void* prm4,
                                  const void* w, const void* dout, void* dx,
                                  void* dr, void* dw, void* dw_part,
                                  void* gb_part, void* dgb, void* apad,
                                  int N, int H,
                                  int W, int K, int O, int stride,
                                  int splits, int chunk, int act, int dtype,
                                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const ptt::Geom g = ptt::geom(N, H, W, K, O, stride);
  auto* dwp = static_cast<float*>(dw_part);
  auto* gbp = static_cast<float*>(gb_part);
  auto* gb = static_cast<float*>(dgb);
  if (dtype == ptt::kBFloat16)
    return ptt::dispatch_bwd<__nv_bfloat16>(x, r, prm, prm4, w, dout, dx, dr,
                                            dw, dwp, gbp, gb, apad, g, splits,
                                            chunk, act, dtype, s);
  return ptt::dispatch_bwd<float>(x, r, prm, prm4, w, dout, dx, dr, dw, dwp,
                                  gbp, gb, apad, g, splits, chunk, act, dtype,
                                  s);
}
