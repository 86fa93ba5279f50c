// The tensor-core tile product of the fused BatchNorm -> convolution
// kernels (bn_matmul.cu: K11 forward and K12 backward; bn_conv.cu: K13
// forward in bf16 and K15 backward; each in both dtypes unless a dtype is
// named), built on mma.cuh's products and ldmatrix loads, the epilogues
// they share, and the BatchNorm prologue pieces and fixed-order partial
// sums every fused kernel uses (Chan, pre_act, sum_splits); bn_conv.cu's
// wide tap product (K14, f32 K13) stages its chunks and runs its bf16
// products with these pieces too.
//
// A block of 128 threads (4 warps, 2 x 2) computes one 64 x 64 tile of
// C = A B in f32 accumulators, each warp a 32 x 32 quarter: 2 x 4 m16n8
// accumulators.  bf16 runs m16n8k16, 8 mma.sync per 16-deep reduction
// step; f32 runs m16n8k8 TF32 products in 3xTF32 (mma.cuh: each fragment
// split into big and small as it is read, small passed unrounded, three
// products a b = a_small b_big + a_big b_small + a_big b_big), 24 mma.sync
// per 8-deep step.  The reduction advances BK (the operator's choice) at a
// time through a ring of shared-memory buffers filled by cp.async, the
// next steps' loads in flight while one is summed.  An operand tile sits
// in shared memory in one of two layouts, chosen by which of its indices
// is contiguous in device memory:
//   TileRR [64][BK]   row (m or n) by reduction: rows contiguous along the
//                     reduction (dO rows in dA, W rows, the gathered dO
//                     pixels of K15's dA, X rows of K11, the apad taps of
//                     K13), read by ldmatrix as A (a_row/a_col) or B
//                     (b_row/b_col); f32 as 8 x 4 f32 matrices
//                     (tf32_a_col, tf32_b_col);
//   TileRM [BK][64]   reduction by row: rows contiguous along the output's
//                     row or column index (X, apad and dO in the dW
//                     products, W in the forwards), read by ldmatrix.trans
//                     as A (at_row/at_col below) or B (bt_row/bt_col) in
//                     bf16, by 32-bit lane loads in f32 (.trans cannot
//                     transpose 32-bit elements).
// A TileRR row is BK elements plus 16 bytes, so the eight 16-byte rows of
// one ldmatrix phase fall in distinct banks (80 or 144 bytes in bf16, 80
// or 144 in f32 at BK 16 or 32); a TileRM row is 64 + 8 elements: in bf16
// the .trans rows likewise, in f32 72 words, so lane (g, t) of a fragment
// load reads bank 8 t + g (+ a constant), all 32 distinct.  A stager fills
// a tile 16 bytes a chunk (8 bf16 or 4 f32), each chunk's device address
// computed once per tile row (the index decoding of a pixel happens per
// chunk, never per element).  A chunk is one cp.async16 with zero fill
// when VEC (every contiguous extent a multiple of a chunk and every base
// 16-byte aligned); otherwise its elements are loaded one by one with
// zeros past the extent, which the loop's barrier makes visible.  Both
// forms run the same tensor-core body: only the staging differs.
//
// mma_loop's order per step: wait for the step's group, barrier, issue the
// loads of step + stages - 1 (into the buffer summed a step ago), run the
// operator's in-place pass over the step's tiles if it has one (K12's dW
// applies the BatchNorm prologue there, once per staged element) and a
// barrier, then the step's products.  The tensor cores add into their f32
// accumulator with truncation (round toward zero), so a long reduction
// carried in one accumulator drifts toward zero, and the drift is
// coherent across the rows that dgamma and dbeta sum (in bf16 at
// ResNet-50's shapes it put those sums 3-9 times further from float64
// than the CUDA-core design).  Each step's products therefore start from
// zero and are added to the running sums by an ordinary f32 add (to
// nearest), in both dtypes.
#pragma once

#include <type_traits>

#include "mma.cuh"

namespace ptt {

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// One channel's forward prologue parameters, from prm [3, K] f32: the
// batch mean, gamma * rsqrt(var + eps) and beta.
struct Chan {
  int k;
  float mu, gi, b;
};

__device__ __forceinline__ Chan chan(const float* __restrict__ prm, int K,
                                     int k) {
  return {k, __ldg(prm + k), __ldg(prm + K + k), __ldg(prm + 2 * K + k)};
}

// pre = (x - mu) * gi + b [+ r], each step rounded on its own (the _rn
// intrinsics are never contracted into an FMA), so it is bit for bit the
// plain version's chain of elementwise ops: a mask pre > 0 then agrees
// with it everywhere, even where pre is within a rounding of 0.
__device__ __forceinline__ float pre_act(float x, float mu, float gi,
                                         float b) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mu), gi), b);
}

namespace {

// out[g * count + e] = sum over s < splits of part[(g * splits + s) *
// count + e], in a fixed order (bit-reproducible): block (32, 16); lane y
// sums s = y, y + 16, ..., then lane 0 adds the 16 lane sums in order.
// grid: (ceil(count / 32), groups).
template <typename TO>
__global__ void __launch_bounds__(512)
sum_splits(const float* __restrict__ part, TO* __restrict__ out,
           int splits, int count) {
  __shared__ float lanes[16][33];
  const int e = blockIdx.x * 32 + threadIdx.x;
  const size_t g = blockIdx.y;
  float s = 0.f;
  if (e < count)
    for (int i = threadIdx.y; i < splits; i += 16)
      s += part[(g * splits + i) * count + e];
  lanes[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && e < count) {
    float t = 0.f;
    for (int y = 0; y < 16; ++y) t += lanes[y][threadIdx.x];
    out[g * count + e] = from_f<TO>(t);
  }
}

template <typename TO>
inline cudaError_t launch_sum_splits(const float* part, TO* out, int groups,
                                     int splits, int count,
                                     cudaStream_t stream) {
  dim3 grid((count + 31) / 32, groups);
  sum_splits<TO><<<grid, dim3(32, 16), 0, stream>>>(part, out, splits,
                                                    count);
  return cudaGetLastError();
}

}  // namespace

namespace bnmma {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64, kBN = 64, kThreads = 128;

// An operand tile of a reduction step of BK elements of T (bf16 or f32)
template <int BK, typename T = bf16>
struct TileRR {
  using Elem = T;
  T v[kBM][BK + 16 / sizeof(T)];
};
template <int BK, typename T = bf16>
struct TileRM {
  using Elem = T;
  T v[BK][kBM + 8];
};

// ldmatrix.trans row addresses for A from a [k][m] tile: matrix j = l / 8
// holds k rows (j / 2) * 8.., m columns (j % 2) * 8.., so the four
// registers are a0..a3 of the m16n8k16 A fragment.
__device__ __forceinline__ int at_row(int l) {
  return (l & 7) + ((l >> 4) << 3);
}
__device__ __forceinline__ int at_col(int l) { return ((l >> 3) & 1) << 3; }

// A fragments of a warp's two m16 tiles (rows wr..wr+31), reduction kk..
template <int BK>
__device__ __forceinline__ void frag_a(uint32_t (&a)[2][4],
                                       const TileRR<BK>& t, int wr, int kk,
                                       int lane) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
    mma::ldsm_x4(a[mi], &t.v[wr + mi * 16 + mma::a_row(lane)]
                            [kk + mma::a_col(lane)]);
}
template <int BK>
__device__ __forceinline__ void frag_a(uint32_t (&a)[2][4],
                                       const TileRM<BK>& t, int wr, int kk,
                                       int lane) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
    mma::ldsm_x4_trans(a[mi], &t.v[kk + at_row(lane)]
                                  [wr + mi * 16 + at_col(lane)]);
}

// B fragments (b0, b1) of a warp's four n8 tiles (columns wc..wc+31)
template <int BK>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4][2],
                                       const TileRR<BK>& t, int wc, int kk,
                                       int lane) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    uint32_t r[4];
    mma::ldsm_x4(r, &t.v[wc + p * 16 + mma::b_row(lane)]
                        [kk + mma::b_col(lane)]);
    b[2 * p][0] = r[0];
    b[2 * p][1] = r[1];
    b[2 * p + 1][0] = r[2];
    b[2 * p + 1][1] = r[3];
  }
}
template <int BK>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4][2],
                                       const TileRM<BK>& t, int wc, int kk,
                                       int lane) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    uint32_t r[4];
    mma::ldsm_x4_trans(r, &t.v[kk + mma::bt_row(lane)]
                              [wc + p * 16 + mma::bt_col(lane)]);
    b[2 * p][0] = r[0];
    b[2 * p][1] = r[1];
    b[2 * p + 1][0] = r[2];
    b[2 * p + 1][1] = r[3];
  }
}

// The f32 fragments of one 8-deep step, each split into big and small as
// it is read (mma.cuh split_tf32<true>).  A of a warp's two m16 tiles:
// from a TileRR by ldmatrix as 8 x 4 f32 matrices (a0..a3 = (g, t), (g+8,
// t), (g, t+4), (g+8, t+4)); from a TileRM by lanes, (g, t) reading rows
// kk + t and kk + t + 4, columns wr + 16 mi + g and + 8.
template <int BK>
__device__ __forceinline__ void frag_a(uint32_t (&big)[2][4],
                                       uint32_t (&small)[2][4],
                                       const TileRR<BK, float>& t, int wr,
                                       int kk, int lane) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    uint32_t x[4];
    mma::ldsm_x4(x, &t.v[wr + mi * 16 + mma::a_row(lane)]
                        [kk + mma::tf32_a_col(lane)]);
    mma::split_tf32<true>(x, big[mi], small[mi]);
  }
}
template <int BK>
__device__ __forceinline__ void frag_a(uint32_t (&big)[2][4],
                                       uint32_t (&small)[2][4],
                                       const TileRM<BK, float>& t, int wr,
                                       int kk, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const float* p0 = &t.v[kk + q][wr + mi * 16 + g];
    const float* p1 = &t.v[kk + q + 4][wr + mi * 16 + g];
    const uint32_t x[4] = {__float_as_uint(p0[0]), __float_as_uint(p0[8]),
                           __float_as_uint(p1[0]), __float_as_uint(p1[8])};
    mma::split_tf32<true>(x, big[mi], small[mi]);
  }
}

// B (b0, b1) of a warp's four n8 tiles, split: from a TileRR ([n][k]) by
// ldmatrix (b_row/tf32_b_col: registers 0, 1 of n-tile 2p, 2, 3 of 2p +
// 1); from a TileRM ([k][n]) by lanes, (g, t) reading rows kk + t and
// kk + t + 4, column wc + 8 nj + g.
template <int BK>
__device__ __forceinline__ void frag_b(uint32_t (&big)[4][2],
                                       uint32_t (&small)[4][2],
                                       const TileRR<BK, float>& t, int wc,
                                       int kk, int lane) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    uint32_t r[4];
    mma::ldsm_x4(r, &t.v[wc + p * 16 + mma::b_row(lane)]
                        [kk + mma::tf32_b_col(lane)]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      mma::split_tf32<true>(__uint_as_float(r[j]), big[2 * p + j / 2][j % 2],
                            small[2 * p + j / 2][j % 2]);
  }
}
template <int BK>
__device__ __forceinline__ void frag_b(uint32_t (&big)[4][2],
                                       uint32_t (&small)[4][2],
                                       const TileRM<BK, float>& t, int wc,
                                       int kk, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) {
    mma::split_tf32<true>(t.v[kk + q][wc + nj * 8 + g], big[nj][0],
                          small[nj][0]);
    mma::split_tf32<true>(t.v[kk + q + 4][wc + nj * 8 + g], big[nj][1],
                          small[nj][1]);
  }
}

// Chunk i of this thread in a TileRR / TileRM stage of T: (row, col).  A
// chunk is E = 16 / sizeof(T) elements; a TileRR row is BK / E chunks, a
// TileRM row 64 / E; a thread takes chunks tid, tid + 128, ...
template <int BK, typename T = bf16>
__device__ __forceinline__ int rr_row(int i) {
  return (threadIdx.x + i * kThreads) / (BK * (int)sizeof(T) / 16);
}
template <int BK, typename T = bf16>
__device__ __forceinline__ int rr_col(int i) {
  constexpr int E = 16 / sizeof(T);
  return ((threadIdx.x + i * kThreads) % (BK / E)) * E;
}
template <typename T = bf16>
__device__ __forceinline__ int rm_row(int i) {
  return (threadIdx.x + i * kThreads) / (kBM * (int)sizeof(T) / 16);
}
template <typename T = bf16>
__device__ __forceinline__ int rm_col(int i) {
  constexpr int E = 16 / sizeof(T);
  return ((threadIdx.x + i * kThreads) % (kBM / E)) * E;
}

// 16-byte chunks a thread stages of one [64][BK] or [BK][64] tile of T
template <int BK, typename T>
__host__ __device__ constexpr int tile_chunks() {
  return kBM * BK * (int)sizeof(T) / (16 * kThreads);
}

// One 16-byte chunk of T (8 bf16 or 4 f32) from src (the first n valid,
// the rest zero) into dst.  VEC: n is 0 or the whole chunk, one 16-byte
// cp.async (src must then be a readable address even when n is 0: pass
// the operand's base).
template <bool VEC, typename T>
__device__ __forceinline__ void stage_chunk(T* dst, const T* src, int n) {
  if constexpr (VEC) {
    mma::cp_async16(dst, src, n > 0);
  } else {
#pragma unroll
    for (int u = 0; u < 16 / (int)sizeof(T); ++u)
      dst[u] = u < n ? src[u] : from_f<T>(0.f);
  }
}

// n / d for 0 <= n < 2^31 by a multiply-high, an add and a shift
// (Granlund and Montgomery): with s = ceil(log2 d) and mul = floor(2^32
// (2^s - d) / d) + 1, n / d = (umulhi(n, mul) + n) >> s, the add within 32
// bits as umulhi(n, mul) < n.  A staging map that decodes a pixel per
// chunk would otherwise spend most of its instructions in integer
// division.
struct FastDiv {
  int d;
  uint32_t mul, s;
  __device__ __forceinline__ int div(int n) const {
    return (int)((__umulhi((uint32_t)n, mul) + (uint32_t)n) >> s);
  }
};

inline FastDiv fast_div(int d) {
  uint32_t s = 0;
  while ((1ull << s) < (unsigned long long)d) ++s;
  const unsigned long long mul =
      ((1ull << 32) * ((1ull << s) - (unsigned long long)d)) / d + 1;
  return {d, (uint32_t)mul, s};
}

// valid elements of the E-element chunk at index c of an extent `len`
template <int E = 8>
__device__ __forceinline__ int chunk_len(int c, int len) {
  return max(0, min(E, len - c));
}

// d = a b: one m16n8k16 product into fresh accumulators (C = 0)
__device__ __forceinline__ void mma_bf16_first(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// One reduction step's products of a warp (rows wr.., columns wc..) into
// `part`, from zero: bf16 m16n8k16 (the first with C = 0), f32 m16n8k8 in
// 3xTF32, small terms first, each fragment split as it is read.
template <int BK, class TA, class TB>
__device__ __forceinline__ void step_products(float (&part)[2][4][4],
                                              const TA& ta, const TB& tb,
                                              int wr, int wc, int lane) {
  if constexpr (std::is_same<typename TA::Elem, float>::value) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mi][nj][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ab[2][4], as[2][4], bb[4][2], bs[4][2];
      frag_a(ab, as, ta, wr, kk, lane);
      frag_b(bb, bs, tb, wc, kk, lane);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
          mma::mma_3xtf32(part[mi][nj], ab[mi], as[mi], bb[nj][0],
                          bb[nj][1], bs[nj][0], bs[nj][1]);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4], b[4][2];
      frag_a(a, ta, wr, kk, lane);
      frag_b(b, tb, wc, kk, lane);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          if (kk == 0)
            mma_bf16_first(part[mi][nj], a[mi], b[nj][0], b[nj][1]);
          else
            mma::mma_bf16(part[mi][nj], a[mi], b[nj][0], b[nj][1]);
        }
    }
  }
}

// The tile product over `nsteps` reduction steps of Op::kBK, through a
// ring of Op::kStages buffers.  Op provides
//   kBK, kStages      its step and ring depth;
//   stage(buf, step)  loads of step into ring buffer buf (chunks above);
//   kPost, post(buf, step)  an in-place pass over the step's tiles;
//   a(buf), b(buf)    the A and B tiles (TileRR or TileRM, both of one
//                     element type) of buf.
template <class Op>
__device__ __forceinline__ void mma_loop(float (&acc)[2][4][4], Op& op,
                                         int nsteps) {
  constexpr int S = Op::kStages;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nsteps) op.stage(s, s);
    mma::cp_async_commit();
  }
  for (int step = 0; step < nsteps; ++step) {
    mma::cp_async_wait<S - 2>();
    __syncthreads();
    const int buf = step % S;
    const int nxt = step + S - 1;
    if (nxt < nsteps) op.stage(nxt % S, nxt);
    mma::cp_async_commit();
    if constexpr (Op::kPost) {
      op.post(buf, step);
      __syncthreads();
    }
    float part[2][4][4];
    step_products<Op::kBK>(part, op.a(buf), op.b(buf), wr, wc, lane);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] += part[mi][nj][e];
  }
  mma::cp_async_wait<0>();
}

// Shared memory of the dA kernels: the operand ring, and over it, once the
// product is done, the f32 C tile (row stride kBN + 8 floats: the lanes'
// float2 stores of one fragment row fall in distinct banks); the tile's 64
// channels' (mean, inv, gamma * inv, beta) and the four warps' column
// sums.
template <int BK, int STAGES, typename T = bf16>
struct DaSmem {
  union {
    struct {
      TileRR<BK, T> a[STAGES];
      TileRR<BK, T> b[STAGES];
    } ring;
    float c[kBM][kBN + 8];
  };
  float mu[kBN], inv[kBN], gi[kBN], b[kBN];
  float sx[kThreads / 32][kBN], sd[kThreads / 32][kBN];
};

// The accumulators into the shared f32 C tile c by their fragment map (c0
// c1 at row g, columns 2t..; c2 c3 at row g + 8), after a barrier: every
// warp's last fragment loads of the ring that c overlays are done.
__device__ __forceinline__ void acc_to_smem(const float (&acc)[2][4][4],
                                            float (&c)[kBM][kBN + 8]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
        *reinterpret_cast<float2*>(
            &c[wr + mi * 16 + g + 8 * h][wc + nj * 8 + 2 * t]) =
            make_float2(acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
}

// Shared memory of the forward kernels (K11, K13): the operand ring, and
// over it, once the product is done, the f32 C tile of store_tile.
template <class Ring>
struct OutSmem {
  union {
    Ring ring;
    float c[kBM][kBN + 8];
  };
};

// The output epilogue of the forward kernels: the accumulator tile at
// (row0, col0) of out [rows, cols] of T (row stride cols), rounded once to
// T.  The accumulators go to the shared C tile c; then thread tid stores
// the 16-byte chunk of E columns (E = 8 bf16, 4 f32; CH = 64 / E chunks a
// row) at (tid % CH) * E of rows tid / CH + (128 / CH) i: a row's 128
// bytes (bf16) or 256 (f32) by neighbouring lanes (element by element, the
// first chunk_len of the chunk, when not VEC).  Rows past `rows` are never
// stored: the forward's A rows there are act(beta - mean * gi), not 0.
template <bool VEC, typename T>
__device__ __forceinline__ void store_tile(const float (&acc)[2][4][4],
                                           float (&c)[kBM][kBN + 8],
                                           T* __restrict__ out, int row0,
                                           int rows, int col0, int cols) {
  constexpr int E = 16 / sizeof(T);       // columns a chunk
  constexpr int CH = kBN / E;             // chunks a row
  constexpr int kStride = kThreads / CH;  // rows between a thread's rows
  acc_to_smem(acc, c);
  __syncthreads();
  const int tid = threadIdx.x, cc = (tid % CH) * E;
  const int n = chunk_len<E>(col0 + cc, cols);
  if (n == 0) return;
#pragma unroll
  for (int i = 0; i < kBM / kStride; ++i) {
    const int r = tid / CH + kStride * i, row = row0 + r;
    if (row >= rows) continue;
    uint4 v;
    if constexpr (std::is_same<T, float>::value) {
      v = *reinterpret_cast<const uint4*>(&c[r][cc]);
    } else {
      const float4 a0 = *reinterpret_cast<const float4*>(&c[r][cc]);
      const float4 a1 = *reinterpret_cast<const float4*>(&c[r][cc + 4]);
      v.x = mma::pack_bf16(a0.x, a0.y);
      v.y = mma::pack_bf16(a0.z, a0.w);
      v.z = mma::pack_bf16(a1.x, a1.y);
      v.w = mma::pack_bf16(a1.z, a1.w);
    }
    T* o = out + (size_t)row * cols + col0 + cc;
    if constexpr (VEC) {
      *reinterpret_cast<uint4*>(o) = v;
    } else {
      const T* vv = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int u = 0; u < E; ++u)
        if (u < n) o[u] = vv[u];
    }
  }
}

// The dA epilogue of K12 and K15: for the C tile at (row0, col0) of dA
// [rows, K] (rows are pixels of X, columns its channels), recompute pre
// from X (and R) with prm4 [4, K] f32 = mean, inv, gamma, beta as the
// forward does (pre_act's rounding chain, so the mask agrees with the
// plain version bit for bit), mask dpre = pre > 0 ? dA : 0 for relu,
// write dX = dpre * gamma * inv and dR = dpre, and write the tile's column
// sums of dpre * xhat and dpre to gb_part[tile][0][k] and [tile][1][k].
// The accumulators go to shared memory by their fragment map (c0 c1 at
// row g, columns 2t..; c2 c3 at row g + 8); then thread tid takes the
// 16-byte chunk of E channels (E = 8 bf16, 4 f32; CH = 64 / E chunks a
// row) at (tid % CH) * E of rows tid / CH + (128 / CH) i, so X, R, dX and
// dR move 16 bytes a thread, a row's chunks by neighbouring lanes (element
// by element when not VEC), its rows' loads issued before any is used.
// The column sums run in a fixed order: each thread over its rows in
// order, then xor shuffles CH, 2 CH, .. 16 over the warp's lanes of one
// chunk (bf16 8 and 16, f32 16), then the four warps in order.
template <bool VEC, typename T, class Smem>
__device__ __forceinline__ void da_epilogue(
    const float (&acc)[2][4][4], const T* __restrict__ x,
    const T* __restrict__ res, const float* __restrict__ prm4,
    T* __restrict__ dx, T* __restrict__ dr, float* __restrict__ gb_part,
    int tile, int row0, int rows, int col0, int K, int act, Smem& sm) {
  constexpr int E = 16 / sizeof(T);       // channels a chunk
  constexpr int CH = kBN / E;             // chunks a row
  constexpr int kStride = kThreads / CH;  // rows between a thread's rows
  constexpr int kRows = kBM / kStride;    // rows a thread
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  acc_to_smem(acc, sm.c);
  if (tid < kBN) {
    const int k = col0 + tid;
    const bool ok = k < K;
    const float inv = ok ? __ldg(prm4 + K + k) : 0.f;
    sm.mu[tid] = ok ? __ldg(prm4 + k) : 0.f;
    sm.inv[tid] = inv;
    sm.gi[tid] = __fmul_rn(inv, ok ? __ldg(prm4 + 2 * K + k) : 0.f);
    sm.b[tid] = ok ? __ldg(prm4 + 3 * K + k) : 0.f;
  }
  const int cc = (tid % CH) * E, k0 = col0 + cc;
  const int nk = max(0, min(E, K - k0));  // valid channels of the chunk
  uint4 xr[kRows], rr[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = row0 + tid / CH + kStride * i;
    xr[i] = rr[i] = make_uint4(0, 0, 0, 0);
    if (row >= rows || nk == 0) continue;
    const size_t off = (size_t)row * K + k0;
    if constexpr (VEC) {
      xr[i] = *reinterpret_cast<const uint4*>(x + off);
      if (res != nullptr) rr[i] = *reinterpret_cast<const uint4*>(res + off);
    } else {
      T* xv = reinterpret_cast<T*>(&xr[i]);
      T* rv = reinterpret_cast<T*>(&rr[i]);
#pragma unroll
      for (int u = 0; u < E; ++u)
        if (u < nk) {
          xv[u] = x[off + u];
          if (res != nullptr) rv[u] = res[off + u];
        }
    }
  }
  __syncthreads();  // the C tile and the channel parameters
  float sx[E], sd[E];
#pragma unroll
  for (int u = 0; u < E; ++u) sx[u] = sd[u] = 0.f;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = tid / CH + kStride * i, row = row0 + r;
    if (row >= rows || nk == 0) continue;
    const T* xv = reinterpret_cast<const T*>(&xr[i]);
    const T* rv = reinterpret_cast<const T*>(&rr[i]);
    float av[E];
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const float4 a = *reinterpret_cast<const float4*>(&sm.c[r][cc + 4 * q]);
      av[4 * q] = a.x;
      av[4 * q + 1] = a.y;
      av[4 * q + 2] = a.z;
      av[4 * q + 3] = a.w;
    }
    uint4 dxr, drr;
    T* dxv = reinterpret_cast<T*>(&dxr);
    T* dpv = reinterpret_cast<T*>(&drr);
#pragma unroll
    for (int u = 0; u < E; ++u) {
      const int cl = cc + u;
      const float xf = to_f(xv[u]), mu = sm.mu[cl], gi = sm.gi[cl];
      float pre = pre_act(xf, mu, gi, sm.b[cl]);
      if (res != nullptr) pre = __fadd_rn(pre, to_f(rv[u]));
      const float dpre = (act == 1 && !(pre > 0.f)) ? 0.f : av[u];
      dxv[u] = from_f<T>(dpre * gi);
      dpv[u] = from_f<T>(dpre);
      if (u < nk) {
        sx[u] += dpre * ((xf - mu) * sm.inv[cl]);
        sd[u] += dpre;
      }
    }
    const size_t off = (size_t)row * K + k0;
    if constexpr (VEC) {
      *reinterpret_cast<uint4*>(dx + off) = dxr;
      if (dr != nullptr) *reinterpret_cast<uint4*>(dr + off) = drr;
    } else {
#pragma unroll
      for (int u = 0; u < E; ++u)
        if (u < nk) {
          dx[off + u] = dxv[u];
          if (dr != nullptr) dr[off + u] = dpv[u];
        }
    }
  }
#pragma unroll
  for (int u = 0; u < E; ++u)
#pragma unroll
    for (int o = CH; o < 32; o <<= 1) {
      sx[u] += __shfl_xor_sync(kFullMask, sx[u], o);
      sd[u] += __shfl_xor_sync(kFullMask, sd[u], o);
    }
  if (lane < CH) {
#pragma unroll
    for (int u = 0; u < E; ++u) {
      sm.sx[warp][cc + u] = sx[u];
      sm.sd[warp][cc + u] = sd[u];
    }
  }
  __syncthreads();
  if (tid < kBN && col0 + tid < K) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      a += sm.sx[w][tid];
      b += sm.sd[w][tid];
    }
    float* p = gb_part + (size_t)tile * 2 * K + col0 + tid;
    p[0] = a;
    p[K] = b;
  }
}

// Store the accumulator tile at (row0, col0) of part [rows, cols] f32
// (row stride cols), as float2 pairs when PAIRS (cols even).
template <bool PAIRS>
__device__ __forceinline__ void store_part(const float (&acc)[2][4][4],
                                           float* __restrict__ part,
                                           int row0, int rows, int col0,
                                           int cols) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + wr + mi * 16 + g + 8 * h;
      if (row >= rows) continue;
      float* p = part + (size_t)row * cols;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int c = col0 + wc + nj * 8 + 2 * t;
        if constexpr (PAIRS) {
          if (c < cols) mma::store_pair(p + c, acc[mi][nj][2 * h],
                                        acc[mi][nj][2 * h + 1]);
        } else {
          if (c < cols) p[c] = acc[mi][nj][2 * h];
          if (c + 1 < cols) p[c + 1] = acc[mi][nj][2 * h + 1];
        }
      }
    }
}

namespace {

// dgamma, dbeta from the dA tiles' column sums gb_part [tiles, 2K]:
// out[e] = sum over t of part[t * count + e] in f64, in a fixed order
// (lane y sums t = y, y + 16, ..., then lane 0 the 16 lane sums in
// order), rounded once to f32.  An f32 sum over ResNet's thousands of
// tiles would lie further from float64 than the tiles' own f32 sums do.
// grid: ceil(count / 32), block (32, 16).
__global__ void __launch_bounds__(512)
sum_tiles_f64(const float* __restrict__ part, float* __restrict__ out,
              int tiles, int count) {
  __shared__ double lanes[16][33];
  const int e = blockIdx.x * 32 + threadIdx.x;
  double s = 0.0;
  if (e < count) {
    // eight loads in flight a thread, summed in the order of t
    int t = threadIdx.y;
    for (; t + 16 * 7 < tiles; t += 16 * 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = part[(size_t)(t + 16 * u) * count + e];
#pragma unroll
      for (int u = 0; u < 8; ++u) s += (double)v[u];
    }
    for (; t < tiles; t += 16) s += (double)part[(size_t)t * count + e];
  }
  lanes[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && e < count) {
    double t = 0.0;
    for (int y = 0; y < 16; ++y) t += lanes[y][threadIdx.x];
    out[e] = (float)t;
  }
}

inline cudaError_t launch_sum_tiles_f64(const float* part, float* out,
                                        int tiles, int count,
                                        cudaStream_t stream) {
  sum_tiles_f64<<<(count + 31) / 32, dim3(32, 16), 0, stream>>>(
      part, out, tiles, count);
  return cudaGetLastError();
}

}  // namespace

}  // namespace bnmma
}  // namespace ptt
