// The CUDA-core tile product of the f32 fused BatchNorm -> convolution
// kernels (bn_matmul.cu: K11, K12; bn_conv.cu: K15), and the pieces of
// their epilogues that the 1x1 and 3x3 kernels have in common.
//
// gemm_tile computes one 64 x 64 tile of C = A B, summed in f32 over a
// range of the reduction index.  A and B are never arrays: each element
// comes from a loader, so the operand can be the BatchNorm prologue of a
// raw conv output, a shifted 3x3 tap with zero padding, or a transposed
// view, and the normalized activation never reaches device memory.  A
// loader splits its element's address into a part that depends on the
// row (or column) only and a part that depends on the reduction index
// only, so the index arithmetic (pixel coordinates, taps, the per-channel
// prologue parameters) is done once per staged slot, not per element:
//
//   A loader: row(m) -> RowCtx, red(r) -> RedCtx, get(RowCtx, RedCtx)
//   B loader: red(r) -> RedCtx, col(c) -> ColCtx, get(RedCtx, ColCtx)
//
// 256 threads stage a 64 x 16 slab of A and a 16 x 64 slab of B per step
// into shared memory as f32 (four elements each), the next slab's loads
// issued into registers before the current one is summed; a thread then
// owns a 4 x 4 block of C (rows ty*4.., columns tx*4.., ty = tid / 16,
// tx = tid % 16) and does 256 FMAs per slab from two float4 reads per
// reduction step.  Products run on the CUDA cores in f32 for both input
// types: the f32 path stays exact (no TF32), and bf16 operands are exact
// in f32, so only the order of the sums differs from the plain versions.

#pragma once

#include "common.cuh"

namespace ptt {

constexpr int kGM = 64, kGN = 64, kGK = 16, kGThreads = 256;

struct GemmSmem {
  float a[kGK][kGM + 4];
  float b[kGK][kGN + 4];
};

// Staging maps.  With A_RED_FAST, consecutive threads take consecutive
// reduction indices of one A row (memory contiguous along the reduction);
// otherwise consecutive rows of one reduction index.  B_COL_FAST likewise
// for B's columns.
template <bool A_RED_FAST, bool B_COL_FAST, class LA, class LB>
__device__ __forceinline__ void gemm_tile(float (&acc)[4][4], const LA& la,
                                          const LB& lb, int row0, int rows,
                                          int col0, int cols, int r_begin,
                                          int r_end, GemmSmem& sm) {
  const int tid = threadIdx.x;
  // slot s of 4: A element (a_row[s], a_red[s]) of the slab, B element
  // (b_red[s], b_col[s])
  int a_row[4], a_red[4], b_red[4], b_col[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int e = tid + s * kGThreads;
    a_red[s] = A_RED_FAST ? e % kGK : e / kGM;
    a_row[s] = A_RED_FAST ? e / kGK : e % kGM;
    b_col[s] = B_COL_FAST ? e % kGN : e / kGK;
    b_red[s] = B_COL_FAST ? e / kGN : e % kGK;
  }
  typename LA::RowCtx rc[4];
  typename LB::ColCtx cc[4];
  bool row_ok[4], col_ok[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    row_ok[s] = row0 + a_row[s] < rows;
    col_ok[s] = col0 + b_col[s] < cols;
    rc[s] = la.row(row_ok[s] ? row0 + a_row[s] : 0);
    cc[s] = lb.col(col_ok[s] ? col0 + b_col[s] : 0);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  float ra[4], rb[4];
  // where the four slots share one reduction index (A_RED_FAST for A,
  // !B_COL_FAST for B), its context is computed once
  auto fetch = [&](int r0) {
    if constexpr (A_RED_FAST) {
      const int r = r0 + a_red[0];
      const bool ok = r < r_end;
      const auto rx = la.red(ok ? r : r_begin);
#pragma unroll
      for (int s = 0; s < 4; ++s)
        ra[s] = (row_ok[s] && ok) ? la.get(rc[s], rx) : 0.f;
    } else {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int r = r0 + a_red[s];
        ra[s] = (row_ok[s] && r < r_end) ? la.get(rc[s], la.red(r)) : 0.f;
      }
    }
    if constexpr (!B_COL_FAST) {
      const int r = r0 + b_red[0];
      const bool ok = r < r_end;
      const auto rx = lb.red(ok ? r : r_begin);
#pragma unroll
      for (int s = 0; s < 4; ++s)
        rb[s] = (col_ok[s] && ok) ? lb.get(rx, cc[s]) : 0.f;
    } else {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int r = r0 + b_red[s];
        rb[s] = (col_ok[s] && r < r_end) ? lb.get(lb.red(r), cc[s]) : 0.f;
      }
    }
  };
  if (r_begin < r_end) fetch(r_begin);
  const int ty = tid / 16, tx = tid % 16;
  for (int r0 = r_begin; r0 < r_end; r0 += kGK) {
    __syncthreads();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      sm.a[a_red[s]][a_row[s]] = ra[s];
      sm.b[b_red[s]][b_col[s]] = rb[s];
    }
    __syncthreads();
    if (r0 + kGK < r_end) fetch(r0 + kGK);
#pragma unroll
    for (int kk = 0; kk < kGK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&sm.a[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&sm.b[kk][tx * 4]);
      const float a4[4] = {av.x, av.y, av.z, av.w};
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a4[i], b4[j], acc[i][j]);
    }
  }
}

// A plain strided operand: A(m, r) = p[m * s_row + r * s_red].
template <typename T>
struct StridedA {
  using RowCtx = size_t;
  const T* p;
  size_t s_row, s_red;
  __device__ size_t row(int m) const { return (size_t)m * s_row; }
  __device__ size_t red(int r) const { return (size_t)r * s_red; }
  __device__ float get(size_t a, size_t b) const { return to_f(p[a + b]); }
};

// B(r, c) = p[r * s_red + c * s_col].
template <typename T>
struct StridedB {
  using ColCtx = size_t;
  const T* p;
  size_t s_red, s_col;
  __device__ size_t red(int r) const { return (size_t)r * s_red; }
  __device__ size_t col(int c) const { return (size_t)c * s_col; }
  __device__ float get(size_t a, size_t b) const { return to_f(p[a + b]); }
};

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

// The prologue of one element: act(pre [+ r]), rounded to the weight's
// type as the product's operand.  relu is act 1.
template <typename T>
__device__ __forceinline__ float prologue(const T* __restrict__ x,
                                          const T* __restrict__ res,
                                          size_t off, const Chan& c,
                                          int act) {
  float v = pre_act(to_f(x[off]), c.mu, c.gi, c.b);
  if (res != nullptr) v = __fadd_rn(v, to_f(res[off]));
  if (act == 1) v = fmaxf(v, 0.f);
  return round_to<T>(v);
}

// The epilogue the dA products share (K12 and K15).  For the C tile at
// (row0, col0) of dA [rows, K] (rows are pixels of X, columns channels):
// recompute pre from X (and R) with prm4 [4, K] f32 = mean, inv, gamma,
// beta as the forward prologue does (pre = (x - mean) * (gamma * inv) +
// beta [+ r]; xhat = (x - mean) * inv), mask
// dpre = pre > 0 ? dA : 0 for relu, write dX = dpre * (gamma * inv) and
// dR = dpre, and write the tile's column sums of dpre * xhat and dpre to
// gb_part[tile][0][k] and gb_part[tile][1][k] (tile = blockIdx.x), in a
// fixed order.  Reuses the product's shared memory.
template <typename T>
__device__ __forceinline__ void dA_epilogue(
    const float (&acc)[4][4], const T* __restrict__ x,
    const T* __restrict__ res, const float* __restrict__ prm4,
    T* __restrict__ dx, T* __restrict__ dr, float* __restrict__ gb_part,
    int row0, int rows, int col0, int K, int act, GemmSmem& sm) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float s_xh[4] = {0.f, 0.f, 0.f, 0.f}, s_dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = col0 + tx * 4 + j;
    if (k >= K) continue;
    const float mu = __ldg(prm4 + k), inv = __ldg(prm4 + K + k),
                g = __ldg(prm4 + 2 * K + k), b = __ldg(prm4 + 3 * K + k);
    const float gi = __fmul_rn(inv, g);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = row0 + ty * 4 + i;
      if (m >= rows) continue;
      const size_t off = (size_t)m * K + k;
      const float xv = to_f(x[off]);
      const float xhat = (xv - mu) * inv;
      float pre = pre_act(xv, mu, gi, b);
      if (res != nullptr) pre = __fadd_rn(pre, to_f(res[off]));
      const float dpre = (act == 1 && !(pre > 0.f)) ? 0.f : acc[i][j];
      dx[off] = from_f<T>(dpre * gi);
      if (dr != nullptr) dr[off] = from_f<T>(dpre);
      s_xh[j] += dpre * xhat;
      s_dp[j] += dpre;
    }
  }
  __syncthreads();  // the product's last reads of sm are done
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sm.a[ty][tx * 4 + j] = s_xh[j];
    sm.b[ty][tx * 4 + j] = s_dp[j];
  }
  __syncthreads();
  if (tid < kGN) {
    const int k = col0 + tid;
    if (k < K) {
      float a = 0.f, b = 0.f;
      for (int t = 0; t < 16; ++t) {
        a += sm.a[t][tid];
        b += sm.b[t][tid];
      }
      gb_part[(size_t)blockIdx.x * 2 * K + k] = a;
      gb_part[(size_t)blockIdx.x * 2 * K + K + k] = b;
    }
  }
}

// Store a C tile of f32 partial sums: part[(row) * ld + col].
__device__ __forceinline__ void store_partial(const float (&acc)[4][4],
                                              float* __restrict__ part,
                                              int row0, int rows, int col0,
                                              int cols, size_t ld) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = row0 + ty * 4 + i;
    if (m >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c < cols) part[(size_t)m * ld + c] = acc[i][j];
    }
  }
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

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace ptt
