// The CUDA-core tile product of the f32 fused BatchNorm -> 1x1
// convolution forward (bn_matmul.cu: f32 K11), the BatchNorm prologue
// pieces every fused kernel shares (Chan, pre_act, prologue), and the
// fixed-order sum of per-block partials (sum_splits).
//
// gemm_tile computes one 64 x 64 tile of C = A B, summed in f32 over a
// range of the reduction index.  A and B are never arrays: each element
// comes from a loader, so the operand can be the BatchNorm prologue of a
// raw conv output and the normalized activation never reaches device
// memory.  A loader splits its element's address into a part that depends
// on the row (or column) only and a part that depends on the reduction
// index only, so the index arithmetic (the per-channel prologue
// parameters) is done once per staged slot, not per element:
//
//   A loader: row(m) -> RowCtx, red(r) -> RedCtx, get(RowCtx, RedCtx)
//   B loader: red(r) -> RedCtx, col(c) -> ColCtx, get(RedCtx, ColCtx)
//
// 256 threads stage a 64 x 16 slab of A and a 16 x 64 slab of B per step
// into shared memory as f32 (four elements each), the next slab's loads
// issued into registers before the current one is summed; a thread then
// owns a 4 x 4 block of C (rows ty*4.., columns tx*4.., ty = tid / 16,
// tx = tid % 16) and does 256 FMAs per slab from two float4 reads per
// reduction step.  Products run on the CUDA cores in f32 (no TF32), so
// only the order of the sums differs from the plain version.

#pragma once

#include "common.cuh"

namespace ptt {

constexpr int kGM = 64, kGN = 64, kGK = 16, kGThreads = 256;

struct GemmSmem {
  float a[kGK][kGM + 4];
  float b[kGK][kGN + 4];
};

// Staging maps: consecutive threads take consecutive reduction indices of
// one A row (X rows are contiguous along the reduction k) and consecutive
// columns of one B row (W rows are contiguous along the output channel).
template <class LA, class LB>
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
    a_red[s] = e % kGK;
    a_row[s] = e / kGK;
    b_col[s] = e % kGN;
    b_red[s] = e / kGN;
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
  // the four A slots share one reduction index, whose context is computed
  // once
  auto fetch = [&](int r0) {
    const int r = r0 + a_red[0];
    const bool ok = r < r_end;
    const auto rx = la.red(ok ? r : r_begin);
#pragma unroll
    for (int s = 0; s < 4; ++s)
      ra[s] = (row_ok[s] && ok) ? la.get(rc[s], rx) : 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int q = r0 + b_red[s];
      rb[s] = (col_ok[s] && q < r_end) ? lb.get(lb.red(q), cc[s]) : 0.f;
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
