// Building blocks of the recurrent time-loop kernels (lstm.cu, gru.cu): a
// small matrix product on the CUDA cores whose two operands come from
// caller-supplied loaders, the gate functions, and the weight-gradient
// product taken once over all T*B rows after the time loop.
//
// A time step is a chain of dependent small products (B x H by H x 4H at
// most), far too small to fill the card, so what matters is the length of
// each thread's serial chain, not the tile's arithmetic intensity.  Hence
// small tiles (16 rows by 16*NC columns, 64 threads, 4 rows x NC columns a
// thread) and the reduce index split over kKS = 8 slices of 64 threads
// inside the block, which are summed through shared memory at the end: a
// step of the LSTM at H 512 is 4 chunks of 16 per slice, and a batch of 64
// gives 128 blocks for the card's 132 SMs.
#pragma once

#include <math.h>

#include "common.cuh"

namespace ptt {
namespace {

constexpr int kTX = 16;                 // column threads of a slice
constexpr int kTY = 4;                  // row threads of a slice
constexpr int kRB = 4;                  // rows per thread
constexpr int kBT = kTY * kRB;          // rows of a tile: 16
constexpr int kKC = 16;                 // reduce-index chunk
constexpr int kKS = 8;                  // reduce-index slices per block
constexpr int kSlice = kTX * kTY;       // threads per slice: 64
constexpr int kRnnThreads = kSlice * kKS;  // threads per block: 512
constexpr int kLda = kBT + 4;           // row stride of the staged A chunk

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
template <int NC> __host__ __device__ constexpr int ldb() { return kTX * NC + 4; }
template <int NC> __host__ __device__ constexpr int slice_floats() {
  return kKC * (kLda + ldb<NC>());
}
// staging for every slice; the partial sums of slices 1.. reuse it
template <int NC> __host__ __device__ constexpr int rnn_smem_floats() {
  return cmax(kKS * slice_floats<NC>(), (kKS - 1) * kRB * NC * kSlice);
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// acc[r][c] = sum over k < K of a(k, row) * b(k, col) for the thread's
// rows ty*kRB + r and columns tx*NC + c of one tile.
//
// load_a(k, row) and load_b(k, cl) return the operands as f32 (0 outside
// the matrices; k < K is checked here).  `cl` is the column in LOAD order:
// with GATED the tile's columns are (hidden column jj, gate g) pairs,
// loaded as cl = g*kTX + jj (16 neighbouring addresses per gate) and kept
// at column jj*NC + g, so that one thread owns every gate of its hidden
// column; otherwise cl is the column itself.  A_KC / B_KC say that the
// operand is contiguous along k in memory, which picks the staging order
// that reads neighbouring addresses from neighbouring threads.
//
// Every thread of the block must call this.  On return the threads of
// slice 0 (threadIdx.x < kSlice) hold the full sums; the others hold
// partial sums and should do nothing more.
template <int NC, bool GATED, bool A_KC, bool B_KC, typename LA, typename LB>
__device__ __forceinline__ void tile_product(float (&acc)[kRB][NC], int K,
                                             LA load_a, LB load_b,
                                             float* smem) {
  constexpr int LDB = ldb<NC>();
  constexpr int NB = kTX * NC;
  const int tid = threadIdx.x % kSlice;
  const int ks = threadIdx.x / kSlice;
  const int tx = tid % kTX, ty = tid / kTX;
  float* as = smem + ks * slice_floats<NC>();
  float* bs = as + kKC * kLda;
#pragma unroll
  for (int r = 0; r < kRB; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  // The next chunk's operands are fetched into registers before the
  // current chunk's sums are taken, so the loads' latency overlaps the
  // arithmetic instead of standing between two barriers.
  constexpr int PA = kKC * kBT / kSlice, PB = kKC * NB / kSlice;
  static_assert(PA * kSlice == kKC * kBT && PB * kSlice == kKC * NB,
                "a slice stages whole rounds of its threads");
  float pa[PA], pb[PB];
  auto fetch = [&](int it) {
    const int k0 = (it * kKS + ks) * kKC;
#pragma unroll
    for (int i = 0; i < PA; ++i) {
      const int e = tid + i * kSlice;
      const int kk = A_KC ? e % kKC : e / kBT;
      const int r = A_KC ? e / kKC : e % kBT;
      pa[i] = (k0 + kk < K) ? load_a(k0 + kk, r) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < PB; ++i) {
      const int e = tid + i * kSlice;
      const int kk = B_KC ? e % kKC : e / NB;
      const int cl = B_KC ? e / kKC : e % NB;
      pb[i] = (k0 + kk < K) ? load_b(k0 + kk, cl) : 0.f;
    }
  };

  const int chunks = (K + kKC - 1) / kKC;
  const int iters = (chunks + kKS - 1) / kKS;
  fetch(0);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < PA; ++i) {
      const int e = tid + i * kSlice;
      const int kk = A_KC ? e % kKC : e / kBT;
      const int r = A_KC ? e / kKC : e % kBT;
      as[kk * kLda + r] = pa[i];
    }
#pragma unroll
    for (int i = 0; i < PB; ++i) {
      const int e = tid + i * kSlice;
      const int kk = B_KC ? e % kKC : e / NB;
      const int cl = B_KC ? e / kKC : e % NB;
      const int pos = GATED ? (cl % kTX) * NC + cl / kTX : cl;
      bs[kk * LDB + pos] = pb[i];
    }
    __syncthreads();
    if (it + 1 < iters) fetch(it + 1);
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
      const float4 a4 =
          *reinterpret_cast<const float4*>(as + kk * kLda + ty * kRB);
      const float av[kRB] = {a4.x, a4.y, a4.z, a4.w};
      float bv[NC];
      const float* bp = bs + kk * LDB + tx * NC;
      if constexpr (NC == 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(bp);
        bv[0] = b4.x; bv[1] = b4.y; bv[2] = b4.z; bv[3] = b4.w;
      } else if constexpr (NC == 2) {
        const float2 b2 = *reinterpret_cast<const float2*>(bp);
        bv[0] = b2.x; bv[1] = b2.y;
      } else {
#pragma unroll
        for (int c = 0; c < NC; ++c) bv[c] = bp[c];
      }
#pragma unroll
      for (int r = 0; r < kRB; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }

  // sum the slices: slice s > 0 leaves its tile in shared memory
  float* red = smem;
  if (ks > 0) {
#pragma unroll
    for (int i = 0; i < kRB * NC; ++i)
      red[((ks - 1) * kRB * NC + i) * kSlice + tid] = acc[i / NC][i % NC];
  }
  __syncthreads();
  if (ks == 0) {
    for (int s = 0; s < kKS - 1; ++s)
#pragma unroll
      for (int i = 0; i < kRB * NC; ++i)
        acc[i / NC][i % NC] += red[(s * kRB * NC + i) * kSlice + tid];
  }
}

// h_{t-1} of row r = b*t_len + t of the saved states: h0[b] at t = 0,
// else hs[b, t-1], which is row r-1 of hs [B*T, H].
template <typename T>
__device__ __forceinline__ float prev_state(const T* __restrict__ s0,
                                            const T* __restrict__ ss, int b,
                                            int t, int t_len, int h, int k) {
  return t == 0 ? to_f(s0[(size_t)b * h + k])
                : to_f(ss[((size_t)b * t_len + t - 1) * h + k]);
}

// The weight gradient, once after the time loop:
//   dw[k, col0 + n] = sum over rows r < R = B*T of a(r, k) * d[r, dcol0 + n]
// in f32, written once in the weight's type.  a(r, k) is a32[r*h + k]
// where a32 is given (the GRU's r*h_{t-1}), else h_{t-1} from the saved
// states; d holds the f32 gate gradients of every step, row stride ldd.
// A padded step has zero gate gradients, so it adds nothing.
// grid: (ceil(n / 64), ceil(h / 16)).
template <typename T>
__global__ void __launch_bounds__(kRnnThreads)
rnn_dw_kernel(const T* __restrict__ h0, const T* __restrict__ hs,
              const float* __restrict__ a32, const float* __restrict__ d,
              int ldd, int col0, T* __restrict__ dw, int ldw, int n, int rows,
              int t_len, int h) {
  __shared__ __align__(16) float smem[rnn_smem_floats<4>()];
  const int n0 = blockIdx.x * kTX * 4, k0 = blockIdx.y * kBT;
  auto la = [&](int r, int row) -> float {
    const int k = k0 + row;
    if (k >= h) return 0.f;
    if (a32 != nullptr) return a32[(size_t)r * h + k];
    return prev_state(h0, hs, r / t_len, r % t_len, t_len, h, k);
  };
  auto lb = [&](int r, int cl) -> float {
    const int c = n0 + cl;
    return c < n ? d[(size_t)r * ldd + col0 + c] : 0.f;
  };
  float acc[kRB][4];
  tile_product<4, false, false, false>(acc, rows, la, lb, smem);
  if (threadIdx.x >= kSlice) return;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
#pragma unroll
  for (int r = 0; r < kRB; ++r) {
    const int k = k0 + ty * kRB + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = n0 + tx * 4 + c;
      if (k < h && col < n)
        dw[(size_t)k * ldw + col0 + col] = from_f<T>(acc[r][c]);
    }
  }
}

template <typename T>
cudaError_t launch_dw(const void* h0, const void* hs, const float* a32,
                      const float* d, int ldd, int col0, void* dw, int ldw,
                      int n, int rows, int t_len, int h,
                      cudaStream_t stream) {
  const dim3 grid((n + kTX * 4 - 1) / (kTX * 4), (h + kBT - 1) / kBT);
  rnn_dw_kernel<T><<<grid, kRnnThreads, 0, stream>>>(
      static_cast<const T*>(h0), static_cast<const T*>(hs), a32, d, ldd, col0,
      static_cast<T*>(dw), ldw, n, rows, t_len, h);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ptt
