// Device helpers shared by the port's attention kernels: dtype conversion
// to and from the f32 compute type, warp-wide reductions, and tile and
// page staging into shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ptt {

constexpr unsigned kFullMask = 0xffffffffu;

// dtype codes passed from Python: 0 = float32, 1 = bfloat16
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round an f32 value to T and back: the probabilities are cast to the
// value dtype before the P.V product, as the reference kernels do.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

// Stage rows [r0, r0 + ROWS) of one [t_len, d] row-major matrix into
// shared memory as f32 with row stride `ld`, zero past t_len and past d
// (up to the padded width DP).
template <typename T, int ROWS, int DP, int NTHREADS>
__device__ __forceinline__ void stage_tile(float* dst, int ld,
                                           const T* __restrict__ src, int r0,
                                           int t_len, int d) {
  for (int e = threadIdx.x; e < ROWS * DP; e += NTHREADS) {
    const int r = e / DP, c = e - r * DP;
    const int gr = r0 + r;
    dst[r * ld + c] =
        (gr < t_len && c < d) ? to_f(src[(size_t)gr * d + c]) : 0.f;
  }
}

// Copy the first `n` elements (whole rows of dh) of one K page and one V
// page into shared memory as f32: element c of row t lands at
// ks[t * ldk + c] and vs[t * ldv + c].  Thread `tid` of `nthreads` takes
// elements tid, tid + nthreads, ... and issues kStage loads of each
// tensor before it stores any, so several loads are in flight per thread.
template <typename T>
__device__ __forceinline__ void stage_page(const T* __restrict__ k,
                                           const T* __restrict__ v, int n,
                                           int dh, int ldk, int ldv,
                                           float* ks, float* vs, int tid,
                                           int nthreads) {
  constexpr int kStage = 8;
  for (int e0 = tid; e0 < n; e0 += kStage * nthreads) {
    float kr[kStage], vr[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int e = e0 + u * nthreads;
      if (e < n) {
        kr[u] = to_f(k[e]);
        vr[u] = to_f(v[e]);
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int e = e0 + u * nthreads;
      if (e < n) {
        const int t = e / dh, c = e - t * dh;
        ks[t * ldk + c] = kr[u];
        vs[t * ldv + c] = vr[u];
      }
    }
  }
}

}  // namespace ptt
