// Device helpers shared by the port's attention kernels: dtype conversion
// to and from the f32 compute type, and tile staging into shared memory.
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

}  // namespace ptt
