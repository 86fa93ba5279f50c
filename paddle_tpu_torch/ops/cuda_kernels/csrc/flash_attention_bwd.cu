// Flash attention backward for Hopper (sm_90a): K5 (dQ) and K6 (dK, dV).
//
// Replaces the two sweeps of the Pallas TPU kernel flash_attention_bwd
// (paddle_tpu/ops/pallas_kernels/flash_attention.py: _dq_kernel,
// _dkv_kernel), the FlashAttention-2 backward over [B, H, T, D]
// (contiguous): from the forward's per-row logsumexp lse and
// delta = rowsum(O * dO) (both [B*H, T] f32),
//   P  = exp(S * scale - lse),  S = Q K^T   (zero where masked)
//   dP = dO V^T
//   dS = P * (dP - delta) * scale
//   dQ = dS K,  dK = dS^T Q,  dV = P^T dO
// with f32 accumulation and the JAX kernels' rounding points: dS is cast
// to the input dtype before dS K and dS^T Q; dV takes P and dO in f32.
// P is never written to device memory.
//
// Bound on an H100: causal, dQ is 6*D*T*(T+1)/2 flops per (b, h) (three
// products over the visible pairs) and dK/dV 8*D*T*(T+1)/2 (four); the
// traffic is 5 (dQ) or 6 (dK/dV) [T, D] tensors plus the two f32 rows.
// At the training shapes (T = 1024, D = 64) f32 is bound by the 67 TFLOP/s
// of the CUDA cores and bf16 by device memory.
//
// Design: the register tiling of K1 (flash_attention.cu).  A block of 128
// threads owns one 64-row tile; thread (ty, tx) of the 8 x 16 grid holds
// rows ty*8 .. ty*8+7 and the score columns tx + 16*j (j < 4), so a row's
// 16 threads sit in one half-warp and the tile that feeds the second
// product passes through shared memory with a warp barrier only.
//   K5: one block per (b*h, Q tile).  It stages the Q and dO tiles and its
//   rows' lse and delta once, then walks the K/V tiles up to the diagonal
//   (all of them when non-causal), forming S and dP, then dS, and adding
//   dS K into registers.  Late Q tiles walk the most K tiles and launch
//   first.
//   K6: one block per (b*h, K tile).  It stages the K and V tiles once and
//   walks the Q tiles from the diagonal to the end, computing S^T and dP^T
//   with the K rows in the thread's rows and the Q rows in its columns, so
//   dV += P^T dO and dK += dS^T Q accumulate into registers and are written
//   once.  Early K tiles walk the most Q tiles and launch first.
// Rows and keys past T are masked in the kernels (no lse is read for
// them), so any T works.  Tensor cores (wgmma) and TMA-fed tiles are left
// for later.

#include <math.h>

#include "common.cuh"

namespace ptt {
namespace {

constexpr int kB = 64;         // rows of a Q tile and of a K tile
constexpr int kThreads = 128;
constexpr int kRows = 8;       // tile rows per thread
constexpr int kCols = 4;       // score columns per thread
constexpr int kLdp = kB + 4;   // row stride of a score tile in shared memory

// s[i][j] = sum_c A[r0 + i][c] * B[tx + 16 j][c], both tiles in shared
// memory as f32 with row stride ld (DP + 4) and DP columns (zero-padded).
template <int DP>
__device__ __forceinline__ void tile_scores(const float* a, const float* b,
                                            int ld, int r0, int tx,
                                            float (&s)[kRows][kCols]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < DP; c += 4) {
    float4 av[kRows], bv[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (r0 + i) * ld + c);
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * ld + c);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
      }
  }
}

// acc[i][4 g + e] += sum_kk P[r0 + i][kk] * M[kk][64 g + 4 tx + e]: P a
// 64 x 64 score tile (row stride kLdp) whose rows r0.. this half-warp
// wrote, M a 64-row tile with row stride ld.
template <int DP>
__device__ __forceinline__ void tile_accumulate(
    const float* p, const float* m, int ld, int r0, int tx,
    float (&acc)[kRows][4 * (DP / 64)]) {
  constexpr int G = DP / 64;
#pragma unroll 2
  for (int kk = 0; kk < kB; kk += 4) {
    float4 p4[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      p4[i] = *reinterpret_cast<const float4*>(p + (r0 + i) * kLdp + kk);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 mv = *reinterpret_cast<const float4*>(
            m + (kk + e) * ld + 64 * g + tx * 4);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float pe = e == 0 ? p4[i].x
                         : e == 1 ? p4[i].y
                         : e == 2 ? p4[i].z : p4[i].w;
          acc[i][4 * g + 0] = fmaf(pe, mv.x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(pe, mv.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(pe, mv.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(pe, mv.w, acc[i][4 * g + 3]);
        }
      }
    }
  }
}

// Write rows r0.. of an accumulator to out rows [row0 + r0, ...) < t_len.
template <typename T, int DP>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[kRows][4 * (DP / 64)],
                                           int row0, int r0, int tx,
                                           int t_len, int d) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = row0 + r0 + i;
    if (r >= t_len) continue;
#pragma unroll
    for (int g = 0; g < DP / 64; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 64 * g + tx * 4 + e;
        if (c < d) out[(size_t)r * d + c] = from_f<T>(acc[i][4 * g + e]);
      }
  }
}

template <int DP>
constexpr int dq_smem_floats() {
  return 4 * kB * (DP + 4) + kB * kLdp;
}

template <int DP>
constexpr int dkv_smem_floats() {
  return 4 * kB * (DP + 4) + 2 * kB * kLdp + 2 * kB;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 2)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq,
                int t_len, int d, int causal, float scale) {
  constexpr int ld = DP + 4;
  constexpr int G = DP / 64;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // [kB][ld]
  float* dos = qs + kB * ld;   // [kB][ld]
  float* ks = dos + kB * ld;   // [kB][ld]
  float* vs = ks + kB * ld;    // [kB][ld]
  float* dss = vs + kB * ld;   // [kB][kLdp]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * kB;
  const size_t base = (size_t)blockIdx.y * t_len * d;
  const size_t rbase = (size_t)blockIdx.y * t_len;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int r0 = ty * kRows;

  stage_tile<T, kB, DP, kThreads>(qs, ld, q + base, q0, t_len, d);
  stage_tile<T, kB, DP, kThreads>(dos, ld, dout + base, q0, t_len, d);
  float lse_r[kRows], dl_r[kRows], acc[kRows][4 * G];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + r0 + i;
    lse_r[i] = qi < t_len ? lse[rbase + qi] : 0.f;
    dl_r[i] = qi < t_len ? delta[rbase + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;
  }

  const int n_kt_all = (t_len + kB - 1) / kB;
  const int n_kt = causal ? min(n_kt_all, qt + 1) : n_kt_all;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // the previous K/V tile is consumed
    stage_tile<T, kB, DP, kThreads>(ks, ld, k + base, k0, t_len, d);
    stage_tile<T, kB, DP, kThreads>(vs, ld, v + base, k0, t_len, d);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
    tile_scores<DP>(qs, ks, ld, r0, tx, s);
    tile_scores<DP>(dos, vs, ld, r0, tx, dp);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + r0 + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = qi < t_len && kj < t_len && (!causal || kj <= qi);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        dss[(r0 + i) * kLdp + tx + 16 * j] =
            round_to<T>(p * (dp[i][j] - dl_r[i]) * scale);
      }
    }
    // rows r0.. of dS were written by this half-warp alone
    __syncwarp();
    tile_accumulate<DP>(dss, ks, ld, r0, tx, acc);
  }
  store_rows<T, DP>(dq + base, acc, q0, r0, tx, t_len, d);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 2)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int t_len, int d, int causal,
                 float scale) {
  constexpr int ld = DP + 4;
  constexpr int G = DP / 64;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;             // [kB][ld]
  float* vs = ks + kB * ld;     // [kB][ld]
  float* qs = vs + kB * ld;     // [kB][ld]
  float* dos = qs + kB * ld;    // [kB][ld]
  float* pts = dos + kB * ld;   // [kB][kLdp]  P^T (K rows x Q rows)
  float* dsts = pts + kB * kLdp;  // [kB][kLdp]  dS^T
  float* lse_s = dsts + kB * kLdp;  // [kB]
  float* dl_s = lse_s + kB;         // [kB]

  const int kt = blockIdx.x;  // early K tiles walk the most Q tiles
  const int k0 = kt * kB;
  const size_t base = (size_t)blockIdx.y * t_len * d;
  const size_t rbase = (size_t)blockIdx.y * t_len;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int r0 = ty * kRows;

  stage_tile<T, kB, DP, kThreads>(ks, ld, k + base, k0, t_len, d);
  stage_tile<T, kB, DP, kThreads>(vs, ld, v + base, k0, t_len, d);
  float acc_dk[kRows][4 * G], acc_dv[kRows][4 * G];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc_dk[i][c] = acc_dv[i][c] = 0.f;

  const int n_qt = (t_len + kB - 1) / kB;
  // kB rows in both tiles: Q tiles before the diagonal see none of these keys
  for (int qt = causal ? kt : 0; qt < n_qt; ++qt) {
    const int q0 = qt * kB;
    __syncthreads();  // the previous Q/dO tile is consumed
    stage_tile<T, kB, DP, kThreads>(qs, ld, q + base, q0, t_len, d);
    stage_tile<T, kB, DP, kThreads>(dos, ld, dout + base, q0, t_len, d);
    for (int e = threadIdx.x; e < kB; e += kThreads) {
      const int qi = q0 + e;
      lse_s[e] = qi < t_len ? lse[rbase + qi] : 0.f;
      dl_s[e] = qi < t_len ? delta[rbase + qi] : 0.f;
    }
    __syncthreads();

    // P^T: rows are this tile's keys r0.., columns the queries tx + 16 j
    float s[kRows][kCols];
    tile_scores<DP>(ks, qs, ld, r0, tx, s);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int kj = k0 + r0 + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int qc = tx + 16 * j;
        const int qi = q0 + qc;
        const bool ok = kj < t_len && qi < t_len && (!causal || kj <= qi);
        pts[(r0 + i) * kLdp + qc] =
            ok ? expf(s[i][j] * scale - lse_s[qc]) : 0.f;
      }
    }
    // dP^T = V dO^T; dS^T from this thread's own P^T entries
    tile_scores<DP>(vs, dos, ld, r0, tx, s);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int qc = tx + 16 * j;
        const float p = pts[(r0 + i) * kLdp + qc];
        dsts[(r0 + i) * kLdp + qc] =
            round_to<T>(p * (s[i][j] - dl_s[qc]) * scale);
      }
    // rows r0.. of P^T and dS^T were written by this half-warp alone
    __syncwarp();
    tile_accumulate<DP>(pts, dos, ld, r0, tx, acc_dv);
    tile_accumulate<DP>(dsts, qs, ld, r0, tx, acc_dk);
  }
  store_rows<T, DP>(dk + base, acc_dk, k0, r0, tx, t_len, d);
  store_rows<T, DP>(dv + base, acc_dv, k0, r0, tx, t_len, d);
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int t_len, int d, int causal,
                      float scale, cudaStream_t stream) {
  const size_t smem = (size_t)dq_smem_floats<DP>() * sizeof(float);
  auto kern = flash_dq_kernel<T, DP>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + kB - 1) / kB, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), t_len, d, causal, scale);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int t_len, int d,
                       int causal, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)dkv_smem_floats<DP>() * sizeof(float);
  auto kern = flash_dkv_kernel<T, DP>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + kB - 1) / kB, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), t_len, d, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int bh, int t_len, int d, int causal,
                        float scale, cudaStream_t s) {
  if (d <= 64)
    return launch_dq<T, 64>(q, k, v, dout, lse, delta, dq, bh, t_len, d, causal, scale, s);
  return launch_dq<T, 128>(q, k, v, dout, lse, delta, dq, bh, t_len, d, causal, scale, s);
}

template <typename T>
cudaError_t dispatch_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse,
                         const void* delta, void* dk, void* dv, int bh,
                         int t_len, int d, int causal, float scale,
                         cudaStream_t s) {
  if (d <= 64)
    return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, bh, t_len, d, causal, scale, s);
  return launch_dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, bh, t_len, d, causal, scale, s);
}

bool bad_shape(int bh, int t_len, int d) {
  return bh < 1 || bh > 65535 || t_len < 1 || d < 1 || d > 128;
}

}  // namespace
}  // namespace ptt

// q, k, v, dout, dq: [bh, t_len, d] contiguous, all of `dtype`; lse,
// delta: [bh, t_len] f32; all on the caller's current device, which owns
// `stream`.  Returns a cudaError_t (0 on success).
extern "C" int ptt_flash_attention_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int bh, int t_len, int d,
                                      int causal, float scale, int dtype,
                                      void* stream) {
  if (ptt::bad_shape(bh, t_len, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kFloat32:
      return (int)ptt::dispatch_dq<float>(q, k, v, dout, lse, delta, dq, bh, t_len, d, causal, scale, s);
    case ptt::kBFloat16:
      return (int)ptt::dispatch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, bh, t_len, d, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// As ptt_flash_attention_dq, writing dk and dv ([bh, t_len, d], `dtype`).
extern "C" int ptt_flash_attention_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int bh, int t_len,
                                       int d, int causal, float scale,
                                       int dtype, void* stream) {
  if (ptt::bad_shape(bh, t_len, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kFloat32:
      return (int)ptt::dispatch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, bh, t_len, d, causal, scale, s);
    case ptt::kBFloat16:
      return (int)ptt::dispatch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, bh, t_len, d, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
