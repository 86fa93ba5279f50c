// Causal flash attention forward for Hopper (sm_90a): K1 and K4.
//
// Replaces the Pallas TPU kernels flash_attention (K1) and
// flash_attention_fwd (K4, with_lse=True)
// (paddle_tpu/ops/pallas_kernels/flash_attention.py: _fwd_body, _fwd_grid):
// out = softmax(Q K^T * scale [+ causal mask]) V over [B, H, T, D]
// (contiguous), f32 scores, an online softmax (running max m, normalizer
// l, f32 accumulator per row), P cast to the input dtype before P.V.  The
// LSE instance (K4, training) also writes lse = m + log l per real row in
// f32, the backward's residual; the serving instance (K1) carries none of
// that code.
//
// Bound on an H100: causal, the work is 4*D*T*(T+1)/2 flops per (b, h)
// and 4*T*D elements of traffic (Q, K, V read once, O written once; K4
// adds T f32 lse values).  At
// the serving prefill shapes (T <= 1024, D = 64) f32 is bound by the
// 67 TFLOP/s of the CUDA cores and bf16 by device memory.
//
// Design: one block per (b*h, 64-row Q tile), 128 threads.  The block
// loops over 64-row K/V tiles and stops at the diagonal under causal — the
// loop replaces the TPU's sequential grid dimension and its clamped index
// map, and masked future tiles are never read.  Tiles are staged in shared
// memory as f32, with the head dim zero-padded to DP (64 or 128).  Both
// products are register-tiled on the CUDA cores: thread (ty, tx) of an
// 8 x 16 grid holds rows ty*8 .. ty*8+7 of the tile, the score columns
// tx + 16*j (j < 4) and the output columns tx*4 + 64*g (+0..3).  A row's
// 16 threads sit in one half-warp, so the row max and sum are four
// shuffles and P passes through shared memory with a warp barrier only.
// Every inner step reads 128-bit words: Q and P rows are broadcast within
// the half-warp, K rows are padded by four floats so eight threads hit
// distinct banks, and V rows are read contiguously.  The kernel masks the
// ragged edge (k >= T) itself, so any T works.  Heavy (late) Q tiles are
// scheduled first.  Moving the products onto the tensor cores (wgmma) with
// TMA-fed tiles is left for later.

#include <math.h>

#include "common.cuh"

namespace ptt {
namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 128;
constexpr int kRows = 8;      // Q rows per thread
constexpr int kCols = 4;      // score columns per thread
constexpr int kLdp = kBK + 4;  // row stride of the P tile

template <int DP>
constexpr int smem_floats() {
  return 2 * kBQ * (DP + 4) + kBK * DP + kBQ * kLdp;
}

// The minimum of two blocks per SM leaves the register cap at 255 but
// changes ptxas's choice: without it the f32 DP = 64 instance is held to
// 128 registers and spills, and runs slower.
template <typename T, int DP, bool LSE>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int t_len, int d, int causal,
                 float scale) {
  constexpr int ldq = DP + 4;
  constexpr int G = DP / 64;  // 4-wide output column groups per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;             // [kBQ][ldq]
  float* ks = qs + kBQ * ldq;   // [kBK][ldq]
  float* vs = ks + kBK * ldq;   // [kBK][DP]
  float* ps = vs + kBK * DP;    // [kBQ][kLdp]

  // late Q tiles walk the most K tiles: launch them first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * kBQ;
  const size_t base = (size_t)blockIdx.y * t_len * d;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int r0 = ty * kRows;

  stage_tile<T, kBQ, DP, kThreads>(qs, ldq, q + base, q0, t_len, d);

  float m[kRows], l[kRows], acc[kRows][4 * G];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;
  }

  const int n_kt_all = (t_len + kBK - 1) / kBK;
  // kBQ == kBK: the diagonal tile of Q tile qt is K tile qt
  const int n_kt = causal ? min(n_kt_all, qt + 1) : n_kt_all;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile is consumed
    stage_tile<T, kBK, DP, kThreads>(ks, ldq, k + base, k0, t_len, d);
    stage_tile<T, kBK, DP, kThreads>(vs, DP, v + base, k0, t_len, d);
    __syncthreads();

    // S = Q K^T for rows r0.., columns tx + 16 j
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      float4 a[kRows], b[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (r0 + i) * ldq + c);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        b[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * ldq + c);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

    // online softmax; a row's 16 threads are lanes xor 1, 2, 4, 8
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + r0 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = kj < t_len && (!causal || kj <= qi);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));
      // every tile walked holds key k0 <= q0 <= qi with k0 < T, so a real
      // row's max is finite; the guard keeps a padding row at 0
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_use);
        sum += p;
        ps[(r0 + i) * kLdp + tx + 16 * j] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFullMask, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * G; ++c) acc[i][c] *= corr;
    }
    // rows r0.. of P were written by this half-warp alone
    __syncwarp();

    // O += P V for rows r0.., columns tx*4 + 64 g
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 p4[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        p4[i] = *reinterpret_cast<const float4*>(ps + (r0 + i) * kLdp + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(
              vs + (kk + e) * DP + 64 * g + tx * 4);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float pe = e == 0 ? p4[i].x
                           : e == 1 ? p4[i].y
                           : e == 2 ? p4[i].z : p4[i].w;
            acc[i][4 * g + 0] = fmaf(pe, vv.x, acc[i][4 * g + 0]);
            acc[i][4 * g + 1] = fmaf(pe, vv.y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(pe, vv.z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(pe, vv.w, acc[i][4 * g + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + r0 + i;
    if (qi >= t_len) continue;
    // the backward's residual: m and l are a row's, shared by its threads
    if (LSE && tx == 0) lse[(size_t)blockIdx.y * t_len + qi] = m[i] + logf(l[i]);
    const float inv = 1.f / l[i];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 64 * g + tx * 4 + e;
        if (c < d)
          o[base + (size_t)qi * d + c] = from_f<T>(acc[i][4 * g + e] * inv);
      }
  }
}

template <typename T, int DP, bool LSE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int t_len, int d, int causal,
                   float scale, cudaStream_t stream) {
  const size_t smem = (size_t)smem_floats<DP>() * sizeof(float);
  auto kern = flash_fwd_kernel<T, DP, LSE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + kBQ - 1) / kBQ, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      t_len, d, causal, scale);
  return cudaGetLastError();
}

template <typename T, bool LSE>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int t_len, int d, int causal,
                       float scale, cudaStream_t stream) {
  if (d <= 64)
    return launch<T, 64, LSE>(q, k, v, o, lse, bh, t_len, d, causal, scale, stream);
  return launch<T, 128, LSE>(q, k, v, o, lse, bh, t_len, d, causal, scale, stream);
}

// lse == nullptr: the serving instance (K1), which writes no logsumexp
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     void* lse, int bh, int t_len, int d, int causal,
                     float scale, cudaStream_t stream) {
  if (lse == nullptr)
    return dispatch_d<T, false>(q, k, v, o, lse, bh, t_len, d, causal, scale, stream);
  return dispatch_d<T, true>(q, k, v, o, lse, bh, t_len, d, causal, scale, stream);
}

}  // namespace
}  // namespace ptt

// q, k, v, o: [bh, t_len, d] contiguous, all of `dtype`, on the caller's
// current device, which owns `stream`; lse: [bh, t_len] f32, or null for
// no logsumexp.  Returns a cudaError_t (0 on success).
extern "C" int ptt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int bh, int t_len, int d, int causal,
                                       float scale, int dtype, void* stream) {
  if (bh < 1 || bh > 65535 || t_len < 1 || d < 1 || d > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kFloat32:
      return (int)ptt::dispatch<float>(q, k, v, o, lse, bh, t_len, d, causal, scale, s);
    case ptt::kBFloat16:
      return (int)ptt::dispatch<__nv_bfloat16>(q, k, v, o, lse, bh, t_len, d, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
