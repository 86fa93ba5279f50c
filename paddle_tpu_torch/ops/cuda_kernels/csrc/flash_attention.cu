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
// scheduled first.  This CUDA-core body serves f32 (K1 and K4: an f32
// product on the tensor cores would be TF32, which the reference's f32
// products and the 1e-4 f32 parity do not allow) and bf16 K1.
//
// bf16 K4 (the training forward) has its own body on the tensor cores,
// flash_fwd_mma_kernel, in FlashAttention-2's form.  At the GPT training
// shape ([8, 8, 1024, 64] causal) its 8.6 GFLOP take 0.0087 ms at the
// card's 989 TFLOP/s, so it is bound by the 0.0101 ms of its bytes; the
// CUDA cores' 67 TFLOP/s alone would need 0.128 ms.
//   - One block of 4 warps per (b*h, 64-row Q tile), 16 Q rows a warp.
//     Late Q tiles launch first.
//   - Q is staged once and its A fragments (ldmatrix) stay in registers
//     for the whole K loop.
//   - K and V tiles (64 rows) stay bf16 in shared memory, in a two-stage
//     ring filled by 16-byte cp.async with zero fill past T and past d:
//     tile k+1 is in flight while tile k is multiplied.  A head dim that
//     is not a whole number of 16-byte chunks (d % 8 != 0) is staged
//     element by element instead.
//   - S = Q K^T by mma.sync m16n8k16 (bf16 in, f32 out), K through
//     ldmatrix.  The online softmax keeps the raw scores' running max m
//     and takes p = exp2(s * c - m * c), c = scale * log2(e), one FFMA
//     and one exp2 an element.  A row's 16 scores of a tile sit in one
//     quad of lanes: the row max takes two shuffles, and the row sum stays
//     a per-lane partial until the end.  Masks are applied only on the
//     diagonal tile, the walk's last, and on the ragged last tile.
//   - P is rounded to bf16 in registers and is, packed, the A fragment of
//     P V (mma.cuh): it never touches shared memory.  V goes through
//     ldmatrix.trans.
//   - O = acc / l in bf16 and lse = m * scale + log l per real row in
//     f32.
// mma.cuh holds the fragment layouts and the loaders.

#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

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

// -- bf16 K4 on the tensor cores ----------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;  // 4 warps, 16 Q rows each
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int DP>
constexpr size_t mma_smem_bytes() {
  return (size_t)(kBQ + 4 * kBK) * (DP + 8) * sizeof(bf16);  // Q, 2 x (K, V)
}

// Three blocks an SM at DP = 64 hold ptxas to 168 registers (149 used, no
// spill); four would hold it to 128 and spill.
template <int DP>
__global__ void __launch_bounds__(kMmaThreads, DP == 64 ? 3 : 2)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int t_len, int d, int causal,
                     float scale_log2, int vec) {
  using namespace mma;
  constexpr int LD = DP + 8;
  constexpr int KC = DP / 16;  // 16-wide k-chunks of the head dim
  constexpr int NO = DP / 8;   // 8-wide n-tiles of the output
  constexpr int NS = kBK / 8;  // 8-wide n-tiles of a score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][LD]
  bf16* ks = qs + kBQ * LD;                      // [2][kBK][LD]
  bf16* vs = ks + 2 * kBK * LD;                  // [2][kBK][LD]

  const int qt = gridDim.x - 1 - blockIdx.x;  // late Q tiles first
  const int q0 = qt * kBQ;
  const size_t base = (size_t)blockIdx.y * t_len * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16;  // this warp's first Q row
  const int n_kt_all = (t_len + kBK - 1) / kBK;
  // kBQ == kBK: the diagonal tile of Q tile qt is K tile qt, the walk's
  // last (written so, the compiler keeps the mask out of the other tiles)
  const int n_kt = causal ? min(n_kt_all, qt + 1) : n_kt_all;

  load_tile<kBQ, DP, LD, kMmaThreads>(qs, q + base, q0, t_len, d, vec);
  load_tile<kBK, DP, LD, kMmaThreads>(ks, k + base, 0, t_len, d, vec);
  load_tile<kBK, DP, LD, kMmaThreads>(vs, v + base, 0, t_len, d, vec);
  cp_async_commit();

  uint32_t qf[KC][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // rows g and g + 8: the running max of the raw scores Q.K and this
  // lane's partial sum of p
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt has landed; tile kt - 1's buffers are free
    if (kt == 0) {
#pragma unroll
      for (int c = 0; c < KC; ++c)
        ldsm_x4(qf[c], qs + (warp * 16 + a_row(lane)) * LD + c * 16 + a_col(lane));
    }
    if (kt + 1 < n_kt) {
      const int nb = (kt + 1) & 1;
      load_tile<kBK, DP, LD, kMmaThreads>(ks + nb * kBK * LD, k + base,
                                          (kt + 1) * kBK, t_len, d, vec);
      load_tile<kBK, DP, LD, kMmaThreads>(vs + nb * kBK * LD, v + base,
                                          (kt + 1) * kBK, t_len, d, vec);
    }
    cp_async_commit();
    const bf16* kb = ks + (kt & 1) * kBK * LD;
    const bf16* vb = vs + (kt & 1) * kBK * LD;

    // S = Q K^T
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c)
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, kb + (np * 16 + b_row(lane)) * LD + c * 16 + b_col(lane));
        mma_bf16(s[2 * np], qf[c], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[c], b[2], b[3]);
      }

    // mask on the diagonal and ragged tiles; the row max over the quad
    const int k0 = kt * kBK;
    const bool masked = (causal && kt == qt) || k0 + kBK > t_len;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (masked) {
          const int kj = k0 + n * 8 + 2 * t + (e & 1);
          const int qi = row0 + g + 8 * (e >> 1);
          if (kj >= t_len || (causal && kj > qi)) s[n][e] = -INFINITY;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    // p = exp2(s * scale * log2(e) - m_use * scale * log2(e)): one FFMA
    float mus[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFullMask, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFullMask, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      // a row with no visible key yet (only padding rows) keeps p = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f((m[h] - m_use) * scale_log2);
      m[h] = m_new;
      mus[h] = m_use * scale_log2;
      l[h] *= corr;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][2 * h] *= corr;
        acc[n][2 * h + 1] *= corr;
      }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[n][e], scale_log2, -mus[e >> 1]));
        l[e >> 1] += p;
        s[n][e] = p;
      }

    // O += bf16(P) V, P straight from the accumulators
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      uint32_t a[4];
      acc_to_a(a, s, j);
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, vb + (j * 16 + bt_row(lane)) * LD + np * 16 + bt_col(lane));
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFullMask, l[h], 1);
    l[h] += __shfl_xor_sync(kFullMask, l[h], 2);
    inv[h] = 1.f / l[h];
    const int qi = row0 + g + 8 * h;
    // lse = max(S * scale) + log l, natural log
    if (t == 0 && qi < t_len)
      lse[(size_t)blockIdx.y * t_len + qi] = m[h] * scale_log2 * kLn2 + logf(l[h]);
  }
  store_acc(o + base, acc, row0, t_len, d, inv[0], inv[1], vec);
}

template <int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int t_len, int d, int causal,
                       float scale, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<DP>();
  auto kern = flash_fwd_mma_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  using mma::aligned16;
  const int vec = d % 8 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(o);
  const dim3 grid((t_len + kBQ - 1) / kBQ, bh);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), t_len, d, causal, scale * kLog2e, vec);
  return cudaGetLastError();
}

// lse == nullptr: the serving instance (K1), which writes no logsumexp;
// bf16 with an lse (K4 in bf16, the GPT training forward) runs on the
// tensor cores
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     void* lse, int bh, int t_len, int d, int causal,
                     float scale, cudaStream_t stream) {
  if (lse == nullptr)
    return dispatch_d<T, false>(q, k, v, o, lse, bh, t_len, d, causal, scale, stream);
  if constexpr (std::is_same<T, bf16>::value) {
    if (d <= 64)
      return launch_mma<64>(q, k, v, o, lse, bh, t_len, d, causal, scale, stream);
    return launch_mma<128>(q, k, v, o, lse, bh, t_len, d, causal, scale, stream);
  } else {
    return dispatch_d<T, true>(q, k, v, o, lse, bh, t_len, d, causal, scale, stream);
  }
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
