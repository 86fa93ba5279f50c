// Causal flash attention forward for Hopper (sm_90a): K1 and K4.
//
// Replaces the Pallas TPU kernels flash_attention (K1) and
// flash_attention_fwd (K4, with_lse=True)
// (paddle_tpu/ops/pallas_kernels/flash_attention.py: _fwd_body, _fwd_grid;
// one pallas_call at :190): out = softmax(Q K^T * scale [+ causal mask]) V
// over [B, H, T, D] (contiguous), f32 scores, an online softmax (running
// max m, normalizer l, f32 accumulator per row), P cast to the value dtype
// before P.V.  The LSE instance (K4, training) also writes lse = m + log l
// per real row in f32, the backward's residual; the serving instance (K1)
// compiles that write out.
//
// Bound on an H100: causal, the work is 4*D*T*(T+1)/2 flops per (b, h)
// and 4*T*D elements of traffic (Q, K, V read once, O written once; K4
// adds T f32 lse values).  Two bodies, one per operand type, both on the
// tensor cores and in FlashAttention-2's form:
//   - bf16, flash_fwd_mma_kernel: mma.sync m16n8k16.  At the GPT training
//     shape ([8, 8, 1024, 64] causal) its 8.6 GFLOP take 0.0087 ms at the
//     card's 989 TFLOP/s, so it is bound by the 0.0101 ms of its bytes.
//   - f32, flash_fwd_tf32_kernel: 3xTF32 (mma.cuh), three m16n8k8 TF32
//     products per f32 product.  One TF32 pass keeps 11 bits of each
//     operand (about 2^-11 relative), which the reference's f32 products
//     and the 1e-4 f32 parity rule out; the split keeps about 2^-22.  At
//     the serving prefill shape ([4, 8, 1024, 64] causal) the three passes
//     are 3 x 4.3 GFLOP, 0.026 ms at the card's 495 TFLOP/s of dense TF32,
//     above the 0.0100 ms of its bytes: bound by operations (the CUDA
//     cores' 67 TFLOP/s would need 0.064 ms for the one f32 product).
// Common to both:
//   - One block of 4 warps per (b*h, 64-row Q tile), 16 Q rows a warp.
//     Late Q tiles walk the most K tiles and launch first; the walk stops
//     at the diagonal under causal, so masked future tiles are never read.
//   - K and V tiles (64 rows) sit in shared memory in a two-stage ring
//     filled by 16-byte cp.async with zero fill past T and past d: tile
//     k+1 is in flight while tile k is multiplied.  A head dim that is not
//     a whole number of 16-byte chunks (bf16 d % 8, f32 d % 4) is staged
//     element by element instead.
//   - S = Q K^T with K through ldmatrix.  The online softmax keeps the raw
//     scores' running max m and takes p = exp2(s * c - m * c), c = scale *
//     log2(e), one FFMA and one exp2 an element.  A row's 16 scores of a
//     tile sit in one quad of lanes: the row max takes two shuffles, and
//     the row sum stays a per-lane partial until the end.  Masks are
//     applied only on the diagonal tile, the walk's last, and on the
//     ragged last tile.
//   - P goes from the score accumulators to the A fragment of P V in
//     registers (mma.cuh): it never touches shared memory.
//   - O = acc / l in the input dtype and, for K4, lse = m * scale + log l
//     per real row in f32.
// bf16: Q's A fragments (ldmatrix) stay in registers for the whole K walk;
// P is rounded to bf16 and packed; V goes through ldmatrix.trans.  Tiles
// are bf16 with a row stride of DP + 8.  Three blocks an SM at DP 64.
// f32: tiles are f32 with a row stride of DP + 4, so shared memory is Q
// plus 2 x (K, V) at 64 x (DP + 4) f32, 87 KB at DP 64 (two blocks an SM)
// and 169 KB at DP 128 (one).  Q is split into TF32 big and small once:
// at DP 64 both fragments stay in registers for the walk (64 registers a
// lane); at DP 128 they would pass 255 with the 64 of O, so Q stays in
// shared memory and is re-read and split for each K tile.  Each K and V
// value is split as it is read.  ldmatrix.trans cannot transpose f32, so
// V's B registers are plain 32-bit loads of key rows 2t and 2t + 1, and
// P's A fragment takes its chunk's keys in the same permuted order.
// mma.cuh holds the fragment layouts, the loaders and the split.

#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace ptt {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kMmaThreads = 128;  // 4 warps, 16 Q rows each
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The row max and partial sum of one 16-row score tile (rows g, g + 8 of
// the warp), masked on the diagonal and ragged tiles, and the scaled
// running state: s becomes p = exp2(s * c - m * c), acc is rescaled.
template <int NS, int NO>
__device__ __forceinline__ void online_softmax(float (&s)[NS][4],
                                               float (&acc)[NO][4],
                                               float (&m)[2], float (&l)[2],
                                               bool masked, int k0,
                                               int row0, int t_len,
                                               int causal, float scale_log2) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
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
}

// -- bf16: mma.sync m16n8k16 ------------------------------------------------

template <int DP>
constexpr size_t mma_smem_bytes() {
  return (size_t)(kBQ + 4 * kBK) * (DP + 8) * sizeof(bf16);  // Q, 2 x (K, V)
}

// Three blocks an SM at DP = 64 hold ptxas to 168 registers (149 used, no
// spill); four would hold it to 128 and spill.
template <int DP, bool LSE>
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

    // p = exp2(s * scale * log2(e) - m * scale * log2(e)): one FFMA
    const int k0 = kt * kBK;
    online_softmax(s, acc, m, l, (causal && kt == qt) || k0 + kBK > t_len,
                   k0, row0, t_len, causal, scale_log2);

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
    if (LSE && t == 0 && qi < t_len)
      lse[(size_t)blockIdx.y * t_len + qi] = m[h] * scale_log2 * kLn2 + logf(l[h]);
  }
  store_acc(o + base, acc, row0, t_len, d, inv[0], inv[1], vec);
}

// -- f32: 3xTF32 on mma.sync m16n8k8 ------------------------------------------

template <int DP>
constexpr size_t tf32_smem_bytes() {
  return (size_t)(kBQ + 4 * kBK) * (DP + 4) * sizeof(float);  // Q, 2 x (K, V)
}

// Two blocks an SM at DP 64 (87 KB of shared memory each), one at DP 128
// (169 KB); either way ptxas may take 255 registers.
template <int DP, bool LSE>
__global__ void __launch_bounds__(kMmaThreads, DP == 64 ? 2 : 1)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int t_len, int d, int causal,
                      float scale_log2, int vec) {
  using namespace mma;
  constexpr int LD = DP + 4;
  constexpr int KC = DP / 8;   // 8-wide k-chunks of the head dim
  constexpr int NO = DP / 8;   // 8-wide n-tiles of the output
  constexpr int NS = kBK / 8;  // 8-wide n-tiles (8-key chunks) of a score tile
  // Q's split fragments in registers for the walk, or re-read (header)
  constexpr bool kHoldQ = DP == 64;
  constexpr int QH = kHoldQ ? KC : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [kBQ][LD]
  float* ks = qs + kBQ * LD;                       // [2][kBK][LD]
  float* vs = ks + 2 * kBK * LD;                   // [2][kBK][LD]

  const int qt = gridDim.x - 1 - blockIdx.x;  // late Q tiles first
  const int q0 = qt * kBQ;
  const size_t base = (size_t)blockIdx.y * t_len * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16;  // this warp's first Q row
  const int n_kt_all = (t_len + kBK - 1) / kBK;
  // kBQ == kBK: the diagonal tile of Q tile qt is K tile qt, the walk's last
  const int n_kt = causal ? min(n_kt_all, qt + 1) : n_kt_all;
  const float* qw = qs + (warp * 16 + a_row(lane)) * LD + tf32_a_col(lane);

  load_tile<kBQ, DP, LD, kMmaThreads>(qs, q + base, q0, t_len, d, vec);
  load_tile<kBK, DP, LD, kMmaThreads>(ks, k + base, 0, t_len, d, vec);
  load_tile<kBK, DP, LD, kMmaThreads>(vs, v + base, 0, t_len, d, vec);
  cp_async_commit();

  uint32_t qb[QH][4], qsm[QH][4];  // Q's big and small A fragments
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt has landed; tile kt - 1's buffers are free
    if (kHoldQ && kt == 0) {
#pragma unroll
      for (int c = 0; c < QH; ++c) {
        uint32_t x[4];
        ldsm_x4(x, qw + c * 8);
        split_tf32(x, qb[c], qsm[c]);
      }
    }
    if (kt + 1 < n_kt) {
      const int nb = (kt + 1) & 1;
      load_tile<kBK, DP, LD, kMmaThreads>(ks + nb * kBK * LD, k + base,
                                          (kt + 1) * kBK, t_len, d, vec);
      load_tile<kBK, DP, LD, kMmaThreads>(vs + nb * kBK * LD, v + base,
                                          (kt + 1) * kBK, t_len, d, vec);
    }
    cp_async_commit();
    const float* kb = ks + (kt & 1) * kBK * LD;
    const float* vb = vs + (kt & 1) * kBK * LD;

    // S = Q K^T, 3xTF32
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      uint32_t ab[4], as[4];
      if constexpr (kHoldQ) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ab[i] = qb[c][i];
          as[i] = qsm[c][i];
        }
      } else {
        uint32_t x[4];
        ldsm_x4(x, qw + c * 8);
        split_tf32(x, ab, as);
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t b[4], bb[4], bs[4];
        ldsm_x4(b, kb + (np * 16 + b_row(lane)) * LD + c * 8 + tf32_b_col(lane));
        split_tf32(b, bb, bs);
        mma_3xtf32(s[2 * np], ab, as, bb[0], bb[1], bs[0], bs[1]);
        mma_3xtf32(s[2 * np + 1], ab, as, bb[2], bb[3], bs[2], bs[3]);
      }
    }

    const int k0 = kt * kBK;
    online_softmax(s, acc, m, l, (causal && kt == qt) || k0 + kBK > t_len,
                   k0, row0, t_len, causal, scale_log2);

    // O += P V, 3xTF32, P straight from the accumulators (keys permuted)
#pragma unroll
    for (int kc = 0; kc < NS; ++kc) {
      uint32_t ab[4], as[4];
      acc_to_a_tf32(ab, as, s[kc]);
      const float* vr = vb + (kc * 8 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t bb[2], bs[2];
        ld_v_tf32<LD>(vr + n * 8, bb, bs);
        mma_3xtf32(acc[n], ab, as, bb[0], bb[1], bs[0], bs[1]);
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
    if (LSE && t == 0 && qi < t_len)
      lse[(size_t)blockIdx.y * t_len + qi] = m[h] * scale_log2 * kLn2 + logf(l[h]);
  }
  store_acc(o + base, acc, row0, t_len, d, inv[0], inv[1], vec);
}

// -- launch -------------------------------------------------------------------

template <typename T, typename Kern>
cudaError_t launch_body(Kern kern, size_t smem, int chunk, const void* q,
                        const void* k, const void* v, void* o, void* lse,
                        int bh, int t_len, int d, int causal, float scale,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  using mma::aligned16;
  const int vec = d % chunk == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(o);
  const dim3 grid((t_len + kBQ - 1) / kBQ, bh);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      t_len, d, causal, scale * kLog2e, vec);
  return cudaGetLastError();
}

// The body for T: f32 on 3xTF32 (4 elements a 16-byte chunk), bf16 on
// m16n8k16 (8)
template <typename T, int DP, bool LSE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int t_len, int d, int causal,
                   float scale, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value)
    return launch_body<float>(flash_fwd_tf32_kernel<DP, LSE>,
                              tf32_smem_bytes<DP>(), 4, q, k, v, o, lse, bh,
                              t_len, d, causal, scale, s);
  else
    return launch_body<bf16>(flash_fwd_mma_kernel<DP, LSE>,
                             mma_smem_bytes<DP>(), 8, q, k, v, o, lse, bh,
                             t_len, d, causal, scale, s);
}

// lse == nullptr: the serving instance (K1), which writes no logsumexp
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     void* lse, int bh, int t_len, int d, int causal,
                     float scale, cudaStream_t s) {
  if (lse == nullptr) {
    if (d <= 64)
      return launch<T, 64, false>(q, k, v, o, lse, bh, t_len, d, causal, scale, s);
    return launch<T, 128, false>(q, k, v, o, lse, bh, t_len, d, causal, scale, s);
  }
  if (d <= 64)
    return launch<T, 64, true>(q, k, v, o, lse, bh, t_len, d, causal, scale, s);
  return launch<T, 128, true>(q, k, v, o, lse, bh, t_len, d, causal, scale, s);
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
