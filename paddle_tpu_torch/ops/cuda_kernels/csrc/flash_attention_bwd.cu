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
// Every body runs on the tensor cores (mma.sync), and at the GPT training
// shape ([8, 8, 1024, 64] causal) each is bound by operations: bf16 at the
// card's 989 TFLOP/s (dQ 12.9 GFLOP, 0.0130 ms; dK/dV 0.0174 ms), f32 in
// 3xTF32, three TF32 products per f32 product at 495 TFLOP/s (dQ 0.078 ms,
// dK/dV 0.104 ms; the CUDA cores' 67 TFLOP/s would need 0.192 and 0.257
// for the one f32 product).  Each kernel has two bodies, one per dtype.
//
// f32 K5 and K6 in 3xTF32, flash_dq_tf32_kernel and flash_dkv_tf32_kernel
// (mma.sync m16n8k8; the f32 forward's building blocks, mma.cuh).  In f32
// the reference's casts are the identity, so each of the products is one
// f32 product, taken as three TF32 products of operands split into big
// and small halves (one TF32 pass, 2^-11 relative, would not hold the f32
// tolerance of 1e-4).  Each warp splits every operand it reads, and that
// integer work weighs on these bodies: small is passed unrounded
// (split_tf32<true>; mma.sync truncates it to TF32, about 2^-21 of x
// against 2^-22), which saves two of the split's five operations an
// element and took K5 + K6 from 0.85 to 0.76 ms at the GPT shape on an
// H100 (tools/time_flash_train.py --dtype float32).
//   - The bf16 bodies' tiling: 4 warps of 16 rows, 64-row tiles, K5 one
//     block per (b*h, Q tile), late tiles first, walking the K and V tiles
//     up to the diagonal; K6 one block per (b*h, K tile), early tiles
//     first, walking the Q tiles (with their lse and delta) from the
//     diagonal.  The walked tiles come through a two-stage cp.async ring,
//     16-byte chunks when d % 4 == 0, element by element otherwise, zero
//     past T and past d.  Masks only on the diagonal and the ragged tile;
//     rows and keys past T read no lse.
//   - Tiles are f32 with a row stride of DP + 4: six of them, 104 KB of
//     shared memory at DP 64 (two blocks an SM), 203 KB at DP 128 (one).
//   - S = Q K^T and dP = dO V^T (K6: S^T = K Q^T, dP^T = V dO^T) take A and
//     B through ldmatrix by the forward's S map, each fragment split as it
//     is read: the staged tiles stay in shared memory, and registers hold
//     S, dP and the accumulators.
//   - The second products, dQ += dS K (K6: dV += P^T dO, dK += dS^T Q),
//     take A from the score accumulators (acc_to_a_tf32, each 8-column
//     chunk's columns permuted) and B from rows 2t and 2t + 1 of the K (dO,
//     Q) tile (ld_v_tf32), as P V does in the forward: P and dS never
//     touch shared memory.  The D-wide accumulators (K6: two) are written
//     once.
//   - Each tile's second product is summed into zeroed registers and then
//     added to its accumulator in f32 (K6 at DP 64 only: at DP 128 the
//     partial sums spilled beside the two accumulators).  Summed straight
//     into an accumulator whose magnitude grows over the walk, the
//     products lost their low bits in the tensor cores' accumulation: dK
//     and dV lay 1.1-1.3e-5 from float64 at the GPT shape (3.9-5.0e-5 at
//     T 4096) against 1.4-2.2e-6 (1.3-1.8e-6) with the partial sums, on
//     an H100.
//
// bf16 K6 on the tensor cores, flash_dkv_mma_kernel (mma.sync m16n8k16):
//   - One block of 4 warps per (b*h, 64-row K tile), 16 K rows a warp; K
//     and V stay bf16 in shared memory and their A fragments are read by
//     ldmatrix for each Q tile (registers hold the two D-wide
//     accumulators instead).  Early K tiles launch first.
//   - The Q tiles from the diagonal to the end (all when non-causal) come
//     through a two-stage ring: Q and dO (bf16) by 16-byte cp.async, lse
//     and delta by 4-byte cp.async, zero past T.
//   - S^T = K Q^T and dP^T = V dO^T by mma.sync m16n8k16, Q and dO through
//     ldmatrix.  P^T = exp(S^T * scale - lse), zero where masked; masks
//     only on the diagonal and the ragged last Q tile.
//   - dV += P^T dO keeps the reference's rounding point (P and dO in f32):
//     P^T = hi + lo with hi = bf16(P), lo = bf16(P - hi), two products
//     into one f32 accumulator.  dO is exactly bf16, so each product is
//     exact and the sum is the f32 product to about 2^-16 relative.  This
//     costs a fifth product (10 D instead of 8 D flops a pair).
//   - dS^T = P^T (dP^T - delta) scale, rounded to bf16 in registers, is
//     the A fragment of dK += dS^T Q (Q through ldmatrix.trans).  P and dS
//     never touch shared memory.
//   - dK and dV go from f32 registers to bf16, written once.
//
// bf16 K5 on the tensor cores, flash_dq_mma_kernel: K6's design turned
// around, three products a tile against K6's five.
//   - One block of 4 warps per (b*h, 64-row Q tile), 16 Q rows a warp.
//     Late Q tiles launch first.  Q and dO are staged once and their A
//     fragments (ldmatrix) stay in registers for the whole K walk; each
//     lane reads lse and delta of its two rows once.
//   - K and V tiles (bf16, 64 rows) come through a two-stage cp.async
//     ring, zero past T and past d (element by element when d % 8 != 0);
//     the walk stops at the diagonal under causal.
//   - S = Q K^T and dP = dO V^T by mma.sync m16n8k16, K and V through
//     ldmatrix as row-major [key][d] tiles.  P = exp(S * scale - lse), zero
//     where masked; masks only on the diagonal and the ragged last K tile.
//   - dS = P (dP - delta) scale is rounded to bf16 in registers and packed
//     into the A fragment of dQ += dS K, K read again from its tile with
//     ldmatrix.trans: dS never touches shared memory.
//   - dQ goes from f32 registers to bf16 once.
// mma.cuh holds the fragment layouts and the loaders.

#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace ptt {
namespace {

constexpr int kB = 64;         // rows of a Q tile and of a K tile
constexpr int kThreads = 128;

// -- bf16 K6 on the tensor cores ----------------------------------------------

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
constexpr size_t dkv_mma_smem_bytes() {
  // K, V, 2 x (Q, dO) in bf16; 2 x (lse, delta) in f32
  return (size_t)6 * kB * (DP + 8) * sizeof(bf16) + 4 * kB * sizeof(float);
}

// 4 warps of 16 K rows each (kThreads)
template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
flash_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int t_len, int d, int causal,
                     float scale, int vec) {
  using namespace mma;
  constexpr int LD = DP + 8;
  constexpr int KC = DP / 16;  // 16-wide k-chunks of the head dim
  constexpr int NO = DP / 8;   // 8-wide n-tiles of dK and dV
  constexpr int NS = kB / 8;   // 8-wide n-tiles of a score tile (queries)
  static_assert(kThreads == 2 * kB, "a thread for each lse and delta value");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kB][LD]
  bf16* vs = ks + kB * LD;                       // [kB][LD]
  bf16* qs = vs + kB * LD;                       // [2][kB][LD]
  bf16* dos = qs + 2 * kB * LD;                  // [2][kB][LD]
  float* ls = reinterpret_cast<float*>(dos + 2 * kB * LD);  // [2][kB]
  float* dls = ls + 2 * kB;                                 // [2][kB]

  const int kt = blockIdx.x;  // early K tiles walk the most Q tiles
  const int k0 = kt * kB;
  const size_t base = (size_t)blockIdx.y * t_len * d;
  const size_t rbase = (size_t)blockIdx.y * t_len;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = k0 + warp * 16;  // this warp's first K row
  const float scale_log2 = scale * kLog2e;

  // Q tile qt's Q, dO, lse and delta into ring slot `buf`
  auto stage = [&](int qt, int buf) {
    const int q0 = qt * kB;
    load_tile<kB, DP, LD, kThreads>(qs + buf * kB * LD, q + base, q0, t_len,
                                    d, vec);
    load_tile<kB, DP, LD, kThreads>(dos + buf * kB * LD, dout + base, q0,
                                    t_len, d, vec);
    const int e = threadIdx.x & (kB - 1);
    const bool ok = q0 + e < t_len;
    const float* src = (threadIdx.x < kB ? lse : delta) + rbase;
    float* dst = (threadIdx.x < kB ? ls : dls) + buf * kB + e;
    cp_async4(dst, ok ? src + q0 + e : src, ok);
  };

  load_tile<kB, DP, LD, kThreads>(ks, k + base, k0, t_len, d, vec);
  load_tile<kB, DP, LD, kThreads>(vs, v + base, k0, t_len, d, vec);
  // kB rows in both tiles: Q tiles before the diagonal see none of these keys
  const int qt0 = causal ? kt : 0;
  const int n_qt = (t_len + kB - 1) / kB;
  stage(qt0, 0);
  cp_async_commit();

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int buf = (qt - qt0) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile qt has landed; the other slot is free
    if (qt + 1 < n_qt) stage(qt + 1, buf ^ 1);
    cp_async_commit();
    const int q0 = qt * kB;
    const bf16* qb = qs + buf * kB * LD;
    const bf16* db = dos + buf * kB * LD;
    const float* lb = ls + buf * kB;
    const float* deb = dls + buf * kB;

    // S^T = K Q^T: rows this warp's keys, columns the tile's queries
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      uint32_t a[4];
      ldsm_x4(a, ks + (warp * 16 + a_row(lane)) * LD + c * 16 + a_col(lane));
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, qb + (np * 16 + b_row(lane)) * LD + c * 16 + b_col(lane));
        mma_bf16(s[2 * np], a, b[0], b[1]);
        mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }

    // P^T = exp(S^T scale - lse), zero where masked
    const bool masked = (causal && qt == kt) || q0 + kB > t_len;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float2 lv = *reinterpret_cast<const float2*>(lb + n * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lq = (e & 1) ? lv.y : lv.x;
        float p = exp2f(s[n][e] * scale_log2 - lq * kLog2e);
        if (masked) {
          const int qi = q0 + n * 8 + 2 * t + (e & 1);
          const int kr = row0 + g + 8 * (e >> 1);
          if (qi >= t_len || (causal && kr > qi)) p = 0.f;
        }
        s[n][e] = p;
      }
    }

    // dV += P^T dO with P^T = hi + lo, both bf16
#pragma unroll
    for (int j = 0; j < NS / 2; ++j) {
      uint32_t hi[4], lo[4];
      acc_to_a(hi, s, j);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* pr = &s[2 * j + (r >> 1)][2 * (r & 1)];
        lo[r] = pack_bf16(pr[0] - bf16_lo(hi[r]), pr[1] - bf16_hi(hi[r]));
      }
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, db + (j * 16 + bt_row(lane)) * LD + np * 16 + bt_col(lane));
        mma_bf16(dv_acc[2 * np], hi, b[0], b[1]);
        mma_bf16(dv_acc[2 * np], lo, b[0], b[1]);
        mma_bf16(dv_acc[2 * np + 1], hi, b[2], b[3]);
        mma_bf16(dv_acc[2 * np + 1], lo, b[2], b[3]);
      }
    }

    // dP^T = V dO^T
    float dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      uint32_t a[4];
      ldsm_x4(a, vs + (warp * 16 + a_row(lane)) * LD + c * 16 + a_col(lane));
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, db + (np * 16 + b_row(lane)) * LD + c * 16 + b_col(lane));
        mma_bf16(dp[2 * np], a, b[0], b[1]);
        mma_bf16(dp[2 * np + 1], a, b[2], b[3]);
      }
    }

    // dS^T = P^T (dP^T - delta) scale, in place of dP^T
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float2 dl = *reinterpret_cast<const float2*>(deb + n * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[n][e] = s[n][e] * (dp[n][e] - ((e & 1) ? dl.y : dl.x)) * scale;
    }

    // dK += bf16(dS^T) Q
#pragma unroll
    for (int j = 0; j < NS / 2; ++j) {
      uint32_t a[4];
      acc_to_a(a, dp, j);
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, qb + (j * 16 + bt_row(lane)) * LD + np * 16 + bt_col(lane));
        mma_bf16(dk_acc[2 * np], a, b[0], b[1]);
        mma_bf16(dk_acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
  store_acc(dk + base, dk_acc, row0, t_len, d, 1.f, 1.f, vec);
  store_acc(dv + base, dv_acc, row0, t_len, d, 1.f, 1.f, vec);
}

template <int DP>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv, int bh,
                           int t_len, int d, int causal, float scale,
                           cudaStream_t stream) {
  const size_t smem = dkv_mma_smem_bytes<DP>();
  auto kern = flash_dkv_mma_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  using mma::aligned16;
  const int vec = d % 8 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(dout) && aligned16(dk) &&
                  aligned16(dv);
  const dim3 grid((t_len + kB - 1) / kB, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), t_len, d, causal,
      scale, vec);
  return cudaGetLastError();
}

// -- bf16 K5 on the tensor cores ----------------------------------------------

template <int DP>
constexpr size_t dq_mma_smem_bytes() {
  return (size_t)6 * kB * (DP + 8) * sizeof(bf16);  // Q, dO, 2 x (K, V)
}

// 4 warps of 16 Q rows each (kThreads)
template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
flash_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int t_len, int d, int causal, float scale, int vec) {
  using namespace mma;
  constexpr int LD = DP + 8;
  constexpr int KC = DP / 16;  // 16-wide k-chunks of the head dim
  constexpr int NO = DP / 8;   // 8-wide n-tiles of dQ
  constexpr int NS = kB / 8;   // 8-wide n-tiles of a score tile (keys)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kB][LD]
  bf16* dos = qs + kB * LD;                      // [kB][LD]
  bf16* ks = dos + kB * LD;                      // [2][kB][LD]
  bf16* vs = ks + 2 * kB * LD;                   // [2][kB][LD]

  const int qt = gridDim.x - 1 - blockIdx.x;  // late Q tiles walk the most
  const int q0 = qt * kB;
  const size_t base = (size_t)blockIdx.y * t_len * d;
  const size_t rbase = (size_t)blockIdx.y * t_len;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16;  // this warp's first Q row
  const float scale_log2 = scale * kLog2e;
  const int n_kt_all = (t_len + kB - 1) / kB;
  // kB rows in both tiles: the diagonal tile of Q tile qt is K tile qt, the
  // walk's last
  const int n_kt = causal ? min(n_kt_all, qt + 1) : n_kt_all;

  load_tile<kB, DP, LD, kThreads>(qs, q + base, q0, t_len, d, vec);
  load_tile<kB, DP, LD, kThreads>(dos, dout + base, q0, t_len, d, vec);
  load_tile<kB, DP, LD, kThreads>(ks, k + base, 0, t_len, d, vec);
  load_tile<kB, DP, LD, kThreads>(vs, v + base, 0, t_len, d, vec);
  cp_async_commit();

  // rows g and g + 8: lse * log2(e) and delta, 0 past T
  float lsl[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    lsl[h] = r < t_len ? lse[rbase + r] * kLog2e : 0.f;
    dl[h] = r < t_len ? delta[rbase + r] : 0.f;
  }

  uint32_t qf[KC][4], df[KC][4];  // Q's and dO's A fragments, held
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt has landed; tile kt - 1's buffers are free
    if (kt == 0) {
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const int off = (warp * 16 + a_row(lane)) * LD + c * 16 + a_col(lane);
        ldsm_x4(qf[c], qs + off);
        ldsm_x4(df[c], dos + off);
      }
    }
    if (kt + 1 < n_kt) {
      const int nb = (kt + 1) & 1;
      load_tile<kB, DP, LD, kThreads>(ks + nb * kB * LD, k + base,
                                      (kt + 1) * kB, t_len, d, vec);
      load_tile<kB, DP, LD, kThreads>(vs + nb * kB * LD, v + base,
                                      (kt + 1) * kB, t_len, d, vec);
    }
    cp_async_commit();
    const int k0 = kt * kB;
    const bf16* kb = ks + (kt & 1) * kB * LD;
    const bf16* vb = vs + (kt & 1) * kB * LD;

    // S = Q K^T: rows this warp's queries, columns the tile's keys
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

    // P = exp(S scale - lse), zero where masked (diagonal and ragged tiles)
    const bool masked = (causal && kt == qt) || k0 + kB > t_len;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[n][e], scale_log2, -lsl[e >> 1]));
        if (masked) {
          const int kj = k0 + n * 8 + 2 * t + (e & 1);
          const int qi = row0 + g + 8 * (e >> 1);
          if (kj >= t_len || (causal && kj > qi)) p = 0.f;
        }
        s[n][e] = p;
      }

    // dP = dO V^T
    float dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c)
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, vb + (np * 16 + b_row(lane)) * LD + c * 16 + b_col(lane));
        mma_bf16(dp[2 * np], df[c], b[0], b[1]);
        mma_bf16(dp[2 * np + 1], df[c], b[2], b[3]);
      }

    // dS = P (dP - delta) scale, in place of dP
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[n][e] = s[n][e] * (dp[n][e] - dl[e >> 1]) * scale;

    // dQ += bf16(dS) K, K as B from its [key][d] tile by ldmatrix.trans
#pragma unroll
    for (int j = 0; j < NS / 2; ++j) {
      uint32_t a[4];
      acc_to_a(a, dp, j);
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, kb + (j * 16 + bt_row(lane)) * LD + np * 16 + bt_col(lane));
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
  store_acc(dq + base, acc, row0, t_len, d, 1.f, 1.f, vec);
}

template <int DP>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, int bh, int t_len,
                          int d, int causal, float scale,
                          cudaStream_t stream) {
  const size_t smem = dq_mma_smem_bytes<DP>();
  auto kern = flash_dq_mma_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  using mma::aligned16;
  const int vec = d % 8 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(dout) && aligned16(dq);
  const dim3 grid((t_len + kB - 1) / kB, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), t_len, d, causal, scale, vec);
  return cudaGetLastError();
}

// -- f32 K5 and K6: 3xTF32 on mma.sync m16n8k8 --------------------------------

// small halves passed unrounded (mma.cuh's split_tf32<true>, the header)
constexpr bool kRawSmall = true;

template <int DP>
constexpr size_t dq_tf32_smem_bytes() {
  return (size_t)6 * kB * (DP + 4) * sizeof(float);  // Q, dO, 2 x (K, V)
}

template <int DP>
constexpr size_t dkv_tf32_smem_bytes() {
  // K, V, 2 x (Q, dO); 2 x (lse, delta)
  return (size_t)6 * kB * (DP + 4) * sizeof(float) + 4 * kB * sizeof(float);
}

// s = A B^T for one warp's 16 rows against a 64-row tile, 3xTF32: A's
// rows from `a` (this lane's ldmatrix address in its tile), B's rows from
// the tile `b` (this lane's ldmatrix offset `boff`), each fragment split
// as it is read.
template <int DP>
__device__ __forceinline__ void scores_3xtf32(float (&s)[kB / 8][4],
                                              const float* a, const float* b,
                                              int boff) {
  using namespace mma;
  constexpr int LD = DP + 4;
#pragma unroll
  for (int n = 0; n < kB / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int c = 0; c < DP / 8; ++c) {
    uint32_t x[4], ab[4], as[4];
    ldsm_x4(x, a + c * 8);
    split_tf32<kRawSmall>(x, ab, as);
#pragma unroll
    for (int np = 0; np < kB / 16; ++np) {
      uint32_t bb[4], bs[4];
      ldsm_x4(x, b + np * 16 * LD + boff + c * 8);
      split_tf32<kRawSmall>(x, bb, bs);
      mma_3xtf32(s[2 * np], ab, as, bb[0], bb[1], bs[0], bs[1]);
      mma_3xtf32(s[2 * np + 1], ab, as, bb[2], bb[3], bs[2], bs[3]);
    }
  }
}

// acc += A M, 3xTF32: A the warp's 16 x 64 score tile in its accumulators
// `p` (each 8-column chunk's columns permuted, acc_to_a_tf32), M the
// 64-row tile `m` read by rows 2t and 2t + 1 of each chunk (ld_v_tf32).
// FRESH sums the tile's product into zeroed registers, 8 n-tiles a pass
// (each pass splits A again), and adds that to acc in f32: summed
// straight into acc, whose magnitude grows over the walk, the products
// lose their low bits in the tensor cores' accumulation (the header).
template <int DP, bool FRESH>
__device__ __forceinline__ void accumulate_3xtf32(float (&acc)[DP / 8][4],
                                                  const float (&p)[kB / 8][4],
                                                  const float* m) {
  using namespace mma;
  constexpr int LD = DP + 4;
  constexpr int NG = FRESH ? 8 : DP / 8;  // n-tiles a pass
  const int lane = threadIdx.x & 31;
  const float* mr = m + 2 * (lane & 3) * LD + (lane >> 2);
#pragma unroll
  for (int n0 = 0; n0 < DP / 8; n0 += NG) {
    float part[NG][4];
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kB / 8; ++kc) {
      uint32_t ab[4], as[4];
      acc_to_a_tf32<kRawSmall>(ab, as, p[kc]);
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        uint32_t bb[2], bs[2];
        ld_v_tf32<LD, kRawSmall>(mr + kc * 8 * LD + (n0 + n) * 8, bb, bs);
        float (&c)[4] = FRESH ? part[n] : acc[n0 + n];
        mma_3xtf32(c, ab, as, bb[0], bb[1], bs[0], bs[1]);
      }
    }
    if constexpr (FRESH) {
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n0 + n][e] += part[n][e];
    }
  }
}

// 4 warps of 16 Q rows each (kThreads).  Two blocks an SM at DP 64, one at
// DP 128; either way ptxas may take 255 registers.
template <int DP>
__global__ void __launch_bounds__(kThreads, DP == 64 ? 2 : 1)
flash_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     int t_len, int d, int causal, float scale, int vec) {
  using namespace mma;
  constexpr int LD = DP + 4;
  constexpr int NO = DP / 8;   // 8-wide n-tiles of dQ
  constexpr int NS = kB / 8;   // 8-key chunks of a score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [kB][LD]
  float* dos = qs + kB * LD;                       // [kB][LD]
  float* ks = dos + kB * LD;                       // [2][kB][LD]
  float* vs = ks + 2 * kB * LD;                    // [2][kB][LD]

  const int qt = gridDim.x - 1 - blockIdx.x;  // late Q tiles walk the most
  const int q0 = qt * kB;
  const size_t base = (size_t)blockIdx.y * t_len * d;
  const size_t rbase = (size_t)blockIdx.y * t_len;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16;  // this warp's first Q row
  const float scale_log2 = scale * kLog2e;
  const int n_kt_all = (t_len + kB - 1) / kB;
  // kB rows in both tiles: the diagonal tile of Q tile qt is K tile qt, the
  // walk's last
  const int n_kt = causal ? min(n_kt_all, qt + 1) : n_kt_all;
  // this lane's ldmatrix addresses: the warp's A rows, a tile's B rows
  const int aoff = (warp * 16 + a_row(lane)) * LD + tf32_a_col(lane);
  const int boff = b_row(lane) * LD + tf32_b_col(lane);

  load_tile<kB, DP, LD, kThreads>(qs, q + base, q0, t_len, d, vec);
  load_tile<kB, DP, LD, kThreads>(dos, dout + base, q0, t_len, d, vec);
  load_tile<kB, DP, LD, kThreads>(ks, k + base, 0, t_len, d, vec);
  load_tile<kB, DP, LD, kThreads>(vs, v + base, 0, t_len, d, vec);
  cp_async_commit();

  // rows g and g + 8: lse * log2(e) and delta, 0 past T
  float lsl[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    lsl[h] = r < t_len ? lse[rbase + r] * kLog2e : 0.f;
    dl[h] = r < t_len ? delta[rbase + r] : 0.f;
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt has landed; tile kt - 1's buffers are free
    if (kt + 1 < n_kt) {
      const int nb = (kt + 1) & 1;
      load_tile<kB, DP, LD, kThreads>(ks + nb * kB * LD, k + base,
                                      (kt + 1) * kB, t_len, d, vec);
      load_tile<kB, DP, LD, kThreads>(vs + nb * kB * LD, v + base,
                                      (kt + 1) * kB, t_len, d, vec);
    }
    cp_async_commit();
    const int k0 = kt * kB;
    const float* kb = ks + (kt & 1) * kB * LD;
    const float* vb = vs + (kt & 1) * kB * LD;

    // S = Q K^T: rows this warp's queries, columns the tile's keys
    float s[NS][4];
    scores_3xtf32<DP>(s, qs + aoff, kb, boff);

    // P = exp(S scale - lse), zero where masked (diagonal and ragged tiles)
    const bool masked = (causal && kt == qt) || k0 + kB > t_len;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[n][e], scale_log2, -lsl[e >> 1]));
        if (masked) {
          const int kj = k0 + n * 8 + 2 * t + (e & 1);
          const int qi = row0 + g + 8 * (e >> 1);
          if (kj >= t_len || (causal && kj > qi)) p = 0.f;
        }
        s[n][e] = p;
      }

    // dP = dO V^T
    float dp[NS][4];
    scores_3xtf32<DP>(dp, dos + aoff, vb, boff);

    // dS = P (dP - delta) scale, in place of dP
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[n][e] = s[n][e] * (dp[n][e] - dl[e >> 1]) * scale;

    // dQ += dS K: dS straight from the accumulators, K by key rows
    accumulate_3xtf32<DP, true>(acc, dp, kb);
  }
  store_acc(dq + base, acc, row0, t_len, d, 1.f, 1.f, vec);
}

// 4 warps of 16 K rows each (kThreads); blocks an SM as K5's
template <int DP>
__global__ void __launch_bounds__(kThreads, DP == 64 ? 2 : 1)
flash_dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int t_len, int d, int causal,
                      float scale, int vec) {
  using namespace mma;
  constexpr int LD = DP + 4;
  constexpr int NO = DP / 8;   // 8-wide n-tiles of dK and dV
  constexpr int NS = kB / 8;   // 8-query chunks of a score tile
  // fresh partial sums at DP 64 only: at DP 128, 16 or 32 registers of
  // them beside the two 64-register accumulators made ptxas spill
  constexpr bool kFresh = DP == 64;
  static_assert(kThreads == 2 * kB, "a thread for each lse and delta value");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // [kB][LD]
  float* vs = ks + kB * LD;                        // [kB][LD]
  float* qs = vs + kB * LD;                        // [2][kB][LD]
  float* dos = qs + 2 * kB * LD;                   // [2][kB][LD]
  float* ls = dos + 2 * kB * LD;                   // [2][kB]
  float* dls = ls + 2 * kB;                        // [2][kB]

  const int kt = blockIdx.x;  // early K tiles walk the most Q tiles
  const int k0 = kt * kB;
  const size_t base = (size_t)blockIdx.y * t_len * d;
  const size_t rbase = (size_t)blockIdx.y * t_len;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = k0 + warp * 16;  // this warp's first K row
  const float scale_log2 = scale * kLog2e;
  const int aoff = (warp * 16 + a_row(lane)) * LD + tf32_a_col(lane);
  const int boff = b_row(lane) * LD + tf32_b_col(lane);

  // Q tile qt's Q, dO, lse and delta into ring slot `buf`
  auto stage = [&](int qt, int buf) {
    const int q0 = qt * kB;
    load_tile<kB, DP, LD, kThreads>(qs + buf * kB * LD, q + base, q0, t_len,
                                    d, vec);
    load_tile<kB, DP, LD, kThreads>(dos + buf * kB * LD, dout + base, q0,
                                    t_len, d, vec);
    const int e = threadIdx.x & (kB - 1);
    const bool ok = q0 + e < t_len;
    const float* src = (threadIdx.x < kB ? lse : delta) + rbase;
    float* dst = (threadIdx.x < kB ? ls : dls) + buf * kB + e;
    cp_async4(dst, ok ? src + q0 + e : src, ok);
  };

  load_tile<kB, DP, LD, kThreads>(ks, k + base, k0, t_len, d, vec);
  load_tile<kB, DP, LD, kThreads>(vs, v + base, k0, t_len, d, vec);
  // kB rows in both tiles: Q tiles before the diagonal see none of these keys
  const int qt0 = causal ? kt : 0;
  const int n_qt = (t_len + kB - 1) / kB;
  stage(qt0, 0);
  cp_async_commit();

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int buf = (qt - qt0) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile qt has landed; the other slot is free
    if (qt + 1 < n_qt) stage(qt + 1, buf ^ 1);
    cp_async_commit();
    const int q0 = qt * kB;
    const float* qb = qs + buf * kB * LD;
    const float* db = dos + buf * kB * LD;
    const float* lb = ls + buf * kB;
    const float* deb = dls + buf * kB;

    // S^T = K Q^T: rows this warp's keys, columns the tile's queries
    float s[NS][4];
    scores_3xtf32<DP>(s, ks + aoff, qb, boff);

    // P^T = exp(S^T scale - lse), zero where masked (diagonal, ragged)
    const bool masked = (causal && qt == kt) || q0 + kB > t_len;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float2 lv = *reinterpret_cast<const float2*>(lb + n * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lq = (e & 1) ? lv.y : lv.x;
        float p = exp2f(fmaf(s[n][e], scale_log2, -lq * kLog2e));
        if (masked) {
          const int qi = q0 + n * 8 + 2 * t + (e & 1);
          const int kr = row0 + g + 8 * (e >> 1);
          if (qi >= t_len || (causal && kr > qi)) p = 0.f;
        }
        s[n][e] = p;
      }
    }

    // dV += P^T dO: P^T straight from the accumulators, dO by query rows
    accumulate_3xtf32<DP, kFresh>(dv_acc, s, db);

    // dP^T = V dO^T
    float dp[NS][4];
    scores_3xtf32<DP>(dp, vs + aoff, db, boff);

    // dS^T = P^T (dP^T - delta) scale, in place of dP^T
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float2 dl = *reinterpret_cast<const float2*>(deb + n * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[n][e] = s[n][e] * (dp[n][e] - ((e & 1) ? dl.y : dl.x)) * scale;
    }

    // dK += dS^T Q
    accumulate_3xtf32<DP, kFresh>(dk_acc, dp, qb);
  }
  store_acc(dk + base, dk_acc, row0, t_len, d, 1.f, 1.f, vec);
  store_acc(dv + base, dv_acc, row0, t_len, d, 1.f, 1.f, vec);
}

// Launch `kern` on a (64-row tiles, bh) grid with `smem` bytes of dynamic
// shared memory; past the card's opt-in limit the attribute call fails and
// its error is returned
template <typename Kern, typename... Args>
cudaError_t launch_tf32(Kern kern, size_t smem, int bh, int t_len,
                        cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + kB - 1) / kB, bh);
  kern<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq_tf32(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int bh, int t_len,
                           int d, int causal, float scale,
                           cudaStream_t stream) {
  using mma::aligned16;
  // 16-byte cp.async chunks: d a whole number of 4 f32, all aligned
  const int vec = d % 4 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(dout) && aligned16(dq);
  return launch_tf32(
      flash_dq_tf32_kernel<DP>, dq_tf32_smem_bytes<DP>(), bh, t_len, stream,
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), t_len, d, causal, scale, vec);
}

template <int DP>
cudaError_t launch_dkv_tf32(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int bh,
                            int t_len, int d, int causal, float scale,
                            cudaStream_t stream) {
  using mma::aligned16;
  const int vec = d % 4 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(dout) && aligned16(dk) &&
                  aligned16(dv);
  return launch_tf32(
      flash_dkv_tf32_kernel<DP>, dkv_tf32_smem_bytes<DP>(), bh, t_len,
      stream, static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), t_len, d, causal,
      scale, vec);
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
    case ptt::kFloat32:  // 3xTF32 on the tensor cores
      if (d <= 64)
        return (int)ptt::launch_dq_tf32<64>(q, k, v, dout, lse, delta, dq, bh, t_len, d, causal, scale, s);
      return (int)ptt::launch_dq_tf32<128>(q, k, v, dout, lse, delta, dq, bh, t_len, d, causal, scale, s);
    case ptt::kBFloat16:  // the tensor-core body
      if (d <= 64)
        return (int)ptt::launch_dq_mma<64>(q, k, v, dout, lse, delta, dq, bh, t_len, d, causal, scale, s);
      return (int)ptt::launch_dq_mma<128>(q, k, v, dout, lse, delta, dq, bh, t_len, d, causal, scale, s);
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
    case ptt::kFloat32:  // 3xTF32 on the tensor cores
      if (d <= 64)
        return (int)ptt::launch_dkv_tf32<64>(q, k, v, dout, lse, delta, dk, dv, bh, t_len, d, causal, scale, s);
      return (int)ptt::launch_dkv_tf32<128>(q, k, v, dout, lse, delta, dk, dv, bh, t_len, d, causal, scale, s);
    case ptt::kBFloat16:  // the tensor-core body
      if (d <= 64)
        return (int)ptt::launch_dkv_mma<64>(q, k, v, dout, lse, delta, dk, dv, bh, t_len, d, causal, scale, s);
      return (int)ptt::launch_dkv_mma<128>(q, k, v, dout, lse, delta, dk, dv, bh, t_len, d, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
