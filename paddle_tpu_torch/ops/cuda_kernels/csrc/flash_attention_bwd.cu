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
// At the GPT training shape ([8, 8, 1024, 64] causal) both dtypes are
// bound by operations: f32 by the 67 TFLOP/s of the CUDA cores (dQ 0.192
// ms), bf16 by the card's 989 TFLOP/s (dQ 12.9 GFLOP, 0.0130 ms; dK/dV
// 0.0174 ms).  Each kernel has two bodies, one per dtype.
//
// f32 K5 and K6, on the CUDA cores (flash_dq_kernel, flash_dkv_kernel;
// their f32 instances beat SDPA's f32 backward).  A block of 128 threads
// owns one 64-row tile; thread (ty, tx) of an 8 x 16 grid holds rows
// ty*8 .. ty*8+7 and the score columns tx + 16*j (j < 4), so a row's 16
// threads sit in one half-warp and the tile that feeds the second product
// passes through shared memory with a warp barrier only.
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
// them), so any T works.
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
    case ptt::kFloat32:
      return (int)ptt::dispatch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, bh, t_len, d, causal, scale, s);
    case ptt::kBFloat16:  // the tensor-core body
      if (d <= 64)
        return (int)ptt::launch_dkv_mma<64>(q, k, v, dout, lse, delta, dk, dv, bh, t_len, d, causal, scale, s);
      return (int)ptt::launch_dkv_mma<128>(q, k, v, dout, lse, delta, dk, dv, bh, t_len, d, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
