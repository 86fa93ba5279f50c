// Multi-query paged (ragged) KV-cache attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paged_attention_mq
// (paddle_tpu/ops/pallas_kernels/paged_attention.py: _mq_kernel_body,
// paged_attention_mq): C query rows per slot n attend over the slot's
// context, which lives in pages of a shared pool [P, nh, ps, dh] reached
// through page_table [N, maxp].  Row c sees the keys
// p <= q_starts[n] + c and p < ctx_lens[n] — the chunked-prefill chunk
// and the speculative verify rows.  Scores are f32 and scaled, masked keys
// weigh nothing, the softmax is online, P is rounded to the value type
// before P.V (as _mq_kernel_body does), and the output is acc / l.
//
// Bound on an H100: memory at the serving shapes.  The K/V bytes the rows
// need are sum_n min(ctx_n, q_starts_n + C) * nh * dh * 2 * itemsize
// (keys past the last row's position are never needed); the work is
// 4 * dh FLOPs per visible (row, key) pair.  At these sizes what holds the
// kernel is latency and occupancy, so it splits the walk across blocks
// and keeps page copies in flight.
//
// Design (split-KV, paged_split.cuh):
//   - Grid (S, nh, N * RT): block (s, h, n, rt) walks pages [8 s, 8 s + 8)
//     of slot n's context for head h and query rows [64 rt, 64 rt + 64)
//     (kMqRows), never past the last page its rows need,
//     min(ctx, q_start + last row + 1, maxp * ps).  One block holds all C
//     rows up to 64 (the mixed step's 32, the verify's 5), so each staged
//     page is read once per (slot, head, split).
//   - Its NW warps: MT = ceil(rows / 16) m-tiles of 16 rows (1, 2 or 4;
//     3 is taken as 4) times KG = NW / MT key groups.  Warp w computes
//     m-tile w % MT against the 16-key units of the split whose index is
//     w / MT modulo KG: a page is ceil(ps / 16) units, a unit's rows past
//     the page or past the keys its rows need are zero.  NW is 4, and 8
//     for f32 blocks of two or more m-tiles, whose three TF32 products
//     make each unit's work three times bf16's (measured: 8 warps were
//     faster there and slower at one m-tile or in bf16).
//   - Staging: the block copies each round's KG units of K and V by
//     16-byte cp.async (zero fill past the valid rows and past dh) into a
//     ring of NSTAGE = 1 + ceil(4 / KG) rounds in shared memory, so four
//     units (eight with 8 warps) are in flight while one round is
//     multiplied.  Pool
//     slots no row can see are never read.  A head dim that is not a whole
//     number of 16-byte chunks, or an unaligned tensor, is staged element
//     by element.
//   - Products on the tensor cores (mma.sync, mma.cuh), as the flash
//     forward does: bf16 Q.K^T and P.V on m16n8k16 with Q's fragments in
//     registers for the walk and P passed from the score accumulators to
//     P.V in registers; f32 in 3xTF32 on m16n8k8 (three TF32 products per
//     f32 product, the fewest that hold the f32 parity of 1e-4).  The
//     online softmax masks every (row, key) pair by position.
//   - The key groups' partial softmaxes merge through shared memory into
//     the block's partial per row; the combine merges the splits into the
//     output.
// Position 0 is visible to every row (q_starts >= 0, ctx_lens >= 1) and
// lies in split 0, so every row has a finite max and a positive
// normalizer: rows past a lane's valid chunk come out finite.  A row that
// sees no key of some later split writes (m = -inf, l = 0) there, which
// the combine weighs as nothing.  Preconditions (not checked: they would
// need a host synchronisation): ctx_lens[n] >= 1 and q_starts[n] >= 0.

#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"
#include "paged_split.cuh"

namespace ptt {
namespace {

using bf16 = __nv_bfloat16;
// query rows a block holds (mirrored in paged_attention.py MQ_ROWS, which
// a test reads from here)
constexpr int kMqRows = 64;
// warps a block: kWarps, or kWarpsWideF32 for f32 blocks of 2+ m-tiles
constexpr int kWarps = 4;
constexpr int kWarpsWideF32 = 8;
constexpr int kUnit = 16;  // keys a unit: one k16 chunk of P.V

// Rows [0, ROWS) of a row-major [*, dh] matrix of T into `dst` (row
// stride LD, columns [0, DP)), zero at rows >= valid and columns >= dh,
// NT threads; with `vec` by 16-byte cp.async, otherwise element by
// element.
template <typename T, int DP, int LD, int ROWS, int NT>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src,
                                           int valid, int dh, bool vec) {
  constexpr int E = 16 / sizeof(T);
  constexpr int CHP = DP / E;  // chunks a padded row
  for (int e = threadIdx.x; e < ROWS * CHP; e += NT) {
    const int r = e / CHP, c = (e - r * CHP) * E;
    T* d = dst + r * LD + c;
    if (vec) {
      const bool ok = r < valid && c < dh;
      mma::cp_async16(d, ok ? src + (size_t)r * dh + c : src, ok);
    } else {
#pragma unroll
      for (int u = 0; u < E; ++u)
        d[u] = (r < valid && c + u < dh) ? src[(size_t)r * dh + c + u]
                                         : from_f<T>(0.f);
    }
  }
}

// The online softmax of one 16-row x 16-key score tile (rows g, g + 8 of
// the warp's m-tile; keys 2t, 2t + 1 of each 8-key n-tile), every pair
// masked by position: key kp weighs nothing past the row's position qp or
// at or past kv_hi.  s becomes p = exp2(s c - m c), acc and l are
// rescaled; l stays this lane's partial sum until the end.
template <int NO>
__device__ __forceinline__ void online_softmax16(float (&s)[2][4],
                                                 float (&acc)[NO][4],
                                                 float (&m)[2], float (&l)[2],
                                                 int kpos0, int qpos0,
                                                 int kv_hi, float c) {
  const int t = threadIdx.x & 3;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kp = kpos0 + n * 8 + 2 * t + (e & 1);
      const int qp = qpos0 + 8 * (e >> 1);
      if (kp > qp || kp >= kv_hi) s[n][e] = -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    }
  float mus[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFullMask, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFullMask, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    // a row with no visible key yet keeps p = 0
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float corr = exp2f((m[h] - m_use) * c);
    m[h] = m_new;
    mus[h] = m_use * c;
    l[h] *= corr;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][2 * h] *= corr;
      acc[n][2 * h + 1] *= corr;
    }
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(fmaf(s[n][e], c, -mus[e >> 1]));
      l[e >> 1] += p;
      s[n][e] = p;
    }
}

template <typename T, int DP>
struct Layout {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int LD = kF32 ? DP + 4 : DP + 8;  // conflict-free ldmatrix
  static constexpr int NO = DP / 8;                  // 8-wide output n-tiles
  // f32: Q's split fragments held for the walk at DP 64, re-read at 128
  static constexpr bool kHoldQ = !kF32 || DP == 64;
};

template <int MT, int NW>
struct Warps {
  static constexpr int NT = NW * 32;                  // threads
  static constexpr int KG = NW / MT;                  // key groups
  static constexpr int NSTAGE = 1 + (4 + KG - 1) / KG;  // rounds in the ring
  static constexpr int MR = MT * 16;                   // rows computed
};

template <typename T, int DP, int MT, int NW>
__global__ void __launch_bounds__(NW * 32)
paged_attn_mq_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                           const T* __restrict__ vp,
                           const int* __restrict__ pt,
                           const int* __restrict__ cl,
                           const int* __restrict__ q0,
                           float* __restrict__ part_ml,
                           float* __restrict__ part_acc, int nh, int C,
                           int dh, int ps, int maxp, float scale_log2,
                           int vec) {
  using namespace mma;
  using L = Layout<T, DP>;
  using W = Warps<MT, NW>;
  constexpr int LD = L::LD, NO = L::NO, KG = W::KG, NSTAGE = W::NSTAGE;
  constexpr int NT = W::NT;
  constexpr int MR = W::MR;
  constexpr int TILE = kUnit * LD;  // elements of one staged unit
  extern __shared__ __align__(16) unsigned char smem_raw[];
  paged::allow_dependent_launch();
  const int s = blockIdx.x, h = blockIdx.y;
  const int RT = (C + kMqRows - 1) / kMqRows;
  const int n = blockIdx.z / RT;
  const int c_lo = (blockIdx.z - n * RT) * kMqRows;
  const int rows = min(C - c_lo, kMqRows);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int start = q0[n];
  // keys any row may see: positions past the table are outside the
  // context, as in the reference's dense view of the table
  const int kv_lim = min(cl[n], maxp * ps);
  // keys some row of this block sees
  const int kv_end = min(kv_lim, start + c_lo + rows);
  const int n_pages = (kv_end + ps - 1) / ps;
  const int p0 = s * paged::kPagesPerSplit;
  // the partial of the block's row 0
  const size_t prow = (((size_t)n * nh + h) * gridDim.x + s) * C + c_lo;
  if (p0 >= n_pages) {  // nothing of this slot's context here
    for (int r = threadIdx.x; r < rows; r += NT) {
      part_ml[2 * (prow + r)] = -INFINITY;
      part_ml[2 * (prow + r) + 1] = 0.f;
    }
    return;
  }
  const int p1 = min(p0 + paged::kPagesPerSplit, n_pages);
  const int upp = (ps + kUnit - 1) / kUnit;  // units a page
  const int n_rounds = ((p1 - p0) * upp + KG - 1) / KG;

  T* qs = reinterpret_cast<T*>(smem_raw);  // [MR][LD]
  T* ring = qs + MR * LD;                  // [NSTAGE][KG][K, V][kUnit][LD]
  const int* ptab = pt + (size_t)n * maxp;
  // unit ui of the split: page j, its first key, and its keys to stage
  auto unit = [&](int ui, int& j, int& kpos0) {
    const int jj = ui / upp;
    j = p0 + jj;
    kpos0 = j * ps + (ui - jj * upp) * kUnit;
    return min(min(kv_end, (j + 1) * ps) - kpos0, kUnit);
  };
  auto stage_round = [&](int r) {
    T* b = ring + (size_t)(r % NSTAGE) * KG * 2 * TILE;
    for (int gi = 0; gi < KG; ++gi) {
      const int ui = r * KG + gi;
      int j, kpos0;
      if (ui >= (p1 - p0) * upp) break;
      const int valid = unit(ui, j, kpos0);
      if (valid <= 0) continue;
      const size_t off = ((size_t)ptab[j] * nh + h) * (size_t)ps * dh +
                         (size_t)(kpos0 - j * ps) * dh;
      stage_rows<T, DP, LD, kUnit, NT>(b + gi * 2 * TILE, kp + off, valid,
                                       dh, vec);
      stage_rows<T, DP, LD, kUnit, NT>(b + gi * 2 * TILE + TILE, vp + off,
                                       valid, dh, vec);
    }
  };
  const T* qrow0 = q + (((size_t)n * nh + h) * C + c_lo) * dh;
  stage_rows<T, DP, LD, MR, NT>(qs, qrow0, rows, dh, vec);
  stage_round(0);
  cp_async_commit();
#pragma unroll
  for (int r = 1; r < NSTAGE - 1; ++r) {
    if (r < n_rounds) stage_round(r);
    cp_async_commit();
  }

  const int mt = warp % MT, kgi = warp / MT;
  const int qpos0 = start + c_lo + mt * 16 + g;  // row g; row g + 8 is +8
  const T* qw = qs + (mt * 16 + a_row(lane)) * LD +
                (L::kF32 ? tf32_a_col(lane) : a_col(lane));
  constexpr int QH = L::kF32 ? (L::kHoldQ ? DP / 8 : 1) : DP / 16;
  uint32_t qa[QH][4], qsm[L::kF32 ? QH : 1][4];  // Q's fragments
  float acc[NO][4];
#pragma unroll
  for (int nn = 0; nn < NO; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nn][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int r = 0; r < n_rounds; ++r) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // round r has landed; round r - 1's buffer is free
    if (r == 0 && L::kHoldQ) {
#pragma unroll
      for (int c = 0; c < QH; ++c) {
        if constexpr (L::kF32) {
          uint32_t x[4];
          ldsm_x4(x, qw + c * 8);
          split_tf32(x, qa[c], qsm[c]);
        } else {
          ldsm_x4(qa[c], qw + c * 16);
        }
      }
    }
    if (r + NSTAGE - 1 < n_rounds) stage_round(r + NSTAGE - 1);
    cp_async_commit();
    const int ui = r * KG + kgi;
    if (ui >= (p1 - p0) * upp) continue;
    int j, kpos0;
    const int valid = unit(ui, j, kpos0);
    if (valid <= 0) continue;
    const T* kb = ring + ((size_t)(r % NSTAGE) * KG + kgi) * 2 * TILE;
    const T* vb = kb + TILE;

    float sc[2][4];
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nn][e] = 0.f;
    if constexpr (L::kF32) {
      // S = Q K^T in 3xTF32
#pragma unroll
      for (int c = 0; c < DP / 8; ++c) {
        uint32_t ab[4], as[4];
        if constexpr (L::kHoldQ) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ab[i] = qa[c][i];
            as[i] = qsm[c][i];
          }
        } else {
          uint32_t x[4];
          ldsm_x4(x, qw + c * 8);
          split_tf32(x, ab, as);
        }
        uint32_t b[4], bb[4], bs[4];
        ldsm_x4(b, kb + b_row(lane) * LD + c * 8 + tf32_b_col(lane));
        split_tf32(b, bb, bs);
        mma_3xtf32(sc[0], ab, as, bb[0], bb[1], bs[0], bs[1]);
        mma_3xtf32(sc[1], ab, as, bb[2], bb[3], bs[2], bs[3]);
      }
      online_softmax16(sc, acc, m, l, kpos0, qpos0, kpos0 + valid,
                       scale_log2);
      // O += P V in 3xTF32, P from the accumulators (keys permuted)
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        uint32_t ab[4], as[4];
        acc_to_a_tf32(ab, as, sc[kc]);
        const float* vr =
            reinterpret_cast<const float*>(vb) + (kc * 8 + 2 * t) * LD + g;
#pragma unroll
        for (int nn = 0; nn < NO; ++nn) {
          uint32_t bb[2], bs[2];
          ld_v_tf32<LD>(vr + nn * 8, bb, bs);
          mma_3xtf32(acc[nn], ab, as, bb[0], bb[1], bs[0], bs[1]);
        }
      }
    } else {
      // S = Q K^T on m16n8k16
#pragma unroll
      for (int c = 0; c < DP / 16; ++c) {
        uint32_t b[4];
        ldsm_x4(b, kb + b_row(lane) * LD + c * 16 + b_col(lane));
        mma_bf16(sc[0], qa[c], b[0], b[1]);
        mma_bf16(sc[1], qa[c], b[2], b[3]);
      }
      online_softmax16(sc, acc, m, l, kpos0, qpos0, kpos0 + valid,
                       scale_log2);
      // O += bf16(P) V, P straight from the accumulators
      uint32_t a[4];
      acc_to_a(a, sc, 0);
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, vb + bt_row(lane) * LD + np * 16 + bt_col(lane));
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }

  // merge the key groups row by row through shared memory (the ring is
  // free once every warp is done): [KG][MR][2 + DP] of m, l, acc
  cp_async_wait<0>();
  __syncthreads();
  constexpr int RS = DP + 2;
  float* red = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(kFullMask, l[hh], 1);
    l[hh] += __shfl_xor_sync(kFullMask, l[hh], 2);
    float* wr = red + ((size_t)kgi * MR + mt * 16 + g + 8 * hh) * RS;
    if (t == 0) {
      wr[0] = m[hh];  // -inf where the row saw no key of these units
      wr[1] = l[hh];
    }
#pragma unroll
    for (int nn = 0; nn < NO; ++nn) {
      wr[2 + nn * 8 + 2 * t] = acc[nn][2 * hh];
      wr[3 + nn * 8 + 2 * t] = acc[nn][2 * hh + 1];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rows * DP; e += NT) {
    const int r = e / DP, col = e - r * DP;
    if (col >= dh) continue;
    float big = -INFINITY;
#pragma unroll
    for (int k = 0; k < KG; ++k) big = fmaxf(big, red[((size_t)k * MR + r) * RS]);
    float norm = 0.f, num = 0.f;
#pragma unroll
    for (int k = 0; k < KG; ++k) {
      const float* wr = red + ((size_t)k * MR + r) * RS;
      if (wr[0] == -INFINITY) continue;
      const float w = exp2f((wr[0] - big) * scale_log2);
      norm = fmaf(wr[1], w, norm);
      num = fmaf(wr[2 + col], w, num);
    }
    part_acc[(prow + r) * dh + col] = num;
    if (col == 0) {
      part_ml[2 * (prow + r)] = big * scale_log2;  // -inf: no key here
      part_ml[2 * (prow + r) + 1] = norm;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(128)
paged_attn_mq_combine_kernel(const float* __restrict__ ml,
                             const float* __restrict__ acc,
                             T* __restrict__ o, long rows, int R, int S,
                             int dh) {
  paged::combine_kernel_body<T>(ml, acc, o, rows, R, S, dh);
}

template <typename T, int DP, int MT, int NW>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* pt, const int* cl, const int* q0, void* o,
                   float* part_ml, float* part_acc, int n_slots, int nh,
                   int C, int dh, int ps, int maxp, float scale,
                   cudaStream_t stream) {
  using L = Layout<T, DP>;
  using W = Warps<MT, NW>;
  const size_t ring = (size_t)W::NSTAGE * W::KG * 2 * kUnit * L::LD * sizeof(T);
  const size_t red = (size_t)W::KG * W::MR * (DP + 2) * sizeof(float);
  const size_t smem = (size_t)W::MR * L::LD * sizeof(T) + (ring > red ? ring : red);
  if (smem > paged::kMaxSmem) return cudaErrorInvalidValue;
  auto kern = paged_attn_mq_split_kernel<T, DP, MT, NW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  using mma::aligned16;
  const int vec = (dh * (int)sizeof(T)) % 16 == 0 && aligned16(q) &&
                  aligned16(kp) && aligned16(vp);
  const int S = paged::n_splits(maxp);
  const int RT = (C + kMqRows - 1) / kMqRows;
  const dim3 grid(S, nh, n_slots * RT);
  kern<<<grid, W::NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), pt, cl, q0, part_ml, part_acc, nh, C, dh, ps,
      maxp, scale * paged::kLog2e, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long rows = (long)n_slots * nh * C;
  err = paged::launch_dependent(paged_attn_mq_combine_kernel<T>,
                                dim3(paged::combine_blocks(rows)), dim3(128),
                                stream, part_ml, part_acc, static_cast<T*>(o),
                                rows, C, S, dh);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// DP: the head dim padded to 64 or 128; MT: m-tiles of the block's rows;
// NW: warps (the header)
template <typename T, int DP>
cudaError_t dispatch_mt(const void* q, const void* kp, const void* vp,
                        const int* pt, const int* cl, const int* q0, void* o,
                        float* ml, float* acc, int n_slots, int nh, int C,
                        int dh, int ps, int maxp, float scale,
                        cudaStream_t s) {
  constexpr int NW = std::is_same<T, float>::value ? kWarpsWideF32 : kWarps;
  const int rows = C < kMqRows ? C : kMqRows;
  if (rows <= 16)
    return launch<T, DP, 1, kWarps>(q, kp, vp, pt, cl, q0, o, ml, acc, n_slots, nh, C, dh, ps, maxp, scale, s);
  if (rows <= 32)
    return launch<T, DP, 2, NW>(q, kp, vp, pt, cl, q0, o, ml, acc, n_slots, nh, C, dh, ps, maxp, scale, s);
  return launch<T, DP, 4, NW>(q, kp, vp, pt, cl, q0, o, ml, acc, n_slots, nh, C, dh, ps, maxp, scale, s);
}

template <typename T>
cudaError_t dispatch(const void* q, const void* kp, const void* vp,
                     const int* pt, const int* cl, const int* q0, void* o,
                     float* ml, float* acc, int n_slots, int nh, int C,
                     int dh, int ps, int maxp, float scale, cudaStream_t s) {
  if (dh <= 64)
    return dispatch_mt<T, 64>(q, kp, vp, pt, cl, q0, o, ml, acc, n_slots, nh, C, dh, ps, maxp, scale, s);
  return dispatch_mt<T, 128>(q, kp, vp, pt, cl, q0, o, ml, acc, n_slots, nh, C, dh, ps, maxp, scale, s);
}

}  // namespace
}  // namespace ptt

// q [n_slots, nh, C, dh]; k_pages, v_pages [P, nh, ps, dh]; page_table
// [n_slots, maxp] int32; ctx_lens, q_starts [n_slots] int32 (ctx_lens >= 1,
// q_starts >= 0); o like q.  part_ml [n_slots * nh * S * C * 2] and
// part_acc [n_slots * nh * S * C * dh] f32, S = ceil(maxp / 8), the split
// partials.  All contiguous on the caller's
// current device, which owns `stream`.  Returns a cudaError_t (0 on
// success).
extern "C" int ptt_paged_attention_mq_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* ctx_lens, const void* q_starts,
    void* o, void* part_ml, void* part_acc, int n_slots, int nh, int C,
    int dh, int ps, int maxp, float scale, int dtype, void* stream) {
  if (n_slots < 1 || nh < 1 || nh > 65535 || C < 1 ||
      (long)n_slots * ((C + ptt::kMqRows - 1) / ptt::kMqRows) > 65535 ||
      dh < 1 || dh > 128 || ps < 1 || maxp < 1 || !part_ml || !part_acc)
    return (int)cudaErrorInvalidValue;
  const int* pt = static_cast<const int*>(page_table);
  const int* cl = static_cast<const int*>(ctx_lens);
  const int* q0 = static_cast<const int*>(q_starts);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kFloat32:
      return (int)ptt::dispatch<float>(q, k_pages, v_pages, pt, cl, q0, o, ml,
                                       acc, n_slots, nh, C, dh, ps, maxp,
                                       scale, s);
    case ptt::kBFloat16:
      return (int)ptt::dispatch<__nv_bfloat16>(q, k_pages, v_pages, pt, cl,
                                               q0, o, ml, acc, n_slots, nh, C,
                                               dh, ps, maxp, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
