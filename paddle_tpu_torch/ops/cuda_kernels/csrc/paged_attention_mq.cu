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
// 4 * dh FLOPs per visible (row, key) pair, which at C <= 64 stays below
// the bytes' time at 67 TFLOP/s in f32.
//
// Design: one block per (slot n, head h, tile of kRows = 8 query rows).
// The block reads its own page-table row, ctx_lens[n] and q_starts[n],
// and walks only the pages that some row of its tile can see:
// ceil(min(ctx, q_starts + last row + 1) / ps) of them.  Its 8 warps split
// those pages round-robin, as K2's do, so several pages are in flight per
// block.  A warp copies the valid rows of its page (slots at or past
// ctx_lens are never read) into its own shared-memory K and V buffers,
// several loads in flight per lane (stage_page), ONCE, and scores them
// against every row of the tile — the reuse that makes this more than K2
// launched C times.  Scoring takes 16 keys at a time: lane i scores key
// i % 16 against the four rows of its half-warp (rows i / 16, +2, +4, +6),
// so each K element read from shared memory feeds four FMAs and every
// lane works at ps = 16; the head dim is padded to 32 * NI with zeros so
// the dot product is a compile-time loop.  Row maxima and sums reduce
// within a half-warp; every lane keeps every row's running max and
// normalizer, and its f32 P.V accumulators for columns lane + 32k of all
// 8 rows, reading the slice's rounded probabilities from shared memory
// as float4.  At the end the warps' partial softmaxes are merged row by
// row through shared memory.  Position 0 is visible to every row
// (q_starts >= 0, ctx_lens >= 1) and lies in page 0, which warp 0 walks,
// so every row has a finite max and a positive normalizer: rows past a
// lane's valid chunk come out finite.  Preconditions (not checked: they
// would need a host synchronisation): ctx_lens[n] >= 1 and
// q_starts[n] >= 0.

#include <math.h>

#include "common.cuh"

namespace ptt {
namespace {

constexpr int kMaxWarps = 8;
constexpr int kRows = 8;   // query rows per block
constexpr int kSlice = 16;  // keys scored together: one per lane of a half-warp
constexpr size_t kMaxSmem = 232448;  // bytes a block may use on sm_90

// floats of shared memory per warp: K page [ps][DHP+1] and V page
// [ps][DHP] (DHP = dh padded to 32 * NI), rounded up to 16 bytes, then
// the probabilities of one slice [kSlice][kRows] (read as float4)
__host__ __device__ inline int page_floats(int ps, int dhp) {
  return (ps * (2 * dhp + 1) + 3) / 4 * 4;
}
__host__ __device__ inline int warp_floats(int ps, int dhp) {
  return page_floats(ps, dhp) + kSlice * kRows;
}
// floats of the block's q tile [kRows][dhp + 1], rounded up to 16 bytes
__host__ __device__ inline int q_floats(int dhp) {
  return (kRows * (dhp + 1) + 3) / 4 * 4;
}

template <typename T, int NI>
__global__ void __launch_bounds__(kMaxWarps * 32)
paged_attn_mq_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                     const T* __restrict__ vp, const int* __restrict__ pt,
                     const int* __restrict__ cl, const int* __restrict__ q0,
                     T* __restrict__ o, int nh, int C, int dh, int ps,
                     int maxp, float scale) {
  constexpr int DHP = 32 * NI;
  constexpr int LDK = DHP + 1;
  // odd row strides: the two half-warps read rows r and r + 1 of q, and
  // lanes read rows t of K, in different banks
  constexpr int LDQ = DHP + 1;
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const int h = blockIdx.y;
  const int c_lo = blockIdx.z * kRows;
  const int rows = min(C - c_lo, kRows);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  float* qs = smem;  // [kRows][LDQ], zero past dh and past the tile
  float* ks = qs + q_floats(DHP) + (size_t)warp * warp_floats(ps, DHP);
  float* vs = ks + ps * LDK;                   // [ps][DHP]
  float* pbuf = ks + page_floats(ps, DHP);  // [kSlice][kRows]

  // zero the padding once: q and K columns past dh must be 0 in the dot
  for (int e = threadIdx.x; e < kRows * LDQ; e += blockDim.x) qs[e] = 0.f;
  for (int e = lane; e < page_floats(ps, DHP); e += 32) ks[e] = 0.f;
  __syncthreads();
  const size_t qbase = ((size_t)n * nh + h) * C * dh;
  for (int e = threadIdx.x; e < rows * dh; e += blockDim.x) {
    const int r = e / dh;
    qs[r * LDQ + e - r * dh] = to_f(q[qbase + (size_t)c_lo * dh + e]);
  }
  __syncthreads();

  const int ctx = cl[n];
  const int start = q0[n];
  // keys some row of the tile can see; positions past the table are
  // outside the context, as in the reference's dense view of the table
  const int kv_end = min(min(ctx, start + c_lo + rows), maxp * ps);
  const int n_pages = (kv_end + ps - 1) / ps;

  // scoring layout: lane scores key `key_lane` of a slice for the rows
  // row0, row0 + 2, row0 + 4, row0 + 6 (its half-warp's rows)
  const int key_lane = lane & (kSlice - 1);
  const int row0 = lane >> 4;
  // every lane keeps every row's running max and normalizer
  float m[kRows], l[kRows], acc[kRows][NI];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int k = 0; k < NI; ++k) acc[r][k] = 0.f;
  }

  for (int j = warp; j < n_pages; j += n_warps) {
    const int page = pt[(size_t)n * maxp + j];
    const size_t pbase = ((size_t)page * nh + h) * (size_t)ps * dh;
    const int valid = min(ps, kv_end - j * ps);
    __syncwarp();  // the previous page's rows are consumed
    stage_page(kp + pbase, vp + pbase, valid * dh, dh, LDK, DHP, ks, vs,
               lane, 32);
    __syncwarp();
    // row r sees keys t < row_end(r) of this page (none past the tile)
    const int base = start + c_lo - j * ps + 1;
    for (int c0 = 0; c0 < valid; c0 += kSlice) {
      const int t = c0 + key_lane;
      float s[kRows / 2];
#pragma unroll
      for (int i = 0; i < kRows / 2; ++i) s[i] = 0.f;
      if (t < valid) {
        const float* krow = ks + t * LDK;
#pragma unroll
        for (int c = 0; c < DHP; ++c) {
          const float kc = krow[c];
#pragma unroll
          for (int i = 0; i < kRows / 2; ++i)
            s[i] = fmaf(qs[(row0 + 2 * i) * LDQ + c], kc, s[i]);
        }
      }
      float corr[kRows];
#pragma unroll
      for (int i = 0; i < kRows / 2; ++i) {
        const int r = row0 + 2 * i;
        const bool seen = t < valid && r < rows && t < base + r;
        const float sc = seen ? s[i] * scale : -INFINITY;
        float mx = sc;
#pragma unroll
        for (int o = kSlice / 2; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, o));
        // rows are per half-warp: lanes 0-15 hold rows 0,2,4,6 and lanes
        // 16-31 rows 1,3,5,7; every lane learns both halves' maxima
        const float mx_even = __shfl_sync(kFullMask, mx, 0);
        const float mx_odd = __shfl_sync(kFullMask, mx, 16);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int rr = 2 * i + half;
          const float m_new = fmaxf(m[rr], half ? mx_odd : mx_even);
          corr[rr] = m_new == -INFINITY ? 1.f : expf(m[rr] - m_new);
          m[rr] = m_new;
        }
        const float m_r = row0 ? m[2 * i + 1] : m[2 * i];
        const float p = seen ? expf(sc - m_r) : 0.f;
        float ps_ = p;
#pragma unroll
        for (int o = kSlice / 2; o > 0; o >>= 1)
          ps_ += __shfl_xor_sync(kFullMask, ps_, o);
        const float sum_even = __shfl_sync(kFullMask, ps_, 0);
        const float sum_odd = __shfl_sync(kFullMask, ps_, 16);
        l[2 * i] = l[2 * i] * corr[2 * i] + sum_even;
        l[2 * i + 1] = l[2 * i + 1] * corr[2 * i + 1] + sum_odd;
        pbuf[key_lane * kRows + r] = round_to<T>(p);
      }
      __syncwarp();
      // P.V: lane owns columns lane + 32k of every row
      const int n_t = min(kSlice, valid - c0);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int k = 0; k < NI; ++k) acc[r][k] *= corr[r];
      for (int tt = 0; tt < n_t; ++tt) {
        const float4 pa = *reinterpret_cast<const float4*>(pbuf + tt * kRows);
        const float4 pb =
            *reinterpret_cast<const float4*>(pbuf + tt * kRows + 4);
        const float pr[kRows] = {pa.x, pa.y, pa.z, pa.w,
                                 pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int k = 0; k < NI; ++k) {
          const float vc = vs[(c0 + tt) * DHP + lane + 32 * k];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r][k] = fmaf(pr[r], vc, acc[r][k]);
        }
      }
      __syncwarp();  // pbuf is read before the next slice writes it
    }
  }

  // merge the warps' partial softmaxes row by row; the page buffers are
  // reused for the partials once every warp is done with its pages
  __syncthreads();
  const int red_stride = 2 + DHP;
  float* red = qs + q_floats(DHP);  // [n_warps][kRows][red_stride]
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float* wr = red + ((size_t)warp * kRows + r) * red_stride;
    if (lane == 0) {
      wr[0] = m[r];
      wr[1] = l[r];
    }
#pragma unroll
    for (int k = 0; k < NI; ++k) wr[2 + lane + 32 * k] = acc[r][k];
  }
  __syncthreads();
  for (int r = warp; r < rows; r += n_warps) {
    // a warp that saw no key of row r has m = -inf and l = 0 and weighs
    // nothing (warp 0 saw position 0)
    float big = -INFINITY;
    for (int w = 0; w < n_warps; ++w)
      big = fmaxf(big, red[((size_t)w * kRows + r) * red_stride]);
    float norm = 0.f, num[NI];
#pragma unroll
    for (int k = 0; k < NI; ++k) num[k] = 0.f;
    for (int w = 0; w < n_warps; ++w) {
      const float* wr = red + ((size_t)w * kRows + r) * red_stride;
      const float sc = wr[0] == -INFINITY ? 0.f : expf(wr[0] - big);
      norm += wr[1] * sc;
#pragma unroll
      for (int k = 0; k < NI; ++k) num[k] += wr[2 + lane + 32 * k] * sc;
    }
    T* orow = o + qbase + (size_t)(c_lo + r) * dh;
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      const int c = lane + 32 * k;
      if (c < dh) orow[c] = from_f<T>(num[k] / norm);
    }
  }
}

template <typename T, int NI>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* pt, const int* cl, const int* q0, void* o,
                   int n_slots, int nh, int C, int dh, int ps, int maxp,
                   float scale, cudaStream_t stream) {
  // as many warps as shared memory allows, up to kMaxWarps; the merge
  // area [warps][kRows][2 + 32*NI] reuses the warps' page buffers
  int warps = kMaxWarps;
  size_t smem = 0;
  for (; warps >= 1; warps /= 2) {
    const size_t walk = (size_t)warps * warp_floats(ps, 32 * NI);
    const size_t merge = (size_t)warps * kRows * (2 + 32 * NI);
    smem = (q_floats(32 * NI) + (walk > merge ? walk : merge)) * sizeof(float);
    if (smem <= kMaxSmem) break;
  }
  if (warps < 1) return cudaErrorInvalidValue;
  auto kern = paged_attn_mq_kernel<T, NI>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_slots, nh, (C + kRows - 1) / kRows);
  kern<<<grid, warps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), pt, cl, q0, static_cast<T*>(o), nh, C, dh,
      ps, maxp, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* kp, const void* vp,
                     const int* pt, const int* cl, const int* q0, void* o,
                     int n_slots, int nh, int C, int dh, int ps, int maxp,
                     float scale, cudaStream_t stream) {
  switch ((dh + 31) / 32) {
    case 1: return launch<T, 1>(q, kp, vp, pt, cl, q0, o, n_slots, nh, C, dh, ps, maxp, scale, stream);
    case 2: return launch<T, 2>(q, kp, vp, pt, cl, q0, o, n_slots, nh, C, dh, ps, maxp, scale, stream);
    case 3: return launch<T, 3>(q, kp, vp, pt, cl, q0, o, n_slots, nh, C, dh, ps, maxp, scale, stream);
    case 4: return launch<T, 4>(q, kp, vp, pt, cl, q0, o, n_slots, nh, C, dh, ps, maxp, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace ptt

// q [n_slots, nh, C, dh]; k_pages, v_pages [P, nh, ps, dh]; page_table
// [n_slots, maxp] int32; ctx_lens, q_starts [n_slots] int32 (ctx_lens >= 1,
// q_starts >= 0); o like q.  All contiguous on the caller's current device,
// which owns `stream`.  Returns a cudaError_t (0 on success).
extern "C" int ptt_paged_attention_mq_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* ctx_lens, const void* q_starts,
    void* o, int n_slots, int nh, int C, int dh, int ps, int maxp,
    float scale, int dtype, void* stream) {
  if (n_slots < 1 || nh < 1 || nh > 65535 || C < 1 ||
      (C + ptt::kRows - 1) / ptt::kRows > 65535 || dh < 1 || dh > 128 ||
      ps < 1 || maxp < 1)
    return (int)cudaErrorInvalidValue;
  const int* pt = static_cast<const int*>(page_table);
  const int* cl = static_cast<const int*>(ctx_lens);
  const int* q0 = static_cast<const int*>(q_starts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kFloat32:
      return (int)ptt::dispatch<float>(q, k_pages, v_pages, pt, cl, q0, o,
                                       n_slots, nh, C, dh, ps, maxp, scale, s);
    case ptt::kBFloat16:
      return (int)ptt::dispatch<__nv_bfloat16>(q, k_pages, v_pages, pt, cl,
                                               q0, o, n_slots, nh, C, dh, ps,
                                               maxp, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
