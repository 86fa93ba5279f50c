// Paged (ragged) KV-cache decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paged_attention
// (paddle_tpu/ops/pallas_kernels/paged_attention.py: _kernel_body,
// paged_attention): one query token per slot n attends over the first
// ctx_lens[n] positions of its context, which lives in pages of a shared
// pool [P, nh, ps, dh] reached through page_table [N, maxp].  Scores are
// f32 and scaled, keys at or past ctx_lens[n] weigh nothing, the softmax
// is online, P is rounded to the value type before P.V, and the output is
// acc / l in the input type.
//
// Bound on an H100: memory.  The work is two dot products per cached
// position; the K/V bytes actually needed are
// sum_n ctx_lens[n] * nh * dh * 2 * itemsize, over 3.35 TB/s.  At the
// serving shapes the walk is short and ragged, so what holds it is latency
// and occupancy: the design splits the walk across blocks and keeps page
// copies in flight.
//
// Design (split-KV, paged_split.cuh):
//   - Grid (S, nh, N): block (s, h, n) walks pages [8 s, 8 s + 8) of slot
//     n's context for head h (kPagesPerSplit), never past the last page
//     its keys need, min(ctx, maxp * ps).  Its 4 warps take the split's
//     pages round-robin (two each at the serving shape) and each keeps
//     its own running max, normalizer and f32 accumulator.
//   - Staging: each warp copies the valid rows of its (page, head) tile
//     [ps, dh] -- contiguous in the pool -- by 16-byte cp.async into its
//     own ring of kStages buffers in shared memory, so its next pages are
//     in flight while it scores the current one.  Rows at or past ctx are
//     never read, so stale pool slots stay invisible.  A head dim that is
//     not a whole number of 16-byte chunks (or an unaligned pool) is
//     staged element by element instead.  Chunk c of row t sits at chunk
//     c ^ 4 (t & 1) of the row: the 16-byte reads below fall in distinct
//     banks without padding.
//   - Scoring keeps every lane busy at ps = 16: a quad of lanes takes one
//     key, 8 keys a pass, each lane a quarter of the head dim (16-byte
//     chunks sub, sub + 4, ...) against q held in registers, then two
//     shuffles sum the quad.  The pass's max takes three more; P.V adds
//     each lane's p times its own chunks of the key's V row, so no
//     probability is broadcast.  The key groups' accumulators are summed
//     once, at the end of the walk.
//   - The warps' partial softmaxes merge through shared memory into the
//     block's partial; the combine merges the splits into the output.
//   - bf16 and f32 share the body: at one query row the products are too
//     small for the tensor cores to matter.
// Precondition (not checked: it would need a host synchronisation):
// ctx_lens[n] >= 1.

#include <math.h>

#include "common.cuh"
#include "mma.cuh"
#include "paged_split.cuh"

namespace ptt {
namespace {

constexpr int kWarps = 4;
constexpr int kStages = 3;  // a warp's ring of page buffers

// bytes of one staged [ps][dh] tile: rows of ldc 16-byte chunks
__host__ __device__ inline int row_chunks(int dh, int itemsize) {
  return (dh * itemsize + 15) / 16;
}
__host__ __device__ inline int ldc_of(int ch) { return (ch + 7) & ~7; }

// Copy rows [0, valid) of one [ps, dh] tile of T into `dst` (rows of ldc
// chunks, chunk c of row t at c ^ 4 (t & 1)), lanes of one warp.  `vec`:
// 16-byte cp.async (dh * sizeof(T) a multiple of 16, pools aligned);
// otherwise element by element, zero past dh up to the last chunk.
template <typename T>
__device__ __forceinline__ void stage_page_tile(uint4* dst,
                                                const T* __restrict__ src,
                                                int valid, int dh, int ch,
                                                int ldc, bool vec, int lane) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    // lane's first chunk (t, c), then +32 chunks a step
    int t = lane / ch, c = lane - t * ch;
    const int dt = 32 / ch, dc = 32 - dt * ch;
    for (; t < valid;) {
      mma::cp_async16(dst + t * ldc + (c ^ ((t & 1) << 2)),
                      src + (size_t)t * dh + c * E, true);
      c += dc;
      t += dt;
      if (c >= ch) {
        c -= ch;
        ++t;
      }
    }
  } else {
    constexpr int E = 16 / sizeof(T);
    const int w = ch * E;  // padded row width in elements
    for (int e = lane; e < valid * w; e += 32) {
      const int t = e / w, col = e - t * w, c = col / E;
      T* d = reinterpret_cast<T*>(dst + t * ldc + (c ^ ((t & 1) << 2)));
      d[col - c * E] = col < dh ? src[(size_t)t * dh + col] : from_f<T>(0.f);
    }
  }
}

// NC: 16-byte chunks a lane holds per key (chunks sub + 4 i, i < NC)
template <typename T, int NC>
__global__ void __launch_bounds__(kWarps * 32)
paged_attn_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                        const T* __restrict__ vp, const int* __restrict__ pt,
                        const int* __restrict__ cl,
                        float* __restrict__ part_ml,
                        float* __restrict__ part_acc, int nh, int dh, int ps,
                        int maxp, float scale_log2, int vec) {
  constexpr int E = 16 / sizeof(T);  // elements a chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  paged::allow_dependent_launch();
  const int s = blockIdx.x, h = blockIdx.y, n = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int kg = lane >> 2, sub = lane & 3;
  const int ch = row_chunks(dh, sizeof(T));
  const int ldc = ldc_of(ch);
  const size_t row = (size_t)n * nh + h;  // output row
  const size_t pidx = row * gridDim.x + s;  // this block's partial
  // positions past the table (ctx > maxp * ps) are outside the context,
  // as in the reference's dense view of the table
  const int kv_end = min(cl[n], maxp * ps);
  const int n_pages = (kv_end + ps - 1) / ps;
  const int p0 = s * paged::kPagesPerSplit;
  if (p0 >= n_pages) {  // nothing of this slot's context here
    if (threadIdx.x == 0) {
      part_ml[2 * pidx] = -INFINITY;
      part_ml[2 * pidx + 1] = 0.f;
    }
    return;
  }
  const int p1 = min(p0 + paged::kPagesPerSplit, n_pages);

  const int tile = ps * ldc;  // chunks of one staged tile
  uint4* ring = reinterpret_cast<uint4*>(smem_raw) +
                (size_t)warp * kStages * 2 * tile;
  float* red = reinterpret_cast<float*>(
      reinterpret_cast<uint4*>(smem_raw) + (size_t)n_warps * kStages * 2 * tile);
  const int red_stride = 2 + NC * 4 * E;

  // this warp's pages p0 + warp + k * n_warps, k < my_pages
  const int my_pages = (p1 - p0 - warp + n_warps - 1) / n_warps;
  const int* ptab = pt + (size_t)n * maxp;
  auto fetch = [&](int k) {
    const int j = p0 + warp + k * n_warps;
    const size_t base = ((size_t)ptab[j] * nh + h) * (size_t)ps * dh;
    const int valid = min(ps, kv_end - j * ps);
    uint4* b = ring + (size_t)(k % kStages) * 2 * tile;
    stage_page_tile<T>(b, kp + base, valid, dh, ch, ldc, vec, lane);
    stage_page_tile<T>(b + tile, vp + base, valid, dh, ch, ldc, vec, lane);
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < my_pages) fetch(k);
    mma::cp_async_commit();
  }

  float qr[NC][E], acc[NC][E];
  const T* qrow = q + row * dh;
#pragma unroll
  for (int i = 0; i < NC; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int col = (sub + 4 * i) * E + e;
      qr[i][e] = col < dh ? to_f(qrow[col]) : 0.f;
      acc[i][e] = 0.f;
    }
  // the warp's running max of the raw scores (the same in every lane) and
  // this key group's share of the normalizer
  float m = -INFINITY, l = 0.f;

  for (int k = 0; k < my_pages; ++k) {
    mma::cp_async_wait<kStages - 2>();
    __syncwarp();  // page k has landed; page k - 1's buffer is consumed
    if (k + kStages - 1 < my_pages) fetch(k + kStages - 1);
    mma::cp_async_commit();
    const int j = p0 + warp + k * n_warps;
    const int valid = min(ps, kv_end - j * ps);
    const uint4* kt = ring + (size_t)(k % kStages) * 2 * tile;
    const uint4* vt = kt + tile;
    for (int t0 = 0; t0 < valid; t0 += 8) {
      const int t = t0 + kg;
      const bool ok = t < valid;
      const int sw = (t & 1) << 2;
      float sc = 0.f;
      if (ok) {
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const int c = sub + 4 * i;
          if (c < ch) {
            float kv[E];
            paged::unpack16(kt[t * ldc + (c ^ sw)], kv);
#pragma unroll
            for (int e = 0; e < E; ++e) sc = fmaf(qr[i][e], kv[e], sc);
          }
        }
      }
      sc += __shfl_xor_sync(kFullMask, sc, 1);
      sc += __shfl_xor_sync(kFullMask, sc, 2);
      if (!ok) sc = -INFINITY;
      float mx = fmaxf(sc, __shfl_xor_sync(kFullMask, sc, 4));
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 16));
      // key t0 (kg 0) is valid, so m_new is finite
      const float m_new = fmaxf(m, mx);
      const float corr = exp2f((m - m_new) * scale_log2);
      const float p = ok ? exp2f((sc - m_new) * scale_log2) : 0.f;
      m = m_new;
      l = fmaf(l, corr, p);
      const float pr = round_to<T>(p);
#pragma unroll
      for (int i = 0; i < NC; ++i)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] *= corr;
      if (ok) {
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const int c = sub + 4 * i;
          if (c < ch) {
            float vv[E];
            paged::unpack16(vt[t * ldc + (c ^ sw)], vv);
#pragma unroll
            for (int e = 0; e < E; ++e) acc[i][e] = fmaf(pr, vv[e], acc[i][e]);
          }
        }
      }
    }
  }

  // sum the key groups (lanes sub, sub + 4, ..., sub + 28)
#pragma unroll
  for (int o_ = 4; o_ < 32; o_ <<= 1) {
    l += __shfl_xor_sync(kFullMask, l, o_);
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[i][e] += __shfl_xor_sync(kFullMask, acc[i][e], o_);
  }
  float* wr = red + warp * red_stride;
  if (lane == 0) {
    wr[0] = m;  // -inf for a warp without a page
    wr[1] = l;
  }
  if (kg == 0) {
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e) wr[2 + (sub + 4 * i) * E + e] = acc[i][e];
  }
  __syncthreads();
  // merge the warps; warp 0 walked page p0, whose key 0 is valid, so big
  // is finite and norm positive
  float big = -INFINITY;
  for (int w = 0; w < n_warps; ++w) big = fmaxf(big, red[w * red_stride]);
  float norm = 0.f;
  for (int w = 0; w < n_warps; ++w) {
    const float mw = red[w * red_stride];
    if (mw != -INFINITY)
      norm = fmaf(red[w * red_stride + 1], exp2f((mw - big) * scale_log2),
                  norm);
  }
  for (int c = threadIdx.x; c < dh; c += blockDim.x) {
    float num = 0.f;
    for (int w = 0; w < n_warps; ++w) {
      const float mw = red[w * red_stride];
      if (mw != -INFINITY)
        num = fmaf(red[w * red_stride + 2 + c], exp2f((mw - big) * scale_log2),
                   num);
    }
    part_acc[pidx * dh + c] = num;
  }
  if (threadIdx.x == 0) {
    part_ml[2 * pidx] = big * scale_log2;
    part_ml[2 * pidx + 1] = norm;
  }
}

template <typename T>
__global__ void __launch_bounds__(128)
paged_attn_combine_kernel(const float* __restrict__ ml,
                          const float* __restrict__ acc, T* __restrict__ o,
                          long rows, int S, int dh) {
  paged::combine_kernel_body<T>(ml, acc, o, rows, 1, S, dh);
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* pt, const int* cl, void* o, float* part_ml,
                   float* part_acc, int n_slots, int nh, int dh, int ps,
                   int maxp, float scale, cudaStream_t stream) {
  const int ch = row_chunks(dh, sizeof(T));
  const size_t tile_bytes = (size_t)ps * ldc_of(ch) * 16;
  const size_t red_bytes = (2 + NC * 4 * (16 / sizeof(T))) * sizeof(float);
  // as many warps as shared memory allows, up to kWarps
  int warps = kWarps;
  size_t smem = 0;
  for (; warps >= 1; warps /= 2) {
    smem = warps * (kStages * 2 * tile_bytes + red_bytes);
    if (smem <= paged::kMaxSmem) break;
  }
  if (warps < 1) return cudaErrorInvalidValue;
  auto kern = paged_attn_split_kernel<T, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  using mma::aligned16;
  const int vec = (dh * (int)sizeof(T)) % 16 == 0 && aligned16(kp) &&
                  aligned16(vp);
  const int S = paged::n_splits(maxp);
  const dim3 grid(S, nh, n_slots);
  kern<<<grid, warps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), pt, cl, part_ml, part_acc, nh, dh, ps, maxp,
      scale * paged::kLog2e, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long rows = (long)n_slots * nh;
  err = paged::launch_dependent(paged_attn_combine_kernel<T>,
                                dim3(paged::combine_blocks(rows)), dim3(128),
                                stream, part_ml, part_acc, static_cast<T*>(o),
                                rows, S, dh);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// NC = ceil(chunks a row / 4), rounded up to 1, 2, 4 or 8
template <typename T>
cudaError_t dispatch(const void* q, const void* kp, const void* vp,
                     const int* pt, const int* cl, void* o, float* part_ml,
                     float* part_acc, int n_slots, int nh, int dh, int ps,
                     int maxp, float scale, cudaStream_t stream) {
  const int nc = (row_chunks(dh, sizeof(T)) + 3) / 4;
  if (nc <= 1)
    return launch<T, 1>(q, kp, vp, pt, cl, o, part_ml, part_acc, n_slots, nh, dh, ps, maxp, scale, stream);
  if (nc <= 2)
    return launch<T, 2>(q, kp, vp, pt, cl, o, part_ml, part_acc, n_slots, nh, dh, ps, maxp, scale, stream);
  if (nc <= 4)
    return launch<T, 4>(q, kp, vp, pt, cl, o, part_ml, part_acc, n_slots, nh, dh, ps, maxp, scale, stream);
  if constexpr (sizeof(T) == 4)
    return launch<T, 8>(q, kp, vp, pt, cl, o, part_ml, part_acc, n_slots, nh, dh, ps, maxp, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace ptt

// q [n_slots, nh, dh]; k_pages, v_pages [P, nh, ps, dh]; page_table
// [n_slots, maxp] int32; ctx_lens [n_slots] int32 (each >= 1); o like q.
// part_ml [n_slots * nh * S * 2] and part_acc [n_slots * nh * S * dh] f32,
// S = ceil(maxp / 8), the split partials.
// All contiguous on the caller's current device, which owns `stream`.
// Returns a cudaError_t (0 on success).
extern "C" int ptt_paged_attention_fwd(const void* q, const void* k_pages,
                                       const void* v_pages,
                                       const void* page_table,
                                       const void* ctx_lens, void* o,
                                       void* part_ml, void* part_acc,
                                       int n_slots, int nh, int dh, int ps,
                                       int maxp, float scale, int dtype,
                                       void* stream) {
  if (n_slots < 1 || n_slots > 65535 || nh < 1 || nh > 65535 || dh < 1 ||
      dh > 128 || ps < 1 || maxp < 1 || !part_ml || !part_acc)
    return (int)cudaErrorInvalidValue;
  const int* pt = static_cast<const int*>(page_table);
  const int* cl = static_cast<const int*>(ctx_lens);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kFloat32:
      return (int)ptt::dispatch<float>(q, k_pages, v_pages, pt, cl, o, ml,
                                       acc, n_slots, nh, dh, ps, maxp, scale,
                                       s);
    case ptt::kBFloat16:
      return (int)ptt::dispatch<__nv_bfloat16>(q, k_pages, v_pages, pt, cl, o,
                                               ml, acc, n_slots, nh, dh, ps,
                                               maxp, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
