// Paged (ragged) KV-cache decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paged_attention
// (paddle_tpu/ops/pallas_kernels/paged_attention.py: _kernel_body,
// paged_attention): one query token per slot n attends over the first
// ctx_lens[n] positions of its context, which lives in pages of a shared
// pool [P, nh, ps, dh] reached through page_table [N, maxp].
//
// Bound on an H100: memory.  The work is two dot products per cached
// position; the K/V bytes actually needed are
// sum_n ctx_lens[n] * nh * dh * 2 * itemsize, over 3.35 TB/s.
//
// Design: one block per (slot n, head h) reads its own page-table row and
// ctx_lens[n] (the TPU kernel's scalar prefetch).  Its eight warps split
// the pages 0 .. ceil(ctx/ps)-1 round-robin, so several pages are in
// flight per (n, h).  A warp copies the valid rows of its page (rows
// t < ctx - j*ps only: the pool's stale slots are never read) straight
// out of the pool at ((page*nh + h)*ps + t)*dh into shared memory with
// coalesced loads, several in flight per lane (stage_page) — the pool is
// never gathered — then lane t scores row
// t, the warp folds the page into its running max, normalizer and f32
// P.V accumulator, and at the end the warps' partial softmaxes are merged
// through shared memory.  Precondition (not checked: it would need a
// host synchronisation): ctx_lens[n] >= 1.

#include <math.h>

#include "common.cuh"

namespace ptt {
namespace {

constexpr int kWarps = 8;

template <typename T, int NI>
__global__ void __launch_bounds__(kWarps * 32)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                  const T* __restrict__ vp, const int* __restrict__ pt,
                  const int* __restrict__ cl, T* __restrict__ o, int nh,
                  int dh, int ps, int maxp, float scale) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ldk = dh + 1;
  const int red_stride = 2 + NI * 32;
  float* qs = smem;                                      // [dh]
  float* ks = qs + dh + (size_t)warp * ps * (ldk + dh);  // [ps][dh + 1]
  float* vs = ks + ps * ldk;                             // [ps][dh]
  float* red = qs + dh + (size_t)kWarps * ps * (ldk + dh);  // [kWarps][red_stride]

  const size_t qo = ((size_t)n * nh + h) * dh;
  for (int c = threadIdx.x; c < dh; c += kWarps * 32) qs[c] = to_f(q[qo + c]);
  __syncthreads();

  const int ctx = cl[n];
  // positions past the table (ctx > maxp*ps) are outside the context,
  // as in the reference's dense view of the table
  const int n_pages = min((ctx + ps - 1) / ps, maxp);
  float m = -INFINITY, l = 0.f, acc[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) acc[i] = 0.f;

  for (int j = warp; j < n_pages; j += kWarps) {
    const int page = pt[(size_t)n * maxp + j];
    const size_t pbase = ((size_t)page * nh + h) * (size_t)ps * dh;
    const int valid = min(ps, ctx - j * ps);
    __syncwarp();  // the previous page's rows are consumed
    stage_page(kp + pbase, vp + pbase, valid * dh, dh, ldk, dh, ks, vs,
               lane, 32);
    __syncwarp();
    for (int c0 = 0; c0 < valid; c0 += 32) {
      const int t = c0 + lane;
      float s = -INFINITY;
      if (t < valid) {
        const float* krow = ks + t * ldk;
        float dot = 0.f;
        for (int c = 0; c < dh; ++c) dot = fmaf(qs[c], krow[c], dot);
        s = dot * scale;
      }
      // row c0 < valid is scored, so the chunk max is finite
      const float m_new = fmaxf(m, warp_max(s));
      const float p = t < valid ? expf(s - m_new) : 0.f;
      const float corr = expf(m - m_new);
      l = l * corr + warp_sum(p);
      m = m_new;
      const float pr = round_to<T>(p);
#pragma unroll
      for (int i = 0; i < NI; ++i) acc[i] *= corr;
      const int n_t = min(32, valid - c0);
      for (int tt = 0; tt < n_t; ++tt) {
        const float pt_t = __shfl_sync(kFullMask, pr, tt);
        const float* vrow = vs + (c0 + tt) * dh;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int c = lane + 32 * i;
          if (c < dh) acc[i] = fmaf(pt_t, vrow[c], acc[i]);
        }
      }
    }
  }

  float* wr = red + warp * red_stride;
  if (lane == 0) {
    wr[0] = m;
    wr[1] = l;
  }
#pragma unroll
  for (int i = 0; i < NI; ++i) wr[2 + lane + 32 * i] = acc[i];
  __syncthreads();
  if (warp != 0) return;
  // merge the warps' partial softmaxes; a warp that had no page has
  // m = -inf and l = 0 and weighs nothing (ctx >= 1: warp 0 had page 0)
  float big = -INFINITY;
  for (int w = 0; w < kWarps; ++w) big = fmaxf(big, red[w * red_stride]);
  float wscale[kWarps];
  float norm = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float mw = red[w * red_stride];
    wscale[w] = mw == -INFINITY ? 0.f : expf(mw - big);
    norm += red[w * red_stride + 1] * wscale[w];
  }
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int c = lane + 32 * i;
    if (c >= dh) continue;
    float num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) num += red[w * red_stride + 2 + c] * wscale[w];
    o[qo + c] = from_f<T>(num / norm);
  }
}

template <typename T, int NI>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* pt, const int* cl, void* o, int n_slots, int nh,
                   int dh, int ps, int maxp, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(dh + kWarps * ps * (2 * dh + 1) +
                               kWarps * (2 + NI * 32)) * sizeof(float);
  auto kern = paged_attn_kernel<T, NI>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_slots, nh);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), pt, cl, static_cast<T*>(o), nh, dh, ps,
      maxp, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* kp, const void* vp,
                     const int* pt, const int* cl, void* o, int n_slots,
                     int nh, int dh, int ps, int maxp, float scale,
                     cudaStream_t stream) {
  switch ((dh + 31) / 32) {
    case 1: return launch<T, 1>(q, kp, vp, pt, cl, o, n_slots, nh, dh, ps, maxp, scale, stream);
    case 2: return launch<T, 2>(q, kp, vp, pt, cl, o, n_slots, nh, dh, ps, maxp, scale, stream);
    case 3: return launch<T, 3>(q, kp, vp, pt, cl, o, n_slots, nh, dh, ps, maxp, scale, stream);
    case 4: return launch<T, 4>(q, kp, vp, pt, cl, o, n_slots, nh, dh, ps, maxp, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace ptt

// q [n_slots, nh, dh]; k_pages, v_pages [P, nh, ps, dh]; page_table
// [n_slots, maxp] int32; ctx_lens [n_slots] int32 (each >= 1); o like q.
// All contiguous on the caller's current device, which owns `stream`.
// Returns a cudaError_t (0 on success).
extern "C" int ptt_paged_attention_fwd(const void* q, const void* k_pages,
                                       const void* v_pages,
                                       const void* page_table,
                                       const void* ctx_lens, void* o,
                                       int n_slots, int nh, int dh, int ps,
                                       int maxp, float scale, int dtype,
                                       void* stream) {
  if (n_slots < 1 || nh < 1 || nh > 65535 || dh < 1 || dh > 128 || ps < 1 ||
      maxp < 1)
    return (int)cudaErrorInvalidValue;
  const int* pt = static_cast<const int*>(page_table);
  const int* cl = static_cast<const int*>(ctx_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kFloat32:
      return (int)ptt::dispatch<float>(q, k_pages, v_pages, pt, cl, o, n_slots,
                                       nh, dh, ps, maxp, scale, s);
    case ptt::kBFloat16:
      return (int)ptt::dispatch<__nv_bfloat16>(q, k_pages, v_pages, pt, cl, o,
                                               n_slots, nh, dh, ps, maxp,
                                               scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
