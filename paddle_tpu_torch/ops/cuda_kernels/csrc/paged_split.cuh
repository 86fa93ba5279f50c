// Split-KV ("flash-decoding") pieces shared by the paged attention kernels
// K2 (paged_attention.cu) and K3 (paged_attention_mq.cu) on Hopper.
//
// A slot's page walk is cut into splits of kPagesPerSplit pages, one
// block each, so a long context is walked by several SMs at once.  The
// grid has ceil(maxp / kPagesPerSplit) splits per (slot, head[, row
// tile]): maxp is known on the host, nothing synchronises.  A block whose
// split starts past its slot's last needed page writes an empty partial
// (m = -inf, l = 0) and exits.
//
// Each live block writes, per query row, a partial softmax: m, its running
// max in log2 units (score * scale * log2 e), l, its normalizer relative
// to exp2(m), and acc[dh], its unnormalized f32 P.V.  A second small
// kernel (combine_row, one warp a row) merges a row's splits:
// out = sum_s acc_s 2^(m_s - M) / sum_s l_s 2^(m_s - M), M = max_s m_s.
// A split that saw no key of the row (m = -inf) weighs nothing and its acc
// is not read.  Split 0 holds key 0, which every row sees, so every
// normalizer is positive and no NaN comes from -inf - (-inf).
//
// The combine is launched as a programmatic dependent of the walk (PDL,
// cudaLaunchAttributeProgrammaticStreamSerialization): the walk's blocks
// allow it at their start, so its launch overlaps the walk, and it waits
// in griddepcontrol.wait until the walk has finished and its writes are
// visible.
//
// Partials are f32, allocated by the wrapper: ml [rows_outer, S, R, 2] and
// acc [rows_outer, S, R, dh], rows_outer = N * nh, R = 1 (K2) or C (K3).
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace ptt {
namespace paged {

// pages one block walks (mirrored in paged_attention.py PAGES_PER_SPLIT,
// which a test reads from here)
constexpr int kPagesPerSplit = 8;
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kMaxSmem = 232448;  // bytes a block may use on sm_90

__host__ __device__ inline int n_splits(int maxp) {
  return (maxp + kPagesPerSplit - 1) / kPagesPerSplit;
}

// The dependent (the combine) may launch once every block of this grid
// has called this or exited.
__device__ __forceinline__ void allow_dependent_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Wait until the grid this one depends on has finished and its memory
// is visible (a no-op without a programmatic dependency).
__device__ __forceinline__ void wait_for_prerequisite() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Merge the splits of one output row, one warp: `ml` and `acc` point at
// split 0's entry of the row, `stride` is the rows between two splits'
// entries; out[c] = num[c] / norm for c < dh (dh <= 128).
template <typename T>
__device__ __forceinline__ void combine_row(const float* __restrict__ ml,
                                            const float* __restrict__ acc,
                                            int splits, int stride, int dh,
                                            T* __restrict__ out, int lane) {
  float big = -INFINITY;
  for (int s = 0; s < splits; ++s)
    big = fmaxf(big, ml[2 * (size_t)s * stride]);
  float norm = 0.f, num[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < splits; ++s) {
    const float m = ml[2 * (size_t)s * stride];
    if (m == -INFINITY) continue;  // no key of the row in this split
    const float w = exp2f(m - big);
    norm = fmaf(ml[2 * (size_t)s * stride + 1], w, norm);
    const float* a = acc + (size_t)s * stride * dh;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = lane + 32 * i;
      if (c < dh) num[i] = fmaf(a[c], w, num[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = lane + 32 * i;
    if (c < dh) out[c] = from_f<T>(num[i] / norm);
  }
}

// The combine grid: one warp a row of `rows` = rows_outer * R output rows,
// four a block.
__host__ __device__ inline unsigned combine_blocks(long rows) {
  return (unsigned)((rows + 3) / 4);
}

// The row a combine warp merges: output row `row` = outer * R + r reads
// the partials at (outer * S + s) * R + r.
template <typename T>
__device__ __forceinline__ void combine_kernel_body(
    const float* __restrict__ ml, const float* __restrict__ acc,
    T* __restrict__ o, long rows, int R, int S, int dh) {
  wait_for_prerequisite();
  const long row = (long)blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long outer = row / R;
  const int r = (int)(row - outer * R);
  const size_t first = (size_t)outer * S * R + r;
  combine_row<T>(ml + 2 * first, acc + first * dh, S, R, dh,
                 o + (size_t)row * dh, threadIdx.x & 31);
}

// Launch `kern` as a programmatic dependent of the previous kernel on
// `stream` (the walk): see the header.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kern)(Params...), dim3 grid, dim3 block,
                             cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, static_cast<Params>(args)...);
}

// 16 staged bytes as f32: four floats, or eight bf16
__device__ __forceinline__ void unpack16(const uint4& x, float (&f)[4]) {
  f[0] = __uint_as_float(x.x);
  f[1] = __uint_as_float(x.y);
  f[2] = __uint_as_float(x.z);
  f[3] = __uint_as_float(x.w);
}
__device__ __forceinline__ void unpack16(const uint4& x, float (&f)[8]) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

}  // namespace paged
}  // namespace ptt
