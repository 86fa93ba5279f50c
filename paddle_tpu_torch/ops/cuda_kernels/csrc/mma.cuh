// Warp-level tensor-core building blocks for the port's bf16 kernels on
// Hopper (sm_90a): 16-byte cp.async tile loads with zero fill, ldmatrix
// fragment loads, the m16n8k16 bf16 product with f32 accumulation, and
// bf16 packing.
//
// Fragment layouts of mma.m16n8k16 (PTX ISA, "Matrix fragments for
// mma.m16n8k16"), lane l = 4 g + t:
//   A (16 x 16, row-major), four b32 of two bf16 each:
//     a0 (g, 2t..2t+1)  a1 (g+8, 2t..2t+1)  a2 (g, 2t+8..2t+9)  a3 (g+8, 2t+8..)
//   B (16 x 8, k x n), two b32:  b0 (2t..2t+1, g)  b1 (2t+8..2t+9, g)
//   C (16 x 8, f32):  c0 c1 (g, 2t..2t+1)  c2 c3 (g+8, 2t..2t+1)
// So the accumulators of two neighbouring n-tiles, packed to bf16 pairs in
// the order (c0 c1) (c2 c3) of the first, then of the second, are the A
// fragment of one 16-wide k-chunk: a score tile becomes the A operand of
// the next product without leaving registers.
//
// Operand addresses for ldmatrix.x4 (each lane names one 16-byte row):
//   a_row/a_col   A from a row-major [m][k] tile: the four regs are a0..a3;
//   b_row/b_col   B for two n-tiles from a row-major [n][k] tile (K in
//                 Q K^T): regs (0, 1) are b0 b1 of n-tile 0, (2, 3) of 1;
//   bt_row/bt_col the same from a row-major [k][n] tile (V in P V), with
//                 the .trans form.
// Tiles sit in shared memory with a row stride of DP + 8 bf16: rows lie 16
// bytes apart modulo 128, so the eight rows of one 8 x 8 matrix fall in
// distinct banks and ldmatrix is free of conflicts.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ptt {
namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; an invalid chunk reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zero when invalid (the lse and delta rows)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b: one m16n8k16 product, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one b32 of bf16 (round to nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// The A fragment of k-chunk j from score accumulators s[2j], s[2j+1]
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&s)[N][4],
                                         int j) {
  a[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
  a[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
  a[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
  a[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
}

// ldmatrix row addresses for lane `l` (see the header)
__device__ __forceinline__ int a_row(int l) { return l & 15; }
__device__ __forceinline__ int a_col(int l) { return (l >> 4) << 3; }
__device__ __forceinline__ int b_row(int l) { return (l & 7) + ((l >> 4) << 3); }
__device__ __forceinline__ int b_col(int l) { return ((l >> 3) & 1) << 3; }
__device__ __forceinline__ int bt_row(int l) { return (l & 7) + (((l >> 3) & 1) << 3); }
__device__ __forceinline__ int bt_col(int l) { return (l >> 4) << 3; }

// A launcher's test for the 16-byte cp.async path (host side)
inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Rows [r0, r0 + ROWS) of a row-major [t_len, d] bf16 matrix into shared
// memory (row stride LD), columns [0, DP), zero past t_len and past d.
// `vec` (d % 8 == 0 and a 16-byte aligned source) takes 16-byte cp.async
// chunks, each wholly inside or wholly outside; otherwise every element is
// loaded and stored on its own, which the caller's barrier makes visible.
template <int ROWS, int DP, int LD, int NTHREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          int r0, int t_len, int d, bool vec) {
  constexpr int CH = DP / 8;  // 16-byte chunks a row
  static_assert((ROWS * CH) % NTHREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < ROWS * CH / NTHREADS; ++i) {
    const int e = threadIdx.x + i * NTHREADS;
    const int r = e / CH, c = (e - r * CH) * 8;
    const int gr = r0 + r;
    __nv_bfloat16* s = dst + r * LD + c;
    if (vec) {
      const bool ok = gr < t_len && c < d;
      cp_async16(s, ok ? src + (size_t)gr * d + c : src, ok);
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u)
        s[u] = (gr < t_len && c + u < d) ? src[(size_t)gr * d + c + u]
                                         : __float2bfloat16(0.f);
    }
  }
}

// Store one 16-row accumulator tile (rows row0 + g, row0 + g + 8 of a
// [t_len, d] bf16 matrix, n-tiles 0 .. N-1) as bf16, inside [t_len, d].
// `pairs`: d even and the output 4-byte aligned, so each lane writes its
// two neighbouring columns as one word.
template <int N>
__device__ __forceinline__ void store_acc(__nv_bfloat16* __restrict__ out,
                                          const float (&acc)[N][4], int row0,
                                          int t_len, int d, float mul0,
                                          float mul1, bool pairs) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    if (r >= t_len) continue;
    const float mul = h ? mul1 : mul0;
    __nv_bfloat16* orow = out + (size_t)r * d;
#pragma unroll
    for (int nt = 0; nt < N; ++nt) {
      const int c = nt * 8 + 2 * t;
      const float x = acc[nt][2 * h] * mul, y = acc[nt][2 * h + 1] * mul;
      if (pairs) {
        if (c < d)
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(x, y);
      } else {
        if (c < d) orow[c] = __float2bfloat16(x);
        if (c + 1 < d) orow[c + 1] = __float2bfloat16(y);
      }
    }
  }
}

}  // namespace mma
}  // namespace ptt
