// Warp-level tensor-core building blocks for the port's attention kernels
// on Hopper (sm_90a): 16-byte cp.async tile loads with zero fill, ldmatrix
// fragment loads, the m16n8k16 bf16 product and the m16n8k8 TF32 product
// with f32 accumulation, bf16 packing, and the 3xTF32 split that keeps an
// f32 product near f32 accuracy on the tensor cores.
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
//
// mma.m16n8k8 with .tf32 operands (f32 tiles), one element a b32:
//   A (16 x 8):  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B (8 x 8, k x n):  b0 (t, g)  b1 (t+4, g)
//   C as above:  c0 c1 (g, 2t..2t+1)  c2 c3 (g+8, 2t..2t+1)
// ldmatrix reads an 8 x 8 b16 matrix as 8 rows of 4 f32 and gives lane l
// the f32 element (l / 4, l % 4), which is (g, t): exactly a0 of A, or b0
// of B from a row-major [n][k] tile.  So A (Q) and B from [n][k] (K in
// Q K^T) load with a_row/tf32_a_col and b_row/tf32_b_col, the bf16 maps
// with 16-byte columns of 4 f32.  .trans moves 16-bit halves and cannot
// transpose f32, so B from a row-major [k][n] tile (V in P V) is read by
// plain 32-bit loads.  A score accumulator gives lane (g, t) keys 2t and
// 2t+1, the A fragment wants columns t and t+4: since P V sums over keys,
// the keys of each 8-key chunk are permuted alike in both operands, A's
// column t standing for key 2t and t+4 for key 2t+1.  Then A = (c0, c2,
// c1, c3) of the chunk's accumulator (acc_to_a_tf32), and V's B registers
// come from key rows 2t and 2t+1 (ld_v_tf32).  With an f32 row stride of
// DP + 4 the eight rows of an ldmatrix fall in distinct banks, and so do
// the 32 lanes of a V load (rows 2t, columns g: banks 8t + g).
//
// 3xTF32: one TF32 product keeps 11 bits of each operand (about 2^-11
// relative), too coarse for an f32 kernel held to 1e-4.  x = big + small,
// big = tf32(x), small = tf32(x - big) (x - big is exact in f32), keeps
// about 22 bits, and a b = a_small b_big + a_big b_small + a_big b_big,
// summed small terms first into one f32 accumulator, drops only
// a_small b_small, about 2^-22 relative: three products for f32 accuracy.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

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

// c += a b: one m16n8k8 product, TF32 operands, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// f32 -> TF32 as cvt.rna.tf32.f32 rounds a finite value (to nearest, ties
// away from zero; the low 13 bits zero), in two integer operations: half
// a TF32 step added to the magnitude's bits, then the low bits cleared.
// cvt is a conversion at a fraction of the ALU rate, and the f32 forward
// splits every element it loads, so the integer form runs faster with
// the same results.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small to about 2^-22 relative (the header's 3xTF32).  RAW
// passes small unrounded: mma.sync reads only the top 19 bits of a .tf32
// operand, so small arrives truncated to TF32, about 2^-21 relative to x,
// for two integer operations fewer an element.
template <bool RAW = false>
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  const float rest = x - __uint_as_float(big);
  small = RAW ? __float_as_uint(rest) : to_tf32(rest);
}

// Split four f32 held as b32 (an ldmatrix result) into big and small
template <bool RAW = false>
__device__ __forceinline__ void split_tf32(const uint32_t (&x)[4],
                                           uint32_t (&big)[4],
                                           uint32_t (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split_tf32<RAW>(__uint_as_float(x[i]), big[i], small[i]);
}

// c += a b in 3xTF32: small terms first, then big by big
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           uint32_t b0_big, uint32_t b1_big,
                                           uint32_t b0_small,
                                           uint32_t b1_small) {
  mma_tf32(c, a_small, b0_big, b1_big);
  mma_tf32(c, a_big, b0_small, b1_small);
  mma_tf32(c, a_big, b0_big, b1_big);
}

// The split A fragment of an 8-key chunk from its score accumulator c,
// keys permuted as the header says: (c0, c2, c1, c3)
template <bool RAW = false>
__device__ __forceinline__ void acc_to_a_tf32(uint32_t (&big)[4],
                                              uint32_t (&small)[4],
                                              const float (&c)[4]) {
  split_tf32<RAW>(c[0], big[0], small[0]);
  split_tf32<RAW>(c[2], big[1], small[1]);
  split_tf32<RAW>(c[1], big[2], small[2]);
  split_tf32<RAW>(c[3], big[3], small[3]);
}

// The split B registers of P V for one 8-key chunk and one n-tile: `v`
// points at the chunk's key row 2t, column g of the n-tile, in a tile of
// row stride LD; b0 is key 2t, b1 key 2t + 1 (the permuted keys)
template <int LD, bool RAW = false>
__device__ __forceinline__ void ld_v_tf32(const float* v, uint32_t (&big)[2],
                                          uint32_t (&small)[2]) {
  split_tf32<RAW>(v[0], big[0], small[0]);
  split_tf32<RAW>(v[LD], big[1], small[1]);
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
// the same 16-byte columns in f32 elements, for the TF32 fragments
__device__ __forceinline__ int tf32_a_col(int l) { return (l >> 4) << 2; }
__device__ __forceinline__ int tf32_b_col(int l) { return ((l >> 3) & 1) << 2; }

// A launcher's test for the 16-byte cp.async path (host side)
inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Rows [r0, r0 + ROWS) of a row-major [t_len, d] matrix of T (bf16 or f32)
// into shared memory (row stride LD), columns [0, DP), zero past t_len and
// past d.  `vec` (d a whole number of 16-byte chunks and a 16-byte aligned
// source) takes 16-byte cp.async chunks, each wholly inside or wholly
// outside; otherwise every element is loaded and stored on its own, which
// the caller's barrier makes visible.
template <int ROWS, int DP, int LD, int NTHREADS, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int r0, int t_len, int d, bool vec) {
  constexpr int E = 16 / sizeof(T);  // elements a 16-byte chunk
  constexpr int CH = DP / E;         // chunks a row
  static_assert((ROWS * CH) % NTHREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < ROWS * CH / NTHREADS; ++i) {
    const int e = threadIdx.x + i * NTHREADS;
    const int r = e / CH, c = (e - r * CH) * E;
    const int gr = r0 + r;
    T* s = dst + r * LD + c;
    if (vec) {
      const bool ok = gr < t_len && c < d;
      cp_async16(s, ok ? src + (size_t)gr * d + c : src, ok);
    } else {
#pragma unroll
      for (int u = 0; u < E; ++u)
        s[u] = (gr < t_len && c + u < d) ? src[(size_t)gr * d + c + u]
                                         : from_f<T>(0.f);
    }
  }
}

// two neighbouring elements of T (4-byte aligned bf16, 8-byte f32) as f32
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// Store one 16-row accumulator tile (rows row0 + g, row0 + g + 8 of a
// [t_len, d] matrix of T, n-tiles 0 .. N-1) as T, inside [t_len, d].
// `pairs`: d even and the output aligned to two elements, so each lane
// writes its two neighbouring columns as one word.
template <int N, typename T>
__device__ __forceinline__ void store_acc(T* __restrict__ out,
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
    T* orow = out + (size_t)r * d;
#pragma unroll
    for (int nt = 0; nt < N; ++nt) {
      const int c = nt * 8 + 2 * t;
      const float x = acc[nt][2 * h] * mul, y = acc[nt][2 * h + 1] * mul;
      if (pairs) {
        if (c < d) store_pair(orow + c, x, y);
      } else {
        if (c < d) orow[c] = from_f<T>(x);
        if (c + 1 < d) orow[c + 1] = from_f<T>(y);
      }
    }
  }
}

}  // namespace mma
}  // namespace ptt
