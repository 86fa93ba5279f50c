// What the persistent time loops of the LSTM (lstm_persistent.cuh, K7 and
// K8) and the GRU (gru_persistent.cuh, K9 and K10) share: the block's
// partition, the group barrier, the warps' staging of operand rows from
// L2 and their small products, and the grid's size.
//
// A block owns a slice of 16 hidden columns for the whole call and runs
// the time loop of a batch group of 16 rows at a time.  The grid is
// (slices, rows), rows = min(groups, the blocks that fit at once /
// slices), launched with cudaLaunchCooperativeKernel so that every block
// is resident at once (a grid too large is refused, it never hangs); grid
// row y serves groups y, y + rows, ... one after another.  Groups share no
// data, each has its own barrier counter, and the blocks of a grid row
// take the same groups in the same order, so a group's blocks are always
// resident together.
//
// The state a step's product needs from the rest of the group is read
// from rows the kernel writes to device memory and never writes again, so
// the one exchange a barrier needs is a monotonic counter a group, zeroed
// by the wrapper.  A block publishes a phase by __syncthreads, a fence and
// an atomicAdd; a reader spins on an acquire load until the counter
// reaches its target, then __syncthreads.  Rows written by other blocks
// are read through L2 only (cp.async.cg, ld.global.cg): a line in L1 may
// hold a neighbour's columns from before they were written.  A group
// barrier still closed after 10 s is a fault of the kernel: it traps, and
// the launch fails with an error instead of spinning on.
//
// Products: a warp multiplies its 16 rows by a run of 128-byte k chunks of
// the operand (64 bf16 or 32 f32), staged by cp.async into a ring of
// buffers of its own (the next chunks' copies overlap this chunk's
// product); a step's product is split over the warps by k, and their
// partial tiles are summed through shared memory.  bf16 runs on the
// tensor cores (mma.sync m16n8k16, f32 accumulation: the products are
// exact, only the order of the sums changes); f32 runs FMA on the CUDA
// cores, operands read as float4.
#pragma once

#include "mma.cuh"
#include "recurrent.cuh"

namespace ptt {
namespace {
namespace rnn_p {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;  // one thread a (row, column) pair
constexpr int kRows = 16;              // batch rows of a group
constexpr int kCols = 16;              // hidden columns of a slice

template <typename T>
struct Cfg {
  static constexpr int E = 16 / sizeof(T);      // elements a 16-byte chunk
  static constexpr int KC = 128 / sizeof(T);    // k of a staged chunk
  static constexpr int LDA = KC + E;            // staged row stride
};

__host__ __device__ constexpr int chunks(int k, int kc) {
  return (k + kc - 1) / kc;
}

// staged chunks in flight a warp: the forward's products hold one (bf16)
// or two (f32) chunks a warp at H 512, the backward's dh products more
// (bf16 all in flight, f32 three: as deep as shared memory allows)
template <typename T>
__host__ __device__ constexpr int nbuf(bool backward) {
  return backward ? (sizeof(T) == 2 ? 4 : 3) : 2;
}

// the warps' staging buffers: 144-byte rows in either type
constexpr size_t kChunkBytes = (size_t)kRows * (128 + 16);
static_assert(kChunkBytes == kRows * Cfg<float>::LDA * sizeof(float) &&
                  kChunkBytes ==
                      kRows * Cfg<__nv_bfloat16>::LDA * sizeof(__nv_bfloat16),
              "one chunk size for both types");
template <typename T>
__host__ __device__ constexpr size_t stage_bytes(bool backward) {
  return (size_t)kWarps * nbuf<T>(backward) * kChunkBytes;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// A group barrier that has not opened after this long is a fault in the
// kernel: it traps (the launch fails with an error) rather than spin on.
constexpr unsigned long long kSpinLimitNs = 10000000000ull;

// wait until the group's counter reaches `target`; the whole block waits
__device__ __forceinline__ void group_wait(const unsigned* counter,
                                           unsigned target) {
  if (threadIdx.x == 0) {
    const unsigned long long t0 = global_ns();
    while (ld_acquire(counter) < target)
      if (global_ns() - t0 > kSpinLimitNs) __trap();
  }
  __syncthreads();
}

// publish this block's writes of the phase to its group
__device__ __forceinline__ void group_arrive(unsigned* counter) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
  }
}

// loads of what another block (or another thread of this one) wrote
// during the call: through L2, never a line cached in L1
__device__ __forceinline__ float ldcg_f(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldcg_f(const __nv_bfloat16* p) {
  const unsigned short v = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}

// One operand of 16 rows: row r at src + r * stride for r < nrows (zero
// beyond), columns k < K (zero beyond).  `vec`: K and stride whole 16-byte
// chunks and src 16-byte aligned, so a chunk is wholly inside or outside.
template <typename T>
struct Rows {
  const T* src;
  size_t stride;
  int nrows, K;
  bool vec;
};

// Two operands read as one run of chunks: a's chunks [0, na), then b's
template <typename T>
struct RowsPair {
  Rows<T> a, b;
  int na;
};

// Stage k chunk `s` of the operand into dst (16 x LDA), by the warp
template <typename T>
__device__ __forceinline__ void stage_chunk(T* dst, const Rows<T>& a, int s) {
  using C = Cfg<T>;
  constexpr int CH = C::KC / C::E;  // 16-byte chunks a row: 8
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kRows * CH / 32; ++i) {
    const int e = lane + 32 * i;
    const int r = e / CH, c = (e % CH) * C::E;
    const int k = s * C::KC + c;
    T* d = dst + r * C::LDA + c;
    const T* p = a.src + (size_t)r * a.stride + k;
    if (a.vec) {
      const bool ok = r < a.nrows && k < a.K;
      mma::cp_async16(d, ok ? p : a.src, ok);
    } else {
#pragma unroll
      for (int u = 0; u < C::E; ++u)
        d[u] = from_f<T>(r < a.nrows && k + u < a.K ? ldcg_f(p + u) : 0.f);
    }
  }
}

template <typename T>
__device__ __forceinline__ void stage_chunk(T* dst, const RowsPair<T>& p,
                                            int s) {
  if (s < p.na)
    stage_chunk(dst, p.a, s);
  else
    stage_chunk(dst, p.b, s - p.na);
}

// body(staged chunk, s) for the operand's chunks [s0, s1), by the warp,
// with the copies of the next NBUF - 1 chunks in flight during a body.
// Every round commits one cp.async group (empty past s1), so "all but
// NBUF - 1 groups done" always means "chunk s has landed".
template <int NBUF, typename T, typename Src, typename Body>
__device__ __forceinline__ void warp_stream(T* buf, const Src& a, int s0,
                                            int s1, Body body) {
  constexpr int SZ = kRows * Cfg<T>::LDA;
#pragma unroll
  for (int i = 0; i < NBUF - 1; ++i) {
    if (s0 + i < s1) stage_chunk(buf + i * SZ, a, s0 + i);
    mma::cp_async_commit();
  }
  for (int s = s0; s < s1; ++s) {
    const int i = s - s0;
    if (s + NBUF - 1 < s1)
      stage_chunk(buf + ((i + NBUF - 1) % NBUF) * SZ, a, s + NBUF - 1);
    mma::cp_async_commit();
    mma::cp_async_wait<NBUF - 1>();
    __syncwarp();
    body(buf + (i % NBUF) * SZ, s);
    __syncwarp();
  }
}

// A warp's 16 x N tile of gate sums (N = 16, 32 or 64), a staged chunk
// times N columns of a [k][column] tile of W in shared memory (row stride
// ldw, 16-byte aligned rows).
template <typename T, int N>
struct GateTile;

template <int N>
struct GateTile<__nv_bfloat16, N> {
  static_assert(N % 16 == 0, "whole pairs of n-tiles");
  using C = Cfg<__nv_bfloat16>;
  float acc[N / 8][4];  // n-tile, C fragment
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  }
  __device__ __forceinline__ void mul_add(const __nv_bfloat16* a,
                                          const __nv_bfloat16* wc, int ldw,
                                          int k0) {
    const int l = threadIdx.x & 31;
#pragma unroll
    for (int ks = 0; ks < C::KC / 16; ++ks) {
      uint32_t af[4];
      mma::ldsm_x4(af, a + mma::a_row(l) * C::LDA + ks * 16 + mma::a_col(l));
#pragma unroll
      for (int p = 0; p < N / 16; ++p) {
        uint32_t bf[4];
        mma::ldsm_x4_trans(bf, wc + (size_t)(k0 + ks * 16 + mma::bt_row(l)) *
                                        ldw + p * 16 + mma::bt_col(l));
        mma::mma_bf16(acc[2 * p], af, bf[0], bf[1]);
        mma::mma_bf16(acc[2 * p + 1], af, bf[2], bf[3]);
      }
    }
  }
  // f(row, column, value) for each of the lane's N / 2 sums
  template <typename F>
  __device__ __forceinline__ void each(F f) const {
    const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        f(g + 8 * (i >> 1), n * 8 + 2 * t + (i & 1), acc[n][i]);
  }
};

// f32: lane l holds rows lr + 4 i (lr = l / 8) by N / 8 columns of lc = l %
// 8: 4 lc + q and 32 + 4 lc + q (N 64), 4 lc + q (N 32), 2 lc + q (N 16).
// The staged rows are 144 bytes apart, so the four rows lr + 4 i a load
// reads start 64 bytes apart and fall in distinct banks (rows 4 lr + i
// would pair up: rows i and 8 + i share their banks).
template <int N>
__host__ __device__ constexpr int f32_col(int lc, int q) {
  return N >= 32 ? (q >> 2) * 32 + 4 * lc + (q & 3) : 2 * lc + q;
}

template <int N>
struct GateTile<float, N> {
  static_assert(N == 16 || N == 32 || N == 64, "a lane's columns");
  using C = Cfg<float>;
  static constexpr int NQ = N / 8;
  float acc[4][NQ];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < NQ; ++q) acc[i][q] = 0.f;
  }
  __device__ __forceinline__ void mul_add(const float* a, const float* wc,
                                          int ldw, int k0) {
    const int l = threadIdx.x & 31, lr = l >> 3, lc = l & 7;
#pragma unroll 2
    for (int kk = 0; kk < C::KC; kk += 4) {
      float av[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v =
            *reinterpret_cast<const float4*>(a + (lr + 4 * i) * C::LDA + kk);
        av[i][0] = v.x; av[i][1] = v.y; av[i][2] = v.z; av[i][3] = v.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* wr = wc + (size_t)(k0 + kk + u) * ldw;
        float bv[NQ];
        if constexpr (NQ >= 4) {
#pragma unroll
          for (int g = 0; g < NQ / 4; ++g) {
            const float4 b =
                *reinterpret_cast<const float4*>(wr + g * 32 + 4 * lc);
            bv[4 * g] = b.x; bv[4 * g + 1] = b.y;
            bv[4 * g + 2] = b.z; bv[4 * g + 3] = b.w;
          }
        } else {
          const float2 b = *reinterpret_cast<const float2*>(wr + 2 * lc);
          bv[0] = b.x; bv[1] = b.y;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < NQ; ++q)
            acc[i][q] = fmaf(av[i][u], bv[q], acc[i][q]);
      }
    }
  }
  template <typename F>
  __device__ __forceinline__ void each(F f) const {
    const int l = threadIdx.x & 31, lr = l >> 3, lc = l & 7;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < NQ; ++q) f(lr + 4 * i, f32_col<N>(lc, q), acc[i][q]);
  }
};

// A warp's 16 x 16 tile of dh sums, a staged chunk of a gradient row
// times W[j, :]^T (W's rows j of the slice, 16 x ld: the [n][k] layout).
template <typename T>
struct DhTile;

template <>
struct DhTile<__nv_bfloat16> {
  using C = Cfg<__nv_bfloat16>;
  float acc[2][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  }
  __device__ __forceinline__ void mul_add(const __nv_bfloat16* a,
                                          const __nv_bfloat16* wr, int ld,
                                          int k0) {
    const int l = threadIdx.x & 31;
#pragma unroll
    for (int ks = 0; ks < C::KC / 16; ++ks) {
      uint32_t af[4], bf[4];
      mma::ldsm_x4(af, a + mma::a_row(l) * C::LDA + ks * 16 + mma::a_col(l));
      mma::ldsm_x4(bf, wr + mma::b_row(l) * ld + k0 + ks * 16 + mma::b_col(l));
      mma::mma_bf16(acc[0], af, bf[0], bf[1]);
      mma::mma_bf16(acc[1], af, bf[2], bf[3]);
    }
  }
  template <typename F>
  __device__ __forceinline__ void each(F f) const {
    const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        f(g + 8 * (i >> 1), n * 8 + 2 * t + (i & 1), acc[n][i]);
  }
};

// f32: lane l holds rows lr + 4 i by columns lc + 8 c (lr = l / 8, lc = l %
// 8): the W rows lc + 8 c a load reads are ld = 4 (mod 32) words apart,
// so the eight distinct rows fall in distinct banks (rows 2 lc + c would
// pair up lc and lc + 4), and the staged rows as in GateTile<float>
template <>
struct DhTile<float> {
  using C = Cfg<float>;
  float acc[4][2];  // rows lr + 4 i, columns lc + 8 c
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.f;
  }
  __device__ __forceinline__ void mul_add(const float* a, const float* wr,
                                          int ld, int k0) {
    const int l = threadIdx.x & 31, lr = l >> 3, lc = l & 7;
#pragma unroll 4
    for (int kk = 0; kk < C::KC; kk += 4) {
      float4 av[4], bv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = *reinterpret_cast<const float4*>(a + (lr + 4 * i) * C::LDA + kk);
#pragma unroll
      for (int c = 0; c < 2; ++c)
        bv[c] = *reinterpret_cast<const float4*>(wr + (lc + 8 * c) * ld + k0 + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float s = acc[i][c];
          s = fmaf(av[i].x, bv[c].x, s);
          s = fmaf(av[i].y, bv[c].y, s);
          s = fmaf(av[i].z, bv[c].z, s);
          acc[i][c] = fmaf(av[i].w, bv[c].w, s);
        }
    }
  }
  template <typename F>
  __device__ __forceinline__ void each(F f) const {
    const int l = threadIdx.x & 31, lr = l >> 3, lc = l & 7;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) f(lr + 4 * i, lc + 8 * c, acc[i][c]);
  }
};

// The operand rows of step t's product: round(h_{t-1}) is h0 at t = 0,
// else hs[:, t-1], for the group's rows from b0
template <typename T>
__device__ __forceinline__ Rows<T> prev_rows(const T* h0, const T* hs, int b0,
                                             int batch, int t, int t_len,
                                             int h, bool vec) {
  const int nrows = min(kRows, batch - b0);
  if (t == 0) return {h0 + (size_t)b0 * h, (size_t)h, nrows, h, vec};
  return {hs + ((size_t)b0 * t_len + t - 1) * h, (size_t)t_len * h, nrows, h,
          vec};
}

// the 16-byte copies need whole chunks a row and an aligned base
template <typename T>
int vec(const void* p, int k) {
  return mma::aligned16(p) && k % Cfg<T>::E == 0;
}

// Blocks of `kernel` (kThreads threads, `smem` bytes of dynamic shared
// memory) that fit on the current device at once, 0 when one block's
// shared memory does not fit.  Also sets the kernel's shared memory.
inline cudaError_t capacity(const void* kernel, size_t smem, int* blocks) {
  *blocks = 0;
  int dev, optin, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

// The persistent grid of `kernel`: (slices, rows) with rows = min(groups,
// the blocks that fit at once / slices); a grid row serves every rows-th
// batch group.  Refused when one row of slices does not fit (the caller's
// shape rule routes such a width to the steps).
inline cudaError_t persistent_grid(const void* kernel, size_t smem, int batch,
                                   int h, dim3* grid) {
  int blocks;
  const cudaError_t err = capacity(kernel, smem, &blocks);
  if (err != cudaSuccess) return err;
  const int slices = (h + kCols - 1) / kCols;
  const int groups = (batch + kRows - 1) / kRows;
  const int rows = groups < blocks / slices ? groups : blocks / slices;
  if (rows < 1) return cudaErrorCooperativeLaunchTooLarge;
  *grid = dim3(slices, rows);
  return cudaSuccess;
}

}  // namespace rnn_p
}  // namespace
}  // namespace ptt
