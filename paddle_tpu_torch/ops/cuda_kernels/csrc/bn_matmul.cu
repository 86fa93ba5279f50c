// The fused BatchNorm(+residual)+act -> 1x1 convolution for Hopper
// (sm_90a): forward (K11) and backward (K12).
//
// Replaces the Pallas TPU kernels bn_matmul_fwd and bn_matmul_bwd
// (paddle_tpu/ops/pallas_kernels/bn_matmul.py: _fwd_kernel, _bwd_body).
// A 1x1 convolution in NHWC is a product [M = N*H*W, K] x [K, N_out].
//
// Forward (K11), both dtypes on the tensor cores (bn_mma.cuh: bf16 mma.sync
// m16n8k16; f32 m16n8k8 TF32 products in 3xTF32, each fragment split as it is
// read, small halves unrounded; each step's products summed from zero): Out =
// act((X - mean) * gamma * rsqrt(var + eps) + beta [+ R]) W.  Each block
// computes a 64 x 64 tile of Out, bound by its bytes at ResNet's 1x1s with a
// residual (X and R are most of them): X and R are staged raw by cp.async16
// (TileRR, rows m), post() applies the prologue in place in shared memory
// once per staged element (channels past K give 0; in bf16 the result is
// rounded to bf16 as the product's operand, in f32 it stays unrounded and the
// fragment loads split it), W is staged as a [k][n] tile (TileRM:
// ldmatrix.trans in bf16, 32-bit lane loads in f32), the blocks of one M tile
// sit next to each other in the grid so that X and R come from device memory
// about once, and Out leaves 16 bytes a thread through shared memory
// (store_tile).  The normalized activation never reaches device memory.
//
// Backward (K12), one C entry point, four launches, both dtypes on the
// tensor cores (bn_mma.cuh: bf16 mma.sync m16n8k16; f32 m16n8k8 TF32
// products in 3xTF32, each fragment split as it is read, small halves
// unrounded; f32 accumulators, each step's products summed from zero):
//   (a) dA = dO W^T per (M tile, K tile): dO and W staged by cp.async16
//       (TileRR), the blocks of one M tile adjacent in the grid so that
//       its dO rows are read from device memory about once; the epilogue
//       (bn_mma.cuh da_epilogue) recomputes pre from X, R and the
//       statistics, masks pre > 0, writes dX = dpre * gamma * inv and
//       dR = dpre 16 bytes a thread through shared memory, and sums the
//       tile's dgamma / dbeta columns in a fixed order (lanes by
//       shuffles, warps through shared memory);
//   (b) dW = A^T dO per (K tile, N tile, M split): X, R and dO staged raw
//       by cp.async16 (TileRM), the prologue run once per staged element
//       in place in shared memory with each thread's two channels' (mean,
//       gamma * inv, beta) hoisted, rows past the split zeroed after it;
//       A and B then load by ldmatrix.trans (bf16) or 32-bit lane loads
//       (f32); each split's f32 sums to its own slice of a partial buffer;
//   (c) the splits summed in a fixed order, cast once to W's type;
//   (d) the M tiles' column sums summed to dgamma, dbeta in f64
//       (bn_mma.cuh sum_tiles_f64).
// A step is 64 bytes of a row in both dtypes (32 bf16 or 16 f32), so the
// rings (three stages) take the same shared memory.  The TPU kernel
// carries dW, dgamma and dbeta in VMEM across a sequential grid; blocks
// here run in no order, so each resident accumulator became a second pass
// over per-block partial sums, which keeps reruns bit-reproducible (no
// atomics).  dmean and dvar follow from dgamma and dbeta in closed form in
// the wrapper, as in the JAX wrapper.
//
// Bound on an H100: 2 M K N flops forward and 4 M K N backward, against
// the bytes of X, R, W and Out (dX, dR, dO too backward): in bf16 the
// forward does K N / (K (1 + r) + N) flops a byte, below the card's 295 at
// most of ResNet-50's 1x1s (57 at stage 2's with a residual, K 512, N
// 128), so it is bound by bytes unless K and N are both large, and the
// backward with a residual is bound by bytes in both dtypes (in f32 at
// three TF32 products per f32 product: 0.26 ms of bytes against 0.16 of
// products at stage 2), and so is the forward in f32 (0.138 ms of bytes
// against 0.080 of products at stage 2).  X and R are read twice (once
// in each pass), as in the first design.  Channel counts that are not a
// multiple of a 16-byte chunk (or unaligned tensors) take the same
// tensor-core body with element-wise staging (VEC false).  What every
// design keeps: X is read, and A recomputed, inside the product, never
// written.

#include "bn_mma.cuh"

namespace ptt {
namespace {

// K11 and K12 on the tensor cores (bn_mma.cuh).
using bnmma::TileRM;
using bnmma::TileRR;
using bf16 = __nv_bfloat16;

// K11: A = act(BN(X) [+ R]) [m][k], X and R staged raw (TileRR, rows m) with
// the step's channels' (mean, gamma * inv, beta) beside them (a [3][BK] f32
// table, one 16-byte chunk each for 3 BK / 4 threads: 24 in bf16, 12 in f32;
// the channel is the tile's column, so it moves with k0), then post() applies
// the prologue in place, each thread to the channel pair k0 + 2 (tid % (BK /
// 2)) of rows tid / (BK / 2) + (256 / BK) i (8 threads a row in f32, 16 in
// bf16).  The two rows of one bank phase (the warp in bf16, a half warp's
// float2 in f32) then share 4 of their 32 banks (adjacent rows, 20 words
// apart); taking rows 4 apart instead (80 words, no conflict) was level in
// f32 and lost up to 7.5% in bf16 on an H100.  A channel past K takes zero
// parameters (the table's zero fill), so its zero-filled elements leave the
// prologue as act(0) = 0 (real parameters would give act(beta - mean * gi),
// not 0); W's rows past K are zero-filled too.  B = W [k][n] (TileRM).  A
// step is 64 bytes of a row in both dtypes (32 bf16, 16 f32) through a ring
// of three (the raw R tile takes the room a deeper step would need).  The
// table is read from shared memory: loading the pair's parameters from device
// memory (L1) in post() took up to 17% longer.
template <typename T, bool VEC>
struct MmFwd {
  static constexpr bool kPost = true;
  static constexpr int E = 16 / sizeof(T);
  static constexpr int kBK = 4 * E, kStages = 3;
  static constexpr int kPairs = kBK / 2;   // channel pairs of a step
  static constexpr int kRows = 256 / kBK;  // rows of a post() pass
  struct Ring {
    TileRR<kBK, T> x[kStages];
    TileRR<kBK, T> r[kStages];
    TileRM<kBK, T> w[kStages];
    float p[kStages][3][kBK];
  };
  TileRR<kBK, T>* sx;
  TileRR<kBK, T>* sr;
  TileRM<kBK, T>* sw;
  float (*sp)[3][kBK];
  const T* x;
  const T* res;
  const T* w;
  const float* prm;
  int M, K, N, row0, col0, act;
  __device__ void stage(int buf, int step) const {
    const int k0 = step * kBK;
    // the chunks a thread stages of a [64][BK] X tile, and as many of the
    // [BK][64] W tile: 2 in both dtypes (64 bytes a row a step)
#pragma unroll
    for (int i = 0; i < bnmma::tile_chunks<kBK, T>(); ++i) {
      const int r = bnmma::rr_row<kBK, T>(i), c = bnmma::rr_col<kBK, T>(i);
      const int m = row0 + r;
      const int nx = m < M ? bnmma::chunk_len<E>(k0 + c, K) : 0;
      const size_t off = (size_t)m * K + k0 + c;
      bnmma::stage_chunk<VEC>(&sx[buf].v[r][c], nx ? x + off : x, nx);
      if (res != nullptr)
        bnmma::stage_chunk<VEC>(&sr[buf].v[r][c], nx ? res + off : res, nx);
      const int kr = bnmma::rm_row<T>(i), nc = bnmma::rm_col<T>(i);
      const int k = k0 + kr;
      const int nw = k < K ? bnmma::chunk_len<E>(col0 + nc, N) : 0;
      bnmma::stage_chunk<VEC>(&sw[buf].v[kr][nc],
                              nw ? w + (size_t)k * N + col0 + nc : w, nw);
    }
    constexpr int kPrmChunks = kBK / 4;  // 16-byte chunks of a table row
    if (threadIdx.x < 3 * kPrmChunks) {
      const int j = threadIdx.x / kPrmChunks;
      const int c = (threadIdx.x - j * kPrmChunks) * 4;
      // K % 4 == 0 when VEC (K whole 16-byte chunks of T), so n is 0 or 4
      const int n = max(0, min(4, K - (k0 + c)));
      float* dst = &sp[buf][j][c];
      const float* src = prm + (size_t)j * K + k0 + c;
      if constexpr (VEC) {
        mma::cp_async16(dst, n ? src : prm, n > 0);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) dst[u] = u < n ? src[u] : 0.f;
      }
    }
  }
  __device__ void post(int buf, int step) const {
    const int cp = 2 * (threadIdx.x % kPairs), r0 = threadIdx.x / kPairs;
    const float2 mu = *reinterpret_cast<const float2*>(&sp[buf][0][cp]);
    const float2 gi = *reinterpret_cast<const float2*>(&sp[buf][1][cp]);
    const float2 be = *reinterpret_cast<const float2*>(&sp[buf][2][cp]);
#pragma unroll
    for (int i = 0; i < bnmma::kBM / kRows; ++i) {
      const int r = r0 + kRows * i;
      T* px = &sx[buf].v[r][cp];
      const float2 xf = mma::load_pair(px);
      float v0 = pre_act(xf.x, mu.x, gi.x, be.x);
      float v1 = pre_act(xf.y, mu.y, gi.y, be.y);
      if (res != nullptr) {
        const float2 rf = mma::load_pair(&sr[buf].v[r][cp]);
        v0 = __fadd_rn(v0, rf.x);
        v1 = __fadd_rn(v1, rf.y);
      }
      if (act == 1) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      mma::store_pair(px, v0, v1);
    }
  }
  __device__ const TileRR<kBK, T>& a(int buf) const { return sx[buf]; }
  __device__ const TileRM<kBK, T>& b(int buf) const { return sw[buf]; }
};

// (a) A = dO [M][N] (rows m), B = W [K][N] (rows k), reduction n, 64
// bytes a row a step (32 bf16, 16 f32) through a ring of three.
template <typename T, bool VEC>
struct MmDA {
  static constexpr bool kPost = false;
  static constexpr int E = 16 / sizeof(T);
  static constexpr int kBK = 4 * E, kStages = 3;
  TileRR<kBK, T>* sa;
  TileRR<kBK, T>* sb;
  const T* dout;
  const T* w;
  int M, K, N, row0, col0;
  __device__ void stage(int buf, int step) const {
    const int n0 = step * kBK;
#pragma unroll
    for (int i = 0; i < bnmma::tile_chunks<kBK, T>(); ++i) {
      const int r = bnmma::rr_row<kBK, T>(i), c = bnmma::rr_col<kBK, T>(i);
      const int m = row0 + r, k = col0 + r;
      const int na = m < M ? bnmma::chunk_len<E>(n0 + c, N) : 0;
      bnmma::stage_chunk<VEC>(&sa[buf].v[r][c],
                              na ? dout + (size_t)m * N + n0 + c : dout, na);
      const int nb = k < K ? bnmma::chunk_len<E>(n0 + c, N) : 0;
      bnmma::stage_chunk<VEC>(&sb[buf].v[r][c],
                              nb ? w + (size_t)k * N + n0 + c : w, nb);
    }
  }
  __device__ const TileRR<kBK, T>& a(int buf) const { return sa[buf]; }
  __device__ const TileRR<kBK, T>& b(int buf) const { return sb[buf]; }
};

// (b) A^T = prologue(X) [m][k] (rows k of C), B = dO [m][n], reduction m
// in [r_begin, r_end): X, R and dO staged raw, then post() applies the
// prologue in place, each thread to the channel pair k0 + 2 (tid % 32),
// rounded to T as the product's operand; 32 bf16 or 16 f32 rows a step
// (the same bytes) through a ring of three (the raw R tile takes the room
// a deeper step would need).
template <typename T, bool VEC>
struct MmDW {
  static constexpr bool kPost = true;
  static constexpr int E = 16 / sizeof(T);
  static constexpr int kBK = 4 * E, kStages = 3;
  TileRM<kBK, T>* sx;
  TileRM<kBK, T>* sr;
  TileRM<kBK, T>* sd;
  const T* x;
  const T* res;
  const T* dout;
  int K, N, row0, col0, r_begin, r_end, act;
  Chan ch[2];
  __device__ void stage(int buf, int step) const {
    const int m0 = r_begin + step * kBK;
#pragma unroll
    for (int i = 0; i < bnmma::tile_chunks<kBK, T>(); ++i) {
      const int r = bnmma::rm_row<T>(i), c = bnmma::rm_col<T>(i);
      const int m = m0 + r;
      const bool ok = m < r_end;
      const int nx = ok ? bnmma::chunk_len<E>(row0 + c, K) : 0;
      const size_t off = (size_t)m * K + row0 + c;
      bnmma::stage_chunk<VEC>(&sx[buf].v[r][c], nx ? x + off : x, nx);
      if (res != nullptr)
        bnmma::stage_chunk<VEC>(&sr[buf].v[r][c], nx ? res + off : res, nx);
      const int nd = ok ? bnmma::chunk_len<E>(col0 + c, N) : 0;
      bnmma::stage_chunk<VEC>(&sd[buf].v[r][c],
                              nd ? dout + (size_t)m * N + col0 + c : dout,
                              nd);
    }
  }
  __device__ void post(int buf, int step) const {
    const int m0 = r_begin + step * kBK;
    const int cp = 2 * (threadIdx.x & 31);
    const bool k0_ok = row0 + cp < K, k1_ok = row0 + cp + 1 < K;
#pragma unroll
    for (int i = 0; i < kBK / 4; ++i) {
      const int r = (threadIdx.x >> 5) + 4 * i;
      T* px = &sx[buf].v[r][cp];
      const float2 xf = mma::load_pair(px);
      float v0 = pre_act(xf.x, ch[0].mu, ch[0].gi, ch[0].b);
      float v1 = pre_act(xf.y, ch[1].mu, ch[1].gi, ch[1].b);
      if (res != nullptr) {
        const float2 rf = mma::load_pair(&sr[buf].v[r][cp]);
        v0 = __fadd_rn(v0, rf.x);
        v1 = __fadd_rn(v1, rf.y);
      }
      if (act == 1) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      const bool m_ok = m0 + r < r_end;
      mma::store_pair(px, m_ok && k0_ok ? v0 : 0.f, m_ok && k1_ok ? v1 : 0.f);
    }
  }
  __device__ const TileRM<kBK, T>& a(int buf) const { return sx[buf]; }
  __device__ const TileRM<kBK, T>& b(int buf) const { return sd[buf]; }
};

__device__ __forceinline__ Chan chan_or_zero(const float* prm, int K, int k) {
  return k < K ? chan(prm, K, k) : Chan{k, 0.f, 0.f, 0.f};
}

// K11. grid: ceil(M / 64) * ceil(N / 64), block b = M tile (b / tiles_n),
// N tile (b % tiles_n).
template <typename T, bool VEC>
__global__ void __launch_bounds__(bnmma::kThreads)
bnmm_fwd_mma(const T* __restrict__ x, const T* __restrict__ res,
             const float* __restrict__ prm, const T* __restrict__ w,
             T* __restrict__ out, int M, int K, int N, int act) {
  using Op = MmFwd<T, VEC>;
  __shared__ __align__(16) bnmma::OutSmem<typename Op::Ring> sm;
  const int tiles_n = (N + bnmma::kBN - 1) / bnmma::kBN;
  const int mt = blockIdx.x / tiles_n, nt = blockIdx.x - mt * tiles_n;
  const int row0 = mt * bnmma::kBM, col0 = nt * bnmma::kBN;
  Op op{sm.ring.x, sm.ring.r, sm.ring.w, sm.ring.p, x, res, w, prm, M, K,
        N, row0, col0, act};
  float acc[2][4][4];
  bnmma::mma_loop(acc, op, (K + Op::kBK - 1) / Op::kBK);
  bnmma::store_tile<VEC>(acc, sm.c, out, row0, M, col0, N);
}

// (a) grid: ceil(M / 64) * ceil(K / 64), block b = M tile (b / tiles_k),
// K tile (b % tiles_k).
template <typename T, bool VEC>
__global__ void __launch_bounds__(bnmma::kThreads)
bnmm_bwd_da_mma(const T* __restrict__ x, const T* __restrict__ res,
                const float* __restrict__ prm4, const T* __restrict__ w,
                const T* __restrict__ dout, T* __restrict__ dx,
                T* __restrict__ dr, float* __restrict__ gb_part, int M, int K,
                int N, int act) {
  using Op = MmDA<T, VEC>;
  __shared__ __align__(16) bnmma::DaSmem<Op::kBK, Op::kStages, T> sm;
  const int tiles_k = (K + bnmma::kBN - 1) / bnmma::kBN;
  const int mt = blockIdx.x / tiles_k, kt = blockIdx.x - mt * tiles_k;
  const int row0 = mt * bnmma::kBM, col0 = kt * bnmma::kBN;
  Op op{sm.ring.a, sm.ring.b, dout, w, M, K, N, row0, col0};
  float acc[2][4][4];
  bnmma::mma_loop(acc, op, (N + Op::kBK - 1) / Op::kBK);
  bnmma::da_epilogue<VEC>(acc, x, res, prm4, dx, dr, gb_part, mt, row0, M,
                          col0, K, act, sm);
}

// (b) grid: (ceil(K / 64), ceil(N / 64), splits); split z sums m in
// [z * chunk, min((z + 1) * chunk, M)) into part[z][K][N].
template <typename T, bool VEC>
__global__ void __launch_bounds__(bnmma::kThreads)
bnmm_bwd_dw_mma(const T* __restrict__ x, const T* __restrict__ res,
                const float* __restrict__ prm, const T* __restrict__ dout,
                float* __restrict__ part, int M, int K, int N, int chunk,
                int act) {
  using Op = MmDW<T, VEC>;
  __shared__ __align__(16) TileRM<Op::kBK, T> sx[Op::kStages];
  __shared__ __align__(16) TileRM<Op::kBK, T> sr[Op::kStages];
  __shared__ __align__(16) TileRM<Op::kBK, T> sd[Op::kStages];
  const int z = blockIdx.z;
  const int r_begin = z * chunk, r_end = min(M, r_begin + chunk);
  const int row0 = blockIdx.x * bnmma::kBM, col0 = blockIdx.y * bnmma::kBN;
  const int k = row0 + 2 * (threadIdx.x & 31);
  Op op{sx, sr, sd, x, res, dout, K, N, row0, col0, r_begin, r_end, act,
        {chan_or_zero(prm, K, k), chan_or_zero(prm, K, k + 1)}};
  float acc[2][4][4];
  bnmma::mma_loop(acc, op, (r_end - r_begin + Op::kBK - 1) / Op::kBK);
  bnmma::store_part<VEC>(acc, part + (size_t)z * K * N, row0, K, col0, N);
}

template <typename T, bool VEC>
cudaError_t fwd_mma(const void* x, const void* r, const void* prm,
                    const void* w, void* out, int M, int K, int N, int act,
                    cudaStream_t stream) {
  const long long blocks =
      (long long)ceil_div(M, bnmma::kBM) * ceil_div(N, bnmma::kBN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  bnmm_fwd_mma<T, VEC><<<(int)blocks, bnmma::kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const float*>(prm), static_cast<const T*>(w),
      static_cast<T*>(out), M, K, N, act);
  return cudaGetLastError();
}

// K11 in T: 16-byte staging and stores (VEC) when every row is whole
// 16-byte chunks of T and every tensor is 16-byte aligned
template <typename T>
cudaError_t dispatch_fwd(const void* x, const void* r, const void* prm,
                         const void* w, void* out, int M, int K, int N,
                         int act, cudaStream_t stream) {
  constexpr int e = 16 / sizeof(T);
  const bool vec = K % e == 0 && N % e == 0 && mma::aligned16(x) &&
                   (r == nullptr || mma::aligned16(r)) &&
                   mma::aligned16(w) && mma::aligned16(out);
  if (vec) return fwd_mma<T, true>(x, r, prm, w, out, M, K, N, act, stream);
  return fwd_mma<T, false>(x, r, prm, w, out, M, K, N, act, stream);
}

template <typename T, bool VEC>
cudaError_t bwd_mma(const void* x, const void* r, const void* prm,
                    const void* prm4, const void* w, const void* dout,
                    void* dx, void* dr, void* dw, float* dw_part,
                    float* gb_part, float* dgb, int M, int K, int N,
                    int splits, int chunk, int act, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(r);
  const T* dot = static_cast<const T*>(dout);
  const int tiles_m = ceil_div(M, bnmma::kBM);
  const long long blocks = (long long)tiles_m * ceil_div(K, bnmma::kBN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  bnmm_bwd_da_mma<T, VEC><<<(int)blocks, bnmma::kThreads, 0, stream>>>(
      xt, rt, static_cast<const float*>(prm4), static_cast<const T*>(w), dot,
      static_cast<T*>(dx), static_cast<T*>(dr), gb_part, M, K, N, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bnmm_bwd_dw_mma<T, VEC><<<dim3(ceil_div(K, bnmma::kBM),
                                 ceil_div(N, bnmma::kBN), splits),
                            bnmma::kThreads, 0, stream>>>(
      xt, rt, static_cast<const float*>(prm), dot, dw_part, M, K, N, chunk,
      act);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = launch_sum_splits<T>(dw_part, static_cast<T*>(dw), 1, splits, K * N,
                             stream);
  if (err != cudaSuccess) return err;
  return bnmma::launch_sum_tiles_f64(gb_part, dgb, tiles_m, 2 * K, stream);
}

// K12 in T: 16-byte staging and dX / dR stores (VEC) when every row is
// whole 16-byte chunks of T and every input is 16-byte aligned
template <typename T>
cudaError_t dispatch_bwd(const void* x, const void* r, const void* prm,
                         const void* prm4, const void* w, const void* dout,
                         void* dx, void* dr, void* dw, float* dw_part,
                         float* gb_part, float* dgb, int M, int K, int N,
                         int splits, int chunk, int act,
                         cudaStream_t stream) {
  constexpr int e = 16 / sizeof(T);
  const bool vec = K % e == 0 && N % e == 0 && mma::aligned16(x) &&
                   (r == nullptr || mma::aligned16(r)) &&
                   mma::aligned16(w) && mma::aligned16(dout);
  if (vec)
    return bwd_mma<T, true>(x, r, prm, prm4, w, dout, dx, dr, dw, dw_part,
                            gb_part, dgb, M, K, N, splits, chunk, act,
                            stream);
  return bwd_mma<T, false>(x, r, prm, prm4, w, dout, dx, dr, dw, dw_part,
                           gb_part, dgb, M, K, N, splits, chunk, act, stream);
}

}  // namespace
}  // namespace ptt

// x, r [M, K] (r may be null), prm [3, K] f32 (mean, gamma * inv, beta),
// w [K, N], out [M, N]; act 1 = relu.
extern "C" int ptt_bn_matmul_fwd(const void* x, const void* r,
                                 const void* prm, const void* w, void* out,
                                 int M, int K, int N, int act, int dtype,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBFloat16)
    return ptt::dispatch_fwd<__nv_bfloat16>(x, r, prm, w, out, M, K, N, act,
                                            s);
  return ptt::dispatch_fwd<float>(x, r, prm, w, out, M, K, N, act, s);
}

// As the forward, plus prm4 [4, K] f32 (mean, inv, gamma, beta), dO [M, N];
// writes dx [M, K], dr [M, K] (when r is given), dw [K, N] in w's type,
// dgb [2, K] f32 (dgamma, dbeta), using dw_part [splits, K, N] and
// gb_part [ceil(M / 64), 2, K] f32 scratch.
extern "C" int ptt_bn_matmul_bwd(const void* x, const void* r,
                                 const void* prm, const void* prm4,
                                 const void* w, const void* dout, void* dx,
                                 void* dr, void* dw, void* dw_part,
                                 void* gb_part, void* dgb, int M, int K,
                                 int N, int splits, int chunk, int act,
                                 int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* dwp = static_cast<float*>(dw_part);
  auto* gbp = static_cast<float*>(gb_part);
  auto* gb = static_cast<float*>(dgb);
  if (dtype == ptt::kBFloat16)
    return ptt::dispatch_bwd<__nv_bfloat16>(x, r, prm, prm4, w, dout, dx, dr,
                                            dw, dwp, gbp, gb, M, K, N, splits,
                                            chunk, act, s);
  return ptt::dispatch_bwd<float>(x, r, prm, prm4, w, dout, dx, dr, dw, dwp,
                                  gbp, gb, M, K, N, splits, chunk, act, s);
}
