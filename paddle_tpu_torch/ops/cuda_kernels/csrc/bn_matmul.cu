// The fused BatchNorm(+residual)+act -> 1x1 convolution for Hopper
// (sm_90a): forward (K11) and backward (K12).
//
// Replaces the Pallas TPU kernels bn_matmul_fwd and bn_matmul_bwd
// (paddle_tpu/ops/pallas_kernels/bn_matmul.py: _fwd_kernel, _bwd_body).
// A 1x1 convolution in NHWC is a product [M = N*H*W, K] x [K, N_out].
//
// Forward (K11): Out = act((X - mean) * gamma * rsqrt(var + eps) + beta
// [+ R]) W.  Each block computes a 64 x 64 tile of Out; X (and R) are read
// through the prologue as the A slab is staged into shared memory, so the
// normalized activation never reaches device memory.
//
// Backward (K12), one C entry point, four launches:
//   (a) dA = dO W^T per (M tile, K tile), with the epilogue that
//       recomputes pre from X, R and the statistics, masks pre > 0, writes
//       dX = dpre * gamma * inv and dR = dpre, and writes the tile's
//       column sums of dpre * xhat and dpre (bn_gemm.cuh dA_epilogue);
//   (b) dW = A^T dO per (K tile, N tile, M split), A recomputed through
//       the prologue as it is loaded, each split's f32 sums to its own
//       slice of a partial buffer;
//   (c) the splits summed in a fixed order, cast once to W's type;
//   (d) the M tiles' column sums summed to dgamma, dbeta (f32).
// The TPU kernel carries dW, dgamma and dbeta in VMEM across a sequential
// grid; blocks here run in no order, so each resident accumulator became a
// second pass over per-block partial sums, which keeps reruns
// bit-reproducible (no atomics).  dmean and dvar follow from dgamma and
// dbeta in closed form in the wrapper, as in the JAX wrapper.
//
// Bound on an H100: 2 M K N flops forward and 4 M K N backward; at
// ResNet-50's shapes (K, N in 64..2048) the products are compute-bound on
// paper (989 TFLOP/s bf16).  This first design runs them on the CUDA cores
// in f32 (67 TFLOP/s at best, less from shared memory with 4 x 4 register
// tiles), for both input types; tensor cores (mma.sync / wgmma for bf16)
// are left for a later design.  What the design does keep: X is read, and
// A recomputed, inside the product, never written.

#include "bn_gemm.cuh"

namespace ptt {
namespace {

// A(m, k) = prologue(X[m, k]): rows m, reduction k (contiguous).
template <typename T>
struct PrologueA {
  using RowCtx = size_t;
  const T* x;
  const T* res;
  const float* prm;
  int K, act;
  __device__ size_t row(int m) const { return (size_t)m * K; }
  __device__ Chan red(int k) const { return chan(prm, K, k); }
  __device__ float get(size_t off, const Chan& c) const {
    return prologue(x, res, off + c.k, c, act);
  }
};

// A^T(k, m) = prologue(X[m, k]): rows k, reduction m (the dW product).
template <typename T>
struct PrologueAT {
  using RowCtx = Chan;
  const T* x;
  const T* res;
  const float* prm;
  int K, act;
  __device__ Chan row(int k) const { return chan(prm, K, k); }
  __device__ size_t red(int m) const { return (size_t)m * K; }
  __device__ float get(const Chan& c, size_t off) const {
    return prologue(x, res, off + c.k, c, act);
  }
};

// grid: (ceil(M / 64), ceil(N / 64)).
template <typename T>
__global__ void __launch_bounds__(kGThreads)
bnmm_fwd(const T* __restrict__ x, const T* __restrict__ res,
         const float* __restrict__ prm, const T* __restrict__ w,
         T* __restrict__ out, int M, int K, int N, int act) {
  __shared__ __align__(16) GemmSmem sm;
  const int row0 = blockIdx.x * kGM, col0 = blockIdx.y * kGN;
  float acc[4][4];
  gemm_tile<true, true>(acc, PrologueA<T>{x, res, prm, K, act},
                        StridedB<T>{w, (size_t)N, 1}, row0, M, col0, N, 0,
                        K, sm);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = row0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = col0 + tx * 4 + j;
      if (n < N) out[(size_t)m * N + n] = from_f<T>(acc[i][j]);
    }
  }
}

// (a) grid: (ceil(M / 64), ceil(K / 64)).
template <typename T>
__global__ void __launch_bounds__(kGThreads)
bnmm_bwd_da(const T* __restrict__ x, const T* __restrict__ res,
            const float* __restrict__ prm4, const T* __restrict__ w,
            const T* __restrict__ dout, T* __restrict__ dx,
            T* __restrict__ dr, float* __restrict__ gb_part, int M, int K,
            int N, int act) {
  __shared__ __align__(16) GemmSmem sm;
  const int row0 = blockIdx.x * kGM, col0 = blockIdx.y * kGN;
  float acc[4][4];
  // dA(m, k) = sum_n dO(m, n) W(k, n)
  gemm_tile<true, false>(acc, StridedA<T>{dout, (size_t)N, 1},
                         StridedB<T>{w, 1, (size_t)N}, row0, M, col0, K, 0,
                         N, sm);
  dA_epilogue<T>(acc, x, res, prm4, dx, dr, gb_part, row0, M, col0, K, act,
                 sm);
}

// (b) grid: (ceil(K / 64), ceil(N / 64), splits); split z sums m in
// [z * chunk, min((z + 1) * chunk, M)) into part[z][K][N].
template <typename T>
__global__ void __launch_bounds__(kGThreads)
bnmm_bwd_dw(const T* __restrict__ x, const T* __restrict__ res,
            const float* __restrict__ prm, const T* __restrict__ dout,
            float* __restrict__ part, int M, int K, int N, int chunk,
            int act) {
  __shared__ __align__(16) GemmSmem sm;
  const int row0 = blockIdx.x * kGM, col0 = blockIdx.y * kGN;
  const int z = blockIdx.z;
  const int r_begin = z * chunk, r_end = min(M, r_begin + chunk);
  float acc[4][4];
  gemm_tile<false, true>(acc, PrologueAT<T>{x, res, prm, K, act},
                         StridedB<T>{dout, (size_t)N, 1}, row0, K, col0, N,
                         r_begin, r_end, sm);
  store_partial(acc, part + (size_t)z * K * N, row0, K, col0, N, N);
}

template <typename T>
cudaError_t fwd(const void* x, const void* r, const void* prm, const void* w,
                void* out, int M, int K, int N, int act,
                cudaStream_t stream) {
  dim3 grid(ceil_div(M, kGM), ceil_div(N, kGN));
  bnmm_fwd<T><<<grid, kGThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const float*>(prm), static_cast<const T*>(w),
      static_cast<T*>(out), M, K, N, act);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* x, const void* r, const void* prm,
                const void* prm4, const void* w, const void* dout, void* dx,
                void* dr, void* dw, float* dw_part, float* gb_part,
                float* dgb, int M, int K, int N, int splits, int chunk,
                int act, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(r);
  const T* dot = static_cast<const T*>(dout);
  const int tiles_m = ceil_div(M, kGM);
  bnmm_bwd_da<T><<<dim3(tiles_m, ceil_div(K, kGN)), kGThreads, 0, stream>>>(
      xt, rt, static_cast<const float*>(prm4), static_cast<const T*>(w), dot,
      static_cast<T*>(dx), static_cast<T*>(dr), gb_part, M, K, N, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bnmm_bwd_dw<T><<<dim3(ceil_div(K, kGM), ceil_div(N, kGN), splits),
                   kGThreads, 0, stream>>>(
      xt, rt, static_cast<const float*>(prm), dot, dw_part, M, K, N, chunk,
      act);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = launch_sum_splits<T>(dw_part, static_cast<T*>(dw), 1, splits, K * N,
                             stream);
  if (err != cudaSuccess) return err;
  return launch_sum_splits<float>(gb_part, dgb, 1, tiles_m, 2 * K, stream);
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
    return ptt::fwd<__nv_bfloat16>(x, r, prm, w, out, M, K, N, act, s);
  return ptt::fwd<float>(x, r, prm, w, out, M, K, N, act, s);
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
    return ptt::bwd<__nv_bfloat16>(x, r, prm, prm4, w, dout, dx, dr, dw,
                                   dwp, gbp, gb, M, K, N, splits, chunk, act,
                                   s);
  return ptt::bwd<float>(x, r, prm, prm4, w, dout, dx, dr, dw, dwp, gbp, gb,
                         M, K, N, splits, chunk, act, s);
}
