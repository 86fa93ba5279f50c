// The fused BatchNorm(+residual)+act -> 3x3 convolution (pad 1, stride 1
// or 2, NHWC, HWIO weights) for Hopper (sm_90a): the forward (K13), its
// O-blocked variant (K14) and the backward (K15).
//
// Replaces the Pallas TPU kernels bn_conv3x3_fwd, bn_conv3x3_fwd_v2 and
// bn_conv3x3_bwd (paddle_tpu/ops/pallas_kernels/bn_conv.py: _fwd_body,
// _fwd_body_v2, _bwd_body).  Those hold a whole image and the whole weight
// in VMEM and sum nine shifted [H*W, K] x [K, O] products per image.  Here
// the convolution is an implicit GEMM: rows are output pixels, columns
// output channels, and the reduction runs over the nine taps x K input
// channels (bn_gemm.cuh's tile product).
//
// K13: each block computes a 64-pixel x 64-channel tile of the output; the
// A slab is gathered from X through the prologue as it is staged, with the
// padding applied AFTER the prologue (an out-of-image tap is 0, not
// act(beta - mean * gamma * inv)), and stride 2 read directly (Ho =
// (H - 1) / 2 + 1, so odd H and W work too).
// K14: the v2 design normalizes each image once into VMEM scratch and
// walks the weight in O blocks; blocks here share no scratch, so it is two
// launches: a prep pass writes the padded, normalized activation
// [N, H+2, W+2, K] in W's type once, then the tap product reads it with
// no prologue and no bounds tests, a block owning the O block the port's
// _v2_block_o picks (walked 64 channels at a time).
// K15, one C entry point, four launches: (a) dA = the transposed taps,
// rows are input pixels and the reduction runs over taps x O, an output
// pixel (h + 1 - ky) / s contributing only where it is whole and inside
// (stride 2 computed directly, no dilated dO), with the epilogue K12
// shares (dX, dR, the dgamma / dbeta column sums per tile); (b) dW[ky,kx]
// = tap^T dO per (K tile, O tile, tap x M split), the tap recomputed
// through the prologue as it is loaded; (c) the splits summed in a fixed
// order into HWIO dW, cast once; (d) dgamma, dbeta from the tile sums.
// The TPU design's resident dW / dgamma / dbeta accumulators became those
// second passes, so reruns are bit-reproducible.
//
// Bound on an H100: 18 M_out K O flops forward and 36 backward, far above
// the bytes at ResNet's shapes: compute-bound on paper at the bf16
// tensor-core rate.  This first design sums on the CUDA cores in f32 for
// both types (see bn_gemm.cuh); what it keeps from the TPU design is that
// no normalized activation, tap copy or dilated gradient is ever written
// to device memory (K14 writes its one padded copy by design).

#include <algorithm>

#include "bn_gemm.cuh"

namespace ptt {
namespace {

struct Geom {
  int N, H, W, K, O, Ho, Wo, s;
};

struct Pix {
  int n, h, w;  // forward: h, w = the top-left tap's input row, column
};

// A(m, (tap, k)) = prologue(X[n, ho*s-1+ky, wo*s-1+kx, k]), 0 outside.
template <typename T>
struct TapA {
  using RowCtx = Pix;
  struct Red {
    int dy, dx;
    Chan c;
  };
  const T* x;
  const T* res;
  const float* prm;
  Geom g;
  int act;
  __device__ Pix row(int m) const {
    const int wo = m % g.Wo, t = m / g.Wo;
    return {t / g.Ho, (t % g.Ho) * g.s - 1, wo * g.s - 1};
  }
  __device__ Red red(int r) const {
    const int tap = r / g.K, k = r - tap * g.K;
    return {tap / 3, tap % 3, chan(prm, g.K, k)};
  }
  __device__ float get(const Pix& p, const Red& q) const {
    const int hi = p.h + q.dy, wi = p.w + q.dx;
    if (hi < 0 || hi >= g.H || wi < 0 || wi >= g.W) return 0.f;
    const size_t off = ((size_t)(p.n * g.H + hi) * g.W + wi) * g.K + q.c.k;
    return prologue(x, res, off, q.c, act);
  }
};

// K14's A from the padded, normalized scratch [N, H+2, W+2, K].
template <typename T>
struct PaddedA {
  using RowCtx = size_t;
  const T* a;
  Geom g;
  __device__ size_t row(int m) const {
    const int wo = m % g.Wo, t = m / g.Wo;
    const int n = t / g.Ho, ho = t % g.Ho;
    return ((size_t)(n * (g.H + 2) + ho * g.s) * (g.W + 2) + wo * g.s) * g.K;
  }
  __device__ size_t red(int r) const {
    const int tap = r / g.K, k = r - tap * g.K;
    return ((size_t)(tap / 3) * (g.W + 2) + tap % 3) * g.K + k;
  }
  __device__ float get(size_t a0, size_t b0) const { return to_f(a[a0 + b0]); }
};

// dA's A: rows are input pixels (n, h, w), the reduction (tap, o):
// dO[n, (h+1-ky)/s, (w+1-kx)/s, o] where that is a whole pixel of dO.
template <typename T>
struct TransTapA {
  using RowCtx = Pix;
  struct Red {
    int dy, dx, o;
  };
  const T* dout;
  Geom g;
  __device__ Pix row(int m) const {
    const int w = m % g.W, t = m / g.W;
    return {t / g.H, t % g.H, w};
  }
  __device__ Red red(int r) const {
    const int tap = r / g.O;
    return {tap / 3, tap % 3, r - tap * g.O};
  }
  __device__ float get(const Pix& p, const Red& q) const {
    int ho = p.h + 1 - q.dy, wo = p.w + 1 - q.dx;
    if (ho < 0 || wo < 0) return 0.f;
    if (g.s == 2) {
      if ((ho | wo) & 1) return 0.f;
      ho >>= 1;
      wo >>= 1;
    }
    if (ho >= g.Ho || wo >= g.Wo) return 0.f;
    return to_f(dout[((size_t)(p.n * g.Ho + ho) * g.Wo + wo) * g.O + q.o]);
  }
};

// dA's B: B((tap, o), k) = W[ky, kx, k, o].
template <typename T>
struct TapWT {
  using ColCtx = size_t;
  const T* w;
  int K, O;
  __device__ size_t red(int r) const {
    const int tap = r / O;
    return (size_t)tap * K * O + (r - tap * O);
  }
  __device__ size_t col(int k) const { return (size_t)k * O; }
  __device__ float get(size_t a, size_t b) const { return to_f(w[a + b]); }
};

// dW's A for one tap: rows k, the reduction over output pixels m:
// prologue(X[n, ho*s-1+ky, wo*s-1+kx, k]), 0 outside (offset -1).
template <typename T>
struct TapAT {
  using RowCtx = Chan;
  const T* x;
  const T* res;
  const float* prm;
  Geom g;
  int dy, dx, act;
  __device__ Chan row(int k) const { return chan(prm, g.K, k); }
  __device__ long long red(int m) const {
    const int wo = m % g.Wo, t = m / g.Wo;
    const int n = t / g.Ho, ho = t % g.Ho;
    const int hi = ho * g.s - 1 + dy, wi = wo * g.s - 1 + dx;
    if (hi < 0 || hi >= g.H || wi < 0 || wi >= g.W) return -1;
    return ((long long)(n * g.H + hi) * g.W + wi) * g.K;
  }
  __device__ float get(const Chan& c, long long off) const {
    return off < 0 ? 0.f : prologue(x, res, (size_t)off + c.k, c, act);
  }
};

template <typename T>
__device__ __forceinline__ void store_out(const float (&acc)[4][4],
                                          T* __restrict__ out, int row0,
                                          int rows, int col0, int cols,
                                          int ld) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = row0 + ty * 4 + i;
    if (m >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c < cols) out[(size_t)m * ld + c] = from_f<T>(acc[i][j]);
    }
  }
}

// K13. grid: (ceil(N*Ho*Wo / 64), ceil(O / 64)).
template <typename T>
__global__ void __launch_bounds__(kGThreads)
bnc_fwd(const T* __restrict__ x, const T* __restrict__ res,
        const float* __restrict__ prm, const T* __restrict__ w,
        T* __restrict__ out, Geom g, int act) {
  __shared__ __align__(16) GemmSmem sm;
  const int rows = g.N * g.Ho * g.Wo;
  const int row0 = blockIdx.x * kGM, col0 = blockIdx.y * kGN;
  float acc[4][4];
  gemm_tile<true, true>(acc, TapA<T>{x, res, prm, g, act},
                        StridedB<T>{w, (size_t)g.O, 1}, row0, rows, col0,
                        g.O, 0, 9 * g.K, sm);
  store_out(acc, out, row0, rows, col0, g.O, g.O);
}

// K14 (1): apad[n, hp, wp, k] = prologue(X[n, hp-1, wp-1, k]) inside, 0 on
// the border.  Grid-stride over every element of apad.
template <typename T>
__global__ void bnc_prep(const T* __restrict__ x, const T* __restrict__ res,
                         const float* __restrict__ prm, T* __restrict__ apad,
                         Geom g, int act) {
  const size_t total = (size_t)g.N * (g.H + 2) * (g.W + 2) * g.K;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int k = (int)(e % g.K);
    size_t t = e / g.K;
    const int wp = (int)(t % (g.W + 2));
    t /= (g.W + 2);
    const int hp = (int)(t % (g.H + 2));
    const int n = (int)(t / (g.H + 2));
    float v = 0.f;
    if (hp >= 1 && hp <= g.H && wp >= 1 && wp <= g.W) {
      const size_t off = ((size_t)(n * g.H + hp - 1) * g.W + wp - 1) * g.K + k;
      v = prologue(x, res, off, chan(prm, g.K, k), act);
    }
    apad[e] = from_f<T>(v);
  }
}

// K14 (2). grid: (ceil(N*Ho*Wo / 64), ceil(O / block_o)); a block walks
// its block_o channels 64 at a time.
template <typename T>
__global__ void __launch_bounds__(kGThreads)
bnc_fwd_v2(const T* __restrict__ apad, const T* __restrict__ w,
           T* __restrict__ out, Geom g, int block_o) {
  __shared__ __align__(16) GemmSmem sm;
  const int rows = g.N * g.Ho * g.Wo;
  const int row0 = blockIdx.x * kGM;
  const int c_begin = blockIdx.y * block_o;
  const int c_end = min(g.O, c_begin + block_o);
  for (int col0 = c_begin; col0 < c_end; col0 += kGN) {
    float acc[4][4];
    gemm_tile<true, true>(acc, PaddedA<T>{apad, g},
                          StridedB<T>{w, (size_t)g.O, 1}, row0, rows, col0,
                          c_end, 0, 9 * g.K, sm);
    store_out(acc, out, row0, rows, col0, c_end, g.O);
  }
}

// K15 (a). grid: (ceil(N*H*W / 64), ceil(K / 64)).
template <typename T>
__global__ void __launch_bounds__(kGThreads)
bnc_bwd_da(const T* __restrict__ x, const T* __restrict__ res,
           const float* __restrict__ prm4, const T* __restrict__ w,
           const T* __restrict__ dout, T* __restrict__ dx,
           T* __restrict__ dr, float* __restrict__ gb_part, Geom g,
           int act) {
  __shared__ __align__(16) GemmSmem sm;
  const int rows = g.N * g.H * g.W;
  const int row0 = blockIdx.x * kGM, col0 = blockIdx.y * kGN;
  float acc[4][4];
  gemm_tile<true, false>(acc, TransTapA<T>{dout, g}, TapWT<T>{w, g.K, g.O},
                         row0, rows, col0, g.K, 0, 9 * g.O, sm);
  dA_epilogue<T>(acc, x, res, prm4, dx, dr, gb_part, row0, rows, col0, g.K,
                 act, sm);
}

// K15 (b). grid: (ceil(K / 64), ceil(O / 64), 9 * splits); z = tap *
// splits + split sums output pixels [split * chunk, ...) into
// part[z][K][O].
template <typename T>
__global__ void __launch_bounds__(kGThreads)
bnc_bwd_dw(const T* __restrict__ x, const T* __restrict__ res,
           const float* __restrict__ prm, const T* __restrict__ dout,
           float* __restrict__ part, Geom g, int splits, int chunk,
           int act) {
  __shared__ __align__(16) GemmSmem sm;
  const int z = blockIdx.z, tap = z / splits, sp = z - tap * splits;
  const int m_out = g.N * g.Ho * g.Wo;
  const int r_begin = sp * chunk, r_end = min(m_out, r_begin + chunk);
  const int row0 = blockIdx.x * kGM, col0 = blockIdx.y * kGN;
  float acc[4][4];
  gemm_tile<false, true>(acc,
                         TapAT<T>{x, res, prm, g, tap / 3, tap % 3, act},
                         StridedB<T>{dout, (size_t)g.O, 1}, row0, g.K, col0,
                         g.O, r_begin, r_end, sm);
  store_partial(acc, part + (size_t)z * g.K * g.O, row0, g.K, col0, g.O,
                g.O);
}

Geom geom(int N, int H, int W, int K, int O, int s) {
  return {N, H, W, K, O, (H - 1) / s + 1, (W - 1) / s + 1, s};
}

template <typename T>
cudaError_t fwd(const void* x, const void* r, const void* prm, const void* w,
                void* out, Geom g, int act, cudaStream_t stream) {
  dim3 grid(ceil_div(g.N * g.Ho * g.Wo, kGM), ceil_div(g.O, kGN));
  bnc_fwd<T><<<grid, kGThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const float*>(prm), static_cast<const T*>(w),
      static_cast<T*>(out), g, act);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_v2(const void* x, const void* r, const void* prm,
                   const void* w, void* apad, void* out, Geom g, int block_o,
                   int act, cudaStream_t stream) {
  const size_t total = (size_t)g.N * (g.H + 2) * (g.W + 2) * g.K;
  const int blocks = (int)std::min<size_t>((total + 255) / 256, 132 * 16);
  bnc_prep<T><<<blocks, 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const float*>(prm), static_cast<T*>(apad), g, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid(ceil_div(g.N * g.Ho * g.Wo, kGM), ceil_div(g.O, block_o));
  bnc_fwd_v2<T><<<grid, kGThreads, 0, stream>>>(
      static_cast<const T*>(apad), static_cast<const T*>(w),
      static_cast<T*>(out), g, block_o);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* x, const void* r, const void* prm,
                const void* prm4, const void* w, const void* dout, void* dx,
                void* dr, void* dw, float* dw_part, float* gb_part,
                float* dgb, Geom g, int splits, int chunk, int act,
                cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(r);
  const T* dot = static_cast<const T*>(dout);
  const int tiles_m = ceil_div(g.N * g.H * g.W, kGM);
  bnc_bwd_da<T><<<dim3(tiles_m, ceil_div(g.K, kGN)), kGThreads, 0, stream>>>(
      xt, rt, static_cast<const float*>(prm4), static_cast<const T*>(w), dot,
      static_cast<T*>(dx), static_cast<T*>(dr), gb_part, g, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bnc_bwd_dw<T><<<dim3(ceil_div(g.K, kGM), ceil_div(g.O, kGN), 9 * splits),
                  kGThreads, 0, stream>>>(
      xt, rt, static_cast<const float*>(prm), dot, dw_part, g, splits, chunk,
      act);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = launch_sum_splits<T>(dw_part, static_cast<T*>(dw), 9, splits,
                             g.K * g.O, stream);
  if (err != cudaSuccess) return err;
  return launch_sum_splits<float>(gb_part, dgb, 1, tiles_m, 2 * g.K, stream);
}

}  // namespace
}  // namespace ptt

// x, r [N, H, W, K] (r may be null), prm [3, K] f32 (mean, gamma * inv,
// beta), w [3, 3, K, O] (HWIO), out [N, Ho, Wo, O]; act 1 = relu.
extern "C" int ptt_bn_conv3x3_fwd(const void* x, const void* r,
                                  const void* prm, const void* w, void* out,
                                  int N, int H, int W, int K, int O,
                                  int stride, int act, int dtype,
                                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const ptt::Geom g = ptt::geom(N, H, W, K, O, stride);
  if (dtype == ptt::kBFloat16)
    return ptt::fwd<__nv_bfloat16>(x, r, prm, w, out, g, act, s);
  return ptt::fwd<float>(x, r, prm, w, out, g, act, s);
}

// As ptt_bn_conv3x3_fwd, through the scratch apad [N, H+2, W+2, K] in w's
// type, a block owning block_o output channels.
extern "C" int ptt_bn_conv3x3_fwd_v2(const void* x, const void* r,
                                     const void* prm, const void* w,
                                     void* apad, void* out, int N, int H,
                                     int W, int K, int O, int stride,
                                     int block_o, int act, int dtype,
                                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const ptt::Geom g = ptt::geom(N, H, W, K, O, stride);
  if (dtype == ptt::kBFloat16)
    return ptt::fwd_v2<__nv_bfloat16>(x, r, prm, w, apad, out, g, block_o,
                                      act, s);
  return ptt::fwd_v2<float>(x, r, prm, w, apad, out, g, block_o, act, s);
}

// As the forward, plus prm4 [4, K] f32 (mean, inv, gamma, beta), dO [N,
// Ho, Wo, O]; writes dx, dr (when r is given) [N, H, W, K], dw [3, 3, K, O]
// in w's type and dgb [2, K] f32 (dgamma, dbeta), using dw_part [9,
// splits, K, O] and gb_part [ceil(N*H*W / 64), 2, K] f32 scratch.
extern "C" int ptt_bn_conv3x3_bwd(const void* x, const void* r,
                                  const void* prm, const void* prm4,
                                  const void* w, const void* dout, void* dx,
                                  void* dr, void* dw, void* dw_part,
                                  void* gb_part, void* dgb, int N, int H,
                                  int W, int K, int O, int stride,
                                  int splits, int chunk, int act, int dtype,
                                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const ptt::Geom g = ptt::geom(N, H, W, K, O, stride);
  auto* dwp = static_cast<float*>(dw_part);
  auto* gbp = static_cast<float*>(gb_part);
  auto* gb = static_cast<float*>(dgb);
  if (dtype == ptt::kBFloat16)
    return ptt::bwd<__nv_bfloat16>(x, r, prm, prm4, w, dout, dx, dr, dw, dwp,
                                   gbp, gb, g, splits, chunk, act, s);
  return ptt::bwd<float>(x, r, prm, prm4, w, dout, dx, dr, dw, dwp, gbp, gb,
                         g, splits, chunk, act, s);
}
