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
// channels (bn_mma.cuh's tile product for K13 and K15 in bf16,
// bn_gemm.cuh's for K14 and the f32 instances).
//
// K13 (f32): each block computes a 64-pixel x 64-channel tile of the
// output; the A slab is gathered from X through the prologue as it is
// staged, with the padding applied AFTER the prologue (an out-of-image tap
// is 0, not act(beta - mean * gamma * inv)), and stride 2 read directly
// (Ho = (H - 1) / 2 + 1, so odd H and W work too).
// K14: the v2 design normalizes each image once into VMEM scratch and
// walks the weight in O blocks; blocks here share no scratch, so it is two
// launches: a prep pass writes the padded, normalized activation
// [N, H+2, W+2, K] in W's type once, then the tap product reads it with
// no prologue and no bounds tests, a block owning the O block the port's
// _v2_block_o picks (walked 64 channels at a time).
// K15 (f32), one C entry point, four launches: (a) dA = the transposed taps,
// rows are input pixels and the reduction runs over taps x O, an output
// pixel (h + 1 - ky) / s contributing only where it is whole and inside
// (stride 2 computed directly, no dilated dO), with the epilogue K12 shares
// (dX, dR, the dgamma / dbeta column sums per tile); (b) dW[ky,kx] = tap^T
// dO per (K tile, O tile, tap x M split), the tap recomputed through the
// prologue as it is loaded; (c) the splits summed in a fixed order into HWIO
// dW, cast once; (d) dgamma, dbeta from the tile sums.  The TPU design's
// resident dW / dgamma / dbeta accumulators became those second passes, so
// reruns are bit-reproducible.
//
// Bound on an H100: 18 M_out K O flops forward and 36 backward, far above
// the bytes at ResNet's shapes: compute-bound on paper at the bf16
// tensor-core rate.  K14 and the f32 K13 and K15 sum on the CUDA cores in
// f32 (see bn_gemm.cuh); what they keep from the TPU design is that no
// normalized activation, tap copy or dilated gradient is ever written to
// device memory (K14 writes its one padded copy by design).
//
// In bf16, K13 and K15 run their products on the tensor cores
// (bn_mma.cuh), and both begin with one prep pass (bnc_pad_prep) that
// writes the padded, normalized activation apad [N, H+2, W+2, K] in bf16,
// the prologue evaluated once per element of X (zero on the border:
// padding after the prologue).
// K13 bf16, two launches: (1) the prep pass; (2) an implicit GEMM whose A
// rows are output pixels: each (pixel, tap) is a contiguous run of K
// channels of apad at ((n (H+2) + ho s + ky) (W+2) + wo s + kx) K, staged
// 16 bytes a chunk by cp.async with no bounds test, the pixel decoded once
// per block and the tap's offset once per step; B is W[ky,kx] as a [k][o]
// tile (ldmatrix.trans); the blocks of one pixel tile adjacent in the grid
// (its apad rows come from L2 for the second O tile); the output leaves
// 16 bytes a thread through shared memory (bn_mma.cuh store_tile).
// K15 bf16, five launches: (1) the prep pass; (2) dA, an implicit
// GEMM whose A rows are input pixels: each (pixel, tap) is a contiguous
// run of O channels of dO at ((h+1-ky)/s, (w+1-kx)/s) or zero (stride 2:
// the parity test), staged 16 bytes a chunk by cp.async with zero fill,
// the pixel decoded once per block and the tap's source once per stage;
// B is W[ky,kx] as a [k][o] tile; the epilogue is K12's (bn_mma.cuh
// da_epilogue); (3) dW[ky,kx] = apad(tap)^T dO per (K tile, O tile, tap x
// M split): both operands plain 16-byte rows of apad and dO, an output
// pixel decoded once per staged chunk by multiplies (bn_mma.cuh FastDiv);
// (4), (5) the two fixed-order sums
// as above (dgamma and dbeta in f64).  The whole prologue's cost is one
// pass over X, not one per tap and O tile, and the one extra tensor is
// apad (read by dW nine times over, once per tap, mostly from L2).

#include <algorithm>

#include "bn_gemm.cuh"
#include "bn_mma.cuh"

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

// K13 and K15 in bf16 on the tensor cores (bn_mma.cuh).
using bnmma::TileRM;
using bnmma::TileRR;
using bf16 = __nv_bfloat16;

// K13 bf16 (1), K15 bf16 (1): apad[n, hp, wp, k] = prologue(X[n, hp-1,
// wp-1, k]) inside, 0 on the border, in bf16.  grid: N * (H + 2), one
// padded row a block; a thread takes 8-channel chunks of the row (16 bytes
// when VEC).
template <bool VEC>
__global__ void __launch_bounds__(256)
bnc_pad_prep(const bf16* __restrict__ x, const bf16* __restrict__ res,
             const float* __restrict__ prm, bf16* __restrict__ apad, Geom g,
             int act) {
  const int hp = blockIdx.x % (g.H + 2), n = blockIdx.x / (g.H + 2);
  const int kc = (g.K + 7) / 8, wpad = g.W + 2;
  const bool row_in = hp >= 1 && hp <= g.H;
  bf16* out = apad + (size_t)blockIdx.x * wpad * g.K;
  for (int e = threadIdx.x; e < wpad * kc; e += blockDim.x) {
    const int wp = e / kc, k0 = (e - wp * kc) * 8;
    const bool in = row_in && wp >= 1 && wp <= g.W;
    const size_t off =
        ((size_t)(n * g.H + hp - 1) * g.W + wp - 1) * g.K + k0;
    uint4 xr = make_uint4(0, 0, 0, 0), rr = xr, orr;
    bf16* xv = reinterpret_cast<bf16*>(&xr);
    bf16* rv = reinterpret_cast<bf16*>(&rr);
    bf16* ov = reinterpret_cast<bf16*>(&orr);
    if (in) {
      if constexpr (VEC) {
        xr = *reinterpret_cast<const uint4*>(x + off);
        if (res != nullptr) rr = *reinterpret_cast<const uint4*>(res + off);
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (k0 + u < g.K) {
            xv[u] = x[off + u];
            if (res != nullptr) rv[u] = res[off + u];
          }
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float v = 0.f;
      if (in && k0 + u < g.K) {
        const Chan c = chan(prm, g.K, k0 + u);
        v = pre_act(to_f(xv[u]), c.mu, c.gi, c.b);
        if (res != nullptr) v = __fadd_rn(v, to_f(rv[u]));
        if (act == 1) v = fmaxf(v, 0.f);
      }
      ov[u] = __float2bfloat16(v);
    }
    bf16* o = out + (size_t)wp * g.K + k0;
    if constexpr (VEC) {
      *reinterpret_cast<uint4*>(o) = orr;
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (k0 + u < g.K) o[u] = ov[u];
    }
  }
}

// K13 bf16 (2): A rows are output pixels (this thread's four decoded once
// to the apad offset of their top-left tap), the reduction (tap, k) in
// steps of 64 channels k within each tap through a ring of two: a chunk of
// A is 8 channels of apad at the row's offset plus the tap's, never out of
// bounds (the border is apad's zeros); B = W[tap] [K][O] as a [k][o]
// tile.  Channels past K are zero in both (the chunks' zero fill).
template <bool VEC>
struct ConvFwd {
  static constexpr bool kPost = false;
  static constexpr int kBK = 64, kStages = 2, kRows = kBK / 16;
  struct Ring {
    TileRR<kBK> a[kStages];
    TileRM<kBK> b[kStages];
  };
  TileRR<kBK>* sa;
  TileRM<kBK>* sb;
  const bf16* apad;
  const bf16* w;
  int K, O, wpad, col0, ksteps;
  size_t base[kRows];
  bool pok[kRows];
  __device__ void stage(int buf, int step) const {
    const int tap = step / ksteps;
    const int k0 = (step - tap * ksteps) * kBK;
    const int dy = tap / 3, dxx = tap - 3 * dy;
    const size_t toff = ((size_t)dy * wpad + dxx) * K + k0;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = bnmma::rr_row<kBK>(i), c = bnmma::rr_col<kBK>(i);
      const int na = pok[i] ? bnmma::chunk_len(k0 + c, K) : 0;
      bnmma::stage_chunk<VEC>(&sa[buf].v[r][c],
                              na ? apad + base[i] + toff + c : apad, na);
      const int kr = bnmma::rm_row(i), oc = bnmma::rm_col(i);
      const int k = k0 + kr;
      const int nb = k < K ? bnmma::chunk_len(col0 + oc, O) : 0;
      bnmma::stage_chunk<VEC>(
          &sb[buf].v[kr][oc],
          nb ? w + ((size_t)tap * K + k) * O + col0 + oc : w, nb);
    }
  }
  __device__ const TileRR<kBK>& a(int buf) const { return sa[buf]; }
  __device__ const TileRM<kBK>& b(int buf) const { return sb[buf]; }
};

// K15 bf16 (2): A rows are input pixels (this thread's four decoded
// once), the reduction (tap, o) in steps of 64 channels o within each tap
// through a ring of two; B = W[tap] [K][O] rows k.
template <bool VEC>
struct ConvDA {
  static constexpr bool kPost = false;
  static constexpr int kBK = 64, kStages = 2, kRows = kBK / 16;
  TileRR<kBK>* sa;
  TileRR<kBK>* sb;
  const bf16* dout;
  const bf16* w;
  Geom g;
  int col0, osteps;
  int pn[kRows], ph[kRows], pw[kRows];
  bool pok[kRows];
  __device__ void stage(int buf, int step) const {
    const int tap = step / osteps;
    const int o0 = (step - tap * osteps) * kBK;
    const int dy = tap / 3, dxx = tap - 3 * dy;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = bnmma::rr_row<kBK>(i), c = bnmma::rr_col<kBK>(i);
      int ho = ph[i] + 1 - dy, wo = pw[i] + 1 - dxx;
      bool v = pok[i] && ho >= 0 && wo >= 0;
      if (g.s == 2) {
        v = v && !((ho | wo) & 1);
        ho >>= 1;
        wo >>= 1;
      }
      v = v && ho < g.Ho && wo < g.Wo;
      const int na = v ? bnmma::chunk_len(o0 + c, g.O) : 0;
      bnmma::stage_chunk<VEC>(
          &sa[buf].v[r][c],
          na ? dout + ((size_t)(pn[i] * g.Ho + ho) * g.Wo + wo) * g.O + o0 + c
             : dout,
          na);
      const int k = col0 + r;
      const int nb = k < g.K ? bnmma::chunk_len(o0 + c, g.O) : 0;
      bnmma::stage_chunk<VEC>(
          &sb[buf].v[r][c],
          nb ? w + ((size_t)tap * g.K + k) * g.O + o0 + c : w, nb);
    }
  }
  __device__ const TileRR<kBK>& a(int buf) const { return sa[buf]; }
  __device__ const TileRR<kBK>& b(int buf) const { return sb[buf]; }
};

// K15 bf16 (3): A^T rows are output pixels m of one tap, read from apad at
// (n, ho*s + ky, wo*s + kx), B = dO [m][o]; the reduction m in [r_begin,
// r_end), 64 a step through a ring of two.
template <bool VEC>
struct ConvDW {
  static constexpr bool kPost = false;
  static constexpr int kBK = 64, kStages = 2;
  TileRM<kBK>* sa;
  TileRM<kBK>* sb;
  const bf16* apad;
  const bf16* dout;
  Geom g;
  bnmma::FastDiv div_wo, div_ho;
  int dy, dxx, row0, col0, r_begin, r_end;
  __device__ void stage(int buf, int step) const {
    const int m0 = r_begin + step * kBK;
#pragma unroll
    for (int i = 0; i < kBK / 16; ++i) {
      const int r = bnmma::rm_row(i), c = bnmma::rm_col(i);
      const int m = m0 + r;
      const bool ok = m < r_end;
      int na = 0, nd = 0;
      const bf16* pa = apad;
      const bf16* pd = dout;
      if (ok) {
        const int t = div_wo.div(m), wo = m - t * g.Wo;
        const int n = div_ho.div(t), ho = t - n * g.Ho;
        na = bnmma::chunk_len(row0 + c, g.K);
        pa = apad + ((size_t)(n * (g.H + 2) + ho * g.s + dy) * (g.W + 2) +
                     wo * g.s + dxx) * g.K + row0 + c;
        nd = bnmma::chunk_len(col0 + c, g.O);
        pd = dout + (size_t)m * g.O + col0 + c;
      }
      bnmma::stage_chunk<VEC>(&sa[buf].v[r][c], na ? pa : apad, na);
      bnmma::stage_chunk<VEC>(&sb[buf].v[r][c], nd ? pd : dout, nd);
    }
  }
  __device__ const TileRM<kBK>& a(int buf) const { return sa[buf]; }
  __device__ const TileRM<kBK>& b(int buf) const { return sb[buf]; }
};

// K13 bf16 (2). grid: ceil(N*Ho*Wo / 64) * ceil(O / 64), block b = pixel
// tile b / tiles_o, O tile b % tiles_o.
template <bool VEC>
__global__ void __launch_bounds__(bnmma::kThreads)
bnc_fwd_mma(const bf16* __restrict__ apad, const bf16* __restrict__ w,
            bf16* __restrict__ out, Geom g) {
  using Op = ConvFwd<VEC>;
  __shared__ __align__(16) bnmma::OutSmem<typename Op::Ring> sm;
  const int rows = g.N * g.Ho * g.Wo;
  const int tiles_o = (g.O + bnmma::kBN - 1) / bnmma::kBN;
  const int mt = blockIdx.x / tiles_o, ot = blockIdx.x - mt * tiles_o;
  const int row0 = mt * bnmma::kBM, col0 = ot * bnmma::kBN;
  const int ksteps = (g.K + Op::kBK - 1) / Op::kBK;
  Op op{sm.ring.a, sm.ring.b, apad, w, g.K, g.O, g.W + 2, col0, ksteps,
        {}, {}};
#pragma unroll
  for (int i = 0; i < Op::kRows; ++i) {
    const int p = row0 + bnmma::rr_row<Op::kBK>(i);
    const int wo = p % g.Wo, t = p / g.Wo;
    const int n = t / g.Ho, ho = t - n * g.Ho;
    op.base[i] =
        ((size_t)(n * (g.H + 2) + ho * g.s) * (g.W + 2) + wo * g.s) * g.K;
    op.pok[i] = p < rows;
  }
  float acc[2][4][4];
  bnmma::mma_loop(acc, op, 9 * ksteps);
  bnmma::store_tile<VEC>(acc, sm.c, out, row0, rows, col0, g.O);
}

// K15 bf16 (2). grid: ceil(N*H*W / 64) * ceil(K / 64), block b = pixel
// tile b / tiles_k, K tile b % tiles_k.
template <bool VEC>
__global__ void __launch_bounds__(bnmma::kThreads)
bnc_bwd_da_mma(const bf16* __restrict__ x, const bf16* __restrict__ res,
               const float* __restrict__ prm4, const bf16* __restrict__ w,
               const bf16* __restrict__ dout, bf16* __restrict__ dx,
               bf16* __restrict__ dr, float* __restrict__ gb_part, Geom g,
               int act) {
  using Op = ConvDA<VEC>;
  __shared__ __align__(16) bnmma::DaSmem<Op::kBK, Op::kStages> sm;
  const int rows = g.N * g.H * g.W;
  const int tiles_k = (g.K + bnmma::kBN - 1) / bnmma::kBN;
  const int mt = blockIdx.x / tiles_k, kt = blockIdx.x - mt * tiles_k;
  const int row0 = mt * bnmma::kBM, col0 = kt * bnmma::kBN;
  const int osteps = (g.O + Op::kBK - 1) / Op::kBK;
  Op op{sm.ring.a, sm.ring.b, dout, w, g, col0, osteps, {}, {}, {}, {}};
#pragma unroll
  for (int i = 0; i < Op::kRows; ++i) {
    const int p = row0 + bnmma::rr_row<Op::kBK>(i);
    const int wq = p % g.W, t = p / g.W;
    op.pn[i] = t / g.H;
    op.ph[i] = t % g.H;
    op.pw[i] = wq;
    op.pok[i] = p < rows;
  }
  float acc[2][4][4];
  bnmma::mma_loop(acc, op, 9 * osteps);
  bnmma::da_epilogue<VEC>(acc, x, res, prm4, dx, dr, gb_part, mt, row0,
                          rows, col0, g.K, act, sm);
}

// K15 bf16 (3). grid: (ceil(K / 64), ceil(O / 64), 9 * splits), z = tap *
// splits + split, as bnc_bwd_dw.
template <bool VEC>
__global__ void __launch_bounds__(bnmma::kThreads)
bnc_bwd_dw_mma(const bf16* __restrict__ apad, const bf16* __restrict__ dout,
               float* __restrict__ part, Geom g, bnmma::FastDiv div_wo,
               bnmma::FastDiv div_ho, int splits, int chunk) {
  using Op = ConvDW<VEC>;
  __shared__ __align__(16) TileRM<Op::kBK> sa[Op::kStages];
  __shared__ __align__(16) TileRM<Op::kBK> sb[Op::kStages];
  const int z = blockIdx.z, tap = z / splits, sp = z - tap * splits;
  const int m_out = g.N * g.Ho * g.Wo;
  const int r_begin = sp * chunk, r_end = min(m_out, r_begin + chunk);
  const int row0 = blockIdx.x * bnmma::kBM, col0 = blockIdx.y * bnmma::kBN;
  Op op{sa, sb, apad, dout, g, div_wo, div_ho, tap / 3, tap % 3, row0,
        col0, r_begin, r_end};
  float acc[2][4][4];
  bnmma::mma_loop(acc, op, (r_end - r_begin + Op::kBK - 1) / Op::kBK);
  bnmma::store_part<VEC>(acc, part + (size_t)z * g.K * g.O, row0, g.K, col0,
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

template <bool VEC>
cudaError_t fwd_mma(const void* x, const void* r, const void* prm,
                    const void* w, void* apad, void* out, Geom g, int act,
                    cudaStream_t stream) {
  bf16* ap = static_cast<bf16*>(apad);
  bnc_pad_prep<VEC><<<g.N * (g.H + 2), 256, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(r),
      static_cast<const float*>(prm), ap, g, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)ceil_div(g.N * g.Ho * g.Wo, bnmma::kBM) *
                           ceil_div(g.O, bnmma::kBN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  bnc_fwd_mma<VEC><<<(int)blocks, bnmma::kThreads, 0, stream>>>(
      ap, static_cast<const bf16*>(w), static_cast<bf16*>(out), g);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t bwd_mma(const void* x, const void* r, const void* prm,
                    const void* prm4, const void* w, const void* dout,
                    void* dx, void* dr, void* dw, float* dw_part,
                    float* gb_part, float* dgb, void* apad, Geom g,
                    int splits, int chunk, int act, cudaStream_t stream) {
  const bf16* xt = static_cast<const bf16*>(x);
  const bf16* rt = static_cast<const bf16*>(r);
  const bf16* dot = static_cast<const bf16*>(dout);
  bf16* ap = static_cast<bf16*>(apad);
  const int tiles_m = ceil_div(g.N * g.H * g.W, bnmma::kBM);
  const long long blocks = (long long)tiles_m * ceil_div(g.K, bnmma::kBN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  bnc_bwd_da_mma<VEC><<<(int)blocks, bnmma::kThreads, 0, stream>>>(
      xt, rt, static_cast<const float*>(prm4), static_cast<const bf16*>(w),
      dot, static_cast<bf16*>(dx), static_cast<bf16*>(dr), gb_part, g, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bnc_pad_prep<VEC><<<g.N * (g.H + 2), 256, 0, stream>>>(
      xt, rt, static_cast<const float*>(prm), ap, g, act);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bnc_bwd_dw_mma<VEC><<<dim3(ceil_div(g.K, bnmma::kBM),
                             ceil_div(g.O, bnmma::kBN), 9 * splits),
                        bnmma::kThreads, 0, stream>>>(
      ap, dot, dw_part, g, bnmma::fast_div(g.Wo), bnmma::fast_div(g.Ho),
      splits, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = launch_sum_splits<bf16>(dw_part, static_cast<bf16*>(dw), 9, splits,
                                g.K * g.O, stream);
  if (err != cudaSuccess) return err;
  return bnmma::launch_sum_tiles_f64(gb_part, dgb, tiles_m, 2 * g.K, stream);
}

}  // namespace
}  // namespace ptt

// x, r [N, H, W, K] (r may be null), prm [3, K] f32 (mean, gamma * inv,
// beta), w [3, 3, K, O] (HWIO), out [N, Ho, Wo, O]; act 1 = relu.  For
// bf16, apad [N, H+2, W+2, K] bf16 scratch (null for f32).
extern "C" int ptt_bn_conv3x3_fwd(const void* x, const void* r,
                                  const void* prm, const void* w, void* apad,
                                  void* out, int N, int H, int W, int K,
                                  int O, int stride, int act, int dtype,
                                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const ptt::Geom g = ptt::geom(N, H, W, K, O, stride);
  if (dtype == ptt::kBFloat16) {
    // 16-byte staging and stores when every row is whole 16-byte chunks
    const bool vec = K % 8 == 0 && O % 8 == 0 && ptt::mma::aligned16(x) &&
                     (r == nullptr || ptt::mma::aligned16(r)) &&
                     ptt::mma::aligned16(w) && ptt::mma::aligned16(apad) &&
                     ptt::mma::aligned16(out);
    if (vec) return ptt::fwd_mma<true>(x, r, prm, w, apad, out, g, act, s);
    return ptt::fwd_mma<false>(x, r, prm, w, apad, out, g, act, s);
  }
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
// splits, K, O] and gb_part [ceil(N*H*W / 64), 2, K] f32 scratch, and for
// bf16 apad [N, H+2, W+2, K] bf16 scratch (null for f32).
extern "C" int ptt_bn_conv3x3_bwd(const void* x, const void* r,
                                  const void* prm, const void* prm4,
                                  const void* w, const void* dout, void* dx,
                                  void* dr, void* dw, void* dw_part,
                                  void* gb_part, void* dgb, void* apad,
                                  int N, int H,
                                  int W, int K, int O, int stride,
                                  int splits, int chunk, int act, int dtype,
                                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const ptt::Geom g = ptt::geom(N, H, W, K, O, stride);
  auto* dwp = static_cast<float*>(dw_part);
  auto* gbp = static_cast<float*>(gb_part);
  auto* gb = static_cast<float*>(dgb);
  if (dtype == ptt::kBFloat16) {
    // 16-byte staging when every row is whole 16-byte chunks
    const bool vec = K % 8 == 0 && O % 8 == 0 && ptt::mma::aligned16(x) &&
                     (r == nullptr || ptt::mma::aligned16(r)) &&
                     ptt::mma::aligned16(w) && ptt::mma::aligned16(dout) &&
                     ptt::mma::aligned16(apad);
    if (vec)
      return ptt::bwd_mma<true>(x, r, prm, prm4, w, dout, dx, dr, dw, dwp,
                                gbp, gb, apad, g, splits, chunk, act, s);
    return ptt::bwd_mma<false>(x, r, prm, prm4, w, dout, dx, dr, dw, dwp,
                               gbp, gb, apad, g, splits, chunk, act, s);
  }
  return ptt::bwd<float>(x, r, prm, prm4, w, dout, dx, dr, dw, dwp, gbp, gb,
                         g, splits, chunk, act, s);
}
