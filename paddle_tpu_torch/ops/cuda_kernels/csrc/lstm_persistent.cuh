// The LSTM time loop as one persistent launch a call (K7, and K8's loop),
// and K8's weight gradient in bf16 on the tensor cores.  Replaces the
// Pallas kernels lstm_forward and lstm_backward of
// paddle_tpu/ops/pallas_kernels/lstm.py (see lstm.cu for the contract and
// the step route these take over from where the grid fits).
//
// What bounds a call is the chain of T dependent steps: a step's products
// (16 x 64 x H a block) are far too small to fill the card, so the design
// shortens the chain's links.  At path A's shape (B 64, T 96, H 512, bf16)
// on an H100 the step route spent 20 us a forward step, 1.8 of them the
// launch gap and about 15 the reads of W and the state (tools/time_lstm.py
// --split); here W is read once a call and a step is a group barrier, a
// read of 16 rows of the exchanged state from L2 and a small product.
//
// A block owns a slice of 16 hidden columns j, that is the 64 gate columns
// j, H+j, 2H+j, 3H+j, for the whole call, and runs the time loop of a
// batch group of 16 rows at a time (the grid, the group barrier, the
// staging and the warps' products are persistent.cuh's, which the GRU's
// loops share).  What stays in the block:
// - its slice of W in shared memory (the forward's, and the backward's
//   gate recompute, W[:, gate columns]; the backward's dh product
//   W[j, :]), read from device memory once a call;
// - while it runs a group, the f32 carry of its own (row, column) pairs,
//   in the registers of the thread that owns the pair (thread tid: row
//   tid / 16, column tid % 16).
//
// Only the product needs the rest of the group, and it reads what the
// kernel has written to device memory anyway:
// - forward: the operand of step t is round(h_{t-1}) in the weight's
//   type, which is bit for bit hs[:, t-1] (and h0 at t = 0: hs, h0 and w
//   share one type), so step t reads its group's rows of hs[:, t-1];
// - backward: dh_{t-1} = (1 - m) dh_acc + round(dg_t) W^T over all 4H gate
//   columns, and round(dg_t) is dx[:, t], so step t's dh product reads its
//   group's rows of dx[:, t].
// A row is written once and never again, so the one exchange a step needs
// is one arrival a block at the group's barrier.
//
// The backward does not recompute the gates inside the loop: the gate
// pre-activations x_t + round(h_{t-1}) W depend on saved states only, so
// a prologue computes them for every step, a warp a step, into the f32
// gate-gradient buffer (dg32 for bf16, dx itself for f32), and the loop
// overwrites each with dg.  So the two W slices are never needed at once:
// the prologue holds W[:, gate columns], the loop W[j, :], in the same
// shared memory, and f32 fits (128 KiB each at H 512) where both together
// would not.
#pragma once

#include "bn_mma.cuh"
#include "persistent.cuh"

namespace ptt {
namespace {
namespace lstm_p {

using namespace rnn_p;

constexpr int kGateCols = 4 * kCols;   // gate columns of a slice
// W[:, gate cols] row stride
template <typename T>
__host__ __device__ constexpr int ldw() {
  return kGateCols + Cfg<T>::E;
}

// W[j, :] row stride: 4H rounded up to whole chunks, plus 16 bytes, so
// that the eight rows of an ldmatrix fall in distinct banks
template <typename T>
__host__ __device__ constexpr int ldr(int h) {
  return chunks(4 * h, Cfg<T>::KC) * Cfg<T>::KC + Cfg<T>::E;
}

template <typename T>
__host__ __device__ constexpr size_t wc_bytes(int h) {
  return (size_t)chunks(h, Cfg<T>::KC) * Cfg<T>::KC * ldw<T>() * sizeof(T);
}

template <typename T>
__host__ __device__ constexpr size_t wr_bytes(int h) {
  return (size_t)kRows * ldr<T>(h) * sizeof(T);
}

constexpr size_t kRedBytes = (size_t)kWarps * kRows * kGateCols * sizeof(float);

// dynamic shared memory of a block: the W region, the warps' staging
// buffers, the partial tiles
template <typename T>
__host__ __device__ constexpr size_t w_bytes(int h, bool backward) {
  return backward && wr_bytes<T>(h) > wc_bytes<T>(h) ? wr_bytes<T>(h)
                                                     : wc_bytes<T>(h);
}
template <typename T>
size_t smem_bytes(int h, bool backward) {
  return w_bytes<T>(h, backward) + stage_bytes<T>(backward) + kRedBytes;
}

// W[:, gate columns] of slice j0 into wc (Kp x ldw), zero past H
template <typename T>
__device__ __forceinline__ void load_wc(T* wc, const T* __restrict__ w,
                                        int j0, int h) {
  using C = Cfg<T>;
  const int kp = chunks(h, C::KC) * C::KC;
  for (int e = threadIdx.x; e < kp * kGateCols; e += kThreads) {
    const int k = e / kGateCols, c = e % kGateCols;
    const int j = j0 + c % kCols;
    wc[k * ldw<T>() + c] = k < h && j < h ? w[(size_t)k * 4 * h + (c / kCols) * h + j]
                                          : from_f<T>(0.f);
  }
}

// W[j0 .. j0 + 15, :] into wr (16 x ldr), zero past H and 4H
template <typename T>
__device__ __forceinline__ void load_wr(T* wr, const T* __restrict__ w,
                                        int j0, int h) {
  const int ld = ldr<T>(h), n = ld - Cfg<T>::E;
  for (int e = threadIdx.x; e < kRows * n; e += kThreads) {
    const int r = e / n, c = e % n;
    const int j = j0 + r;
    wr[r * ld + c] = j < h && c < 4 * h ? w[(size_t)j * 4 * h + c] : from_f<T>(0.f);
  }
}

// Forward, the whole time loop.  grid: (ceil(H / 16), grid rows); grid
// row y serves batch groups y, y + rows, ... one after another.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_persistent(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ h0, const T* __restrict__ c0,
                    T* hs, T* __restrict__ cs, T* __restrict__ h_last,
                    T* __restrict__ c_last, const int* __restrict__ lengths,
                    unsigned* counters, int batch, int t_len, int h,
                    int vec_h) {
  using C = Cfg<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NBUF = nbuf<T>(false);
  T* wc = reinterpret_cast<T*>(smem);
  T* buf = reinterpret_cast<T*>(smem + w_bytes<T>(h, false)) +
           (threadIdx.x >> 5) * NBUF * kRows * C::LDA;
  float* red = reinterpret_cast<float*>(smem + w_bytes<T>(h, false) +
                                        stage_bytes<T>(false));
  const int warp = threadIdx.x >> 5, slices = gridDim.x;
  const int j0 = blockIdx.x * kCols;
  const int r = threadIdx.x / kCols, jj = threadIdx.x % kCols;
  const int j = j0 + jj;
  const int nsub = chunks(h, C::KC);
  const int s0 = warp * nsub / kWarps, s1 = (warp + 1) * nsub / kWarps;
  load_wc(wc, w, j0, h);
  __syncthreads();
  const int groups = (batch + kRows - 1) / kRows;
  for (int grp = blockIdx.y; grp < groups; grp += gridDim.y) {
    const int b0 = grp * kRows, b = b0 + r;
    const bool own = b < batch && j < h;
    const size_t s = (size_t)b * h + j;
    float hc = own ? to_f(h0[s]) : 0.f, cc = own ? to_f(c0[s]) : 0.f;
    const int len = own ? lengths[b] : 0;
    unsigned* counter = counters + grp;
    for (int t = 0; t < t_len; ++t) {
      const size_t row = (size_t)b * t_len + t;
      float xg[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        xg[g] = own ? to_f(x[row * 4 * h + g * h + j]) : 0.f;
      if (t > 0) group_wait(counter, slices * t);
      GateTile<T, kGateCols> tile;
      tile.zero();
      warp_stream<NBUF>(
          buf, prev_rows(h0, hs, b0, batch, t, t_len, h, vec_h != 0), s0, s1,
          [&](const T* a, int sc) { tile.mul_add(a, wc, ldw<T>(), sc * C::KC); });
      float* mine = red + warp * kRows * kGateCols;
      tile.each(
          [&](int rr, int cl, float v) { mine[rr * kGateCols + cl] = v; });
      __syncthreads();
      if (own) {
        float gs[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float acc = 0.f;
#pragma unroll
          for (int k = 0; k < kWarps; ++k)
            acc += red[(k * kRows + r) * kGateCols + g * kCols + jj];
          gs[g] = acc + xg[g];
        }
        if (t < len) {
          const float gi = sigmoidf(gs[0]), gf = sigmoidf(gs[1]);
          const float gc = tanhf(gs[2]), go = sigmoidf(gs[3]);
          cc = gf * cc + gi * gc;
          hc = go * tanhf(cc);
        }
        hs[row * h + j] = from_f<T>(hc);
        cs[row * h + j] = from_f<T>(cc);
        if (t == t_len - 1) {
          h_last[s] = from_f<T>(hc);
          c_last[s] = from_f<T>(cc);
        }
      }
      group_arrive(counter);
    }
  }
}

// Backward, the whole time loop (dW is a second launch).  g32 [B,T,4H] f32
// takes the gate pre-activations from the prologue and then dg: dg32 for
// bf16, dx itself for f32 (then dx and g32 are one buffer).
// grid: (ceil(H / 16), grid rows); grid row y serves batch groups y,
// y + rows, ...: first the prologue of all of them, then their loops one
// after another.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_persistent(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ h0, const T* __restrict__ c0,
                    const T* __restrict__ hs, const T* __restrict__ cs,
                    const T* __restrict__ dhs, const T* __restrict__ dcs,
                    float* __restrict__ dh_out, float* __restrict__ dc_out,
                    T* dx, float* g32, const int* __restrict__ lengths,
                    unsigned* counters, int batch, int t_len, int h,
                    int vec_h, int vec_dx) {
  using C = Cfg<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NBUF = nbuf<T>(true);
  T* wsm = reinterpret_cast<T*>(smem);
  T* buf = reinterpret_cast<T*>(smem + w_bytes<T>(h, true)) +
           (threadIdx.x >> 5) * NBUF * kRows * C::LDA;
  float* red = reinterpret_cast<float*>(smem + w_bytes<T>(h, true) +
                                        stage_bytes<T>(true));
  const int warp = threadIdx.x >> 5, slices = gridDim.x;
  const int j0 = blockIdx.x * kCols;
  const int h4 = 4 * h;
  const int groups = (batch + kRows - 1) / kRows;
  const int my_groups = (groups - blockIdx.y + gridDim.y - 1) / gridDim.y;

  // prologue: g32[b, t, gate column] = x + round(h_{t-1}) W, a warp a
  // (group, step)
  load_wc(wsm, w, j0, h);
  __syncthreads();
  const int nsub = chunks(h, C::KC);
  for (int q = warp; q < my_groups * t_len; q += kWarps) {
    const int b0 = (blockIdx.y + q / t_len * gridDim.y) * kRows;
    const int t = q % t_len;
    GateTile<T, kGateCols> tile;
    tile.zero();
    warp_stream<NBUF>(
        buf, prev_rows(h0, hs, b0, batch, t, t_len, h, vec_h != 0), 0, nsub,
        [&](const T* a, int sc) { tile.mul_add(a, wsm, ldw<T>(), sc * C::KC); });
    tile.each([&](int rr, int cl, float v) {
      const int bb = b0 + rr, jc = j0 + cl % kCols;
      if (bb < batch && jc < h) {
        const size_t o = ((size_t)bb * t_len + t) * h4 + (cl / kCols) * h + jc;
        g32[o] = v + to_f(x[o]);
      }
    });
  }
  __syncthreads();
  load_wr(wsm, w, j0, h);
  __syncthreads();

  const int r = threadIdx.x / kCols, jj = threadIdx.x % kCols;
  const int j = j0 + jj;
  const int ld = ldr<T>(h);
  const int nsub4 = chunks(h4, C::KC);
  const int s0 = warp * nsub4 / kWarps, s1 = (warp + 1) * nsub4 / kWarps;
  for (int grp = blockIdx.y; grp < groups; grp += gridDim.y) {
    const int b0 = grp * kRows, b = b0 + r;
    const bool own = b < batch && j < h;
    const int len = own ? lengths[b] : 0;
    unsigned* counter = counters + grp;
    // step t's inputs of the gate gradients, none of which the barrier
    // guards: the next step's are loaded before this step's barrier
    struct StepIn {
      float g[4], c_prev, dh_t, dc_t;
    };
    auto load_step = [&](int t) {
      StepIn in{};
      if (own) {
        const size_t row = (size_t)b * t_len + t, o = row * h4 + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) in.g[g] = ldcg_f(g32 + o + g * h);
        in.c_prev = t == 0 ? to_f(c0[(size_t)b * h + j])
                           : to_f(cs[(row - 1) * h + j]);
        in.dh_t = to_f(dhs[row * h + j]);
        in.dc_t = to_f(dcs[row * h + j]);
      }
      return in;
    };
    float dh = 0.f, dc = 0.f;
    StepIn next = load_step(t_len - 1);
    for (int t = t_len - 1; t >= 0; --t) {
      const StepIn in = next;
      float dh_acc = 0.f, m = 0.f;
      if (own) {
        const size_t o = ((size_t)b * t_len + t) * h4 + j;
        const float gi = sigmoidf(in.g[0]), gf = sigmoidf(in.g[1]);
        const float gu = tanhf(in.g[2]), go = sigmoidf(in.g[3]);
        const float c_prev = in.c_prev;
        const float tc = tanhf(gf * c_prev + gi * gu);
        dh_acc = in.dh_t + dh;
        const float dc_acc = in.dc_t + dc;
        m = t < len ? 1.f : 0.f;
        const float dh_raw = m * dh_acc;
        const float dc_raw = m * dc_acc + dh_raw * go * (1.f - tc * tc);
        const float dg[4] = {dc_raw * gu * gi * (1.f - gi),
                             dc_raw * c_prev * gf * (1.f - gf),
                             dc_raw * gi * (1.f - gu * gu),
                             dh_raw * tc * go * (1.f - go)};
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          dx[o + g * h] = from_f<T>(dg[g]);
          if (static_cast<void*>(g32) != static_cast<void*>(dx))
            g32[o + g * h] = dg[g];
        }
        dc = (1.f - m) * dc_acc + dc_raw * gf;
      }
      group_arrive(counter);
      if (t > 0) next = load_step(t - 1);
      group_wait(counter, slices * (t_len - t));
      // dh = (1 - m) dh_acc + round(dg_t) W^T over the group's rows of
      // dx[:, t]
      DhTile<T> tile;
      tile.zero();
      const Rows<T> dgr{dx + ((size_t)b0 * t_len + t) * h4,
                        (size_t)t_len * h4, min(kRows, batch - b0), h4,
                        vec_dx != 0};
      warp_stream<NBUF>(buf, dgr, s0, s1, [&](const T* a, int sc) {
        tile.mul_add(a, wsm, ld, sc * C::KC);
      });
      float* mine = red + warp * kRows * kCols;
      tile.each([&](int rr, int cl, float v) { mine[rr * kCols + cl] = v; });
      __syncthreads();
      if (own) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < kWarps; ++k)
          acc += red[(k * kRows + r) * kCols + jj];
        dh = (1.f - m) * dh_acc + acc;
      }
    }
    if (own) {
      dh_out[(size_t)b * h + j] = dh;
      dc_out[(size_t)b * h + j] = dc;
    }
  }
}

// The weight gradient of the bf16 backward on the tensor cores, after the
// loop: dw[k, n] = sum over rows r < R = B*T of h_{t-1}[r, k] dg[r, n],
// with h_{t-1} exactly bf16 (h0 or the saved hs) and dg the f32 gate
// gradients.  dg = hi + lo with hi = bf16(dg), lo = bf16(dg - hi) keeps
// 16 of its 24 bits (|dg - hi - lo| <= 2^-17 |dg|), and the products of
// bf16 values are exact, so dw = h hi + h lo is the f32 product to well
// below the bf16 rounding of the result.  bn_mma.cuh's mma_loop runs it:
// a 64 x 64 tile of dw a block, a reduction step of 32 rows r as 64
// reduction indices (the rows' h against hi, then the same h against lo),
// each step's products started from zero and added to the running sums to
// nearest (the tensor cores' own adds truncate).  A step's dg rows land in
// f32 by cp.async and are split into the bf16 B tile in place (post).
// grid: (ceil(4H / 64), ceil(H / 64)), 128 threads.
namespace dwk {

using bnmma::TileRM;
constexpr int kBK = 64, kStepRows = kBK / 2, kStages = 4;

struct Smem {
  TileRM<kBK> a[kStages], b[kStages];
  float d[kStages][kStepRows][bnmma::kBN + 4];
};

struct Op {
  static constexpr int kBK = dwk::kBK, kStages = dwk::kStages;
  static constexpr bool kPost = true;
  Smem& sm;
  const __nv_bfloat16* h0;
  const __nv_bfloat16* hs;
  const float* d;
  int rows, t_len, h, k0, n0;
  bool vec_h;

  __device__ __forceinline__ const TileRM<kBK>& a(int buf) const {
    return sm.a[buf];
  }
  __device__ __forceinline__ const TileRM<kBK>& b(int buf) const {
    return sm.b[buf];
  }
  // rows [step * 32, + 32): h_{t-1} into A rows i and 32 + i, dg into d
  __device__ __forceinline__ void stage(int buf, int step) {
    const int n4 = 4 * h;
#pragma unroll
    for (int q = 0; q < kStepRows * 8 / bnmma::kThreads; ++q) {
      const int e = threadIdx.x + q * bnmma::kThreads;
      const int i = e >> 3, c = (e & 7) * 8;
      const int r = step * kStepRows + i;
      const __nv_bfloat16* src = hs;
      int n = 0;
      if (r < rows) {
        const int bb = r / t_len, t = r % t_len;
        src = t == 0 ? h0 + (size_t)bb * h : hs + ((size_t)r - 1) * h;
        src += k0 + c;
        n = bnmma::chunk_len(k0 + c, h);
      }
      if (vec_h) {
        bnmma::stage_chunk<true>(&sm.a[buf].v[i][c], n ? src : hs, n);
        bnmma::stage_chunk<true>(&sm.a[buf].v[kStepRows + i][c],
                                 n ? src : hs, n);
      } else {
        bnmma::stage_chunk<false>(&sm.a[buf].v[i][c], src, n);
        bnmma::stage_chunk<false>(&sm.a[buf].v[kStepRows + i][c], src, n);
      }
    }
#pragma unroll
    for (int q = 0; q < kStepRows * 16 / bnmma::kThreads; ++q) {
      const int e = threadIdx.x + q * bnmma::kThreads;
      const int i = e >> 4, c = (e & 15) * 4;
      const int r = step * kStepRows + i;
      const bool ok = r < rows && n0 + c < n4;
      mma::cp_async16(&sm.d[buf][i][c], ok ? d + (size_t)r * n4 + n0 + c : d,
                      ok);
    }
  }
  // dg -> (hi, lo) into B rows i and 32 + i, four columns a thread
  __device__ __forceinline__ void post(int buf, int) {
#pragma unroll
    for (int q = 0; q < kStepRows * bnmma::kBN / 4 / bnmma::kThreads; ++q) {
      const int e = threadIdx.x + q * bnmma::kThreads;
      const int i = e >> 4, c = (e & 15) * 4;
      const float4 v = *reinterpret_cast<const float4*>(&sm.d[buf][i][c]);
      const uint32_t h01 = mma::pack_bf16(v.x, v.y);
      const uint32_t h23 = mma::pack_bf16(v.z, v.w);
      const uint32_t l01 = mma::pack_bf16(v.x - mma::bf16_lo(h01),
                                          v.y - mma::bf16_hi(h01));
      const uint32_t l23 = mma::pack_bf16(v.z - mma::bf16_lo(h23),
                                          v.w - mma::bf16_hi(h23));
      *reinterpret_cast<uint2*>(&sm.b[buf].v[i][c]) = make_uint2(h01, h23);
      *reinterpret_cast<uint2*>(&sm.b[buf].v[kStepRows + i][c]) =
          make_uint2(l01, l23);
    }
  }
};

__global__ void __launch_bounds__(bnmma::kThreads)
lstm_dw_mma(const __nv_bfloat16* __restrict__ h0,
            const __nv_bfloat16* __restrict__ hs, const float* __restrict__ d,
            __nv_bfloat16* __restrict__ dw, int rows, int t_len, int h,
            int vec_h) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem& sm = *reinterpret_cast<Smem*>(smem);
  const int n0 = blockIdx.x * bnmma::kBN, k0 = blockIdx.y * bnmma::kBM;
  Op op{sm, h0, hs, d, rows, t_len, h, k0, n0, vec_h != 0};
  float acc[2][4][4];
  bnmma::mma_loop(acc, op, (rows + kStepRows - 1) / kStepRows);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int k = k0 + wr + mi * 16 + g + 8 * hh;
      if (k >= h) continue;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int n = n0 + wc + nj * 8 + 2 * t + u;
          if (n < 4 * h)
            dw[(size_t)k * 4 * h + n] = __float2bfloat16(acc[mi][nj][2 * hh + u]);
        }
    }
}

}  // namespace dwk

}  // namespace lstm_p
}  // namespace
}  // namespace ptt
