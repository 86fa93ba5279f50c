// The GRU time loop as one persistent launch a call (K9, and K10's loop).
// Replaces the Pallas kernels gru_forward and gru_backward of
// paddle_tpu/ops/pallas_kernels/gru.py (see gru.cu for the contract and
// the step route these take over from where the grid fits).  The grid,
// the group barrier, the staging and the warps' products are
// persistent.cuh's, as in the LSTM's loops (lstm_persistent.cuh).
//
// A block owns a slice of 16 hidden columns j, that is the 48 gate columns
// j, H+j, 2H+j (update u, reset r, candidate), for the whole call, and
// runs the time loop of a batch group of 16 rows at a time; the f32 carry
// of its own (row, column) pairs stays in the registers of the thread
// that owns the pair (thread tid: row tid / 16, column tid % 16).
//
// A GRU step is two dependent products: the candidate takes round(r h)
// for every hidden column.  Each product's operand is a row the kernel
// writes once and never again, so both exchanges are arrivals at the
// group's one monotonic counter, two a step:
// - forward step t: (A) the rows round(h_{t-1}) = hs[:, t-1] (h0 at t = 0)
//   times W[:, u and r columns] give u and r; the owner writes
//   round(r h_{t-1}), from its f32 carry, to a scratch row rhs[:, t] and
//   arrives; (B) after the group's arrivals, the rows rhs[:, t] times
//   W[:, candidate columns] give c; the owner mixes and masks h, writes
//   hs[:, t] and arrives.  W[:, 48 columns] stays in shared memory.
// - backward: a prologue computes the state-only pre-activations of
//   every step into the f32 gradient buffer (dg32 for bf16, dx itself for
//   f32): (i) x[:, :2H] + round(h_{t-1}) W[:, :2H] and r h_{t-1} in f32
//   (rh_all, which the candidate's dW takes; its rounding is the operand
//   of (ii)), then a barrier of the grid row, then (ii) x[:, 2H:] +
//   round(r h_{t-1}) W[:, 2H:].  The loop, in reverse time: the owner
//   forms dg_u and da_c into dx[:, t] and arrives; after the group's
//   arrivals the rows dx[:, t, 2H:] times W_c[j, :]^T give drh, and the
//   rows dx[:, t, :H] times W_u[j, :]^T dh's update part (published at
//   the same barrier); the owner forms dg_r into dx[:, t, H:2H], adds
//   drh r and the update part to its carry and arrives; after the
//   group's arrivals the rows dx[:, t, H:2H] times W_r[j, :]^T close dh.
//   The prologue holds W[:, 48 columns], the loop W[j, :] (its three
//   gates' columns each padded to whole chunks), in turn in the same
//   shared memory.
#pragma once

#include "persistent.cuh"

namespace ptt {
namespace {
namespace gru_p {

using namespace rnn_p;

constexpr int kGateCols = 3 * kCols;  // gate columns of a slice

// W[:, gate cols] row stride
template <typename T>
__host__ __device__ constexpr int ldw() {
  return kGateCols + Cfg<T>::E;
}

// a gate's columns in the loop's W rows: H rounded up to whole chunks
template <typename T>
__host__ __device__ constexpr int hpad(int h) {
  return chunks(h, Cfg<T>::KC) * Cfg<T>::KC;
}

// W[j, :] row stride: three padded gates plus 16 bytes, so that the eight
// rows of an ldmatrix fall in distinct banks
template <typename T>
__host__ __device__ constexpr int ldr(int h) {
  return 3 * hpad<T>(h) + Cfg<T>::E;
}

template <typename T>
__host__ __device__ constexpr size_t wc_bytes(int h) {
  return (size_t)hpad<T>(h) * ldw<T>() * sizeof(T);
}

template <typename T>
__host__ __device__ constexpr size_t wr_bytes(int h) {
  return (size_t)kRows * ldr<T>(h) * sizeof(T);
}

// the warps' partial tiles, 16 x 32 sums a warp: the forward's u and r,
// the backward's drh and dh's update part
constexpr int kRedCols = 2 * kCols;
constexpr size_t kRedBytes = (size_t)kWarps * kRows * kRedCols * sizeof(float);

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

// W[:, gate columns] of slice j0 into wc (Kp x ldw, column c = gate * 16 +
// hidden column), zero past H
template <typename T>
__device__ __forceinline__ void load_wc(T* wc, const T* __restrict__ w,
                                        int j0, int h) {
  const int kp = hpad<T>(h);
  for (int e = threadIdx.x; e < kp * kGateCols; e += kThreads) {
    const int k = e / kGateCols, c = e % kGateCols;
    const int j = j0 + c % kCols;
    wc[k * ldw<T>() + c] =
        k < h && j < h ? w[(size_t)k * 3 * h + (c / kCols) * h + j]
                       : from_f<T>(0.f);
  }
}

// W[j0 .. j0 + 15, :] into wr (16 x ldr; gate g's column n at g * hpad +
// n), zero past H
template <typename T>
__device__ __forceinline__ void load_wr(T* wr, const T* __restrict__ w,
                                        int j0, int h) {
  const int ld = ldr<T>(h), hp = hpad<T>(h), n = 3 * hp;
  for (int e = threadIdx.x; e < kRows * n; e += kThreads) {
    const int r = e / n, c = e % n;
    const int j = j0 + r, g = c / hp, k = c % hp;
    wr[r * ld + c] = j < h && k < h ? w[(size_t)j * 3 * h + g * h + k]
                                    : from_f<T>(0.f);
  }
}

// Forward, the whole time loop.  rhs [B,T,H] in the weight's type takes
// round(r h_{t-1}), each row once.  grid: (ceil(H / 16), grid rows); grid
// row y serves batch groups y, y + rows, ... one after another.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
gru_fwd_persistent(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ h0, T* hs, T* rhs,
                   T* __restrict__ h_last, const int* __restrict__ lengths,
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
  float* mine = red + warp * kRows * kRedCols;
  load_wc(wc, w, j0, h);
  __syncthreads();
  const int groups = (batch + kRows - 1) / kRows;
  for (int grp = blockIdx.y; grp < groups; grp += gridDim.y) {
    const int b0 = grp * kRows, b = b0 + r;
    const int nrows = min(kRows, batch - b0);
    const bool own = b < batch && j < h;
    const size_t s = (size_t)b * h + j;
    float hc = own ? to_f(h0[s]) : 0.f;
    const int len = own ? lengths[b] : 0;
    unsigned* counter = counters + grp;
    for (int t = 0; t < t_len; ++t) {
      const size_t row = (size_t)b * t_len + t;
      float xg[3];
#pragma unroll
      for (int g = 0; g < 3; ++g)
        xg[g] = own ? to_f(x[row * 3 * h + g * h + j]) : 0.f;
      // (A) u and r from the rows round(h_{t-1})
      if (t > 0) group_wait(counter, 2u * slices * t);
      GateTile<T, 2 * kCols> tg;
      tg.zero();
      warp_stream<NBUF>(
          buf, prev_rows(h0, hs, b0, batch, t, t_len, h, vec_h != 0), s0, s1,
          [&](const T* a, int sc) { tg.mul_add(a, wc, ldw<T>(), sc * C::KC); });
      tg.each([&](int rr, int cl, float v) { mine[rr * kRedCols + cl] = v; });
      __syncthreads();
      float u = 0.f;
      if (own) {
        float gu = 0.f, gr = 0.f;
#pragma unroll
        for (int k = 0; k < kWarps; ++k) {
          gu += red[(k * kRows + r) * kRedCols + jj];
          gr += red[(k * kRows + r) * kRedCols + kCols + jj];
        }
        u = sigmoidf(gu + xg[0]);
        rhs[row * h + j] = from_f<T>(sigmoidf(gr + xg[1]) * hc);
      }
      group_arrive(counter);
      // (B) the candidate from the rows round(r h_{t-1})
      group_wait(counter, slices * (2u * t + 1));
      GateTile<T, kCols> tc;
      tc.zero();
      const Rows<T> rh{rhs + ((size_t)b0 * t_len + t) * h, (size_t)t_len * h,
                       nrows, h, vec_h != 0};
      warp_stream<NBUF>(buf, rh, s0, s1, [&](const T* a, int sc) {
        tc.mul_add(a, wc + 2 * kCols, ldw<T>(), sc * C::KC);
      });
      tc.each([&](int rr, int cl, float v) { mine[rr * kCols + cl] = v; });
      __syncthreads();
      if (own) {
        float gc = 0.f;
#pragma unroll
        for (int k = 0; k < kWarps; ++k)
          gc += red[k * kRows * kRedCols + r * kCols + jj];
        if (t < len) hc = u * hc + (1.f - u) * tanhf(gc + xg[2]);
        hs[row * h + j] = from_f<T>(hc);
        if (t == t_len - 1) h_last[s] = from_f<T>(hc);
      }
      group_arrive(counter);
    }
  }
}

// Backward, the whole time loop (dW is launched after it).  g32 [B,T,3H]
// f32 takes the pre-activations from the prologue and then dg: dg32 for
// bf16, dx itself for f32 (then dx and g32 are one buffer).  rh_all
// [B,T,H] f32 takes r h_{t-1}; rh_op is its rounding to the weight's type
// (bf16: a buffer of its own; f32: rh_all itself).  counters: one a batch
// group, then one a grid row (the prologue's barrier).
// grid: (ceil(H / 16), grid rows); grid row y serves batch groups y,
// y + rows, ...: first the prologue of all of them, then their loops one
// after another.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
gru_bwd_persistent(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ h0, const T* __restrict__ hs,
                   const T* __restrict__ dhs, float* __restrict__ dh_out,
                   T* dx, float* g32, float* rh_all, T* rh_op,
                   const int* __restrict__ lengths, unsigned* counters,
                   int batch, int t_len, int h, int vec_h, int vec_dx) {
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
  const int h3 = 3 * h;
  const int groups = (batch + kRows - 1) / kRows;
  const int my_groups = (groups - blockIdx.y + gridDim.y - 1) / gridDim.y;
  const int nsub = chunks(h, C::KC);
  float* mine = red + warp * kRows * kRedCols;

  // prologue (i): g32[b, t, u and r columns] = x + round(h_{t-1}) W and
  // rh_all = r h_{t-1}, a warp a (group, step)
  load_wc(wsm, w, j0, h);
  __syncthreads();
  for (int q = warp; q < my_groups * t_len; q += kWarps) {
    const int b0 = (blockIdx.y + q / t_len * gridDim.y) * kRows;
    const int t = q % t_len;
    GateTile<T, 2 * kCols> tile;
    tile.zero();
    warp_stream<NBUF>(
        buf, prev_rows(h0, hs, b0, batch, t, t_len, h, vec_h != 0), 0, nsub,
        [&](const T* a, int sc) { tile.mul_add(a, wsm, ldw<T>(), sc * C::KC); });
    tile.each([&](int rr, int cl, float v) {
      const int bb = b0 + rr, jc = j0 + cl % kCols;
      if (bb < batch && jc < h) {
        const size_t row = (size_t)bb * t_len + t;
        const size_t o = row * h3 + (cl / kCols) * h + jc;
        const float pre = v + to_f(x[o]);
        g32[o] = pre;
        if (cl >= kCols) {
          const float rh =
              sigmoidf(pre) * prev_state(h0, hs, bb, t, t_len, h, jc);
          rh_all[row * h + jc] = rh;
          if constexpr (sizeof(T) == 2) rh_op[row * h + jc] = from_f<T>(rh);
        }
      }
    });
  }
  // every slice of the grid row has written its columns of rh
  unsigned* row_counter = counters + groups + blockIdx.y;
  group_arrive(row_counter);
  group_wait(row_counter, slices);
  // prologue (ii): g32[b, t, candidate columns] = x + round(r h_{t-1}) W
  for (int q = warp; q < my_groups * t_len; q += kWarps) {
    const int b0 = (blockIdx.y + q / t_len * gridDim.y) * kRows;
    const int t = q % t_len;
    GateTile<T, kCols> tile;
    tile.zero();
    const Rows<T> rh{rh_op + ((size_t)b0 * t_len + t) * h, (size_t)t_len * h,
                     min(kRows, batch - b0), h, vec_h != 0};
    warp_stream<NBUF>(buf, rh, 0, nsub, [&](const T* a, int sc) {
      tile.mul_add(a, wsm + 2 * kCols, ldw<T>(), sc * C::KC);
    });
    tile.each([&](int rr, int cl, float v) {
      const int bb = b0 + rr, jc = j0 + cl;
      if (bb < batch && jc < h) {
        const size_t o = ((size_t)bb * t_len + t) * h3 + 2 * h + jc;
        g32[o] = v + to_f(x[o]);
      }
    });
  }
  __syncthreads();
  load_wr(wsm, w, j0, h);
  __syncthreads();

  const int r = threadIdx.x / kCols, jj = threadIdx.x % kCols;
  const int k = j0 + jj;
  const int ld = ldr<T>(h), hp = hpad<T>(h);
  // the first product's chunks: the candidate columns', then the update
  // columns'; the second's: the reset columns'
  const int s0a = warp * 2 * nsub / kWarps, s1a = (warp + 1) * 2 * nsub / kWarps;
  const int s0b = warp * nsub / kWarps, s1b = (warp + 1) * nsub / kWarps;
  const bool split = static_cast<void*>(g32) != static_cast<void*>(dx);
  for (int grp = blockIdx.y; grp < groups; grp += gridDim.y) {
    const int b0 = grp * kRows, b = b0 + r;
    const int nrows = min(kRows, batch - b0);
    const bool own = b < batch && k < h;
    const int len = own ? lengths[b] : 0;
    unsigned* counter = counters + grp;
    // step t's inputs, none of which the barrier guards: the next step's
    // are loaded before this step's first barrier
    struct StepIn {
      float g[3], hp, dh_t;
    };
    auto load_step = [&](int t) {
      StepIn in{};
      if (own) {
        const size_t row = (size_t)b * t_len + t, o = row * h3 + k;
#pragma unroll
        for (int g = 0; g < 3; ++g) in.g[g] = ldcg_f(g32 + o + g * h);
        in.hp = prev_state(h0, hs, b, t, t_len, h, k);
        in.dh_t = to_f(dhs[row * h + k]);
      }
      return in;
    };
    const size_t stride = (size_t)t_len * h3;
    float dh = 0.f;
    StepIn next = load_step(t_len - 1);
    for (int t = t_len - 1; t >= 0; --t) {
      const StepIn in = next;
      const unsigned i = t_len - 1 - t;
      const size_t o = ((size_t)b * t_len + t) * h3 + k;
      float carry = 0.f, rg = 0.f;
      if (own) {
        const float u = sigmoidf(in.g[0]), c = tanhf(in.g[2]);
        rg = sigmoidf(in.g[1]);
        const float dh_acc = in.dh_t + dh;
        const float m = t < len ? 1.f : 0.f;
        const float dh_raw = m * dh_acc;
        const float da_c = dh_raw * (1.f - u) * (1.f - c * c);
        const float dg_u = dh_raw * (in.hp - c) * u * (1.f - u);
        dx[o] = from_f<T>(dg_u);
        dx[o + 2 * h] = from_f<T>(da_c);
        if (split) {
          g32[o] = dg_u;
          g32[o + 2 * h] = da_c;
        }
        carry = (1.f - m) * dh_acc + dh_raw * u;
      }
      group_arrive(counter);
      if (t > 0) next = load_step(t - 1);
      group_wait(counter, slices * (2 * i + 1));
      // drh = round(da_c) W_c[j, :]^T and dh's update part round(dg_u)
      // W_u[j, :]^T, both over rows published at the first barrier
      const T* drow = dx + ((size_t)b0 * t_len + t) * h3;
      DhTile<T> tc, tu;
      tc.zero();
      tu.zero();
      const RowsPair<T> cu{{drow + 2 * h, stride, nrows, h, vec_dx != 0},
                           {drow, stride, nrows, h, vec_dx != 0}, nsub};
      warp_stream<NBUF>(buf, cu, s0a, s1a, [&](const T* a, int sc) {
        if (sc < nsub)
          tc.mul_add(a, wsm + 2 * hp, ld, sc * C::KC);
        else
          tu.mul_add(a, wsm, ld, (sc - nsub) * C::KC);
      });
      tc.each([&](int rr, int cl, float v) { mine[rr * kRedCols + cl] = v; });
      tu.each([&](int rr, int cl, float v) {
        mine[rr * kRedCols + kCols + cl] = v;
      });
      __syncthreads();
      if (own) {
        float drh = 0.f, dhu = 0.f;
#pragma unroll
        for (int q = 0; q < kWarps; ++q) {
          drh += red[(q * kRows + r) * kRedCols + jj];
          dhu += red[(q * kRows + r) * kRedCols + kCols + jj];
        }
        const float dg_r = drh * in.hp * rg * (1.f - rg);
        dx[o + h] = from_f<T>(dg_r);
        if (split) g32[o + h] = dg_r;
        carry = carry + drh * rg;
        carry = carry + dhu;
      }
      group_arrive(counter);
      group_wait(counter, slices * (2 * i + 2));
      // dh's reset part round(dg_r) W_r[j, :]^T
      DhTile<T> tr;
      tr.zero();
      const Rows<T> rr_rows{drow + h, stride, nrows, h, vec_dx != 0};
      warp_stream<NBUF>(buf, rr_rows, s0b, s1b, [&](const T* a, int sc) {
        tr.mul_add(a, wsm + hp, ld, sc * C::KC);
      });
      tr.each([&](int rr, int cl, float v) { mine[rr * kCols + cl] = v; });
      __syncthreads();
      if (own) {
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < kWarps; ++q)
          acc += red[q * kRows * kRedCols + r * kCols + jj];
        dh = carry + acc;
      }
    }
    if (own) dh_out[(size_t)b * h + k] = dh;
  }
}

}  // namespace gru_p
}  // namespace
}  // namespace ptt
