// The LSTM time loop for Hopper (sm_90a), forward (K7) and BPTT (K8).
//
// Replaces the Pallas TPU kernels lstm_forward and lstm_backward
// (paddle_tpu/ops/pallas_kernels/lstm.py: _kernel, _bwd_kernel).  Those run
// a sequential grid=(T,) with h, c and the whole recurrent weight resident
// in VMEM.  A CUDA grid has no order and one SM holds 227 KB, so here each
// public entry point launches step kernels T times on the stream: the
// launch boundary is the barrier between steps, the state passes through
// device memory (it stays in L2: 2 x B x H f32), and W (2-4 MB at H 512) is
// read from L2 by the blocks that own its columns.
//
// Forward, one launch per step: a block owns 16 hidden columns and with
// them the four gate columns j, H+j, 2H+j, 3H+j of each, for 16 batch
// rows, so it finishes c' and h' itself.  g = x_t + round(h) W with h
// rounded to the weight's type as the product's operand only: the carried
// h and c stay f32 in their own buffers (h ping-pongs, because every block
// reads all of it), and hs, cs are written in the input's type.  The step
// mask is t < lengths[b]: a padded step keeps h and c.
//
// Backward, two launches per step in reverse time plus one product at the
// end: (1) the gates are recomputed from (x_t, h_{t-1}, W) with h_{t-1},
// c_{t-1} read from the saved, rounded hs, cs; the block forms the four
// gate gradients dg, writes dx_t = dg in the input's type (and in f32 for
// the weight gradient when the input is bf16) and updates the dc carry;
// (2) dh = (1-m) dh_acc + dg W^T with dg as rounded for dx — a product
// over all 4H columns, so it needs every block of (1) to have finished;
// (3) after the loop dW = sum over all (b, t) of h_{t-1}^T dg from f32
// operands, one product over T*B rows, cast once to the weight's type.
//
// Bound on an H100: forward 8 B T H^2 flops, backward 24 B T H^2, on the
// CUDA cores in f32 (67 TFLOP/s); the bytes (x, hs, cs, dx, W once) are
// far below that.  Both bounds ignore that the T steps depend on each
// other: a step's products are too small to fill the card, and what is
// measured is mostly T (or 2T) dependent launches.  Tensor cores and one
// persistent cooperative launch with W slices kept in shared memory are
// left for later.

#include "recurrent.cuh"

namespace ptt {
namespace {

// grid: (ceil(H / 16), ceil(B / 16)).
template <typename T>
__global__ void __launch_bounds__(kRnnThreads)
lstm_fwd_step(const T* __restrict__ x, const T* __restrict__ w,
              const float* __restrict__ h_in, float* __restrict__ h_out,
              float* __restrict__ c, T* __restrict__ hs, T* __restrict__ cs,
              T* __restrict__ h_last, T* __restrict__ c_last,
              const int* __restrict__ lengths, int t, int batch, int t_len,
              int h) {
  __shared__ __align__(16) float smem[rnn_smem_floats<4>()];
  const int j0 = blockIdx.x * kTX, b0 = blockIdx.y * kBT;
  auto la = [&](int k, int row) -> float {
    const int b = b0 + row;
    return b < batch ? round_to<T>(h_in[(size_t)b * h + k]) : 0.f;
  };
  auto lb = [&](int k, int cl) -> float {
    const int j = j0 + cl % kTX, g = cl / kTX;
    return j < h ? to_f(w[(size_t)k * 4 * h + g * h + j]) : 0.f;
  };
  float acc[kRB][4];
  tile_product<4, true, true, false>(acc, h, la, lb, smem);
  if (threadIdx.x >= kSlice) return;
  const int j = j0 + threadIdx.x % kTX;
  if (j >= h) return;
#pragma unroll
  for (int r = 0; r < kRB; ++r) {
    const int b = b0 + (threadIdx.x / kTX) * kRB + r;
    if (b >= batch) continue;
    const size_t row = (size_t)b * t_len + t;
    const T* xr = x + row * 4 * h + j;
    const float gi = sigmoidf(acc[r][0] + to_f(xr[0]));
    const float gf = sigmoidf(acc[r][1] + to_f(xr[h]));
    const float gc = tanhf(acc[r][2] + to_f(xr[2 * h]));
    const float go = sigmoidf(acc[r][3] + to_f(xr[3 * h]));
    const size_t s = (size_t)b * h + j;
    float c_new = c[s], h_new = h_in[s];
    if (t < lengths[b]) {
      c_new = gf * c_new + gi * gc;
      h_new = go * tanhf(c_new);
    }
    c[s] = c_new;
    h_out[s] = h_new;
    hs[row * h + j] = from_f<T>(h_new);
    cs[row * h + j] = from_f<T>(c_new);
    if (t == t_len - 1) {
      h_last[s] = from_f<T>(h_new);
      c_last[s] = from_f<T>(c_new);
    }
  }
}

// Backward (1): recompute the gates of step t, form dg, write dx_t (and
// the f32 copy dg32 when given) and the dc carry.  dh_carry is read only.
// grid: (ceil(H / 16), ceil(B / 16)).
template <typename T>
__global__ void __launch_bounds__(kRnnThreads)
lstm_bwd_gates(const T* __restrict__ x, const T* __restrict__ w,
               const T* __restrict__ h0, const T* __restrict__ c0,
               const T* __restrict__ hs, const T* __restrict__ cs,
               const T* __restrict__ dhs, const T* __restrict__ dcs,
               const float* __restrict__ dh_carry,
               float* __restrict__ dc_carry, T* __restrict__ dx,
               float* __restrict__ dg32, const int* __restrict__ lengths,
               int t, int batch, int t_len, int h) {
  __shared__ __align__(16) float smem[rnn_smem_floats<4>()];
  const int j0 = blockIdx.x * kTX, b0 = blockIdx.y * kBT;
  auto la = [&](int k, int row) -> float {
    const int b = b0 + row;
    return b < batch ? prev_state(h0, hs, b, t, t_len, h, k) : 0.f;
  };
  auto lb = [&](int k, int cl) -> float {
    const int j = j0 + cl % kTX, g = cl / kTX;
    return j < h ? to_f(w[(size_t)k * 4 * h + g * h + j]) : 0.f;
  };
  float acc[kRB][4];
  tile_product<4, true, true, false>(acc, h, la, lb, smem);
  if (threadIdx.x >= kSlice) return;
  const int j = j0 + threadIdx.x % kTX;
  if (j >= h) return;
#pragma unroll
  for (int r = 0; r < kRB; ++r) {
    const int b = b0 + (threadIdx.x / kTX) * kRB + r;
    if (b >= batch) continue;
    const size_t row = (size_t)b * t_len + t;
    const T* xr = x + row * 4 * h + j;
    const float gi = sigmoidf(acc[r][0] + to_f(xr[0]));
    const float gf = sigmoidf(acc[r][1] + to_f(xr[h]));
    const float gu = tanhf(acc[r][2] + to_f(xr[2 * h]));
    const float go = sigmoidf(acc[r][3] + to_f(xr[3 * h]));
    const float c_prev = prev_state(c0, cs, b, t, t_len, h, j);
    const float tc = tanhf(gf * c_prev + gi * gu);
    const size_t s = (size_t)b * h + j;
    const float dh_acc = to_f(dhs[row * h + j]) + dh_carry[s];
    const float dc_acc = to_f(dcs[row * h + j]) + dc_carry[s];
    const float m = t < lengths[b] ? 1.f : 0.f;
    const float dh_raw = m * dh_acc;
    const float dc_raw = m * dc_acc + dh_raw * go * (1.f - tc * tc);
    const float dg[4] = {dc_raw * gu * gi * (1.f - gi),
                         dc_raw * c_prev * gf * (1.f - gf),
                         dc_raw * gi * (1.f - gu * gu),
                         dh_raw * tc * go * (1.f - go)};
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const size_t o = row * 4 * h + g * h + j;
      dx[o] = from_f<T>(dg[g]);
      if (dg32 != nullptr) dg32[o] = dg[g];
    }
    dc_carry[s] = (1.f - m) * dc_acc + dc_raw * gf;
  }
}

// Backward (2): dh_carry = (1-m) (dhs_t + dh_carry) + dx_t W^T.
// grid: (ceil(H / 16), ceil(B / 16)).
template <typename T>
__global__ void __launch_bounds__(kRnnThreads)
lstm_bwd_dh(const T* __restrict__ w, const T* __restrict__ dhs,
            const T* __restrict__ dx, float* __restrict__ dh_carry,
            const int* __restrict__ lengths, int t, int batch, int t_len,
            int h) {
  __shared__ __align__(16) float smem[rnn_smem_floats<1>()];
  const int k0 = blockIdx.x * kTX, b0 = blockIdx.y * kBT;
  auto la = [&](int n, int row) -> float {
    const int b = b0 + row;
    return b < batch ? to_f(dx[((size_t)b * t_len + t) * 4 * h + n]) : 0.f;
  };
  auto lb = [&](int n, int cl) -> float {
    const int k = k0 + cl;
    return k < h ? to_f(w[(size_t)k * 4 * h + n]) : 0.f;
  };
  float acc[kRB][1];
  tile_product<1, false, true, true>(acc, 4 * h, la, lb, smem);
  if (threadIdx.x >= kSlice) return;
  const int k = k0 + threadIdx.x % kTX;
  if (k >= h) return;
#pragma unroll
  for (int r = 0; r < kRB; ++r) {
    const int b = b0 + (threadIdx.x / kTX) * kRB + r;
    if (b >= batch) continue;
    const size_t s = (size_t)b * h + k;
    const float dh_acc =
        to_f(dhs[((size_t)b * t_len + t) * h + k]) + dh_carry[s];
    dh_carry[s] = (t < lengths[b] ? 0.f : dh_acc) + acc[r][0];
  }
}

template <typename T>
cudaError_t forward(const void* x, const void* w, float* hbuf, float* c,
                    void* hs, void* cs, void* h_last, void* c_last,
                    const int* lengths, int batch, int t_len, int h,
                    cudaStream_t stream) {
  const dim3 grid((h + kTX - 1) / kTX, (batch + kBT - 1) / kBT);
  const size_t state = (size_t)batch * h;
  for (int t = 0; t < t_len; ++t) {
    lstm_fwd_step<T><<<grid, kRnnThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        hbuf + (t & 1) * state, hbuf + ((t + 1) & 1) * state, c,
        static_cast<T*>(hs), static_cast<T*>(cs), static_cast<T*>(h_last),
        static_cast<T*>(c_last), lengths, t, batch, t_len, h);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const void* x, const void* w, const void* h0,
                     const void* c0, const void* hs, const void* cs,
                     const void* dhs, const void* dcs, float* dh_carry,
                     float* dc_carry, void* dx, float* dg32, void* dw,
                     const int* lengths, int batch, int t_len, int h,
                     cudaStream_t stream) {
  const dim3 grid((h + kTX - 1) / kTX, (batch + kBT - 1) / kBT);
  for (int t = t_len - 1; t >= 0; --t) {
    lstm_bwd_gates<T><<<grid, kRnnThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const T*>(h0), static_cast<const T*>(c0),
        static_cast<const T*>(hs), static_cast<const T*>(cs),
        static_cast<const T*>(dhs), static_cast<const T*>(dcs), dh_carry,
        dc_carry, static_cast<T*>(dx), dg32, lengths, t, batch, t_len, h);
    lstm_bwd_dh<T><<<grid, kRnnThreads, 0, stream>>>(
        static_cast<const T*>(w), static_cast<const T*>(dhs),
        static_cast<const T*>(dx), dh_carry, lengths, t, batch, t_len, h);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // f32 inputs: dx holds the f32 gate gradients themselves
  const float* d = dg32 != nullptr ? dg32 : static_cast<const float*>(dx);
  return launch_dw<T>(h0, hs, nullptr, d, 4 * h, 0, dw, 4 * h, 4 * h,
                      batch * t_len, t_len, h, stream);
}

}  // namespace
}  // namespace ptt

// All tensors contiguous, of `dtype` unless said, on the caller's current
// device, which owns `stream`.  x [B,T,4H], w [H,4H]; hbuf [2,B,H] f32 with
// h0 in its first half and c [B,H] f32 holding c0 are the carried state
// (scratch on return); hs, cs [B,T,H]; h_last, c_last [B,H]; lengths [B]
// int32.  T launches.  Returns a cudaError_t (0 on success).
extern "C" int ptt_lstm_forward(const void* x, const void* w, void* hbuf,
                                void* c, void* hs, void* cs, void* h_last,
                                void* c_last, const void* lengths, int batch,
                                int t_len, int h, int dtype, void* stream) {
  if (batch < 1 || t_len < 1 || h < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* hb = static_cast<float*>(hbuf);
  float* cb = static_cast<float*>(c);
  const int* len = static_cast<const int*>(lengths);
  switch (dtype) {
    case ptt::kFloat32:
      return (int)ptt::forward<float>(x, w, hb, cb, hs, cs, h_last, c_last,
                                      len, batch, t_len, h, s);
    case ptt::kBFloat16:
      return (int)ptt::forward<__nv_bfloat16>(x, w, hb, cb, hs, cs, h_last,
                                              c_last, len, batch, t_len, h,
                                              s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// x, w, hs, cs as the forward's; h0, c0 [B,H]; dhs, dcs [B,T,H] the
// cotangents of hs, cs; dh_carry, dc_carry [B,H] f32, zero on entry, hold
// dh0 and dc0 on return; dx [B,T,4H]; dg32 [B,T,4H] f32 scratch, or null
// when dtype is float32; dw [H,4H].  2T + 1 launches.
extern "C" int ptt_lstm_backward(const void* x, const void* w, const void* h0,
                                 const void* c0, const void* hs,
                                 const void* cs, const void* dhs,
                                 const void* dcs, void* dh_carry,
                                 void* dc_carry, void* dx, void* dg32,
                                 void* dw, const void* lengths, int batch,
                                 int t_len, int h, int dtype, void* stream) {
  if (batch < 1 || t_len < 1 || h < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dh = static_cast<float*>(dh_carry);
  float* dc = static_cast<float*>(dc_carry);
  float* g32 = static_cast<float*>(dg32);
  const int* len = static_cast<const int*>(lengths);
  switch (dtype) {
    case ptt::kFloat32:
      if (g32 != nullptr) return (int)cudaErrorInvalidValue;
      return (int)ptt::backward<float>(x, w, h0, c0, hs, cs, dhs, dcs, dh, dc,
                                       dx, g32, dw, len, batch, t_len, h, s);
    case ptt::kBFloat16:
      if (g32 == nullptr) return (int)cudaErrorInvalidValue;
      return (int)ptt::backward<__nv_bfloat16>(x, w, h0, c0, hs, cs, dhs, dcs,
                                               dh, dc, dx, g32, dw, len,
                                               batch, t_len, h, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
