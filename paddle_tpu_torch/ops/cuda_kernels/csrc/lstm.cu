// The LSTM time loop for Hopper (sm_90a), forward (K7) and BPTT (K8).
//
// Replaces the Pallas TPU kernels lstm_forward and lstm_backward
// (paddle_tpu/ops/pallas_kernels/lstm.py: _kernel, _bwd_kernel).  Those run
// a sequential grid=(T,) with h, c and the whole recurrent weight resident
// in VMEM.  A CUDA grid has no order and one SM holds 227 KB, so the loop
// is split over blocks by (16 batch rows, 16 hidden columns), and each
// entry point has two routes, which the caller picks (lstm.py's shape
// rule, before the launch):
//
// - persistent (lstm_persistent.cuh): one cooperative launch runs the
//   whole loop, every block resident, W's slice in shared memory and the
//   carry in registers for the whole call; a barrier among the blocks of
//   a batch group a step.  K7 is one launch, K8 two (the loop, then dW).
//   Used where the grid and the block's shared memory fit on the card.
// - steps (below): a launch a step (two a backward step) on the stream;
//   the launch boundary is the barrier, the carried state passes through
//   device memory (it stays in L2: 2 x B x H f32), and the blocks that own
//   W's columns read them from L2 every step.  K7 is T launches, K8 2T + 1.
//
// Step forward, one launch per step: a block owns 16 hidden columns and
// with them the four gate columns j, H+j, 2H+j, 3H+j of each, for 16 batch
// rows, so it finishes c' and h' itself.  g = x_t + round(h) W with h
// rounded to the weight's type as the product's operand only: the carried
// h and c stay f32 in their own buffers (h ping-pongs, because every block
// reads all of it), and hs, cs are written in the input's type.  The step
// mask is t < lengths[b]: a padded step keeps h and c.
//
// Step backward, two launches per step in reverse time plus one product at
// the end: (1) the gates are recomputed from (x_t, h_{t-1}, W) with
// h_{t-1}, c_{t-1} read from the saved, rounded hs, cs; the block forms the
// four gate gradients dg, writes dx_t = dg in the input's type (and in f32
// for the weight gradient when the input is bf16) and updates the dc
// carry; (2) dh = (1-m) dh_acc + dg W^T with dg as rounded for dx — a
// product over all 4H columns, so it needs every block of (1) to have
// finished; (3) after the loop dW = sum over all (b, t) of h_{t-1}^T dg
// from f32 operands, one product over T*B rows, cast once to the weight's
// type.  The persistent backward ends with the same dW launch.
//
// Bound on an H100: forward 8 B T H^2 flops, backward 24 B T H^2, on the
// CUDA cores in f32 (67 TFLOP/s) and the tensor cores in bf16; the bytes
// (x, hs, cs, dx, W once) are far below that.  Both bounds ignore that the
// T steps depend on each other: a step's products are too small to fill
// the card, so what is measured is the chain of T dependent steps, each a
// launch (steps) or a group barrier (persistent) plus a small product.

#include <atomic>

#include "lstm_persistent.cuh"
#include "recurrent.cuh"

// The kernels the entry points below launch, as ptt_lstm_device_launches
// numbers them (lstm.py's KERNELS)
enum LstmKernel : int {
  kFwdPersistent = 0,
  kFwdStep,
  kBwdPersistent,
  kBwdGates,
  kBwdDh,
  kDwMma,
  kRnnDw,
  kLstmKernels
};

namespace ptt {
namespace {

// Device launches of each LstmKernel since the library was loaded,
// counted on the host where the kernel is launched
std::atomic<long long> g_launches[kLstmKernels];

void tally(LstmKernel k, long long n = 1) { g_launches[k] += n; }

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
  tally(kFwdStep, t_len);
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
  tally(kBwdGates, t_len);
  tally(kBwdDh, t_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // f32 inputs: dx holds the f32 gate gradients themselves
  const float* d = dg32 != nullptr ? dg32 : static_cast<const float*>(dx);
  tally(kRnnDw);
  return launch_dw<T>(h0, hs, nullptr, d, 4 * h, 0, dw, 4 * h, 4 * h,
                      batch * t_len, t_len, h, stream);
}

namespace lstm_p {

template <typename T>
const void* fwd_kernel() { return (const void*)lstm_fwd_persistent<T>; }
template <typename T>
const void* bwd_kernel() { return (const void*)lstm_bwd_persistent<T>; }

// Blocks of the persistent kernel that fit on the current device at once
// with its shared memory at hidden width h (0 if one block does not fit).
template <typename T>
cudaError_t capacity(int h, bool backward, int* blocks) {
  return rnn_p::capacity(backward ? bwd_kernel<T>() : fwd_kernel<T>(),
                         smem_bytes<T>(h, backward), blocks);
}

template <typename T>
cudaError_t persistent_grid(int batch, int h, bool backward, dim3* grid) {
  return rnn_p::persistent_grid(backward ? bwd_kernel<T>() : fwd_kernel<T>(),
                                smem_bytes<T>(h, backward), batch, h, grid);
}

// dW after the persistent loop: bf16 on the tensor cores (dwk), f32 the
// CUDA-core rnn_dw_kernel the step route uses
template <typename T>
cudaError_t launch_dw_persistent(const void* h0, const void* hs,
                                 const float* g32, void* dw, int batch,
                                 int t_len, int h, cudaStream_t stream) {
  if constexpr (sizeof(T) == 4) {
    tally(kRnnDw);
    return launch_dw<T>(h0, hs, nullptr, g32, 4 * h, 0, dw, 4 * h, 4 * h,
                        batch * t_len, t_len, h, stream);
  } else {
    const size_t smem = sizeof(dwk::Smem);
    cudaError_t err = cudaFuncSetAttribute(
        dwk::lstm_dw_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((4 * h + bnmma::kBN - 1) / bnmma::kBN,
                    (h + bnmma::kBM - 1) / bnmma::kBM);
    dwk::lstm_dw_mma<<<grid, bnmma::kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(h0),
        static_cast<const __nv_bfloat16*>(hs), g32,
        static_cast<__nv_bfloat16*>(dw), batch * t_len, t_len, h,
        vec<T>(hs, h) && vec<T>(h0, h));
    tally(kDwMma);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t forward(const void* x, const void* w, const void* h0,
                    const void* c0, void* hs, void* cs, void* h_last,
                    void* c_last, const int* lengths, unsigned* counters,
                    int batch, int t_len, int h, cudaStream_t stream) {
  dim3 g;
  cudaError_t err = persistent_grid<T>(batch, h, false, &g);
  if (err != cudaSuccess) return err;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* h0p = static_cast<const T*>(h0);
  const T* c0p = static_cast<const T*>(c0);
  T* hsp = static_cast<T*>(hs);
  T* csp = static_cast<T*>(cs);
  T* hl = static_cast<T*>(h_last);
  T* cl = static_cast<T*>(c_last);
  int vec_h = vec<T>(hs, h) && vec<T>(h0, h);
  void* args[] = {&xp, &wp, &h0p, &c0p, &hsp, &csp, &hl, &cl,
                  (void*)&lengths, &counters, &batch, &t_len, &h, &vec_h};
  err = cudaLaunchCooperativeKernel(fwd_kernel<T>(), g, dim3(kThreads), args,
                                    smem_bytes<T>(h, false), stream);
  if (err != cudaSuccess) return err;
  tally(kFwdPersistent);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const void* x, const void* w, const void* h0,
                     const void* c0, const void* hs, const void* cs,
                     const void* dhs, const void* dcs, float* dh_out,
                     float* dc_out, void* dx, float* dg32, void* dw,
                     const int* lengths, unsigned* counters, int batch,
                     int t_len, int h, cudaStream_t stream) {
  dim3 g;
  cudaError_t err = persistent_grid<T>(batch, h, true, &g);
  if (err != cudaSuccess) return err;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* h0p = static_cast<const T*>(h0);
  const T* c0p = static_cast<const T*>(c0);
  const T* hsp = static_cast<const T*>(hs);
  const T* csp = static_cast<const T*>(cs);
  const T* dhp = static_cast<const T*>(dhs);
  const T* dcp = static_cast<const T*>(dcs);
  T* dxp = static_cast<T*>(dx);
  // f32 inputs: dx holds the gate pre-activations, then the f32 dg
  float* g32 = dg32 != nullptr ? dg32 : static_cast<float*>(dx);
  int vec_h = vec<T>(hs, h) && vec<T>(h0, h);
  int vec_dx = vec<T>(dx, 4 * h);
  void* args[] = {&xp,     &wp,     &h0p,     &c0p,
                  &hsp,    &csp,    &dhp,     &dcp,
                  &dh_out, &dc_out, &dxp,     &g32,
                  (void*)&lengths, &counters, &batch, &t_len,
                  &h,      &vec_h,  &vec_dx};
  err = cudaLaunchCooperativeKernel(bwd_kernel<T>(), g, dim3(kThreads), args,
                                    smem_bytes<T>(h, true), stream);
  if (err != cudaSuccess) return err;
  tally(kBwdPersistent);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_dw_persistent<T>(h0, hs, g32, dw, batch, t_len, h, stream);
}

}  // namespace lstm_p
}  // namespace
}  // namespace ptt

// Route codes of the two C entry points below (lstm.py's shape rule)
enum LstmRoute : int { kSteps = 0, kPersistent = 1 };

// All tensors contiguous, of `dtype` unless said, on the caller's current
// device, which owns `stream`.  x [B,T,4H], w [H,4H], h0, c0 [B,H]; hs, cs
// [B,T,H]; h_last, c_last [B,H]; lengths [B] int32.  `route` kSteps: hbuf
// [2,B,H] f32 with h0 in its first half and c [B,H] f32 holding c0 are the
// carried state (scratch on return), T launches; kPersistent: counters
// [ceil(B/16)] uint32, zero on entry, one launch.  Returns a cudaError_t
// (0 on success).
extern "C" int ptt_lstm_forward(const void* x, const void* w, const void* h0,
                                const void* c0, void* hbuf, void* c, void* hs,
                                void* cs, void* h_last, void* c_last,
                                const void* lengths, void* counters,
                                int batch, int t_len, int h, int dtype,
                                int route, void* stream) {
  if (batch < 1 || t_len < 1 || h < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* hb = static_cast<float*>(hbuf);
  float* cb = static_cast<float*>(c);
  const int* len = static_cast<const int*>(lengths);
  unsigned* cnt = static_cast<unsigned*>(counters);
  const bool steps = route == kSteps;
  if (steps ? hb == nullptr || cb == nullptr : cnt == nullptr)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case ptt::kFloat32:
      return steps ? (int)ptt::forward<float>(x, w, hb, cb, hs, cs, h_last,
                                              c_last, len, batch, t_len, h, s)
                   : (int)ptt::lstm_p::forward<float>(
                         x, w, h0, c0, hs, cs, h_last, c_last, len, cnt,
                         batch, t_len, h, s);
    case ptt::kBFloat16:
      return steps ? (int)ptt::forward<__nv_bfloat16>(
                         x, w, hb, cb, hs, cs, h_last, c_last, len, batch,
                         t_len, h, s)
                   : (int)ptt::lstm_p::forward<__nv_bfloat16>(
                         x, w, h0, c0, hs, cs, h_last, c_last, len, cnt,
                         batch, t_len, h, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// x, w, hs, cs as the forward's; h0, c0 [B,H]; dhs, dcs [B,T,H] the
// cotangents of hs, cs; dh_carry, dc_carry [B,H] f32, zero on entry, hold
// dh0 and dc0 on return; dx [B,T,4H]; dg32 [B,T,4H] f32 scratch, or null
// when dtype is float32; dw [H,4H].  `route` kSteps: 2T + 1 launches;
// kPersistent: counters [ceil(B/16)] uint32, zero on entry, two launches
// (the loop, then dW).
extern "C" int ptt_lstm_backward(const void* x, const void* w, const void* h0,
                                 const void* c0, const void* hs,
                                 const void* cs, const void* dhs,
                                 const void* dcs, void* dh_carry,
                                 void* dc_carry, void* dx, void* dg32,
                                 void* dw, const void* lengths,
                                 void* counters, int batch, int t_len, int h,
                                 int dtype, int route, void* stream) {
  if (batch < 1 || t_len < 1 || h < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dh = static_cast<float*>(dh_carry);
  float* dc = static_cast<float*>(dc_carry);
  float* g32 = static_cast<float*>(dg32);
  const int* len = static_cast<const int*>(lengths);
  unsigned* cnt = static_cast<unsigned*>(counters);
  const bool steps = route == kSteps;
  if (!steps && cnt == nullptr) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case ptt::kFloat32:
      if (g32 != nullptr) return (int)cudaErrorInvalidValue;
      return steps ? (int)ptt::backward<float>(x, w, h0, c0, hs, cs, dhs,
                                               dcs, dh, dc, dx, g32, dw, len,
                                               batch, t_len, h, s)
                   : (int)ptt::lstm_p::backward<float>(
                         x, w, h0, c0, hs, cs, dhs, dcs, dh, dc, dx, g32, dw,
                         len, cnt, batch, t_len, h, s);
    case ptt::kBFloat16:
      if (g32 == nullptr) return (int)cudaErrorInvalidValue;
      return steps ? (int)ptt::backward<__nv_bfloat16>(
                         x, w, h0, c0, hs, cs, dhs, dcs, dh, dc, dx, g32, dw,
                         len, batch, t_len, h, s)
                   : (int)ptt::lstm_p::backward<__nv_bfloat16>(
                         x, w, h0, c0, hs, cs, dhs, dcs, dh, dc, dx, g32, dw,
                         len, cnt, batch, t_len, h, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// *blocks = how many blocks of the persistent forward (backward != 0: the
// backward's loop) fit on the current device at once at hidden width h, 0
// when one block's shared memory does not fit (lstm.py's shape rule: the
// persistent route needs ceil(h / 16) of them).
extern "C" int ptt_lstm_capacity(int h, int dtype, int backward,
                                 int* blocks) {
  if (h < 1 || blocks == nullptr) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case ptt::kFloat32:
      return (int)ptt::lstm_p::capacity<float>(h, backward != 0, blocks);
    case ptt::kBFloat16:
      return (int)ptt::lstm_p::capacity<__nv_bfloat16>(h, backward != 0,
                                                       blocks);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// *bytes = the dynamic shared memory a block asks for at hidden width h:
// kernel 0 the persistent forward, 1 the persistent backward's loop, 2 the
// bf16 dW (dtype bfloat16 only).  Needs no device.
extern "C" int ptt_lstm_smem_bytes(int h, int dtype, int kernel,
                                   int* bytes) {
  if (h < 1 || bytes == nullptr) return (int)cudaErrorInvalidValue;
  const bool bf16 = dtype == ptt::kBFloat16;
  if (!bf16 && dtype != ptt::kFloat32) return (int)cudaErrorInvalidValue;
  switch (kernel) {
    case 0:
    case 1:
      *bytes = (int)(bf16 ? ptt::lstm_p::smem_bytes<__nv_bfloat16>(h, kernel)
                          : ptt::lstm_p::smem_bytes<float>(h, kernel));
      return (int)cudaSuccess;
    case 2:
      if (!bf16) return (int)cudaErrorInvalidValue;
      *bytes = (int)sizeof(ptt::lstm_p::dwk::Smem);
      return (int)cudaSuccess;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// *launches = the device launches of LstmKernel `kernel` that the entry
// points above have made since the library was loaded.  Needs no device.
extern "C" int ptt_lstm_device_launches(int kernel, int* launches) {
  if (kernel < 0 || kernel >= kLstmKernels || launches == nullptr)
    return (int)cudaErrorInvalidValue;
  *launches = (int)ptt::g_launches[kernel].load();
  return (int)cudaSuccess;
}
