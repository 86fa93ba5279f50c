// The GRU time loop for Hopper (sm_90a), forward (K9) and BPTT (K10).
//
// Replaces the Pallas TPU kernels gru_forward and gru_backward
// (paddle_tpu/ops/pallas_kernels/gru.py: _fwd_kernel, _bwd_kernel), which
// run a sequential grid=(T,) with h and both recurrent weights resident in
// VMEM.  Gate layout: w [H,3H] = [update u, reset r | candidate].  As for
// the LSTM (lstm.cu), each entry point has two routes, which the caller
// picks (gru.py's shape rule, before the launch):
//
// - persistent (gru_persistent.cuh): one cooperative launch runs the
//   whole loop, every block resident, W's slice in shared memory and the
//   carry in registers for the whole call; two barriers among the blocks
//   of a batch group a step.  K9 is one launch, K10 three (the loop, then
//   the two dW products below).  Used where the grid and the block's
//   shared memory fit on the card.
// - steps (below): step kernels on the stream, the launch boundary being
//   the barrier, with the f32 state in device memory.  K9 is 2T launches,
//   K10 4T + 2.
//
// The step route.  A GRU step is two dependent products, because the
// candidate needs r*h for every hidden column before it can start:
//   forward (2 launches a step)
//     (a) [u, r] = sigmoid(x[:, :2H] + round(h) W[:, :2H]); a block owns 16
//         hidden columns and both gate columns of each; u and r*h go to f32
//         scratch;
//     (b) c = tanh(x[:, 2H:] + round(r*h) W[:, 2H:]), h' = u h + (1-u) c,
//         masked by t < lengths[b]; h is updated in place (each element is
//         read and written by its owner; (a) only reads it).
//   backward (4 launches a step in reverse time, 2 products at the end)
//     (a) recompute u, r from (x_t, h_{t-1}, W) with h_{t-1} from the saved,
//         rounded hs; r*h_{t-1} is kept in f32 for every step: the weight
//         gradient of the candidate needs it;
//     (b) recompute c; form da_c and dg_u, write them to dx_t, start the
//         dh carry: (1-m) dh_acc + dh_raw u;
//     (c) drh = round(da_c) W_c^T; dr, dg_r into dx_t; carry += drh r;
//     (d) carry += round(dg) W_g^T over the 2H gate columns;
//     then dW[:, :2H] = sum h_{t-1}^T dg and dW[:, 2H:] = sum (r h_{t-1})^T
//     da_c over all T*B rows, f32 operands, cast once.
// Rounding points are the Pallas kernels': the product operands h, r*h, dg
// and da_c at the weight's type, everything else f32; dx in the input's
// type (with an f32 copy for the weight gradient when the input is bf16).
//
// Bound on an H100: forward 6 B T H^2 flops, backward 18 B T H^2, on the
// CUDA cores in f32; as for the LSTM the bound ignores that the steps
// depend on each other.

#include <atomic>

#include "gru_persistent.cuh"
#include "recurrent.cuh"

// The kernels the entry points below launch, as ptt_gru_device_launches
// numbers them (gru.py's KERNELS)
enum GruKernel : int {
  kFwdPersistent = 0,
  kBwdPersistent,
  kGates,
  kFwdCand,
  kBwdCand,
  kBwdDrh,
  kBwdDh,
  kRnnDw,
  kGruKernels
};

namespace ptt {
namespace {

// Device launches of each GruKernel since the library was loaded, counted
// on the host where the kernel is launched
std::atomic<long long> g_launches[kGruKernels];

void tally(GruKernel k, long long n = 1) { g_launches[k] += n; }

// Gates of one step: A = h (f32 state, `hf`) or h_{t-1} from the saved
// states (hf null).  Writes u and r [B,H] f32 and r*h to rh (row stride of
// batch: rh_ld, so that the backward can keep every step's).
// grid: (ceil(H / 16), ceil(B / 16)).
template <typename T>
__global__ void __launch_bounds__(kRnnThreads)
gru_gates(const T* __restrict__ x, const T* __restrict__ w,
          const float* __restrict__ hf, const T* __restrict__ h0,
          const T* __restrict__ hs, float* __restrict__ u_buf,
          float* __restrict__ r_buf, float* __restrict__ rh, size_t rh_ld,
          int t, int batch, int t_len, int h) {
  __shared__ __align__(16) float smem[rnn_smem_floats<2>()];
  const int j0 = blockIdx.x * kTX, b0 = blockIdx.y * kBT;
  auto h_prev = [&](int b, int k) -> float {
    return hf != nullptr ? hf[(size_t)b * h + k]
                         : prev_state(h0, hs, b, t, t_len, h, k);
  };
  auto la = [&](int k, int row) -> float {
    const int b = b0 + row;
    return b < batch ? round_to<T>(h_prev(b, k)) : 0.f;
  };
  auto lb = [&](int k, int cl) -> float {
    const int j = j0 + cl % kTX, g = cl / kTX;
    return j < h ? to_f(w[(size_t)k * 3 * h + g * h + j]) : 0.f;
  };
  float acc[kRB][2];
  tile_product<2, true, true, false>(acc, h, la, lb, smem);
  if (threadIdx.x >= kSlice) return;
  const int j = j0 + threadIdx.x % kTX;
  if (j >= h) return;
#pragma unroll
  for (int r = 0; r < kRB; ++r) {
    const int b = b0 + (threadIdx.x / kTX) * kRB + r;
    if (b >= batch) continue;
    const T* xr = x + ((size_t)b * t_len + t) * 3 * h + j;
    const float u = sigmoidf(acc[r][0] + to_f(xr[0]));
    const float rr = sigmoidf(acc[r][1] + to_f(xr[h]));
    const size_t s = (size_t)b * h + j;
    u_buf[s] = u;
    r_buf[s] = rr;
    rh[(size_t)b * rh_ld + j] = rr * h_prev(b, j);
  }
}

// Forward (b): the candidate and the new state.
// grid: (ceil(H / 16), ceil(B / 16)).
template <typename T>
__global__ void __launch_bounds__(kRnnThreads)
gru_fwd_cand(const T* __restrict__ x, const T* __restrict__ w,
             const float* __restrict__ rh, const float* __restrict__ u_buf,
             float* __restrict__ hf, T* __restrict__ hs,
             T* __restrict__ h_last, const int* __restrict__ lengths, int t,
             int batch, int t_len, int h) {
  __shared__ __align__(16) float smem[rnn_smem_floats<1>()];
  const int j0 = blockIdx.x * kTX, b0 = blockIdx.y * kBT;
  auto la = [&](int k, int row) -> float {
    const int b = b0 + row;
    return b < batch ? round_to<T>(rh[(size_t)b * h + k]) : 0.f;
  };
  auto lb = [&](int k, int cl) -> float {
    const int j = j0 + cl;
    return j < h ? to_f(w[(size_t)k * 3 * h + 2 * h + j]) : 0.f;
  };
  float acc[kRB][1];
  tile_product<1, false, true, false>(acc, h, la, lb, smem);
  if (threadIdx.x >= kSlice) return;
  const int j = j0 + threadIdx.x % kTX;
  if (j >= h) return;
#pragma unroll
  for (int r = 0; r < kRB; ++r) {
    const int b = b0 + (threadIdx.x / kTX) * kRB + r;
    if (b >= batch) continue;
    const size_t row = (size_t)b * t_len + t;
    const size_t s = (size_t)b * h + j;
    float h_new = hf[s];
    if (t < lengths[b]) {
      const float c = tanhf(acc[r][0] + to_f(x[row * 3 * h + 2 * h + j]));
      const float u = u_buf[s];
      h_new = u * h_new + (1.f - u) * c;
    }
    hf[s] = h_new;
    hs[row * h + j] = from_f<T>(h_new);
    if (t == t_len - 1) h_last[s] = from_f<T>(h_new);
  }
}

// Backward (b): recompute c from the kept r*h_{t-1}; da_c and dg_u into
// dx_t (and dg32 when given); dh_carry = (1-m) dh_acc + dh_raw u.
// grid: (ceil(H / 16), ceil(B / 16)).
template <typename T>
__global__ void __launch_bounds__(kRnnThreads)
gru_bwd_cand(const T* __restrict__ x, const T* __restrict__ w,
             const T* __restrict__ h0, const T* __restrict__ hs,
             const T* __restrict__ dhs, const float* __restrict__ rh_all,
             const float* __restrict__ u_buf, float* __restrict__ dh_carry,
             T* __restrict__ dx, float* __restrict__ dg32,
             const int* __restrict__ lengths, int t, int batch, int t_len,
             int h) {
  __shared__ __align__(16) float smem[rnn_smem_floats<1>()];
  const int j0 = blockIdx.x * kTX, b0 = blockIdx.y * kBT;
  auto la = [&](int k, int row) -> float {
    const int b = b0 + row;
    return b < batch
               ? round_to<T>(rh_all[((size_t)b * t_len + t) * h + k])
               : 0.f;
  };
  auto lb = [&](int k, int cl) -> float {
    const int j = j0 + cl;
    return j < h ? to_f(w[(size_t)k * 3 * h + 2 * h + j]) : 0.f;
  };
  float acc[kRB][1];
  tile_product<1, false, true, false>(acc, h, la, lb, smem);
  if (threadIdx.x >= kSlice) return;
  const int j = j0 + threadIdx.x % kTX;
  if (j >= h) return;
#pragma unroll
  for (int r = 0; r < kRB; ++r) {
    const int b = b0 + (threadIdx.x / kTX) * kRB + r;
    if (b >= batch) continue;
    const size_t row = (size_t)b * t_len + t;
    const size_t s = (size_t)b * h + j;
    const float c = tanhf(acc[r][0] + to_f(x[row * 3 * h + 2 * h + j]));
    const float u = u_buf[s];
    const float hp = prev_state(h0, hs, b, t, t_len, h, j);
    const float dh_acc = to_f(dhs[row * h + j]) + dh_carry[s];
    const float m = t < lengths[b] ? 1.f : 0.f;
    const float dh_raw = m * dh_acc;
    const float du = dh_raw * (hp - c);
    const float dc = dh_raw * (1.f - u);
    const float da_c = dc * (1.f - c * c);
    const float dg_u = du * u * (1.f - u);
    dx[row * 3 * h + j] = from_f<T>(dg_u);
    dx[row * 3 * h + 2 * h + j] = from_f<T>(da_c);
    if (dg32 != nullptr) {
      dg32[row * 3 * h + j] = dg_u;
      dg32[row * 3 * h + 2 * h + j] = da_c;
    }
    dh_carry[s] = (1.f - m) * dh_acc + dh_raw * u;
  }
}

// Backward (c): drh = dx_t[:, 2H:] W_c^T; dg_r into dx_t; carry += drh r.
// grid: (ceil(H / 16), ceil(B / 16)).
template <typename T>
__global__ void __launch_bounds__(kRnnThreads)
gru_bwd_drh(const T* __restrict__ w, const T* __restrict__ h0,
            const T* __restrict__ hs, const float* __restrict__ r_buf,
            float* __restrict__ dh_carry, T* dx, float* __restrict__ dg32,
            int t, int batch, int t_len, int h) {
  __shared__ __align__(16) float smem[rnn_smem_floats<1>()];
  const int k0 = blockIdx.x * kTX, b0 = blockIdx.y * kBT;
  auto la = [&](int n, int row) -> float {
    const int b = b0 + row;
    return b < batch
               ? to_f(dx[((size_t)b * t_len + t) * 3 * h + 2 * h + n])
               : 0.f;
  };
  auto lb = [&](int n, int cl) -> float {
    const int k = k0 + cl;
    return k < h ? to_f(w[(size_t)k * 3 * h + 2 * h + n]) : 0.f;
  };
  float acc[kRB][1];
  tile_product<1, false, true, true>(acc, h, la, lb, smem);
  if (threadIdx.x >= kSlice) return;
  const int k = k0 + threadIdx.x % kTX;
  if (k >= h) return;
#pragma unroll
  for (int r = 0; r < kRB; ++r) {
    const int b = b0 + (threadIdx.x / kTX) * kRB + r;
    if (b >= batch) continue;
    const size_t row = (size_t)b * t_len + t;
    const size_t s = (size_t)b * h + k;
    const float drh = acc[r][0];
    const float rr = r_buf[s];
    const float dg_r =
        drh * prev_state(h0, hs, b, t, t_len, h, k) * rr * (1.f - rr);
    dx[row * 3 * h + h + k] = from_f<T>(dg_r);
    if (dg32 != nullptr) dg32[row * 3 * h + h + k] = dg_r;
    dh_carry[s] += drh * rr;
  }
}

// Backward (d): carry += dx_t[:, :2H] W_g^T.
// grid: (ceil(H / 16), ceil(B / 16)).
template <typename T>
__global__ void __launch_bounds__(kRnnThreads)
gru_bwd_dh(const T* __restrict__ w, const T* __restrict__ dx,
           float* __restrict__ dh_carry, int t, int batch, int t_len,
           int h) {
  __shared__ __align__(16) float smem[rnn_smem_floats<1>()];
  const int k0 = blockIdx.x * kTX, b0 = blockIdx.y * kBT;
  auto la = [&](int n, int row) -> float {
    const int b = b0 + row;
    return b < batch ? to_f(dx[((size_t)b * t_len + t) * 3 * h + n]) : 0.f;
  };
  auto lb = [&](int n, int cl) -> float {
    const int k = k0 + cl;
    return k < h ? to_f(w[(size_t)k * 3 * h + n]) : 0.f;
  };
  float acc[kRB][1];
  tile_product<1, false, true, true>(acc, 2 * h, la, lb, smem);
  if (threadIdx.x >= kSlice) return;
  const int k = k0 + threadIdx.x % kTX;
  if (k >= h) return;
#pragma unroll
  for (int r = 0; r < kRB; ++r) {
    const int b = b0 + (threadIdx.x / kTX) * kRB + r;
    if (b < batch) dh_carry[(size_t)b * h + k] += acc[r][0];
  }
}

template <typename T>
cudaError_t forward(const void* x_, const void* w_, float* hf, float* u_buf,
                    float* r_buf, float* rh, void* hs_, void* h_last,
                    const int* lengths, int batch, int t_len, int h,
                    cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  const T* w = static_cast<const T*>(w_);
  T* hs = static_cast<T*>(hs_);
  const dim3 grid((h + kTX - 1) / kTX, (batch + kBT - 1) / kBT);
  for (int t = 0; t < t_len; ++t) {
    gru_gates<T><<<grid, kRnnThreads, 0, stream>>>(
        x, w, hf, nullptr, nullptr, u_buf, r_buf, rh, (size_t)h, t, batch,
        t_len, h);
    gru_fwd_cand<T><<<grid, kRnnThreads, 0, stream>>>(
        x, w, rh, u_buf, hf, hs, static_cast<T*>(h_last), lengths, t, batch,
        t_len, h);
  }
  tally(kGates, t_len);
  tally(kFwdCand, t_len);
  return cudaGetLastError();
}

// dW after either route's loop: dW[:, :2H] = sum h_{t-1}^T dg and
// dW[:, 2H:] = sum (r h_{t-1})^T da_c over all T*B rows from the f32 gate
// gradients d, two launches of rnn_dw_kernel
template <typename T>
cudaError_t launch_dw_gru(const void* h0, const void* hs, const float* rh_all,
                          const float* d, void* dw, int batch, int t_len,
                          int h, cudaStream_t stream) {
  const int rows = batch * t_len;
  cudaError_t err = launch_dw<T>(h0, hs, nullptr, d, 3 * h, 0, dw, 3 * h,
                                 2 * h, rows, t_len, h, stream);
  if (err != cudaSuccess) return err;
  tally(kRnnDw);
  err = launch_dw<T>(h0, hs, rh_all, d, 3 * h, 2 * h, dw, 3 * h, h, rows,
                     t_len, h, stream);
  if (err != cudaSuccess) return err;
  tally(kRnnDw);
  return cudaSuccess;
}

template <typename T>
cudaError_t backward(const void* x_, const void* w_, const void* h0_,
                     const void* hs_, const void* dhs_, float* dh_carry,
                     float* u_buf, float* r_buf, float* rh_all, void* dx_,
                     float* dg32, void* dw, const int* lengths, int batch,
                     int t_len, int h, cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  const T* w = static_cast<const T*>(w_);
  const T* h0 = static_cast<const T*>(h0_);
  const T* hs = static_cast<const T*>(hs_);
  const T* dhs = static_cast<const T*>(dhs_);
  T* dx = static_cast<T*>(dx_);
  const dim3 grid((h + kTX - 1) / kTX, (batch + kBT - 1) / kBT);
  for (int t = t_len - 1; t >= 0; --t) {
    gru_gates<T><<<grid, kRnnThreads, 0, stream>>>(
        x, w, nullptr, h0, hs, u_buf, r_buf, rh_all + (size_t)t * h,
        (size_t)t_len * h, t, batch, t_len, h);
    gru_bwd_cand<T><<<grid, kRnnThreads, 0, stream>>>(
        x, w, h0, hs, dhs, rh_all, u_buf, dh_carry, dx, dg32, lengths, t,
        batch, t_len, h);
    gru_bwd_drh<T><<<grid, kRnnThreads, 0, stream>>>(
        w, h0, hs, r_buf, dh_carry, dx, dg32, t, batch, t_len, h);
    gru_bwd_dh<T><<<grid, kRnnThreads, 0, stream>>>(w, dx, dh_carry, t, batch,
                                                    t_len, h);
  }
  tally(kGates, t_len);
  tally(kBwdCand, t_len);
  tally(kBwdDrh, t_len);
  tally(kBwdDh, t_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float* d = dg32 != nullptr ? dg32 : reinterpret_cast<const float*>(dx);
  return launch_dw_gru<T>(h0_, hs_, rh_all, d, dw, batch, t_len, h, stream);
}

namespace gru_p {

template <typename T>
const void* fwd_kernel() { return (const void*)gru_fwd_persistent<T>; }
template <typename T>
const void* bwd_kernel() { return (const void*)gru_bwd_persistent<T>; }

// Blocks of the persistent kernel that fit on the current device at once
// with its shared memory at hidden width h (0 if one block does not fit).
template <typename T>
cudaError_t capacity(int h, bool backward, int* blocks) {
  return rnn_p::capacity(backward ? bwd_kernel<T>() : fwd_kernel<T>(),
                         smem_bytes<T>(h, backward), blocks);
}

template <typename T>
cudaError_t forward(const void* x, const void* w, const void* h0, void* rhs,
                    void* hs, void* h_last, const int* lengths,
                    unsigned* counters, int batch, int t_len, int h,
                    cudaStream_t stream) {
  dim3 g;
  const size_t smem = smem_bytes<T>(h, false);
  cudaError_t err =
      persistent_grid(fwd_kernel<T>(), smem, batch, h, &g);
  if (err != cudaSuccess) return err;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* h0p = static_cast<const T*>(h0);
  T* hsp = static_cast<T*>(hs);
  T* rp = static_cast<T*>(rhs);
  T* hl = static_cast<T*>(h_last);
  int vec_h = vec<T>(hs, h) && vec<T>(h0, h) && vec<T>(rhs, h);
  void* args[] = {&xp, &wp, &h0p, &hsp, &rp, &hl, (void*)&lengths,
                  &counters, &batch, &t_len, &h, &vec_h};
  err = cudaLaunchCooperativeKernel(fwd_kernel<T>(), g, dim3(kThreads), args,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  tally(kFwdPersistent);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const void* x, const void* w, const void* h0,
                     const void* hs, const void* dhs, float* dh_out,
                     float* rh_all, void* rh16, void* dx, float* dg32,
                     void* dw, const int* lengths, unsigned* counters,
                     int batch, int t_len, int h, cudaStream_t stream) {
  dim3 g;
  const size_t smem = smem_bytes<T>(h, true);
  cudaError_t err = persistent_grid(bwd_kernel<T>(), smem, batch, h, &g);
  if (err != cudaSuccess) return err;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* h0p = static_cast<const T*>(h0);
  const T* hsp = static_cast<const T*>(hs);
  const T* dhp = static_cast<const T*>(dhs);
  T* dxp = static_cast<T*>(dx);
  // f32 inputs: dx holds the pre-activations, then the f32 gradients, and
  // the candidate product's operand is rh_all itself
  float* g32 = dg32 != nullptr ? dg32 : static_cast<float*>(dx);
  T* rh_op = sizeof(T) == 2 ? static_cast<T*>(rh16)
                            : reinterpret_cast<T*>(rh_all);
  int vec_h = vec<T>(hs, h) && vec<T>(h0, h) && vec<T>(rh_op, h);
  int vec_dx = vec<T>(dx, h);
  void* args[] = {&xp,  &wp,    &h0p,   &hsp,     &dhp,
                  &dh_out, &dxp, &g32,  &rh_all,  &rh_op,
                  (void*)&lengths, &counters, &batch, &t_len,
                  &h,   &vec_h, &vec_dx};
  err = cudaLaunchCooperativeKernel(bwd_kernel<T>(), g, dim3(kThreads), args,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  tally(kBwdPersistent);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_dw_gru<T>(h0, hs, rh_all, g32, dw, batch, t_len, h, stream);
}

}  // namespace gru_p

}  // namespace
}  // namespace ptt

// Route codes of the two C entry points below (gru.py's shape rule)
enum GruRoute : int { kSteps = 0, kPersistent = 1 };

// All tensors contiguous, of `dtype` unless said, on the caller's current
// device, which owns `stream`.  x [B,T,3H], w [H,3H], h0 [B,H]; hs
// [B,T,H]; h_last [B,H]; lengths [B] int32.  `route` kSteps: hf [B,H] f32
// holds h0 on entry (scratch on return), u_buf, r_buf, rh [B,H] f32
// scratch, 2T launches; kPersistent: rhs [B,T,H] scratch, counters
// [ceil(B/16)] uint32, zero on entry, one launch.  Returns a cudaError_t
// (0 on success).
extern "C" int ptt_gru_forward(const void* x, const void* w, const void* h0,
                               void* hf, void* u_buf, void* r_buf, void* rh,
                               void* rhs, void* hs, void* h_last,
                               const void* lengths, void* counters,
                               int batch, int t_len, int h, int dtype,
                               int route, void* stream) {
  if (batch < 1 || t_len < 1 || h < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* f[4] = {static_cast<float*>(hf), static_cast<float*>(u_buf),
                 static_cast<float*>(r_buf), static_cast<float*>(rh)};
  const int* len = static_cast<const int*>(lengths);
  unsigned* cnt = static_cast<unsigned*>(counters);
  const bool steps = route == kSteps;
  if (steps ? !f[0] || !f[1] || !f[2] || !f[3] : !rhs || !cnt)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case ptt::kFloat32:
      return steps ? (int)ptt::forward<float>(x, w, f[0], f[1], f[2], f[3],
                                              hs, h_last, len, batch, t_len,
                                              h, s)
                   : (int)ptt::gru_p::forward<float>(x, w, h0, rhs, hs,
                                                     h_last, len, cnt, batch,
                                                     t_len, h, s);
    case ptt::kBFloat16:
      return steps ? (int)ptt::forward<__nv_bfloat16>(x, w, f[0], f[1], f[2],
                                                      f[3], hs, h_last, len,
                                                      batch, t_len, h, s)
                   : (int)ptt::gru_p::forward<__nv_bfloat16>(
                         x, w, h0, rhs, hs, h_last, len, cnt, batch, t_len,
                         h, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// x, w, hs as the forward's; h0 [B,H]; dhs [B,T,H] the cotangent of hs;
// dh_carry [B,H] f32 holds dh0 on return; rh_all [B,T,H] f32 scratch; dx
// [B,T,3H]; dg32 [B,T,3H] f32 scratch, or null when dtype is float32; dw
// [H,3H].  `route` kSteps: dh_carry zero on entry, u_buf, r_buf [B,H] f32
// scratch, 4T + 2 launches; kPersistent: rh16 [B,T,H] bf16 scratch when
// dtype is bfloat16 (else null), counters [2 ceil(B/16)] uint32, zero on
// entry, three launches (the loop, then the two dW products).
extern "C" int ptt_gru_backward(const void* x, const void* w, const void* h0,
                                const void* hs, const void* dhs,
                                void* dh_carry, void* u_buf, void* r_buf,
                                void* rh_all, void* rh16, void* dx,
                                void* dg32, void* dw, const void* lengths,
                                void* counters, int batch, int t_len, int h,
                                int dtype, int route, void* stream) {
  if (batch < 1 || t_len < 1 || h < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dh = static_cast<float*>(dh_carry);
  float* ub = static_cast<float*>(u_buf);
  float* rb = static_cast<float*>(r_buf);
  float* rha = static_cast<float*>(rh_all);
  float* g32 = static_cast<float*>(dg32);
  const int* len = static_cast<const int*>(lengths);
  unsigned* cnt = static_cast<unsigned*>(counters);
  const bool steps = route == kSteps;
  const bool bf16 = dtype == ptt::kBFloat16;
  if (steps ? !ub || !rb : !cnt || bf16 != (rh16 != nullptr))
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case ptt::kFloat32:
      if (g32 != nullptr) return (int)cudaErrorInvalidValue;
      return steps ? (int)ptt::backward<float>(x, w, h0, hs, dhs, dh, ub, rb,
                                               rha, dx, g32, dw, len, batch,
                                               t_len, h, s)
                   : (int)ptt::gru_p::backward<float>(
                         x, w, h0, hs, dhs, dh, rha, rh16, dx, g32, dw, len,
                         cnt, batch, t_len, h, s);
    case ptt::kBFloat16:
      if (g32 == nullptr) return (int)cudaErrorInvalidValue;
      return steps ? (int)ptt::backward<__nv_bfloat16>(
                         x, w, h0, hs, dhs, dh, ub, rb, rha, dx, g32, dw, len,
                         batch, t_len, h, s)
                   : (int)ptt::gru_p::backward<__nv_bfloat16>(
                         x, w, h0, hs, dhs, dh, rha, rh16, dx, g32, dw, len,
                         cnt, batch, t_len, h, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// *blocks = how many blocks of the persistent forward (backward != 0: the
// backward's loop) fit on the current device at once at hidden width h, 0
// when one block's shared memory does not fit (gru.py's shape rule: the
// persistent route needs ceil(h / 16) of them).
extern "C" int ptt_gru_capacity(int h, int dtype, int backward, int* blocks) {
  if (h < 1 || blocks == nullptr) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case ptt::kFloat32:
      return (int)ptt::gru_p::capacity<float>(h, backward != 0, blocks);
    case ptt::kBFloat16:
      return (int)ptt::gru_p::capacity<__nv_bfloat16>(h, backward != 0,
                                                      blocks);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// *bytes = the dynamic shared memory a block asks for at hidden width h:
// kernel 0 the persistent forward, 1 the persistent backward's loop.
// Needs no device.
extern "C" int ptt_gru_smem_bytes(int h, int dtype, int kernel, int* bytes) {
  if (h < 1 || bytes == nullptr || (kernel != 0 && kernel != 1))
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case ptt::kFloat32:
      *bytes = (int)ptt::gru_p::smem_bytes<float>(h, kernel);
      return (int)cudaSuccess;
    case ptt::kBFloat16:
      *bytes = (int)ptt::gru_p::smem_bytes<__nv_bfloat16>(h, kernel);
      return (int)cudaSuccess;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// *launches = the device launches of GruKernel `kernel` that the entry
// points above have made since the library was loaded.  Needs no device.
extern "C" int ptt_gru_device_launches(int kernel, int* launches) {
  if (kernel < 0 || kernel >= kGruKernels || launches == nullptr)
    return (int)cudaErrorInvalidValue;
  *launches = (int)ptt::g_launches[kernel].load();
  return (int)cudaSuccess;
}
