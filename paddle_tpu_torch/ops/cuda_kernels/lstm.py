"""The LSTM time loop, forward and BPTT: the CUDA kernels and their plain
PyTorch versions.

- K7 ``lstm_forward`` and K8 ``lstm_backward`` (``csrc/lstm.cu``) replace
  the Pallas kernels ``lstm_forward`` and ``lstm_backward`` of
  ``paddle_tpu/ops/pallas_kernels/lstm.py``.
- ``LSTMTrain`` is the counterpart of ``make_lstm_train``: a
  ``torch.autograd.Function`` whose forward runs K7 and whose backward
  runs K8.

Contract: x_proj [B,T,4H] (the input projection and bias already applied;
gate order i, f, c̃, o), h0, c0 [B,H], w [H,4H], all of one dtype (float32
or bfloat16), lengths [B] integers → hs, cs [B,T,H] and hT, cT [B,H] in
that dtype.  Default activations, no peepholes.  The carried h and c are
f32; h is rounded to the weight's dtype only as the product's operand; a
step t ≥ lengths[b] keeps row b's state.  The backward recomputes the
gates from (x_t, h_{t-1}, W) with h_{t-1}, c_{t-1} read from the saved,
rounded hs, cs; the gate gradient dg is rounded to the weight's dtype for
dg·Wᵀ, dW takes f32 h_{t-1} and f32 dg, dx is dg in the input's dtype, and
dw is summed in f32 and cast once.  The plain versions round at the same
points.  Any B, T, H; a CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises.

On a CUDA tensor each kernel has two bodies, and ``route`` picks one
before the launch by a shape rule (see there): ``"persistent"``, one
cooperative launch that runs the whole time loop (K8: then one launch for
dW), or ``"steps"``, a launch a step (K7 T launches, K8 2T + 1).  Nothing
retries the other body after an error.
"""

from __future__ import annotations

import torch

from . import _common, _recurrent
from ._recurrent import (check_inputs, check_launchable, check_saved,
                         prev_states, step_mask)


def _dot(a, b):
    """a·b summed in f32 from operands that keep their rounding."""
    return torch.matmul(a.float(), b.float())


def lstm_forward_ref(x_proj, h0, c0, w, lengths):
    """Plain version of K7: a Python loop over T."""
    B, T, H4 = x_proj.shape
    H = H4 // 4
    mask = step_mask(lengths, T, torch.float32)
    h, c = h0.float(), c0.float()
    hs, cs = [], []
    for t in range(T):
        g = x_proj[:, t].float() + _dot(h.to(w.dtype), w)
        i = torch.sigmoid(g[:, :H])
        f = torch.sigmoid(g[:, H:2 * H])
        cand = torch.tanh(g[:, 2 * H:3 * H])
        o = torch.sigmoid(g[:, 3 * H:])
        c_new = f * c + i * cand
        h_new = o * torch.tanh(c_new)
        m = mask[:, t, None]
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        hs.append(h.to(x_proj.dtype))
        cs.append(c.to(x_proj.dtype))
    return (torch.stack(hs, 1), torch.stack(cs, 1), h.to(x_proj.dtype),
            c.to(x_proj.dtype))


def lstm_backward_ref(x_proj, h0, c0, w, lengths, hs, cs, dhs, dcs):
    """Plain version of K8: (dx, dh0, dc0, dw), the reverse-time loop of
    the Pallas backward kernel, not autograd."""
    B, T, H4 = x_proj.shape
    H = H4 // 4
    mask = step_mask(lengths, T, torch.float32)
    h_prev = prev_states(h0, hs).float()
    c_prev = prev_states(c0, cs).float()
    dh = torch.zeros(B, H, dtype=torch.float32, device=x_proj.device)
    dc = torch.zeros_like(dh)
    dw = torch.zeros(H, H4, dtype=torch.float32, device=x_proj.device)
    dx = [None] * T
    for t in reversed(range(T)):
        hp, cp = h_prev[:, t], c_prev[:, t]
        g = x_proj[:, t].float() + _dot(hp.to(w.dtype), w)
        i = torch.sigmoid(g[:, :H])
        f = torch.sigmoid(g[:, H:2 * H])
        u = torch.tanh(g[:, 2 * H:3 * H])
        o = torch.sigmoid(g[:, 3 * H:])
        tc = torch.tanh(f * cp + i * u)
        dh_acc = dhs[:, t].float() + dh
        dc_acc = dcs[:, t].float() + dc
        m = mask[:, t, None]
        dh_raw = m * dh_acc
        dc_raw = m * dc_acc + dh_raw * o * (1.0 - tc * tc)
        dg = torch.cat([dc_raw * u * i * (1.0 - i),
                        dc_raw * cp * f * (1.0 - f),
                        dc_raw * i * (1.0 - u * u),
                        dh_raw * tc * o * (1.0 - o)], dim=1)
        dx[t] = dg.to(x_proj.dtype)
        dw += torch.matmul(hp.t(), dg)
        dh = (1.0 - m) * dh_acc + _dot(dg.to(w.dtype), w.t())
        dc = (1.0 - m) * dc_acc + dc_raw * f
    return (torch.stack(dx, 1), dh.to(h0.dtype), dc.to(c0.dtype),
            dw.to(w.dtype))


def capacity(device, H, dtype, backward=False):
    """Blocks of the persistent forward (with ``backward``, the backward's
    loop) that fit on `device` at once at hidden width `H` in `dtype`: the
    C query ``ptt_lstm_capacity`` (``_recurrent.capacity``)."""
    return _recurrent.capacity("ptt_lstm_capacity", device, H, dtype,
                               backward)


def route(x_proj, backward=False):
    """The body K7 (with ``backward``, K8) runs for CUDA inputs shaped as
    ``x_proj`` [B,T,4H], by this shape rule, chosen before the launch:
    ``"persistent"`` when one block of each of the ceil(H/16) column
    slices fits on the card at once (``capacity`` >= ceil(H/16)); the
    grid then runs min(ceil(B/16), capacity // ceil(H/16)) batch groups
    at a time, so B does not enter, nor does T.  Otherwise ``"steps"``.
    A block's shared memory grows with H (``ptt_lstm_smem_bytes``; at H
    512 143 KB forward and 180 KB backward in bf16, 209 and 227 KB in
    f32), so with 227 KB a block, as on an H100, the persistent route
    takes the f32 forward to H 576, the f32 backward to H 512, the bf16
    forward to H 1088 and the bf16 backward to H 832."""
    return _recurrent.route("ptt_lstm_capacity", x_proj, 4, backward)


# the kernels K7 and K8 launch, in the order of the C query
# ``ptt_lstm_device_launches``'s kernel codes (csrc/lstm.cu, LstmKernel)
KERNELS = ("lstm_fwd_persistent", "lstm_fwd_step", "lstm_bwd_persistent",
           "lstm_bwd_gates", "lstm_bwd_dh", "lstm_dw_mma", "rnn_dw_kernel")


def device_launches(device):
    """{kernel name: device launches} that K7 and K8 have made since the
    kernel library was loaded, counted by the C entry points where each
    kernel is launched (``ptt_lstm_device_launches``)."""
    return _recurrent.device_launches("ptt_lstm_device_launches", KERNELS,
                                      device)


def _empty_forward(x_proj, h0, c0, B, T, H):
    hs = x_proj.new_empty(B, T, H)
    return hs, hs.clone(), h0.clone(), c0.clone()


def lstm_forward(x_proj, h0, c0, w, lengths):
    """K7: (hs [B,T,H], cs [B,T,H], hT [B,H], cT [B,H]); on CUDA tensors
    the body ``route(x_proj)`` names."""
    B, T, H = check_inputs("lstm_forward", 4, x_proj, w, lengths, h0, c0)
    if B == 0 or T == 0:
        return _empty_forward(x_proj, h0, c0, B, T, H)
    if x_proj.device.type in _common.PLAIN_DEVICES:
        return lstm_forward_ref(x_proj, h0, c0, w, lengths)
    if x_proj.device.type != "cuda":
        raise ValueError(f"lstm_forward: no kernel for {x_proj.device}")
    check_launchable("lstm_forward", B, T, H, 4)
    dev = x_proj.device
    body = route(x_proj)
    if body == "persistent":
        hbuf = c = None
        counters = _recurrent.group_counters(B, dev)
    else:
        hbuf = torch.empty(2, B, H, dtype=torch.float32, device=dev)
        hbuf[0] = h0
        c = c0.float().clone()
        counters = None
    hs, cs = x_proj.new_empty(B, T, H), x_proj.new_empty(B, T, H)
    hT, cT = x_proj.new_empty(B, H), x_proj.new_empty(B, H)
    _common.launch("ptt_lstm_forward", x_proj.contiguous(), w.contiguous(),
                   h0.contiguous(), c0.contiguous(), hbuf, c, hs, cs, hT, cT,
                   lengths.to(torch.int32).contiguous(), counters, B, T, H,
                   _common.dtype_code(x_proj), _recurrent.ROUTES[body],
                   device=dev)
    lstm_forward.launches += 1
    return hs, cs, hT, cT


def lstm_backward(x_proj, h0, c0, w, lengths, hs, cs, dhs, dcs):
    """K8: (dx [B,T,4H], dh0, dc0 [B,H], dw [H,4H]) from the saved hs, cs
    and their cotangents; on CUDA tensors the body
    ``route(x_proj, backward=True)`` names."""
    B, T, H = check_inputs("lstm_backward", 4, x_proj, w, lengths, h0, c0)
    check_saved("lstm_backward", B, T, H, x_proj, hs, cs, dhs, dcs)
    if B == 0 or T == 0:
        return (torch.zeros_like(x_proj), torch.zeros_like(h0),
                torch.zeros_like(c0), torch.zeros_like(w))
    if x_proj.device.type in _common.PLAIN_DEVICES:
        return lstm_backward_ref(x_proj, h0, c0, w, lengths, hs, cs, dhs,
                                 dcs)
    if x_proj.device.type != "cuda":
        raise ValueError(f"lstm_backward: no kernel for {x_proj.device}")
    check_launchable("lstm_backward", B, T, H, 4)
    dev, dt = x_proj.device, x_proj.dtype
    carry = torch.zeros(2, B, H, dtype=torch.float32, device=dev)
    dx = torch.empty_like(x_proj, memory_format=torch.contiguous_format)
    # bf16: the weight gradient takes the gate gradients unrounded
    dg32 = None if dt == torch.float32 else torch.empty(
        B, T, 4 * H, dtype=torch.float32, device=dev)
    dw = torch.empty(H, 4 * H, dtype=dt, device=dev)
    body = route(x_proj, backward=True)
    counters = _recurrent.group_counters(B, dev) \
        if body == "persistent" else None
    _common.launch("ptt_lstm_backward", x_proj.contiguous(), w.contiguous(),
                   h0.contiguous(), c0.contiguous(),
                   hs.to(dt).contiguous(), cs.to(dt).contiguous(),
                   dhs.to(dt).contiguous(), dcs.to(dt).contiguous(),
                   carry[0], carry[1], dx, dg32, dw,
                   lengths.to(torch.int32).contiguous(), counters, B, T, H,
                   _common.dtype_code(x_proj), _recurrent.ROUTES[body],
                   device=dev)
    lstm_backward.launches += 1
    return dx, carry[0].to(h0.dtype), carry[1].to(c0.dtype), dw


lstm_forward.launches = 0
lstm_backward.launches = 0


class LSTMTrain(torch.autograd.Function):
    """The LSTM for training, the counterpart of JAX ``make_lstm_train``:
    (x_proj, h0, c0, w, lengths) → (hs, cs).  The forward runs K7 and saves
    its inputs and outputs; the backward runs K8 on the cotangents of hs
    and cs (a missing one arrives as zeros).  On CPU tensors both take the
    plain versions."""

    @staticmethod
    def forward(ctx, x_proj, h0, c0, w, lengths):
        hs, cs, _, _ = lstm_forward(x_proj, h0, c0, w, lengths)
        ctx.save_for_backward(x_proj, h0, c0, w, lengths, hs, cs)
        return hs, cs

    @staticmethod
    def backward(ctx, dhs, dcs):
        x_proj, h0, c0, w, lengths, hs, cs = ctx.saved_tensors
        dx, dh0, dc0, dw = lstm_backward(x_proj, h0, c0, w, lengths, hs, cs,
                                         dhs, dcs)
        return dx, dh0, dc0, dw, None
