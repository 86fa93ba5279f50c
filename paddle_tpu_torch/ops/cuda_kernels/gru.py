"""The GRU time loop, forward and BPTT: the CUDA kernels and their plain
PyTorch versions.

- K9 ``gru_forward`` and K10 ``gru_backward`` (``csrc/gru.cu``) replace the
  Pallas kernels ``gru_forward`` and ``gru_backward`` of
  ``paddle_tpu/ops/pallas_kernels/gru.py``.
- ``GRUTrain`` is the counterpart of ``make_gru_train``.

Contract: x_proj [B,T,3H] (projection and bias applied; layout update u,
reset r, candidate), h0 [B,H], w [H,3H] = [W_u, W_r | W_c], one dtype
(float32 or bfloat16), lengths [B] integers → hs [B,T,H], hT [B,H].
``[u, r] = σ(x[:, :2H] + h·W[:, :2H])``, ``c = tanh(x[:, 2H:] +
(r·h)·W[:, 2H:])`` (the reset gate applied BEFORE the candidate product, as
Paddle's GRU does), ``h' = u·h + (1−u)·c``; a step t ≥ lengths[b] keeps
row b's state.  The carried h is f32; h, r·h and, in the backward, the
gate gradients are rounded to the weight's dtype only as product operands;
dW takes f32 operands and is cast once.  The plain versions round at the
same points.  Any B, T, H; a CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises.

On a CUDA tensor each kernel has two bodies, and ``route`` picks one
before the launch by a shape rule (see there): ``"persistent"``, one
cooperative launch that runs the whole time loop (K10: then two launches
for dW), or ``"steps"``, step kernels (K9 2T launches, K10 4T + 2).
Nothing retries the other body after an error.
"""

from __future__ import annotations

import torch

from . import _common, _recurrent
from ._recurrent import (check_inputs, check_launchable, check_saved,
                         prev_states, step_mask)
from .lstm import _dot


def gru_forward_ref(x_proj, h0, w, lengths):
    """Plain version of K9: a Python loop over T."""
    B, T, H3 = x_proj.shape
    H = H3 // 3
    w_g, w_c = w[:, :2 * H], w[:, 2 * H:]
    mask = step_mask(lengths, T, torch.float32)
    h = h0.float()
    hs = []
    for t in range(T):
        x_t = x_proj[:, t].float()
        g = x_t[:, :2 * H] + _dot(h.to(w.dtype), w_g)
        u = torch.sigmoid(g[:, :H])
        r = torch.sigmoid(g[:, H:])
        c = torch.tanh(x_t[:, 2 * H:] + _dot((r * h).to(w.dtype), w_c))
        h_new = u * h + (1.0 - u) * c
        m = mask[:, t, None]
        h = m * h_new + (1.0 - m) * h
        hs.append(h.to(x_proj.dtype))
    return torch.stack(hs, 1), h.to(x_proj.dtype)


def gru_backward_ref(x_proj, h0, w, lengths, hs, dhs):
    """Plain version of K10: (dx, dh0, dw), the reverse-time loop of the
    Pallas backward kernel, not autograd."""
    B, T, H3 = x_proj.shape
    H = H3 // 3
    w_g, w_c = w[:, :2 * H], w[:, 2 * H:]
    mask = step_mask(lengths, T, torch.float32)
    h_prev = prev_states(h0, hs).float()
    dh = torch.zeros(B, H, dtype=torch.float32, device=x_proj.device)
    dw = torch.zeros(H, H3, dtype=torch.float32, device=x_proj.device)
    dx = [None] * T
    for t in reversed(range(T)):
        hp = h_prev[:, t]
        x_t = x_proj[:, t].float()
        g = x_t[:, :2 * H] + _dot(hp.to(w.dtype), w_g)
        u = torch.sigmoid(g[:, :H])
        r = torch.sigmoid(g[:, H:])
        rh = r * hp
        c = torch.tanh(x_t[:, 2 * H:] + _dot(rh.to(w.dtype), w_c))
        dh_acc = dhs[:, t].float() + dh
        m = mask[:, t, None]
        dh_raw = m * dh_acc
        dh_new = (1.0 - m) * dh_acc + dh_raw * u
        du = dh_raw * (hp - c)
        da_c = dh_raw * (1.0 - u) * (1.0 - c * c)
        drh = _dot(da_c.to(w.dtype), w_c.t())
        dh_new = dh_new + drh * r
        dg = torch.cat([du * u * (1.0 - u), drh * hp * r * (1.0 - r)], dim=1)
        dh_new = dh_new + _dot(dg.to(w.dtype), w_g.t())
        dx[t] = torch.cat([dg, da_c], dim=1).to(x_proj.dtype)
        dw[:, :2 * H] += torch.matmul(hp.t(), dg)
        dw[:, 2 * H:] += torch.matmul(rh.t(), da_c)
        dh = dh_new
    return torch.stack(dx, 1), dh.to(h0.dtype), dw.to(w.dtype)


def capacity(device, H, dtype, backward=False):
    """Blocks of the persistent forward (with ``backward``, the backward's
    loop) that fit on `device` at once at hidden width `H` in `dtype`: the
    C query ``ptt_gru_capacity`` (``_recurrent.capacity``)."""
    return _recurrent.capacity("ptt_gru_capacity", device, H, dtype,
                               backward)


def smem_bytes(device, H, dtype, backward=False):
    """Dynamic shared memory a block of the persistent forward (with
    ``backward``, the backward's loop) asks for at hidden width `H` in
    `dtype`: the C query ``ptt_gru_smem_bytes``, from the kernels' own
    layout."""
    return _common.query("ptt_gru_smem_bytes", H, _common.dtype_code(dtype),
                         int(backward), device=device)


def steps_widths(device):
    """Widths past 512 that `device`'s shared memory routes to the step
    kernels, from ``smem_bytes`` against its opt-in limit a block: the
    first multiple of 16 at which some body's block does not fit, and the
    first at which none does."""
    optin = torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin

    def fits(H):
        return [smem_bytes(device, H, dt, back) <= optin
                for dt in (torch.float32, torch.bfloat16)
                for back in (False, True)]

    some = next(H for H in range(512, 8192, 16) if not all(fits(H)))
    none = next(H for H in range(some, 8192, 16) if not any(fits(H)))
    return some, none


def route(x_proj, backward=False):
    """The body K9 (with ``backward``, K10) runs for CUDA inputs shaped as
    ``x_proj`` [B,T,3H], by this shape rule, chosen before the launch:
    ``"persistent"`` when one block of each of the ceil(H/16) column
    slices fits on the card at once (``capacity`` >= ceil(H/16)); the
    grid then runs min(ceil(B/16), capacity // ceil(H/16)) batch groups
    at a time, so neither B nor T enters.  Otherwise ``"steps"``.  A
    block's shared memory grows with H (``ptt_gru_smem_bytes``: W's 48
    columns of the slice, the warps' staging rings, the partial tiles),
    so a width past the card's opt-in limit takes the step kernels."""
    return _recurrent.route("ptt_gru_capacity", x_proj, 3, backward)


# the kernels K9 and K10 launch, in the order of the C query
# ``ptt_gru_device_launches``'s kernel codes (csrc/gru.cu, GruKernel);
# the step route's gru_gates serves both directions
KERNELS = ("gru_fwd_persistent", "gru_bwd_persistent", "gru_gates",
           "gru_fwd_cand", "gru_bwd_cand", "gru_bwd_drh", "gru_bwd_dh",
           "rnn_dw_kernel")


def device_launches(device):
    """{kernel name: device launches} that K9 and K10 have made since the
    kernel library was loaded, counted by the C entry points where each
    kernel is launched (``ptt_gru_device_launches``)."""
    return _recurrent.device_launches("ptt_gru_device_launches", KERNELS,
                                      device)


def gru_forward(x_proj, h0, w, lengths):
    """K9: (hs [B,T,H], hT [B,H]); on CUDA tensors the body
    ``route(x_proj)`` names."""
    B, T, H = check_inputs("gru_forward", 3, x_proj, w, lengths, h0)
    if B == 0 or T == 0:
        return x_proj.new_empty(B, T, H), h0.clone()
    if x_proj.device.type in _common.PLAIN_DEVICES:
        return gru_forward_ref(x_proj, h0, w, lengths)
    if x_proj.device.type != "cuda":
        raise ValueError(f"gru_forward: no kernel for {x_proj.device}")
    check_launchable("gru_forward", B, T, H, 3)
    dev = x_proj.device
    body = route(x_proj)
    if body == "persistent":
        # round(r·h) of every step, each row written once
        state = [None] * 4
        rhs = x_proj.new_empty(B, T, H)
        counters = _recurrent.group_counters(B, dev)
    else:
        # f32 [B,H] each: the carried h, then the scratch u, r and r·h
        state = torch.empty(4, B, H, dtype=torch.float32, device=dev)
        state[0] = h0
        rhs = counters = None
    hs, hT = x_proj.new_empty(B, T, H), x_proj.new_empty(B, H)
    _common.launch("ptt_gru_forward", x_proj.contiguous(), w.contiguous(),
                   h0.contiguous(), *state, rhs, hs, hT,
                   lengths.to(torch.int32).contiguous(), counters, B, T, H, _common.dtype_code(x_proj),
                   _recurrent.ROUTES[body], device=dev)
    gru_forward.launches += 1
    return hs, hT


def gru_backward(x_proj, h0, w, lengths, hs, dhs):
    """K10: (dx [B,T,3H], dh0 [B,H], dw [H,3H]) from the saved hs and its
    cotangent; on CUDA tensors the body ``route(x_proj, backward=True)``
    names."""
    B, T, H = check_inputs("gru_backward", 3, x_proj, w, lengths, h0)
    check_saved("gru_backward", B, T, H, x_proj, hs, dhs)
    if B == 0 or T == 0:
        return (torch.zeros_like(x_proj), torch.zeros_like(h0),
                torch.zeros_like(w))
    if x_proj.device.type in _common.PLAIN_DEVICES:
        return gru_backward_ref(x_proj, h0, w, lengths, hs, dhs)
    if x_proj.device.type != "cuda":
        raise ValueError(f"gru_backward: no kernel for {x_proj.device}")
    check_launchable("gru_backward", B, T, H, 3)
    dev, dt = x_proj.device, x_proj.dtype
    body = route(x_proj, backward=True)
    # f32 [B,H]: the dh carry (zero), which holds dh0 on return; the step
    # route's scratch u and r after it
    state = torch.zeros(1 if body == "persistent" else 3, B, H,
                        dtype=torch.float32, device=dev)
    # r·h_{t-1} in f32 for every step: the candidate's weight gradient
    rh_all = torch.empty(B, T, H, dtype=torch.float32, device=dev)
    dx = torch.empty_like(x_proj, memory_format=torch.contiguous_format)
    # bf16: the weight gradient takes the gate gradients unrounded
    dg32 = None if dt == torch.float32 else torch.empty(
        B, T, 3 * H, dtype=torch.float32, device=dev)
    dw = torch.empty(H, 3 * H, dtype=dt, device=dev)
    if body == "persistent":
        u_buf = r_buf = None
        # the candidate product's operand round(r·h) in bf16 (f32 reads
        # rh_all itself); the barriers: one a batch group, one a grid row
        rh16 = None if dt == torch.float32 else torch.empty(
            B, T, H, dtype=dt, device=dev)
        counters = _recurrent.group_counters(B, dev, per_group=2)
    else:
        u_buf, r_buf = state[1], state[2]
        rh16 = counters = None
    _common.launch("ptt_gru_backward", x_proj.contiguous(), w.contiguous(),
                   h0.contiguous(), hs.to(dt).contiguous(),
                   dhs.to(dt).contiguous(), state[0], u_buf, r_buf, rh_all,
                   rh16, dx, dg32, dw, lengths.to(torch.int32).contiguous(),
                   counters, B, T, H, _common.dtype_code(x_proj),
                   _recurrent.ROUTES[body], device=dev)
    gru_backward.launches += 1
    return dx, state[0].to(h0.dtype), dw


gru_forward.launches = 0
gru_backward.launches = 0


class GRUTrain(torch.autograd.Function):
    """The GRU for training, the counterpart of JAX ``make_gru_train``:
    (x_proj, h0, w, lengths) → hs.  The forward runs K9, the backward K10;
    on CPU tensors both take the plain versions."""

    @staticmethod
    def forward(ctx, x_proj, h0, w, lengths):
        hs, _ = gru_forward(x_proj, h0, w, lengths)
        ctx.save_for_backward(x_proj, h0, w, lengths, hs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        x_proj, h0, w, lengths, hs = ctx.saved_tensors
        dx, dh0, dw = gru_backward(x_proj, h0, w, lengths, hs, dhs)
        return dx, dh0, dw, None
