"""What the LSTM and GRU wrappers share (``lstm.py``, ``gru.py``): the
padded-step mask and the reverse-within-length view of
``paddle_tpu/ops/pallas_kernels/_common.py`` as plain functions on
tensors, the checks the kernels' entry points rely on, and the shape rule
that picks a kernel's body on a CUDA tensor."""

from __future__ import annotations

import torch

from . import _common


def step_mask(lengths, T, dtype):
    """[B] lengths -> [B,T] {0,1} mask in `dtype`."""
    steps = torch.arange(T, device=lengths.device)
    return (steps[None, :] < lengths[:, None]).to(dtype)


def reverse_within_length(x, lengths, pad_fill=None):
    """Flip each row's first ``lengths[b]`` steps of x [B,T,...], keeping
    the padding at the tail: a reversed recurrence over padded data is the
    forward one run on this view, with its outputs flipped back.  A row of
    length 0 maps every step to itself.  ``pad_fill`` (a [B,...] state,
    broadcast over time) overwrites the tail — the convention for OUTPUT
    arrays, whose pad steps carry the untouched initial state."""
    T = x.shape[1]
    idx = torch.arange(T, device=x.device)[None, :]
    rev = lengths[:, None].long() - 1 - idx
    rev = torch.where(rev >= 0, rev, idx)
    rev = rev.reshape(rev.shape + (1,) * (x.ndim - 2)).expand(x.shape)
    out = torch.gather(x, 1, rev)
    if pad_fill is not None:
        m = step_mask(lengths, T, torch.bool)
        m = m.reshape(m.shape + (1,) * (out.ndim - 2))
        out = torch.where(m, out, pad_fill[:, None].to(out.dtype))
    return out


def prev_states(s0, ss):
    """[s0, ss[:, :-1]] along time: the state each step starts from."""
    return torch.cat([s0[:, None], ss[:, :-1]], dim=1)


def check_inputs(name, gates, x_proj, w, lengths, *states):
    """The recurrent kernels' contract: x_proj [B,T,gates·H], w
    [H,gates·H], every state [B,H], all of one float dtype on one device;
    lengths [B] integers.  Returns (B, T, H)."""
    if x_proj.ndim != 3 or w.ndim != 2:
        raise ValueError(f"{name}: x_proj must be [B,T,{gates}H] and w "
                         f"[H,{gates}H], got {tuple(x_proj.shape)} and "
                         f"{tuple(w.shape)}")
    B, T, G = x_proj.shape
    H = w.shape[0]
    if G != gates * H or w.shape[1] != gates * H:
        raise ValueError(f"{name}: x_proj {tuple(x_proj.shape)} and w "
                         f"{tuple(w.shape)} do not agree on H with "
                         f"{gates} gates")
    for s in states:
        if tuple(s.shape) != (B, H):
            raise ValueError(f"{name}: a state must be [B,H] = [{B},{H}], "
                             f"got {tuple(s.shape)}")
    if tuple(lengths.shape) != (B,) or lengths.is_floating_point():
        raise ValueError(f"{name}: lengths must be [B] = [{B}] integers, "
                         f"got {tuple(lengths.shape)} {lengths.dtype}")
    for t in (w, *states):
        if t.dtype != x_proj.dtype:
            raise TypeError(f"{name}: x_proj, w and the states must share "
                            f"one dtype, got {x_proj.dtype} and {t.dtype}")
    for t in (w, lengths, *states):
        if t.device != x_proj.device:
            raise ValueError(f"{name}: inputs must share one device")
    return B, T, H


def check_saved(name, B, T, H, x_proj, *saved):
    """Saved states and cotangents [B,T,H] on x_proj's device."""
    for s in saved:
        if tuple(s.shape) != (B, T, H) or s.device != x_proj.device:
            raise ValueError(f"{name}: expected [B,T,H] = [{B},{T},{H}] on "
                             f"{x_proj.device}, got {tuple(s.shape)} on "
                             f"{s.device}")


# the kernels index with 32-bit row numbers and size_t offsets
_MAX_ROWS = 2 ** 31 - 1


def check_launchable(name, B, T, H, gates):
    if B * T > _MAX_ROWS or gates * H > _MAX_ROWS:
        raise ValueError(f"{name}: B*T = {B * T} and {gates}H = {gates * H} "
                         f"must each stay below 2^31")
    if (max(B, H) + 15) // 16 > 65535:
        raise ValueError(f"{name}: B = {B} or H = {H} needs more than 65535 "
                         f"tiles of 16 rows (grid.y)")


# the persistent kernels' tile: a block owns 16 hidden columns (a slice)
# for the whole call and runs 16 batch rows (a group) at a time
# (csrc/persistent.cuh)
ROWS = COLS = 16
ROUTES = {"steps": 0, "persistent": 1}
_capacity = {}


def capacity(query, device, H, dtype, backward):
    """Blocks of a persistent kernel that fit on `device` at once at hidden
    width `H` in `dtype`, each with its slice of W in shared memory: the C
    query `query` (``ptt_lstm_capacity``, ``ptt_gru_capacity``), 0 when a
    block's shared memory exceeds the device's opt-in limit, else the
    blocks a multiprocessor holds times the multiprocessors."""
    key = (query, device.index, H, dtype, bool(backward))
    if key not in _capacity:
        _capacity[key] = _common.query(query, H, _common.dtype_code(dtype),
                                       int(backward), device=device)
    return _capacity[key]


def route(query, x_proj, gates, backward):
    """``"persistent"`` when one block of each of the ceil(H/16) column
    slices of x_proj [B,T,gates·H] fits on its card at once (``capacity``
    by `query` >= ceil(H/16)), else ``"steps"``; B and T do not enter."""
    H = x_proj.shape[2] // gates
    blocks = capacity(query, x_proj.device, H, x_proj.dtype, backward)
    return "persistent" if blocks >= -(-H // COLS) else "steps"


def device_launches(query, kernels, device):
    """{kernel name: device launches} counted by the C query `query` for
    each of `kernels`, in the order of its kernel codes."""
    return {name: _common.query(query, i, device=device)
            for i, name in enumerate(kernels)}


def group_counters(B, dev, per_group=1):
    """The persistent kernels' barriers: `per_group` counters for each
    batch group of B's, zero."""
    return torch.zeros(per_group * -(-B // ROWS), dtype=torch.int32,
                       device=dev)
