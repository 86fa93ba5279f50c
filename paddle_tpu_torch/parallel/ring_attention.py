"""Ring and Ulysses attention: sequence parallelism over the 'sp' mesh axis
— the port of ``paddle_tpu/parallel/ring_attention.py``.

Q, K, V are sharded along the sequence axis over the 'sp' positions; each
position holds its Q chunk, and K/V chunks rotate around the ring
(``collectives.ppermute``) while the chunks' attention merges:

- **plain ring** (``_ring_body``): each chunk's scores in the plain
  attention, an online softmax (max, normalizer, output) in f32;
- **flash ring** (``_ring_flash_fwd``/``_ring_flash_bwd``): each chunk
  through K4 (``flash_attention_fwd``: output and logsumexp), merged by
  ``o = Σ_s o_s · exp(lse_s − lse_tot)`` in f32; the backward runs K5 and
  K6 (``flash_attention_bwd``) against the total logsumexp for each hop,
  and the dK/dV accumulators rotate with their chunks, so after S hops
  each chunk's gradient is home.  Causal: after s hops a position holds
  chunk (my − s) mod S, the diagonal at s = 0 (K4's causal flag), past
  for my ≥ s, future otherwise (its lse forced to −inf, so its weight is
  0; its backward block is dropped) — one K4 launch a hop forward and one
  K5 + K6 a hop backward, as the JAX schedule runs;
- **zigzag** (``zigzag_permutation``, ``_ring_flash_zigzag_core``): the
  load-balanced causal schedule, position d holding half-chunks (d,
  2S−1−d): 2S + 1 equal K4 blocks a position a layer in the forward and
  as many K5/K6 blocks in the backward.  Single-controller, the port
  knows each position's index on the host, so where JAX selects operands
  with ``jnp.where`` on a traced index the port picks them in Python: the
  same blocks, the same results;
- **Ulysses** (``ulysses_attention``): an ``all_to_all`` pair re-shards
  seq → heads and back around one full-sequence attention a position
  (K4 forward, or ``FlashAttentionTrain`` in training).

Training: ``ring_flash_train`` and ``ring_zigzag_train`` run the ring as
one ``torch.autograd.Function`` over every position's shards at once, the
counterparts of ``make_ring_flash_train`` and
``make_ring_flash_zigzag_train``.

The gate is the port's: the kernel wrappers launch K4–K6 on CUDA tensors
or raise, and take their plain versions (``flash_attention_fwd_ref``,
``flash_attention_bwd_ref``) on CPU tensors.  JAX's 128-tile gates
(``flash_ring_eligible``, ``flash_ulysses_eligible``) are Mosaic's and are
not ported: ``scaled_dot_product_attention`` under an 'sp' mesh takes the
flash ring, zigzag whenever it is causal and T divides by 2S.

The ``*_shards`` functions take and return one tensor a mesh position (the
mesh's row-major order), [B, H, t, D] each; ``ring_attention`` and
``ulysses_attention`` take global [B, H, T, D] tensors, as JAX's do.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.cuda_kernels import flash_attention as fa
from . import collectives as col
from .mesh import axis_size


def attention(q, k, v, causal: bool = False, scale: Optional[float] = None):
    """Dense reference: q,k,v [B, H, T, D] → [B, H, T, D]."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * s
    if causal:
        T = q.shape[2]
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask[None, None], logits,
                             torch.tensor(-1e30, dtype=logits.dtype,
                                          device=q.device))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)


def _perm(S):
    return [(i, (i + 1) % S) for i in range(S)]


def _each(mesh, xs, fn, *more):
    """fn(xs[p], *(m[p] for m in more)) at this process's positions."""
    return mesh.local_map(lambda p: fn(xs[p], *(m[p] for m in more)))


def _zeros32(x):
    return torch.zeros(x.shape, dtype=torch.float32, device=x.device)


def _mine(mesh, xs):
    """This process's entries of a per-position list."""
    return [xs[p] for p in mesh.local]


def _full(mesh, mine):
    """A per-position list from this process's entries."""
    out = [None] * mesh.size
    for p, x in zip(mesh.local, mine):
        out[p] = x
    return out


def _merge(o_acc, lse_acc, o_s, lse_s):
    """The attention-merge identity in f32: (o, lse) of two chunks' parts."""
    lse_s = lse_s.reshape(lse_acc.shape).float()
    lse_new = torch.logaddexp(lse_acc, lse_s)
    o_new = (o_acc * torch.exp(lse_acc - lse_new)[..., None]
             + o_s.float() * torch.exp(lse_s - lse_new)[..., None])
    return o_new, lse_new


def _ring_body(qs, ks, vs, mesh, axis: str, causal: bool, scale: float):
    """Plain ring, every position at once: the online softmax in f32 over
    the chunks as they arrive."""
    S = axis_size(mesh, axis)
    my = col.axis_index(mesh, axis)
    q_s = _each(mesh, qs, lambda q: q * scale)
    m = _each(mesh, qs, lambda q: torch.full(
        q.shape[:-1], -1e30, dtype=torch.float32, device=q.device))
    l = _each(mesh, qs, lambda q: torch.zeros(
        q.shape[:-1], dtype=torch.float32, device=q.device))
    o = _each(mesh, qs, lambda q: torch.zeros(
        q.shape, dtype=torch.float32, device=q.device))
    k_cur, v_cur = list(ks), list(vs)
    for s in range(S):
        for p in mesh.local:
            t = qs[p].shape[2]
            logits = torch.einsum("bhqd,bhkd->bhqk", q_s[p],
                                  k_cur[p]).float()
            if causal:
                src = (my[p] - s) % S
                q_pos = my[p] * t + torch.arange(t, device=qs[p].device)
                k_pos = src * t + torch.arange(t, device=qs[p].device)
                mask = q_pos[:, None] >= k_pos[None, :]
                logits = torch.where(mask[None, None], logits,
                                     torch.tensor(-1e30,
                                                  device=logits.device))
            m_new = torch.maximum(m[p], logits.amax(-1))
            corr = torch.exp(m[p] - m_new)
            pr = torch.exp(logits - m_new[..., None])
            l[p] = l[p] * corr + pr.sum(-1)
            o[p] = o[p] * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", pr, v_cur[p].float())
            m[p] = m_new
        k_cur = col.ppermute(k_cur, mesh, axis, _perm(S))
        v_cur = col.ppermute(v_cur, mesh, axis, _perm(S))
    return mesh.local_map(lambda p: (o[p] / l[p][..., None]).to(
        qs[p].dtype))


def _ring_flash_fwd(qs, ks, vs, mesh, axis, scale, causal):
    """Flash ring forward: (out shards, f32 lse shards [B,H,t])."""
    S = axis_size(mesh, axis)
    my = col.axis_index(mesh, axis)
    o_acc = _each(mesh, qs, lambda q: torch.zeros(
        q.shape, dtype=torch.float32, device=q.device))
    lse_acc = _each(mesh, qs, lambda q: torch.full(
        q.shape[:-1], float("-inf"), dtype=torch.float32, device=q.device))
    k_cur, v_cur = list(ks), list(vs)
    for s in range(S):
        for p in mesh.local:
            out_s, lse_s = fa.flash_attention_fwd(
                qs[p], k_cur[p], v_cur[p], causal=causal and s == 0,
                scale=scale)
            lse_s = lse_s.reshape(lse_acc[p].shape).float()
            if causal and s > 0 and my[p] < s:
                lse_s = torch.full_like(lse_s, float("-inf"))
            o_acc[p], lse_acc[p] = _merge(o_acc[p], lse_acc[p], out_s,
                                          lse_s)
        if s < S - 1:  # the final hop's result would be discarded
            k_cur = col.ppermute(k_cur, mesh, axis, _perm(S))
            v_cur = col.ppermute(v_cur, mesh, axis, _perm(S))
    return _each(mesh, o_acc, lambda o, q: o.to(q.dtype), qs), lse_acc


def _ring_flash_bwd(qs, ks, vs, outs, lses, dos, mesh, axis, scale,
                    causal):
    """Flash ring backward: K5 and K6 a hop against the total lse; dK/dV
    accumulators rotate with their chunks (all S hops, arriving home)."""
    S = axis_size(mesh, axis)
    my = col.axis_index(mesh, axis)
    dq, dk, dv = (_each(mesh, xs, _zeros32) for xs in (qs, ks, vs))
    k_cur, v_cur = list(ks), list(vs)
    for s in range(S):
        for p in mesh.local:
            lse_k = lses[p].reshape(-1, lses[p].shape[-1])
            dq_s, dk_s, dv_s = fa.flash_attention_bwd(
                qs[p], k_cur[p], v_cur[p], outs[p], lse_k, dos[p],
                causal=causal and s == 0, scale=scale)
            if causal and s > 0 and my[p] < s:
                continue  # a future chunk: no contribution either way
            dq[p] = dq[p] + dq_s.float()
            dk[p] = dk[p] + dk_s.float()
            dv[p] = dv[p] + dv_s.float()
        if s < S - 1:
            k_cur = col.ppermute(k_cur, mesh, axis, _perm(S))
            v_cur = col.ppermute(v_cur, mesh, axis, _perm(S))
        dk = col.ppermute(dk, mesh, axis, _perm(S))
        dv = col.ppermute(dv, mesh, axis, _perm(S))
    return tuple(_each(mesh, g, lambda a, x: a.to(x.dtype), xs)
                 for g, xs in ((dq, qs), (dk, ks), (dv, vs)))


def zigzag_permutation(T: int, S: int):
    """Permutation placing chunk pair (d, 2S-1-d) contiguous for position
    d (T split into 2S half-chunks).  Returns (perm, inv) index arrays:
    x_zig = x[..., perm, :] shards the zigzag layout contiguously;
    x = x_zig[..., inv, :] undoes it."""
    t2 = T // (2 * S)
    order = []
    for d in range(S):
        order.extend(range(d * t2, (d + 1) * t2))
        order.extend(range((2 * S - 1 - d) * t2, (2 * S - d) * t2))
    perm = np.asarray(order)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(T)
    return perm, inv


def _halves(x):
    t2 = x.shape[2] // 2
    return x[:, :, :t2], x[:, :, t2:]


def _ring_flash_zigzag_core(qs, ks, vs, mesh, axis, scale):
    """Zigzag forward over the zigzag-laid-out shards: (out, lse)."""
    S = axis_size(mesh, axis)
    my = col.axis_index(mesh, axis)

    def fresh(x):
        return (torch.zeros(x.shape, dtype=torch.float32, device=x.device),
                torch.full(x.shape[:-1], float("-inf"),
                           dtype=torch.float32, device=x.device))

    acc_e = _each(mesh, qs, lambda q: fresh(_halves(q)[0]))
    acc_l = _each(mesh, qs, lambda q: fresh(_halves(q)[1]))
    k_cur, v_cur = list(ks), list(vs)
    for s in range(S):
        for p in mesh.local:
            qe, ql = _halves(qs[p])
            ke, kl = _halves(k_cur[p])
            ve, vl = _halves(v_cur[p])
            if s == 0:
                o, l_ = fa.flash_attention_fwd(qe, ke, ve, causal=True,
                                               scale=scale)
                acc_e[p] = _merge(*acc_e[p], o, l_)
                o, l_ = fa.flash_attention_fwd(ql, kl, vl, causal=True,
                                               scale=scale)
                acc_l[p] = _merge(*acc_l[p], o, l_)
            elif my[p] >= s:  # (q_early, kv_early) is live
                o, l_ = fa.flash_attention_fwd(qe, ke, ve, causal=False,
                                               scale=scale)
                acc_e[p] = _merge(*acc_e[p], o, l_)
            else:  # (q_late, kv_late) is live
                o, l_ = fa.flash_attention_fwd(ql, kl, vl, causal=False,
                                               scale=scale)
                acc_l[p] = _merge(*acc_l[p], o, l_)
            o, l_ = fa.flash_attention_fwd(ql, ke, ve, causal=False,
                                           scale=scale)
            acc_l[p] = _merge(*acc_l[p], o, l_)
        if s < S - 1:
            k_cur = col.ppermute(k_cur, mesh, axis, _perm(S))
            v_cur = col.ppermute(v_cur, mesh, axis, _perm(S))
    outs = mesh.local_map(lambda p: torch.cat(
        [acc_e[p][0], acc_l[p][0]], 2).to(qs[p].dtype))
    lses = mesh.local_map(lambda p: torch.cat(
        [acc_e[p][1], acc_l[p][1]], 2))
    return outs, lses


def _ring_flash_zigzag_bwd(qs, ks, vs, outs, lses, dos, mesh, axis, scale):
    """Zigzag backward: the same balanced block schedule transposed; the
    dK/dV pair rotates with its K/V pair (all S hops, arriving home)."""
    S = axis_size(mesh, axis)
    my = col.axis_index(mesh, axis)
    dq_e = _each(mesh, qs, lambda q: _zeros32(_halves(q)[0]))
    dq_l = _each(mesh, qs, lambda q: _zeros32(_halves(q)[1]))
    dk, dv = (_each(mesh, xs, _zeros32) for xs in (ks, vs))
    k_cur, v_cur = list(ks), list(vs)

    def rows(lse):
        return lse.reshape(-1, lse.shape[-1])

    for s in range(S):
        for p in mesh.local:
            qe, ql = _halves(qs[p])
            oe, ol = _halves(outs[p])
            doe, dol = _halves(dos[p])
            lse_e, lse_l = (rows(h) for h in _halves(lses[p]))
            ke, kl = _halves(k_cur[p])
            ve, vl = _halves(v_cur[p])
            dke = torch.zeros(ke.shape, dtype=torch.float32,
                              device=ke.device)
            dve, dkl, dvl = (torch.zeros_like(dke) for _ in range(3))
            if s == 0:
                a, b, c = fa.flash_attention_bwd(qe, ke, ve, oe, lse_e, doe,
                                                 causal=True, scale=scale)
                dq_e[p] = dq_e[p] + a.float()
                dke, dve = dke + b.float(), dve + c.float()
                a, b, c = fa.flash_attention_bwd(ql, kl, vl, ol, lse_l, dol,
                                                 causal=True, scale=scale)
                dq_l[p] = dq_l[p] + a.float()
                dkl, dvl = dkl + b.float(), dvl + c.float()
            elif my[p] >= s:
                a, b, c = fa.flash_attention_bwd(qe, ke, ve, oe, lse_e, doe,
                                                 causal=False, scale=scale)
                dq_e[p] = dq_e[p] + a.float()
                dke, dve = dke + b.float(), dve + c.float()
            else:
                a, b, c = fa.flash_attention_bwd(ql, kl, vl, ol, lse_l, dol,
                                                 causal=False, scale=scale)
                dq_l[p] = dq_l[p] + a.float()
                dkl, dvl = dkl + b.float(), dvl + c.float()
            a, b, c = fa.flash_attention_bwd(ql, ke, ve, ol, lse_l, dol,
                                             causal=False, scale=scale)
            dq_l[p] = dq_l[p] + a.float()
            dke, dve = dke + b.float(), dve + c.float()
            dk[p] = dk[p] + torch.cat([dke, dkl], 2)
            dv[p] = dv[p] + torch.cat([dve, dvl], 2)
        if s < S - 1:
            k_cur = col.ppermute(k_cur, mesh, axis, _perm(S))
            v_cur = col.ppermute(v_cur, mesh, axis, _perm(S))
        dk = col.ppermute(dk, mesh, axis, _perm(S))
        dv = col.ppermute(dv, mesh, axis, _perm(S))
    dq = mesh.local_map(lambda p: torch.cat([dq_e[p], dq_l[p]], 2).to(
        qs[p].dtype))
    return (dq, _each(mesh, dk, lambda g, k: g.to(k.dtype), ks),
            _each(mesh, dv, lambda g, v: g.to(v.dtype), vs))


class _RingTrain(torch.autograd.Function):
    """A ring over this process's positions' shards: forward (out, lse)
    by `fwd`, backward by `bwd` (whose hops reach the other processes'
    positions).  Inputs: (spec, *qs, *ks, *vs), the local positions'
    only."""

    @staticmethod
    def forward(ctx, spec, *qkv):
        mesh = spec["mesh"]
        L = len(mesh.local)
        qs, ks, vs = (_full(mesh, qkv[i * L:(i + 1) * L]) for i in range(3))
        outs, lses = spec["fwd"](qs, ks, vs)
        ctx.spec = spec
        ctx.save_for_backward(*qkv, *_mine(mesh, outs), *_mine(mesh, lses))
        return tuple(_mine(mesh, outs))

    @staticmethod
    def backward(ctx, *dos):
        spec = ctx.spec
        mesh = spec["mesh"]
        L = len(mesh.local)
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (_full(mesh, saved[i * L:(i + 1) * L])
                                  for i in range(5))
        dos = _full(mesh, [torch.zeros_like(o) if d is None else d
                           for d, o in zip(dos, saved[3 * L:4 * L])])
        dq, dk, dv = spec["bwd"](qs, ks, vs, outs, lses, dos)
        return (None, *_mine(mesh, dq), *_mine(mesh, dk), *_mine(mesh, dv))


def _train(spec, qs, ks, vs):
    mesh = spec["mesh"]
    return _full(mesh, _RingTrain.apply(spec, *_mine(mesh, qs),
                                        *_mine(mesh, ks), *_mine(mesh, vs)))


def ring_flash_train(qs, ks, vs, mesh, axis, scale, causal):
    """``make_ring_flash_train``'s counterpart: the flash ring with its
    ring backward, over every position's shards."""
    return _train({"mesh": mesh,
                   "fwd": lambda q, k, v: _ring_flash_fwd(
                       q, k, v, mesh, axis, scale, causal),
                   "bwd": lambda q, k, v, o, l, d: _ring_flash_bwd(
                       q, k, v, o, l, d, mesh, axis, scale, causal)},
                  qs, ks, vs)


def ring_zigzag_train(qs, ks, vs, mesh, axis, scale):
    """``make_ring_flash_zigzag_train``'s counterpart, on zigzag-laid-out
    shards."""
    return _train({"mesh": mesh,
                   "fwd": lambda q, k, v: _ring_flash_zigzag_core(
                       q, k, v, mesh, axis, scale),
                   "bwd": lambda q, k, v, o, l, d: _ring_flash_zigzag_bwd(
                       q, k, v, o, l, d, mesh, axis, scale)},
                  qs, ks, vs)


_ZIGZAG_INDEX = {}


def _zigzag_index(T, S, inverse, device):
    """The permutation as an index tensor on `device`, made once (a copy
    to the card is not allowed while a CUDA graph is being captured)."""
    key = (T, S, inverse, str(device))
    idx = _ZIGZAG_INDEX.get(key)
    if idx is None:
        perm, inv = zigzag_permutation(T, S)
        idx = _ZIGZAG_INDEX[key] = torch.as_tensor(
            inv if inverse else perm).to(device)
    return idx


def zigzag_relayout(shards, mesh, axis, inverse=False):
    """The zigzag layout's shards from the contiguous layout's (or back):
    position d's half-chunks (d, 2S−1−d) gathered over the axis (an
    all-gather, counted) and re-sliced."""
    S = axis_size(mesh, axis)
    whole = col.all_gather(shards, mesh, axis, dim=2)
    T = whole[mesh.local[0]].shape[2]
    my = col.axis_index(mesh, axis)
    t = T // S

    def one(p):
        laid = whole[p].index_select(
            2, _zigzag_index(T, S, inverse, whole[p].device))
        return laid[:, :, my[p] * t:(my[p] + 1) * t]

    return mesh.local_map(one)


def ring_attention_shards(qs, ks, vs, mesh, axis="sp", causal=False,
                          scale=None, use_flash=False, is_train=False,
                          schedule="plain", pre_permuted=False):
    """The ring over every position's [B,H,t,D] shards (t = T/S, the
    sequence split over `axis` in order); returns the output shards."""
    d = qs[mesh.local[0]].shape[-1]
    s = scale if scale is not None else 1.0 / (d ** 0.5)
    zigzag = schedule == "zigzag"
    if zigzag and not (use_flash and causal):
        raise ValueError(
            "schedule='zigzag' supports causal flash attention "
            "(use_flash=True, causal=True)")
    if not use_flash:
        return _ring_body(qs, ks, vs, mesh, axis, causal, s)
    if zigzag:
        S = axis_size(mesh, axis)
        T = qs[mesh.local[0]].shape[2] * S
        if T % (2 * S):
            raise ValueError(
                f"zigzag needs T divisible by 2*S ({T} vs {2 * S})")
        if not pre_permuted:
            qs, ks, vs = (zigzag_relayout(x, mesh, axis)
                          for x in (qs, ks, vs))
        if is_train:
            out = ring_zigzag_train(qs, ks, vs, mesh, axis, s)
        else:
            out = _ring_flash_zigzag_core(qs, ks, vs, mesh, axis, s)[0]
        if pre_permuted:
            return out
        return zigzag_relayout(out, mesh, axis, inverse=True)
    if is_train:
        return ring_flash_train(qs, ks, vs, mesh, axis, s, causal)
    return _ring_flash_fwd(qs, ks, vs, mesh, axis, s, causal)[0]


def _split_seq(x, mesh, axis):
    from .sharded import from_global, norm_spec

    sh = from_global(mesh, x, norm_spec((None, None, axis, None), 4))
    return sh.shards if hasattr(sh, "shards") else mesh.local_map(
        lambda p: x)


def _join_seq(shards, mesh, axis):
    from .sharded import ShardedTensor

    return ShardedTensor(mesh, (None, None, axis, None), shards).gather()


def ring_attention(q, k, v, mesh, axis_name: str = "sp",
                   causal: bool = False, scale: Optional[float] = None,
                   use_flash: bool = False, is_train: bool = False,
                   schedule: str = "plain", pre_permuted: bool = False):
    """q,k,v [B,H,T,D] (T divisible by mesh[axis_name]) → [B,H,T,D], the
    sequence axis sharded over `axis_name`.  `use_flash=True` runs each
    chunk's attention through K4 (its plain version on the CPU) and merges
    by logsumexp; `is_train=True` rides the ring-level autograd Function
    whose backward rotates dK/dV with their chunks.  `schedule="zigzag"`
    (causal flash) runs the load-balanced schedule: inputs are permuted so
    each position holds one early and one late half-chunk; with
    `pre_permuted=True` the caller has laid the sequence out in zigzag
    order already (``zigzag_permutation``)."""
    S = axis_size(mesh, axis_name)
    if schedule == "zigzag" and not (use_flash and causal):
        raise ValueError(
            "schedule='zigzag' supports causal flash attention "
            "(use_flash=True, causal=True)")
    if schedule == "zigzag" and q.shape[2] % (2 * S):
        raise ValueError(
            f"zigzag needs T divisible by 2*S ({q.shape[2]} vs {2 * S})")
    if pre_permuted and schedule == "zigzag":
        # global tensors already in zigzag order: shard contiguously
        outs = ring_attention_shards(
            *(_split_seq(x, mesh, axis_name) for x in (q, k, v)), mesh,
            axis_name, causal, scale, use_flash, is_train, schedule,
            pre_permuted=True)
        return _join_seq(outs, mesh, axis_name)
    outs = ring_attention_shards(
        *(_split_seq(x, mesh, axis_name) for x in (q, k, v)), mesh,
        axis_name, causal, scale, use_flash, is_train, schedule)
    return _join_seq(outs, mesh, axis_name)


def ulysses_shards(qs, ks, vs, mesh, axis="sp", causal=False, scale=None,
                   use_flash=False, is_train=False):
    """Ulysses over every position's [B,H,t,D] shards: all_to_all to
    [B,H/S,T,D], full-sequence attention, all_to_all back."""
    S = axis_size(mesh, axis)
    H = qs[mesh.local[0]].shape[1]
    if H % S:
        raise ValueError(
            f"ulysses attention: head count {H} must be a multiple of the "
            f"{axis!r} axis size {S}")
    qh, kh, vh = (col.all_to_all(x, mesh, axis, split_axis=1,
                                 concat_axis=2) for x in (qs, ks, vs))

    def one(p):
        if use_flash:
            if is_train:
                return fa.FlashAttentionTrain.apply(qh[p], kh[p], vh[p],
                                                    causal, scale)
            return fa.flash_attention_fwd(qh[p], kh[p], vh[p],
                                          causal=causal, scale=scale)[0]
        return attention(qh[p], kh[p], vh[p], causal=causal, scale=scale)

    out = mesh.local_map(one)
    return col.all_to_all(out, mesh, axis, split_axis=2, concat_axis=1)


def ulysses_attention(q, k, v, mesh, axis_name: str = "sp",
                      causal: bool = False, scale: Optional[float] = None,
                      use_flash: bool = False, is_train: bool = False):
    """All-to-all (DeepSpeed-Ulysses-style) sequence parallelism: q,k,v
    [B,H,T,D] with T and H divisible by mesh[axis_name] → [B,H,T,D];
    dense attention re-sharded head-wise.  `use_flash=True` runs the
    local attention through K4 (``FlashAttentionTrain`` when
    `is_train`)."""
    S = axis_size(mesh, axis_name)
    if q.shape[1] % S:
        raise ValueError(
            f"ulysses attention: head count {q.shape[1]} must be a "
            f"multiple of the {axis_name!r} axis size {S}")
    if q.shape[2] % S:
        raise ValueError(
            f"ulysses attention: sequence length {q.shape[2]} must be a "
            f"multiple of the {axis_name!r} axis size {S}")
    outs = ulysses_shards(*(_split_seq(x, mesh, axis_name)
                            for x in (q, k, v)), mesh, axis_name, causal,
                          scale, use_flash, is_train)
    return _join_seq(outs, mesh, axis_name)
