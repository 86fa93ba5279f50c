"""Collectives over one mesh axis — the port's counterpart of
``jax.lax``'s ``psum``, ``pmean``, ``all_gather``, ``ppermute``,
``all_to_all`` and ``axis_index`` inside ``shard_map``.

Each function takes the list of the positions' shards (one tensor a
position, in the mesh's row-major order, ``None`` at the positions of
other processes) and returns the list of results at this process's
positions.  A group is the positions that agree on every mesh axis but
the reduced ones.  Within a process a transfer is a ``.to(device)`` copy,
and on one device it is the tensor itself, so a psum over positions of
one card is adds and an all-gather a concatenation.  Where a group spans
processes, each process computes the results of its own positions and
fetches the shards it lacks through ``mesh.transport``
(``parallel/transport.py``), whose exchange is differentiable; every
process calls every collective, in the same order.  Every function is
made of differentiable torch ops and exchanges, so autograd runs through
a collective as ``jax.grad`` runs through ``lax.psum``.

``psum`` over several axes (a tuple) reduces a group in the positions'
flat order whatever the mesh's shape: a ``{"dcn_dp": 2, "dp": 4}`` mesh
and a flat ``{"dp": 8}`` one add the same tensors in the same order.
Over processes the order is kept: the process that owns a group's first
positions adds them and sends that prefix (widened), every later shard is
sent alone, and every process adds the same tensors in the same order, so
the sum equals the single-process mesh's to the bit.

Each call counts once, its kind and payload bytes (the per-position
output buffer, the convention of ``analysis/sharding.py``'s
``Collective``, for which one collective runs in every group at once),
into
the ``parallel_collectives_total`` and ``parallel_collective_bytes_total``
counters of ``observability.metrics.REGISTRY``, and into every open
``record()`` log.  A call over a one-position group counts nothing, and
neither does a call inside ``uncounted()`` (a gradient's re-run of its
forward op).
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence

import torch

from ..observability.metrics import REGISTRY as _MET
from .mesh import axis_size

_CALLS = _MET.counter("parallel_collectives_total",
                      "collectives run over a mesh, by kind")
_BYTES = _MET.counter("parallel_collective_bytes_total",
                      "per-position output bytes of the mesh collectives, "
                      "by kind")

_state = {"muted": 0, "logs": [], "tag": None}


@contextlib.contextmanager
def uncounted():
    """Collectives run inside count nothing (a recompute)."""
    _state["muted"] += 1
    try:
        yield
    finally:
        _state["muted"] -= 1


@contextlib.contextmanager
def tagged(name):
    """Collectives run inside are logged with `name` (the variable they
    make, as the executor sets it)."""
    prev, _state["tag"] = _state["tag"], name
    try:
        yield
    finally:
        _state["tag"] = prev


@contextlib.contextmanager
def record():
    """Yield a list that collects (kind, axes, bytes, tag) of every
    counted collective run inside."""
    log: list = []
    _state["logs"].append(log)
    try:
        yield log
    finally:
        logs = _state["logs"]
        del logs[next(i for i, x in enumerate(logs) if x is log)]


def _count(kind, axes, out: Sequence, n: int):
    """Count one call: `out` is the results (any local one gives the
    per-position bytes), so every process counts what the single-process
    mesh counts."""
    if n <= 1 or _state["muted"]:
        return
    out = next(t for t in out if t is not None)
    nbytes = out.numel() * out.element_size()
    _CALLS.inc(1, kind=kind)
    _BYTES.inc(nbytes, kind=kind)
    for log in _state["logs"]:
        log.append((kind, tuple(axes), int(nbytes), _state["tag"]))


def _axes(axis) -> tuple:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def groups(mesh, axis) -> List[List[int]]:
    """The positions grouped by their coordinates off `axis` (an axis name
    or a tuple of them), each group in flat order; the groups in the order
    of their first positions."""
    axes = frozenset(_axes(axis))
    memo = mesh.memo.get(("groups_off", axes))
    if memo is not None:
        return memo
    out = {}
    for p in range(mesh.size):
        c = mesh.coords(p)
        key = tuple(v for a, v in c.items() if a not in axes)
        out.setdefault(key, []).append(p)
    memo = mesh.memo[("groups_off", axes)] = list(out.values())
    return memo


def _size(mesh, axis) -> int:
    n = 1
    for a in _axes(axis):
        n *= axis_size(mesh, a)
    return n


def _spread(result, mesh, group, out):
    for q in group:
        if mesh.is_local(q):
            out[q] = result.to(mesh.device(q))


def _swap(mesh, wants, have, like):
    """One exchange between processes.  `wants` is the ordered list of
    (key, source process, destination process) that every process builds
    the same way; this process sends ``have(key)`` where it is the source
    and receives a tensor of ``like(key)`` (shape, dtype, device) where it
    is the destination.  Returns {key: received tensor}.  A single-process
    mesh exchanges nothing."""
    if mesh.process_count == 1:
        return {}
    tr = mesh.transport
    tag = tr.next_tag()
    me = mesh.process_index
    sends, recvs, keys = {}, {}, {}
    if any(src != dst for _, src, dst in wants):
        tr.crossings += 1
    for key, src, dst in wants:
        if src == dst:
            continue
        if src == me:
            sends.setdefault(dst, []).append(have(key))
        elif dst == me:
            recvs.setdefault(src, []).append(like(key))
            keys.setdefault(src, []).append(key)
    if not sends and not recvs:
        return {}
    got = tr.exchange(sends, recvs, tag)
    return {k: t for src, ts in got.items() for k, t in zip(keys[src], ts)}


def _meta(t, device):
    return (tuple(t.shape), t.dtype, device)


_WIDEN = {torch.bfloat16: torch.float32, torch.float16: torch.float32}


def _runs(mesh, group):
    """[(process, [positions])] of a group, in flat order."""
    out = []
    for q in group:
        k = mesh.process_of(q)
        if out and out[-1][0] == k:
            out[-1][1].append(q)
        else:
            out.append((k, [q]))
    return out


def psum(shards: Sequence[torch.Tensor], mesh, axis) -> list:
    """Sum over `axis` (a name or a tuple of names), added in the group's
    flat order; every member of a group gets the sum.  A bf16 or fp16
    sum accumulates in f32 and rounds once, as a reduction kernel does
    on one device."""
    out = [None] * mesh.size
    gs = groups(mesh, axis)
    me = mesh.process_index
    local_gs = [g for g in gs if mesh.first_local(g) is not None]
    runs = {id(g): _runs(mesh, g) for g in local_gs}

    def wide_of(g):
        dt = shards[mesh.first_local(g)].dtype
        return dt, _WIDEN.get(dt, dt)

    def prefix(g, qs):
        dev = mesh.device(mesh.first_local(g))
        dt, wide = wide_of(g)
        acc = shards[qs[0]].to(dev, wide)
        for q in qs[1:]:
            acc = acc + shards[q].to(dev, wide)
        return acc

    # what each process sends a group: the first run's prefix, then every
    # later shard alone
    wants = []
    for g in gs:
        procs = {mesh.process_of(q) for q in g}
        if len(procs) < 2:
            continue
        rs = _runs(mesh, g)
        for dst in sorted(procs):
            for j, (src, qs) in enumerate(rs):
                if j == 0:
                    wants.append((("pre", g[0]), src, dst))
                else:
                    wants += [(("one", q), src, dst) for q in qs]
    by_pos = {g[0]: g for g in local_gs}
    group_of = {q: g for g in local_gs for q in g}
    pre = {}

    def have(key):
        kind, q = key
        if kind == "pre":
            if q not in pre:
                g = by_pos[q]
                pre[q] = prefix(g, runs[id(g)][0][1])
            return pre[q]
        return shards[q]

    def like(key):
        kind, q = key
        g = group_of[q]
        r = mesh.first_local(g)
        dt, wide = wide_of(g)
        return (tuple(shards[r].shape), wide if kind == "pre" else dt,
                mesh.device(r))

    got = _swap(mesh, wants, have, like)
    for g in local_gs:
        dev = mesh.device(mesh.first_local(g))
        dt, wide = wide_of(g)
        rs = runs[id(g)]
        first, qs = rs[0]
        if first == me:
            acc = pre.get(g[0])
            if acc is None:
                acc = prefix(g, qs)
        else:
            acc = got[("pre", g[0])]
        for src, qs in rs[1:]:
            for q in qs:
                t = shards[q] if src == me else got[("one", q)]
                acc = acc + t.to(dev, wide)
        _spread(acc.to(dt), mesh, g, out)
    _count("all-reduce", _axes(axis), out, len(gs[0]))
    return out


def pmean(shards, mesh, axis) -> list:
    n = _size(mesh, axis)
    return [None if s is None else s / n for s in psum(shards, mesh, axis)]


def _fetch(mesh, gs, needed, shards):
    """The shards of other processes that this process's positions need:
    `needed(g)` lists (source position, destination position) pairs of a
    group in a fixed order; each source shard goes once to each process
    that needs it.  Returns {(source, destination process): tensor}."""
    wants, group_of = [], {}
    for g in gs:
        for src, dst in needed(g):
            key = (src, mesh.process_of(dst))
            if key not in group_of:
                group_of[key] = g
                wants.append((key, mesh.process_of(src), key[1]))

    def like(key):
        r = mesh.first_local(group_of[key])
        return _meta(shards[r], mesh.device(r))

    return _swap(mesh, wants, lambda key: shards[key[0]], like)


def _shard_at(mesh, shards, got, src, dst):
    """Position `src`'s shard as position `dst` (local) reads it."""
    if mesh.is_local(src):
        return shards[src]
    return got[(src, mesh.process_of(dst))]


def all_gather(shards, mesh, axis, dim: int = 0, tiled: bool = True) -> list:
    """Concatenate (``tiled``) or stack the group's shards along `dim`, in
    the axis's order; every member gets the whole."""
    out = [None] * mesh.size
    gs = groups(mesh, axis)
    got = _fetch(mesh, gs, lambda g: [(s, d) for d in g for s in g], shards)
    for g in gs:
        r = mesh.first_local(g)
        if r is None:
            continue
        dev = mesh.device(r)
        parts = [_shard_at(mesh, shards, got, q, r).to(dev) for q in g]
        whole = torch.cat(parts, dim) if tiled else torch.stack(parts, dim)
        _spread(whole, mesh, g, out)
    _count("all-gather", _axes(axis), out, len(gs[0]))
    return out


def ppermute(shards, mesh, axis: str, perm) -> list:
    """Send each position's shard to another along `axis`: `perm` is
    [(source index, destination index)]; a destination no pair names gets
    zeros, as in JAX."""
    out = [None] * mesh.size
    src_of = {d: s for s, d in perm}
    gs = groups(mesh, axis)
    got = _fetch(mesh, gs, lambda g: [(g[src_of[i]], q)
                                      for i, q in enumerate(g)
                                      if i in src_of], shards)
    for g in gs:
        for i, q in enumerate(g):
            if not mesh.is_local(q):
                continue
            if i in src_of:
                out[q] = _shard_at(mesh, shards, got, g[src_of[i]],
                                   q).to(mesh.device(q))
            else:
                out[q] = torch.zeros_like(shards[q])
    _count("collective-permute", (axis,), out, len(gs[0]))
    return out


def all_to_all(shards, mesh, axis: str, split_axis: int, concat_axis: int,
               tiled: bool = True) -> list:
    """Member j splits its shard into S chunks along `split_axis`; member
    i receives chunk i of every member, joined along `concat_axis` in
    member order (``tiled``: concatenated; else the split dim, of size S,
    is taken apart and the pieces stacked at `concat_axis`)."""
    out = [None] * mesh.size
    gs = groups(mesh, axis)
    index = {q: i for g in gs for i, q in enumerate(g)}
    pieces = {}

    def piece(src, dst):
        """The chunk member `src` sends member `dst` (src local)."""
        if src not in pieces:
            x, S = shards[src], len(gs[0])
            pieces[src] = (x.chunk(S, split_axis) if tiled
                           else x.unbind(split_axis))
        return pieces[src][index[dst]]

    wants = [((src, dst), mesh.process_of(src), mesh.process_of(dst))
             for g in gs for dst in g for src in g]
    got = _swap(mesh, wants, lambda key: piece(*key),
                lambda key: _meta(piece(key[1], key[1]),
                                  mesh.device(key[1])))
    for g in gs:
        for q in g:
            if not mesh.is_local(q):
                continue
            dev = mesh.device(q)
            mine = [(piece(j, q) if mesh.is_local(j) else got[(j, q)])
                    .to(dev) for j in g]
            out[q] = (torch.cat(mine, concat_axis) if tiled
                      else torch.stack(mine, concat_axis))
    _count("all-to-all", (axis,), out, len(gs[0]))
    return out


def axis_index(mesh, axis: str) -> List[int]:
    """Each position's index along `axis`."""
    return [mesh.coords(p)[axis] for p in range(mesh.size)]
