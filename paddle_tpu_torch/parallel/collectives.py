"""Collectives over one mesh axis — the port's counterpart of
``jax.lax``'s ``psum``, ``pmean``, ``all_gather``, ``ppermute``,
``all_to_all`` and ``axis_index`` inside ``shard_map``.

Single-controller, as in ``parallel/mesh.py``: each function takes the
list of the positions' shards (one tensor a position, in the mesh's
row-major order) and returns the list of results.  A group is the
positions that agree on every mesh axis but the reduced ones.  Between
different devices a transfer is a ``.to(device)`` copy; on one device it
is the tensor itself, so a psum over positions of one card is adds and an
all-gather a concatenation.  Every function is made of differentiable
torch ops, so autograd runs through a collective as ``jax.grad`` runs
through ``lax.psum``.

``psum`` over several axes (a tuple) reduces a group in the positions'
flat order whatever the mesh's shape: a ``{"dcn_dp": 2, "dp": 4}`` mesh
and a flat ``{"dp": 8}`` one add the same tensors in the same order.

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


def _count(kind, axes, out: torch.Tensor, n: int):
    if n <= 1 or _state["muted"]:
        return
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
        out[q] = result.to(mesh.device(q))


_WIDEN = {torch.bfloat16: torch.float32, torch.float16: torch.float32}


def psum(shards: Sequence[torch.Tensor], mesh, axis) -> list:
    """Sum over `axis` (a name or a tuple of names), added in the group's
    flat order; every member of a group gets the sum.  A bf16 or fp16
    sum accumulates in f32 and rounds once, as a reduction kernel does
    on one device."""
    out = [None] * mesh.size
    gs = groups(mesh, axis)
    for g in gs:
        dev = mesh.device(g[0])
        dt = shards[g[0]].dtype
        wide = _WIDEN.get(dt, dt)
        acc = shards[g[0]].to(dev, wide)
        for q in g[1:]:
            acc = acc + shards[q].to(dev, wide)
        _spread(acc.to(dt), mesh, g, out)
    _count("all-reduce", _axes(axis), out[gs[0][0]], len(gs[0]))
    return out


def pmean(shards, mesh, axis) -> list:
    n = _size(mesh, axis)
    return [s / n for s in psum(shards, mesh, axis)]


def all_gather(shards, mesh, axis, dim: int = 0, tiled: bool = True) -> list:
    """Concatenate (``tiled``) or stack the group's shards along `dim`, in
    the axis's order; every member gets the whole."""
    out = [None] * mesh.size
    gs = groups(mesh, axis)
    for g in gs:
        dev = mesh.device(g[0])
        parts = [shards[q].to(dev) for q in g]
        whole = torch.cat(parts, dim) if tiled else torch.stack(parts, dim)
        _spread(whole, mesh, g, out)
    _count("all-gather", _axes(axis), out[gs[0][0]], len(gs[0]))
    return out


def ppermute(shards, mesh, axis: str, perm) -> list:
    """Send each position's shard to another along `axis`: `perm` is
    [(source index, destination index)]; a destination no pair names gets
    zeros, as in JAX."""
    out = [None] * mesh.size
    src_of = {d: s for s, d in perm}
    gs = groups(mesh, axis)
    for g in gs:
        for i, q in enumerate(g):
            if i in src_of:
                out[q] = shards[g[src_of[i]]].to(mesh.device(q))
            else:
                out[q] = torch.zeros_like(shards[q])
    _count("collective-permute", (axis,), out[gs[0][0]], len(gs[0]))
    return out


def all_to_all(shards, mesh, axis: str, split_axis: int, concat_axis: int,
               tiled: bool = True) -> list:
    """Member j splits its shard into S chunks along `split_axis`; member
    i receives chunk i of every member, joined along `concat_axis` in
    member order (``tiled``: concatenated; else the split dim, of size S,
    is taken apart and the pieces stacked at `concat_axis`)."""
    out = [None] * mesh.size
    gs = groups(mesh, axis)
    for g in gs:
        S = len(g)
        if tiled:
            pieces = [shards[q].chunk(S, split_axis) for q in g]
        else:
            pieces = [shards[q].unbind(split_axis) for q in g]
        for i, q in enumerate(g):
            dev = mesh.device(q)
            mine = [pieces[j][i].to(dev) for j in range(S)]
            out[q] = (torch.cat(mine, concat_axis) if tiled
                      else torch.stack(mine, concat_axis))
    _count("all-to-all", (axis,), out[gs[0][0]], len(gs[0]))
    return out


def axis_index(mesh, axis: str) -> List[int]:
    """Each position's index along `axis`."""
    return [mesh.coords(p)[axis] for p in range(mesh.size)]
