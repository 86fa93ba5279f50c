"""``ShardedTensor``: a value laid out over a mesh, and ``reshard``.

A value under the ``ParallelExecutor`` is either a plain tensor
(replicated: every position reads the whole) or a ``ShardedTensor``: its
spec (one entry a dim: None or a tuple of mesh axes, the first major) and
one shard for each position, in the mesh's row-major order.  Positions
that agree on every axis of the spec hold the same shard: the group's
first position (its representative) holds the tensor, and the others hold
it moved to their device, which on one device is the same object.  So a
value is never held twice on one device, and autograd sees each shard
once.

Over a mesh of several processes a ``ShardedTensor`` holds no tensor for
the positions of other processes (``None``), and a group's
representative is its first position in this process.  ``from_global``,
``from_groups`` and ``local_view`` touch this process's positions only;
``gather``, ``all_gathered``, ``__array__`` and a ``reshard`` that is not
a local slice are collectives that every process calls.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import collectives
from .mesh import local_slice, shard_index


def norm_spec(spec, ndim: int) -> tuple:
    """A spec as `ndim` entries, each None or a non-empty tuple of axes."""
    out = []
    for e in list(spec or ())[:ndim]:
        if e is None:
            out.append(None)
            continue
        axes = tuple(a for a in (e if isinstance(e, (tuple, list))
                                 else (e,)) if a)
        out.append(axes or None)
    return tuple(out + [None] * (ndim - len(out)))


def spec_axes(spec) -> tuple:
    return tuple(a for e in spec if e for a in e)


class ShardedTensor:
    """`shards[p]` is position p's local block of the global value.

    `local_only`: the shards are per-position blocks with no global order
    (layer_norm's flattened row statistics over a dim pair sharded two
    ways): a gradient op reads them where they were made, and a gather
    raises."""

    __slots__ = ("mesh", "spec", "shards", "local_only")
    # duck-typed by the scope and the executor (framework/ imports nothing
    # of parallel/)
    __sharded__ = True

    def __init__(self, mesh, spec, shards: List[torch.Tensor],
                 local_only: bool = False):
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of "
                             f"{mesh.size} positions")
        self.mesh = mesh
        self.shards = list(shards)
        self.spec = norm_spec(spec, self._any().ndim)
        self.local_only = local_only

    def _any(self) -> torch.Tensor:
        """This process's first shard."""
        return self.shards[self.mesh.local[0]]

    # -- shape ---------------------------------------------------------
    @property
    def ndim(self) -> int:
        return self._any().ndim

    @property
    def dtype(self):
        return self._any().dtype

    @property
    def device(self):
        return self._any().device

    def split_of(self, d: int) -> int:
        n = 1
        for a in self.spec[d] or ():
            n *= dict(zip(self.mesh.axis_names,
                          self.mesh.devices.shape)).get(a, 1)
        return n

    @property
    def shape(self) -> tuple:
        """The global shape."""
        return tuple(s * self.split_of(d)
                     for d, s in enumerate(self._any().shape))

    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def element_size(self) -> int:
        return self._any().element_size()

    def local(self, p: int) -> torch.Tensor:
        return self.shards[p]

    def is_floating_point(self) -> bool:
        return self._any().is_floating_point()

    def clone(self) -> "ShardedTensor":
        return self.map(torch.Tensor.clone)

    def detach(self) -> "ShardedTensor":
        return self.map(torch.Tensor.detach)

    def copy_(self, other) -> "ShardedTensor":
        """In place, each group's shard from `other` laid out like self."""
        other = reshard(other, self.spec, self.mesh)
        for r in self.representatives():
            self.shards[r].copy_(local_view(self.mesh, other, r))
        return self

    def __array__(self, dtype=None, copy=None):
        from ..framework.scope import to_numpy

        a = to_numpy(self.gather())
        return a if dtype is None else a.astype(dtype)

    # -- groups --------------------------------------------------------
    def groups(self) -> List[List[int]]:
        """Positions grouped by their coordinates on the spec's axes (the
        positions that hold one shard), each in flat order."""
        return layout_groups(self.mesh, self.spec)

    def representatives(self) -> List[int]:
        """Each group's first position in this process (groups this
        process holds no position of are left out)."""
        return [g[0] for g in local_groups(self.mesh, self.groups())]

    def gather(self, device: Optional[torch.device] = None) -> torch.Tensor:
        """The global tensor on `device` (this process's first position's
        by default), by concatenation: differentiable, and counts nothing
        (callers that move data between positions count it).  Over
        several processes every process calls it: a group's block comes
        from the process that owns the group's first position."""
        if self.local_only:
            raise ValueError(
                "a local-only sharded value (per-position row statistics "
                "of a dim pair sharded two ways) has no global order")
        mesh = self.mesh
        device = device or mesh.device(mesh.local[0])
        gs = self.groups()
        wants = []
        for g in gs:
            if mesh.process_count > 1:
                have = {mesh.process_of(q) for q in g}
                wants += [(g[0], mesh.process_of(g[0]), k)
                          for k in range(mesh.process_count)
                          if k not in have]
        like = self._any()
        got = collectives._swap(
            mesh, wants, lambda q: self.shards[q],
            lambda q: (tuple(like.shape), like.dtype, device))
        blocks: Dict[tuple, torch.Tensor] = {}
        sharded = [(d, axes) for d, axes in enumerate(self.spec) if axes]
        for g in gs:
            c = mesh.coords(g[0])
            key = tuple(shard_index(mesh, c, axes)[0]
                        for _, axes in sharded)
            r = mesh.first_local(g)
            blocks[key] = (self.shards[r] if r is not None
                           else got[g[0]]).to(device)

        def build(level, prefix):
            if level == len(sharded):
                return blocks[prefix]
            d, axes = sharded[level]
            n = shard_index(self.mesh, {}, axes)[1]
            return torch.cat([build(level + 1, prefix + (i,))
                              for i in range(n)], d)

        return build(0, ())

    def map(self, fn) -> "ShardedTensor":
        """fn on each group's shard, the spec kept."""
        out = from_groups(self.mesh, self.spec,
                          {r: fn(self.shards[r])
                           for r in self.representatives()})
        if isinstance(out, ShardedTensor):
            out.local_only = self.local_only
        return out

    def __repr__(self):
        return (f"ShardedTensor(shape={self.shape}, spec={self.spec}, "
                f"dtype={self.dtype})")


def local_groups(mesh, gs) -> List[List[int]]:
    """`gs` (groups of positions) cut to this process's positions, the
    groups it holds none of left out."""
    if mesh.process_count == 1:
        return gs
    key = ("local", id(gs))
    memo = mesh.memo.get(key)
    if memo is None or memo[0] is not gs:
        memo = mesh.memo[key] = (gs, [
            [q for q in g if mesh.is_local(q)] for g in gs
            if mesh.first_local(g) is not None])
    return memo[1]


def layout_groups(mesh, spec) -> List[List[int]]:
    """Positions grouped by their coordinates on the axes `spec` uses
    (the groups in the order of their first positions)."""
    axes = frozenset(spec_axes(spec))
    memo = mesh.memo.get(("groups_on", axes))
    if memo is not None:
        return memo
    out: Dict[tuple, List[int]] = {}
    for p in range(mesh.size):
        c = mesh.coords(p)
        out.setdefault(tuple(c[a] for a in mesh.axis_names if a in axes),
                       []).append(p)
    memo = mesh.memo[("groups_on", axes)] = list(out.values())
    return memo


def from_groups(mesh, spec, by_rep: Dict[int, torch.Tensor]):
    """A ShardedTensor from {representative position: shard} (each
    group's first position in this process); a spec with no axes gives
    the plain tensor."""
    some = next(iter(by_rep.values()))
    spec = norm_spec(spec, some.ndim)
    if not spec_axes(spec):
        return some
    shards = [None] * mesh.size
    for g in local_groups(mesh, layout_groups(mesh, spec)):
        t = by_rep[g[0]]
        for q in g:
            shards[q] = t.to(mesh.device(q))
    return ShardedTensor(mesh, spec, shards)


def from_global(mesh, x: torch.Tensor, spec):
    """Slice a global (replicated) tensor by `spec` at this process's
    positions; no data moves between positions."""
    spec = norm_spec(spec, x.ndim)
    if not spec_axes(spec):
        return x
    return from_groups(mesh, spec, {
        g[0]: local_slice(mesh, x, spec, g[0])
        for g in local_groups(mesh, layout_groups(mesh, spec))})


def local_view(mesh, x, p: int, spec=None) -> torch.Tensor:
    """Position p's block of `x` under `spec` (x's own spec when None): a
    ShardedTensor's shard, or a plain tensor sliced."""
    if isinstance(x, ShardedTensor):
        if spec is None or norm_spec(spec, x.ndim) == x.spec:
            return x.shards[p]
        x = reshard(x, spec)
        return x.shards[p] if isinstance(x, ShardedTensor) else x
    if spec is None:
        return x
    return local_slice(mesh, x, norm_spec(spec, x.ndim), p).to(
        mesh.device(p))


def _refines(src, dst) -> bool:
    """Every dim's source axes are a prefix of its target axes: the
    target's block is a sub-block of the source's, sliced locally."""
    for a, b in zip(src, dst):
        a, b = a or (), b or ()
        if tuple(b[:len(a)]) != tuple(a):
            return False
    return True


def reshard(x, spec, mesh=None, stats: Optional[dict] = None):
    """`x` (ShardedTensor, or plain tensor over `mesh`) laid out by
    `spec`.  Slicing a finer split out of a coarser one is local; anything
    else gathers the global value first (an all-gather, counted, and one
    reshard in `stats`)."""
    if not isinstance(x, ShardedTensor):
        return from_global(mesh, x, spec)
    mesh = x.mesh
    spec = norm_spec(spec, x.ndim)
    if spec == x.spec:
        return x
    if _refines(x.spec, spec):
        out = {}
        for g in local_groups(mesh, layout_groups(mesh, spec)):
            p = g[0]
            t = x.shards[p]
            c = mesh.coords(p)
            for d, (have, want) in enumerate(zip(x.spec, spec)):
                rest = (want or ())[len(have or ()):]
                if rest:
                    i, n = shard_index(mesh, c, rest)
                    step = t.shape[d] // n
                    if t.shape[d] % n:
                        raise ValueError(f"dim {d} of size {t.shape[d]} "
                                         f"does not split {n} ways")
                    t = t.narrow(d, i * step, step)
            out[p] = t
        return from_groups(mesh, spec, out)
    whole = all_gathered(x)
    if stats is not None:
        stats["reshards"] = stats.get("reshards", 0) + 1
    return from_global(mesh, whole, spec)


def all_gathered(x: ShardedTensor) -> torch.Tensor:
    """The global value of `x`, counted as one all-gather over its axes
    (each position receives the whole)."""
    whole = x.gather()
    groups = x.groups()
    if len(groups) > 1:
        collectives._count("all-gather", spec_axes(x.spec), whole,
                           len(groups))
    return whole
