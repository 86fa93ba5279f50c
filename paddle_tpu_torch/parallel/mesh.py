"""Device mesh, the PartitionSpec mint and ``shard_map`` — the port of
``paddle_tpu/parallel/mesh.py``.

A ``Mesh`` here is a grid of mesh POSITIONS, each on a ``torch.device``
and owned by one process; an op runs once for each of this process's
positions on that position's shard, and collectives
(``parallel/collectives.py``) are explicit functions over the positions'
shards.  Positions may repeat a device: eight positions on ``cuda:0``
(or, in the tests, on the CPU) are the port's virtual devices, the
counterpart of JAX's ``--xla_force_host_platform_device_count``.

One process may own every position (``make_mesh``), or the mesh may span
the processes of a ``torch.distributed`` group (``distributed.launch.
global_mesh``), as JAX's global mesh spans every process's devices after
``jax.distributed.initialize``: positions are process-contiguous (rank
0's first), every process runs the same program, holds only its own
positions' shards and exchanges the rest through ``mesh.transport``
(``parallel/transport.py``).  A list of per-position values has one entry
a position, ``None`` at the positions of other processes.

Axis names:
  dp — data parallel (batch axis)
  mp — model/tensor parallel (hidden/vocab axes)
  sp — sequence parallel (long-context time axis)
  ep — expert parallel (one expert per member)
  pp — pipeline stages
  dcn* — a "dcn" prefix marks an axis as crossing the data-center
         network; the sharding analyzer prices its collectives at DCN
         bandwidth and PTV021 flags inner-step collectives that cross it

``pspec`` is the one place in ``parallel/`` that mints a
``PartitionSpec``: every other module derives specs through
``pspec``/``named``/``replicated``, so the sharding analyzer can trust
that whatever plan it is handed was minted by rules.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


class PartitionSpec(tuple):
    """One entry a dim: None (not sharded), a mesh axis name, or a tuple
    of axis names (the dim split over their product, the first axis
    major).  Missing trailing entries mean None, as in JAX."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


class Mesh:
    """A grid of mesh positions: ``devices`` is a numpy object array of
    ``torch.device`` shaped by the axis sizes, ``axis_names`` names its
    dims.  Position ``p`` is the ``p``-th cell in row-major order.

    `owners` (one process index a position, row-major; default all 0)
    says which process holds each position, `process_index` which process
    this is, and `transport` how it reaches the others (None when it owns
    every position).  A remote position's device is the label its owner
    gave it; nothing here moves data to it."""

    def __init__(self, devices, axis_names, owners=None,
                 process_index: int = 0, transport=None):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh devices of shape {self.devices.shape} "
                             f"for axes {self.axis_names}")
        self._flat = list(self.devices.reshape(-1))
        self._owner = ([0] * len(self._flat) if owners is None
                       else [int(o) for o in np.asarray(owners).reshape(-1)])
        if len(self._owner) != len(self._flat) or any(
                b < a for a, b in zip(self._owner, self._owner[1:])):
            raise ValueError(f"mesh owners {self._owner}: one process a "
                             f"position, process-contiguous")
        self.process_index = int(process_index)
        self.process_count = self._owner[-1] + 1 if self._owner else 1
        self.local = tuple(p for p, o in enumerate(self._owner)
                           if o == self.process_index)
        if not self.local:
            raise ValueError(f"process {self.process_index} owns no "
                             f"position of the mesh")
        self._is_local = [o == self.process_index for o in self._owner]
        if self.process_count > 1 and transport is None:
            raise ValueError("a mesh over several processes needs a "
                             "transport")
        self.transport = transport
        shape = self.devices.shape
        self._coords = [
            {a: int(i) for a, i in zip(self.axis_names,
                                       np.unravel_index(p, shape))}
            for p in range(len(self._flat))]
        # memo of derived layouts (position groups by axis set), keyed by
        # the caller
        self.memo = {}

    @property
    def shape(self) -> Dict[str, int]:
        return mesh_axis_sizes(self)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, position: int) -> torch.device:
        return self._flat[position]

    def coords(self, position: int) -> Dict[str, int]:
        """{axis: index} of a position (do not mutate)."""
        return self._coords[position]

    def process_of(self, position: int) -> int:
        """The process that owns `position`."""
        return self._owner[position]

    def is_local(self, position: int) -> bool:
        return self._is_local[position]

    def local_map(self, fn) -> list:
        """[fn(p)] at this process's positions, None at the others'."""
        return [fn(p) if loc else None
                for p, loc in enumerate(self._is_local)]

    def first_local(self, group):
        """The first of `group`'s positions this process owns (None if
        it owns none)."""
        return next((p for p in group if self._is_local[p]), None)

    def __eq__(self, other):
        return (isinstance(other, Mesh)
                and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and self._owner == other._owner
                and self.process_index == other.process_index
                and all(a == b for a, b in zip(self.devices.reshape(-1),
                                               other.devices.reshape(-1))))

    def __hash__(self):
        return hash((self.axis_names, self.devices.shape,
                     self.process_count, self.process_index))

    def __repr__(self):
        devices = sorted(set(map(str, (self._flat[p] for p in self.local))))
        if self.process_count == 1:
            return f"Mesh({self.shape}, devices={devices})"
        return (f"Mesh({self.shape}, process {self.process_index} of "
                f"{self.process_count}, positions {list(self.local)}, "
                f"devices={devices})")


class NamedSharding:
    """A spec over a mesh (``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    def __eq__(self, other):
        if not isinstance(other, NamedSharding) or other.mesh != self.mesh:
            return False
        a, b = list(self.spec), list(other.spec)
        n = max(len(a), len(b))
        return a + [None] * (n - len(a)) == b + [None] * (n - len(b))

    def __hash__(self):
        return hash(tuple(e for e in self.spec if e is not None))

    def __repr__(self):
        return f"NamedSharding({self.mesh.shape}, {self.spec!r})"


def axis_size(mesh, name: str, default: int = 1) -> int:
    """Size of mesh axis `name` (`default` when the mesh has no such
    axis) — the one place for the name→size lookup."""
    return dict(zip(mesh.axis_names, mesh.devices.shape)).get(name, default)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} for every axis of `mesh`."""
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def dcn_axes(mesh_or_axes) -> tuple:
    """Axis names that cross DCN rather than ICI, by the naming
    convention (a ``dcn`` prefix)."""
    names = getattr(mesh_or_axes, "axis_names", mesh_or_axes)
    return tuple(n for n in names if str(n).startswith("dcn"))


def pspec(*entries):
    """The PartitionSpec mint: one constructor site for all of
    parallel/."""
    return PartitionSpec(*entries)


def named(mesh, *entries):
    """NamedSharding over `mesh` with spec entries `entries`."""
    return NamedSharding(mesh, pspec(*entries))


def replicated(mesh):
    """Fully-replicated NamedSharding over `mesh`."""
    return named(mesh)


def _devices(devices, total):
    """The devices a mesh of `total` positions takes: the caller's list,
    else the visible CUDA devices (raising when there are fewer than
    positions)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < total:
            raise ValueError(
                f"a mesh of {total} positions needs {total} CUDA devices, "
                f"have {n}; pass `devices` (repeated devices are the "
                f"port's virtual positions: [torch.device('cuda', 0)] * "
                f"{total}, or CPU devices as the tests use)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if total > len(devices):
        raise ValueError(f"mesh needs {total} devices, have {len(devices)}")
    return devices[:total]


def make_mesh(axes: Optional[Dict[str, int]] = None, devices=None) -> Mesh:
    """Build a Mesh.  `axes` maps axis name → size.  `devices` defaults
    to the visible CUDA devices (raising when there are fewer than the
    mesh's positions); pass them to repeat one device.  Default axes:
    pure DP over all devices."""
    if axes is None:
        if devices is None:
            devices = _devices(None, max(torch.cuda.device_count(), 1)
                               if torch.cuda.is_available() else 1)
        axes = {"dp": len(devices)}
    names = list(axes.keys())
    sizes = [int(axes[n]) for n in names]
    total = int(np.prod(sizes))
    devs = _devices(devices, total)
    arr = np.empty(total, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(sizes), axis_names=names)


def make_hybrid_mesh(ici_axes: Dict[str, int],
                     dcn_axes_map: Dict[str, int], devices=None) -> Mesh:
    """A multi-slice Mesh: outer `dcn*` axes across slices, inner axes
    within a slice.  `dcn_axes_map` names MUST carry the ``dcn`` prefix
    (the analyzer's link-class convention).  Slices are contiguous chunks
    of the devices, so a 2-slice mesh over 8 positions models positions
    0-3 as slice 0 and 4-7 as slice 1."""
    for name in dcn_axes_map:
        if not str(name).startswith("dcn"):
            raise ValueError(
                f"hybrid mesh slice axis {name!r} must carry the 'dcn' "
                f"prefix (the analyzer's link-class convention)")
    axes = {**{n: int(s) for n, s in dcn_axes_map.items()},
            **{n: int(s) for n, s in ici_axes.items()}}
    return make_mesh(axes, devices)


def spec_split(spec, ndim: int):
    """[(dim, axes tuple)] of the sharded dims of a spec."""
    out = []
    for d, e in enumerate(tuple(spec)[:ndim]):
        if e is None:
            continue
        axes = tuple(e) if isinstance(e, (tuple, list)) else (e,)
        axes = tuple(a for a in axes if a)
        if axes:
            out.append((d, axes))
    return out


def shard_index(mesh, coords: Dict[str, int], axes) -> tuple:
    """(chunk index, chunk count) of a dim split over `axes` at a
    position's coordinates: row-major over the axes, the first major."""
    idx, n = 0, 1
    for a in axes:
        s = axis_size(mesh, a)
        idx = idx * s + coords.get(a, 0)
        n *= s
    return idx, n


def local_slice(mesh, x, spec, position: int):
    """Position `position`'s shard of the global tensor `x` under
    `spec` (a view)."""
    coords = mesh.coords(position)
    for d, axes in spec_split(spec, x.ndim):
        i, n = shard_index(mesh, coords, axes)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of size {x.shape[d]} does not split "
                             f"{n} ways over {axes}")
        c = x.shape[d] // n
        x = x.narrow(d, i * c, c)
    return x


class AxisContext:
    """What a ``shard_map`` body knows of its position: ``position`` (the
    flat index), ``coords`` ({axis: index}) and ``axis_index(name)``."""

    def __init__(self, mesh, position):
        self.mesh = mesh
        self.position = position
        self.coords = mesh.coords(position)

    def axis_index(self, name: str) -> int:
        return self.coords[name]


def shard_map(fn, mesh, in_specs, out_specs):
    """``jax.shard_map``'s counterpart: the returned callable takes global
    tensors, runs ``fn(ctx, *local_shards)`` once for each of this
    process's positions in row-major order (``ctx`` an
    ``AxisContext``), and assembles the positions' outputs into global
    tensors by `out_specs` (one spec, or a tuple of specs for a tuple of
    outputs).  A body that needs a
    collective takes every position's shards at once instead (the ring
    bodies of ``parallel/ring_attention.py``)."""
    from .sharded import ShardedTensor

    def run(*xs):
        outs = mesh.local_map(lambda p: fn(AxisContext(mesh, p), *[
            local_slice(mesh, x, s, p).to(mesh.device(p))
            for x, s in zip(xs, in_specs)]))
        if isinstance(out_specs, PartitionSpec) or not isinstance(
                out_specs, (tuple, list)):
            return ShardedTensor(mesh, out_specs, outs).gather()
        return tuple(ShardedTensor(mesh, s, [
            None if o is None else o[j] for o in outs]).gather()
            for j, s in enumerate(out_specs))

    return run
