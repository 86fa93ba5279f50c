"""Multi-process bring-up (replacing the reference's cluster launchers:
paddle/scripts/cluster_train fabric/k8s scripts + etcd discovery) — the
port of ``paddle_tpu/distributed/launch.py`` on ``torch.distributed``.

`init_distributed()` joins this process to a process group from the env
contract (the reference's submit_local.sh.in / Flags.h:19 trainer_id /
trainers):

  PADDLE_TRAINER_ID     — process index (0-based)
  PADDLE_TRAINERS       — total process count
  PADDLE_COORDINATOR    — host:port of process 0 (the group's TCP store),
                          or file://<path> of a store file all share

The transport is chosen by one rule before the group is joined, and
logged: each rank publishes its card's identity through the rendezvous
store, and the group takes ``nccl`` where every rank holds a card of its
own, else ``gloo`` — ranks that share a card (NCCL does not admit two
ranks on one card) stage each card tensor through a pinned host buffer,
and ranks on the CPU send their tensors as they are.  An NCCL failure
raises; nothing retries over gloo.  A single process needs none of this.

``global_mesh`` builds one mesh over every process's positions, as JAX's
global mesh spans every process's devices after
``jax.distributed.initialize``: positions are process-contiguous (rank
0's first), each process names its own (by default its card, repeated to
its share of the positions), and collectives between processes go
through ``parallel/transport.py``."""

from __future__ import annotations

import datetime
import logging
import os
import socket
from typing import Optional

logger = logging.getLogger(__name__)

# the transport of the group this process joined (None: not joined)
_STATE = {"transport": None}


def env_trainer_id() -> int:
    return int(os.environ.get("PADDLE_TRAINER_ID", "0"))


def env_trainer_count() -> int:
    return int(os.environ.get("PADDLE_TRAINERS", "1"))


def card_identity(device) -> Optional[str]:
    """The physical card behind `device` (its UUID where CUDA
    reports one), None for the CPU."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return None
    props = torch.cuda.get_device_properties(device)
    uuid = getattr(props, "uuid", None)
    if uuid:
        return str(uuid)
    return (f"{socket.gethostname()}:"
            f"{os.environ.get('CUDA_VISIBLE_DEVICES', '')}:"
            f"{device.index or 0}")


def choose_transport(cards):
    """(backend, staged, reason) for ranks whose cards are `cards` (one
    identity a rank, None for a rank on the CPU): the one rule."""
    if all(c is None for c in cards):
        return "gloo", False, "every rank runs on the CPU: gloo"
    if None not in cards and len(set(cards)) == len(cards):
        return "nccl", False, ("every rank holds a card of its own: "
                               "nccl")
    shared = len(cards) - len(set(cards))
    return "gloo", True, (
        f"{'ranks share a card' if shared else 'some ranks run on the CPU'}"
        f" ({len(set(c for c in cards if c))} card(s) for {len(cards)} "
        f"ranks): NCCL does not admit two ranks on one card, so gloo, "
        f"each card tensor staged through a pinned host buffer")


def _store(addr: str, rank: int, num: int, timeout):
    import torch.distributed as dist

    if addr.startswith("file://"):
        return dist.FileStore(addr[len("file://"):], num)
    host, port = addr.rsplit(":", 1)
    return dist.TCPStore(host, int(port), num, is_master=rank == 0,
                         timeout=timeout)


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, place=None,
                     timeout_s: float = 120.0):
    """Join the multi-process job over ``<coordinator>`` (``host:port``
    of rank 0's TCP store, or ``file://<path>`` of a store file all ranks
    share) with this process on `place` (None: ``CUDAPlace(0)``); the
    transport by ``choose_transport``, logged.  Returns False (and does
    nothing) for a single-process job, True once joined.  Every
    collective waits at most `timeout_s` seconds, then raises."""
    import torch
    import torch.distributed as dist

    from ..framework.place import CUDAPlace
    from ..parallel.transport import Transport

    num = num_processes if num_processes is not None else env_trainer_count()
    if num <= 1:
        return False
    place = place if place is not None else CUDAPlace(0)
    dev = place.device
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    rank = process_id if process_id is not None else env_trainer_id()
    addr = (coordinator or os.environ.get("PADDLE_COORDINATOR",
                                          "127.0.0.1:8476"))
    timeout = datetime.timedelta(seconds=timeout_s)
    store = _store(addr, rank, num, timeout)
    store.set_timeout(timeout)
    # the rule is decided before the group is joined: every rank's card
    # through the store
    store.set(f"paddle_tpu_torch/card/{rank}",
              card_identity(dev) or "")
    cards = [store.get(f"paddle_tpu_torch/card/{r}").decode() or None
             for r in range(num)]
    backend, staged, reason = choose_transport(cards)
    logger.info("rank %d of %d on %s: transport %s (%s)", rank, num, dev,
                backend, reason)
    dist.init_process_group(backend, store=store, world_size=num,
                            rank=rank, timeout=timeout)
    _STATE["transport"] = Transport(rank, num, backend, staged, reason, dev)
    return True


def transport():
    """The transport of the group this process joined (None: none)."""
    return _STATE["transport"]


def shutdown():
    """Leave the group (after a barrier)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    _STATE["transport"] = None


def global_mesh(axes=None, devices=None):
    """The mesh of a job: ``make_mesh(axes, devices)`` in a single
    process; over a joined group, one mesh over every process's positions,
    process-contiguous (rank 0's first).  `devices` are this process's
    positions (default: its card — or the CPU — repeated to its share of
    the mesh, the port's virtual positions).  An all-gather of every
    process's position count, axes and device labels checks that the
    processes agree; the mesh's ``transport`` reaches the others."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..parallel.mesh import Mesh, make_mesh

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return make_mesh(axes, devices)
    tr = _STATE["transport"]
    if tr is None:
        raise RuntimeError("global_mesh: the process group was not joined "
                           "by distributed.launch.init_distributed")
    world = dist.get_world_size()
    if axes is None:
        n_local = len(devices) if devices is not None else 1
        axes = {"dp": n_local * world}
    names = list(axes.keys())
    sizes = [int(axes[n]) for n in names]
    total = int(np.prod(sizes))
    if devices is None:
        if total % world:
            raise ValueError(f"global_mesh: {total} positions do not split "
                             f"over {world} processes; pass `devices`")
        devices = [tr.device] * (total // world)
    mine = {"axes": list(zip(names, sizes)),
            "devices": [str(torch.device(d)) for d in devices]}
    every = [None] * world
    dist.all_gather_object(every, mine)
    for r, other in enumerate(every):
        if other["axes"] != mine["axes"]:
            raise ValueError(f"global_mesh: rank {r} builds axes "
                             f"{other['axes']}, rank {tr.rank} "
                             f"{mine['axes']}")
    counts = [len(o["devices"]) for o in every]
    if sum(counts) != total:
        raise ValueError(f"global_mesh: the processes name {counts} "
                         f"positions, {sum(counts)} in all, for a mesh of "
                         f"{total}")
    flat = [torch.device(d) for o in every for d in o["devices"]]
    owners = [r for r, c in enumerate(counts) for _ in range(c)]
    arr = np.empty(total, dtype=object)
    arr[:] = flat
    return Mesh(arr.reshape(sizes), names, owners=owners,
                process_index=tr.rank, transport=tr)


def shard_reader(reader, trainer_id: Optional[int] = None,
                 trainer_count: Optional[int] = None):
    """Deterministic round-robin sample sharding per host process (the
    task-pull alternative is distributed.master)."""
    tid = trainer_id if trainer_id is not None else env_trainer_id()
    tc = trainer_count if trainer_count is not None else env_trainer_count()

    def reader_():
        for i, s in enumerate(reader()):
            if i % tc == tid:
                yield s

    return reader_
