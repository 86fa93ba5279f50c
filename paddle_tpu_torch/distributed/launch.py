"""Multi-process bring-up (replacing the reference's cluster launchers:
paddle/scripts/cluster_train fabric/k8s scripts + etcd discovery) — the
port of ``paddle_tpu/distributed/launch.py`` on ``torch.distributed``.

`init_distributed()` joins this process to a process group from the env
contract (the reference's submit_local.sh.in / Flags.h:19 trainer_id /
trainers):

  PADDLE_TRAINER_ID     — process index (0-based)
  PADDLE_TRAINERS       — total process count
  PADDLE_COORDINATOR    — host:port of process 0 (the group's TCP store)

gloo for CPU places, nccl for cards.  A single process needs none of
this.  The port's mesh (``parallel/mesh.py``) is single-controller: one
process drives every position, so ``global_mesh`` over several processes
raises (a mesh across processes is ROADMAP.md Queue A item 11's one item
left); the process group serves host-side coordination (barriers,
collectives of host values) beside the pserver and master services."""

from __future__ import annotations

import os
from typing import Optional


def env_trainer_id() -> int:
    return int(os.environ.get("PADDLE_TRAINER_ID", "0"))


def env_trainer_count() -> int:
    return int(os.environ.get("PADDLE_TRAINERS", "1"))


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, place=None,
                     timeout_s: float = 120.0):
    """Join the multi-process job: ``torch.distributed`` over
    ``tcp://<coordinator>``, gloo when `place` is a CPU place, nccl for
    the card (`place` None: ``CUDAPlace(0)``).  Returns False (and does
    nothing) for a single-process job, True once joined."""
    import datetime

    import torch.distributed as dist

    from ..framework.place import CUDAPlace

    num = num_processes if num_processes is not None else env_trainer_count()
    if num <= 1:
        return False
    place = place if place is not None else CUDAPlace(0)
    backend = "gloo" if place.device.type == "cpu" else "nccl"
    addr = (coordinator or os.environ.get("PADDLE_COORDINATOR",
                                          "127.0.0.1:8476"))
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}", world_size=num,
        rank=process_id if process_id is not None else env_trainer_id(),
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def global_mesh(axes=None, devices=None):
    """The mesh of a job: ``make_mesh(axes, devices)`` in a single
    process.  The port's mesh is single-controller, so with more than one
    process in the group this raises."""
    import torch.distributed as dist

    from ..parallel.mesh import make_mesh

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            f"global_mesh: the port's mesh is single-controller (one "
            f"process drives every position); a mesh over the "
            f"{dist.get_world_size()} processes of this group is ROADMAP.md "
            f"Queue A item 11's one item left — run one process per host "
            f"with make_mesh over its cards, and the pserver/master "
            f"services between them")
    return make_mesh(axes, devices)


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
