"""Trainer checkpoint/resume without losing data-epoch position
(SURVEY.md §7 hard part (f); reference go/pserver/service.go:120-227/346
checkpoints + master snapshot, fluid save/load_persistables) — the port
of ``paddle_tpu/distributed/checkpoint.py``, in the JAX package's layout
(the port's ``io`` writes the same ``.npy`` files and
``persistables.json``).

A checkpoint = model+optimizer persistables (io.save_persistables) + trainer
progress (pass/step counters, RNG step) + optionally the master task-queue
snapshot, written atomically (tmp+rename, the Go pserver's pattern) with an
md5-style integrity digest in the meta (service.go uses md5+etcd meta).

Crash robustness (the chaos suite's contract, docs/distributed.md):

  * a writer killed mid-save leaves only a ``.tmp_ckpt_<n>`` directory —
    never a half-renamed ``ckpt_<n>`` — and the next ``save_checkpoint``
    sweeps the leftover;
  * ``load_checkpoint`` walks checkpoints newest-first and FALLS BACK past
    any snapshot that fails its digest, is truncated, or will not load,
    landing on the newest good one; it raises only when checkpoints exist
    but none is usable (silent weight loss would be worse than a crash);
  * this module is the ONLY writer into checkpoint directories, so the
    atomicity argument stays in one place.

Under a ``ParallelExecutor`` the scope may hold ``ShardedTensor`` values:
a save gathers each to the whole array (as ``np.asarray`` of a sharded
``jax.Array`` does in the JAX package), and a load writes whole tensors,
which the executor lays out by its plan at the next ``run``.

The optional ``fault_hook`` parameter exists for the chaos runner
(distributed/chaos.py): it is invoked at the named internal barriers so a
scheduled fault can kill the "process" at exactly the worst moments
(state written but meta missing; renamed but LATEST stale).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import time
from typing import List, Optional

from .. import io as fio
from ..framework.scope import Scope, global_scope

_CKPT_RE = re.compile(r"^ckpt_(\d+)$")
_TMP_PREFIX = ".tmp_ckpt_"


def _digest(dirname) -> str:
    h = hashlib.md5()
    for fn in sorted(os.listdir(dirname)):
        if fn.endswith(".npy"):
            with open(os.path.join(dirname, fn), "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def _versions(dirname) -> List[int]:
    """Completed checkpoint version numbers on disk, ascending.  The dir
    listing — not the LATEST pointer — is the source of truth: a writer
    killed between the rename and the pointer update leaves a complete
    ckpt_<n> the pointer does not know about yet."""
    try:
        names = os.listdir(dirname)
    except OSError:
        return []
    out = []
    for d in names:
        m = _CKPT_RE.match(d)
        if m and os.path.isdir(os.path.join(dirname, d)):
            out.append(int(m.group(1)))
    return sorted(out)


def checkpoint_ok(path: str) -> bool:
    """Structural + integrity validity of one checkpoint dir: readable
    meta, digest matches the parameter files."""
    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return meta.get("digest") == _digest(path)
    except (OSError, ValueError, KeyError):
        return False


def _processes(executor):
    """(rank, count) of the processes the executor's mesh spans."""
    mesh = getattr(executor, "mesh", None)
    if mesh is None:
        return 0, 1
    return mesh.process_index, mesh.process_count


def _barrier():
    import torch.distributed as dist

    dist.barrier()


def _gathered(scope):
    """`scope`, or an overlay holding its sharded values gathered whole
    (over a mesh of several processes a collective: every process calls
    it)."""
    scope = scope if scope is not None else global_scope()
    sharded = [n for n in scope.local_names()
               if getattr(scope.find(n), "__sharded__", False)]
    if not sharded:
        return scope
    overlay = Scope(parent=scope)
    for n in sharded:
        overlay.set(n, scope.find(n).gather())
    return overlay


def save_checkpoint(executor, dirname, main_program=None, trainer_state=None,
                    master: Optional[object] = None, keep: int = 3,
                    scope=None, fault_hook=None):
    """Write checkpoint dir `<dirname>/ckpt_<n>` + update LATEST pointer.

    Atomicity: everything lands in a ``.tmp_ckpt_<n>`` staging dir which
    becomes ``ckpt_<n>`` in a single rename; the LATEST pointer is itself
    written tmp+rename.  A crash at ANY point leaves either the previous
    state or a complete new checkpoint plus debris this function sweeps
    on its next call — never a torn snapshot a reader could trust."""
    rank, count = _processes(executor)
    if count > 1:
        # every process gathers (a gather only rank 0 called would hang
        # the job), rank 0 writes, and all meet at a barrier
        overlay = _gathered(scope)
        _barrier()
        if rank == 0:
            final = save_checkpoint(
                _Rank0(executor), dirname, main_program, trainer_state,
                master, keep, overlay, fault_hook)
        _barrier()
        return final if rank == 0 else latest_checkpoint(dirname)
    hook = fault_hook if fault_hook is not None else (lambda point: None)
    os.makedirs(dirname, exist_ok=True)
    # sweep kill-during-save leftovers (ours included: a same-version
    # retry must not inherit a prior attempt's partial files)
    for d in os.listdir(dirname):
        if d.startswith(_TMP_PREFIX):
            shutil.rmtree(os.path.join(dirname, d), ignore_errors=True)
    existing = _versions(dirname)
    n = (existing[-1] + 1) if existing else 0
    tmp = os.path.join(dirname, f"{_TMP_PREFIX}{n}")
    fio.save_persistables(executor, tmp, main_program, _gathered(scope))
    if master is not None:
        # snapshot the queue INTO the staging dir, then restore the
        # master's own path: leaving it pointed here would make every
        # later queue mutation write into a renamed (gone) directory —
        # and continuous snapshots into a finalized checkpoint would
        # break its params/queue consistency point anyway
        prev_snapshot_path = getattr(master, "snapshot_path", None)
        master.snapshot_path = os.path.join(tmp, "master_queue.json")
        try:
            master.snapshot()
        finally:
            master.snapshot_path = prev_snapshot_path
    hook("state_written")
    meta = {
        "version": n,
        "time": time.time(),
        "trainer_state": trainer_state or {},
        "digest": _digest(tmp),
    }
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    hook("before_rename")
    final = os.path.join(dirname, f"ckpt_{n}")
    os.replace(tmp, final)
    hook("before_latest")
    with open(os.path.join(dirname, "LATEST.tmp"), "w") as f:
        f.write(str(n))
    os.replace(os.path.join(dirname, "LATEST.tmp"),
               os.path.join(dirname, "LATEST"))
    # retention
    for old in existing[: max(0, len(existing) - keep + 1)]:
        shutil.rmtree(os.path.join(dirname, f"ckpt_{old}"),
                      ignore_errors=True)
    return final


class _Rank0:
    """An executor seen as a single process's (rank 0 writes alone)."""

    def __init__(self, executor):
        self.executor = executor


def latest_checkpoint(dirname, verify: bool = False) -> Optional[str]:
    """Path of the newest checkpoint, or None when none exists.  With
    ``verify=True`` the newest checkpoint that passes its integrity
    digest — falling back past corrupt/truncated snapshots (the resume
    path's view; resume correctness survives landing on an OLDER good
    checkpoint because replay from any checkpoint is deterministic)."""
    for n in reversed(_versions(dirname)):
        path = os.path.join(dirname, f"ckpt_{n}")
        if not verify or checkpoint_ok(path):
            return path
    return None


def load_checkpoint(executor, dirname, main_program=None,
                    master: Optional[object] = None,
                    verify_digest: bool = True, scope=None):
    """Restore the newest USABLE checkpoint → trainer_state dict (or None
    when no checkpoint exists).

    Walks candidates newest-first; a snapshot that fails its digest, is
    truncated, or errors during load is skipped and the previous one is
    tried (chaos scenarios: corrupt newest, kill-during-save).  Raises
    IOError only when checkpoints exist but none loads — resuming from
    nothing when state was expected must be a loud failure, not a silent
    reinitialization."""
    versions = _versions(dirname)
    if not versions:
        return None
    errors = []
    for n in reversed(versions):
        path = os.path.join(dirname, f"ckpt_{n}")
        try:
            with open(os.path.join(path, "meta.json")) as f:
                meta = json.load(f)
            if verify_digest and meta["digest"] != _digest(path):
                raise IOError("integrity digest mismatch")
            fio.load_persistables(executor, path, main_program, scope)
            mq = os.path.join(path, "master_queue.json")
            if master is not None and os.path.exists(mq):
                # recover the queue from the snapshot, then restore the
                # master's own path — it must NOT keep live-writing into
                # this finalized checkpoint dir
                prev_snapshot_path = getattr(master, "snapshot_path",
                                             None)
                master.snapshot_path = mq
                try:
                    master.recover()
                finally:
                    master.snapshot_path = prev_snapshot_path
            return meta["trainer_state"]
        except Exception as e:  # fall back past this snapshot
            errors.append(f"{os.path.basename(path)}: "
                          f"{type(e).__name__}: {e}")
    raise IOError(
        f"no usable checkpoint under {dirname!r} "
        f"({len(versions)} present, all failed): " + "; ".join(errors))
