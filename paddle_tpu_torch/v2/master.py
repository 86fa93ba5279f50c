"""v2 master client, the port of ``paddle_tpu/v2/master.py`` (reference
python/paddle/v2/master/client.py:28 — the cgo binding onto
go/master/client.go).

The Go master + etcd collapse into the elastic MasterService
(``distributed/master.py``: chunked task queue, timeout requeue, failure
cap, snapshot/recover); this module keeps the reference client surface —
set_dataset(recordio paths) / next_record() / release() — over that
service's JSON-RPC transport, reading each task's shard through
``native/recordio.py``.  A shard that fails to read raises from
``next_record``."""

from __future__ import annotations

import glob as _glob

from ..distributed.master import MasterClient
from ..native.recordio import read_records

__all__ = ["client"]


class client:
    """reference client.py:33 — `etcd_endpoints` generalizes to the master
    address ("host:port"); etcd discovery is the reference mechanism, the
    address IS the discovery here (launch.py hands it out)."""

    def __init__(self, etcd_endpoints, timeout_sec=30, buf_size=0):
        addr = etcd_endpoints
        if isinstance(addr, str):
            addr = addr.split(",")[0].replace("http://", "")
            host, _, port = addr.rpartition(":")
            addr = (host or "127.0.0.1", int(port))
        self._c = MasterClient(addr)
        self._records = iter(())
        self._task = None
        self._pass_done = False
        self._pass_epoch = None

    # -- dataset / records -------------------------------------------------
    def set_dataset(self, paths):
        """Shard recordio paths into master tasks (client.py:62)."""
        expanded = []
        for p in paths:
            hits = sorted(_glob.glob(p))
            expanded.extend(hits or [p])
        self._c.call("set_dataset", expanded)

    def paddle_start_get_records(self, pass_id):
        self._pass_done = False
        self._records = iter(())
        self._task = None
        self._pass_epoch = None

    def next_record(self):
        """One record per call; (None, 0) at end of pass (client.py:70).
        The master recycles tasks for the next epoch once all finish, so
        the pass boundary is an epoch change on the dispensed task — that
        task goes back untouched (put_back) for the next pass."""
        while True:
            nxt = next(self._records, None)
            if nxt is not None:
                return nxt, len(nxt)
            if self._task is not None:
                self._c.task_finished(self._task["task_id"])
                self._task = None
            if self._pass_done:
                return None, 0
            task = self._c.get_task()
            if task is None:
                self._pass_done = True
                return None, 0
            if self._pass_epoch is None:
                self._pass_epoch = task["epoch"]
            elif task["epoch"] != self._pass_epoch:
                self._c.call("put_back", task["task_id"])
                self._pass_done = True
                return None, 0
            self._task = task
            self._records = iter(read_records(task["payload"]))

    # -- save-model coordination (client.py:37) ----------------------------
    def request_save_model(self, trainer_id, block_ms):
        """Returns 1 if THIS trainer should save the model, 0 otherwise —
        the master arbitrates so exactly one trainer saves (the reference's
        etcd-lock semantics)."""
        return int(self._c.call("request_save_model", trainer_id, block_ms))

    def release(self):
        self._records = iter(())
        self._task = None
