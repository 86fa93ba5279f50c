"""Elastic data-dispatch master (reference go/master/service.go) — the
port of ``paddle_tpu/distributed/master.py``, host logic unchanged.

The Go master shards a dataset into tasks (partition :106), serves GetTask
(:368) / TaskFinished (:411) / TaskFailed (:455) to trainers, requeues on
timeout (checkTimeoutFunc :341), caps per-task failures (processFailedTask
:313), and snapshots queue state to etcd (:207) for leader-failover recovery
(:166).

Here the *elastic dispatch* capability serves multi-process input sharding
and straggler tolerance, and leases tasks to the training service's
workers (distributed/service.py).  The
service is plain Python (it is control plane, not compute): in-process use
for tests, JSON-lines-over-TCP for multi-process, snapshot to a file standing
in for etcd."""

from __future__ import annotations

import collections
import json
import os
import random
import socket
import socketserver
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..observability.metrics import REGISTRY as _MET


@dataclass
class Task:
    task_id: int
    payload: object  # opaque descriptor: file path, index range, chunk
    epoch: int = 0
    num_failures: int = 0


class MasterService:
    """In-process task queue with timeout requeue and failure caps."""

    def __init__(self, timeout_s: float = 60.0, failure_max: int = 3,
                 snapshot_path: Optional[str] = None):
        self.timeout_s = timeout_s
        self.failure_max = failure_max
        self.snapshot_path = snapshot_path
        self._lock = threading.Lock()
        self._todo: List[Task] = []
        # id -> (Task, deadline, trainer_id, leased_at)
        self._pending: Dict[int, tuple] = {}
        self._done: List[Task] = []
        self._epoch = 0
        self._next_id = 0
        # trainer_id -> last heartbeat timestamp (lease liveness: the
        # chaos runner and the training service read ages off progress())
        self._trainers: Dict[str, float] = {}
        # last N lease-expiry requeues, newest last: the chaos runner
        # asserts requeue latency (overdue_s) against the lease timeout
        self._requeue_log = collections.deque(maxlen=64)
        # per-client-nonce last (seq, reply): transport retry dedup
        self._rpc_cache: Dict[str, tuple] = {}
        if snapshot_path and os.path.exists(snapshot_path):
            self.recover()

    # -- dataset ------------------------------------------------------------
    def set_dataset(self, payloads: List[object]):
        with self._lock:
            self._todo = [Task(self._take_id(), p) for p in payloads]
            self._pending.clear()
            self._done.clear()
            self._snapshot_locked()

    def _take_id(self) -> int:
        self._next_id += 1
        return self._next_id - 1

    # -- trainer RPCs (service.go:368/411/455) ------------------------------
    def get_task(self, trainer_id: str = "") -> Optional[dict]:
        with self._lock:
            self._requeue_timeouts_locked()
            if not self._todo:
                if not self._pending and self._done:
                    # epoch finished → recycle for the next pass
                    self._epoch += 1
                    self._todo = [
                        Task(t.task_id, t.payload, self._epoch)
                        for t in self._done
                    ]
                    self._done = []
                else:
                    return None
            t = self._todo.pop(0)
            now = time.time()
            self._pending[t.task_id] = (t, now + self.timeout_s,
                                        str(trainer_id), now)
            self._snapshot_locked()
            _MET.counter("master_leases_granted_total",
                         "tasks leased to trainers").inc()
            return {"task_id": t.task_id, "payload": t.payload,
                    "epoch": t.epoch}

    def task_finished(self, task_id: int):
        with self._lock:
            ent = self._pending.pop(task_id, None)
            if ent is not None:
                self._done.append(ent[0])
                _MET.counter("master_tasks_finished_total",
                             "leases acked complete").inc()
            self._snapshot_locked()

    def put_back(self, task_id: int):
        """Return an unconsumed task to the queue front (no failure charge):
        the v2 master client pushes back the first next-epoch task it sees
        when detecting its pass boundary."""
        with self._lock:
            ent = self._pending.pop(task_id, None)
            if ent is not None:
                self._todo.insert(0, ent[0])
            self._snapshot_locked()

    def task_failed(self, task_id: int):
        with self._lock:
            ent = self._pending.pop(task_id, None)
            if ent is None:
                return
            t = ent[0]
            t.num_failures += 1
            if t.num_failures < self.failure_max:
                self._todo.append(t)  # requeue (processFailedTask :313)
            else:
                self._done.append(t)  # drop after failure_max, logged as done
            self._snapshot_locked()

    def _requeue_timeouts_locked(self):
        now = time.time()
        for t_id in [t for t, ts in self._trainers.items()
                     if now - ts > self._TRAINER_TTL_S]:
            del self._trainers[t_id]
        for tid in [tid for tid, ent in self._pending.items()
                    if ent[1] < now]:
            t, deadline, trainer, leased_at = self._pending.pop(tid)
            t.num_failures += 1
            self._requeue_log.append({
                "task_id": tid, "trainer_id": trainer,
                "leased_at": leased_at, "requeued_at": now,
                "lease_timeout_s": self.timeout_s,
                # how long past the lease expiry the requeue landed:
                # the chaos runner's requeue-latency assertion
                "overdue_s": round(now - deadline, 4),
            })
            _MET.counter("master_requeues_total",
                         "expired leases returned to the queue").inc()
            _MET.histogram(
                "master_requeue_overdue_seconds",
                "delay between lease expiry and its requeue").observe(
                max(0.0, now - deadline))
            if t.num_failures < self.failure_max:
                self._todo.append(t)
            else:
                self._done.append(t)

    # -- lease liveness (service/chaos-runner introspection) ----------------
    # heartbeat records older than this are pruned in the timeout sweep:
    # a long-lived master serving churning trainer ids must not grow its
    # liveness table forever.  Far above any stall-detection threshold
    # (the service's first-step grace is 60s) so pruning never hides a
    # stall the monitor still cares about.
    _TRAINER_TTL_S = 600.0

    def heartbeat(self, trainer_id: str) -> dict:
        """Record trainer liveness; the training service declares a worker
        dead when its heartbeat age exceeds the lease timeout (the Go
        master leaned on etcd leases for this; here the master itself is
        the lease authority)."""
        now = time.time()
        _MET.counter("master_heartbeats_total",
                     "trainer heartbeats received").inc()
        with self._lock:
            self._trainers[str(trainer_id)] = now
            return {"server_time": now}

    # -- transport retry dedup (lost-reply replays: the client retries a
    # processed get_task and would otherwise receive a SECOND task while
    # the first burns a timeout+failure — at-most-once per seq token) -----
    def rpc_cached(self, seq: str):
        nonce = str(seq).split(":", 1)[0]
        with self._lock:
            ent = self._rpc_cache.get(nonce)
            if ent is not None and ent[0] == seq:
                return ent[1]
        return None

    def rpc_record(self, seq: str, resp: dict):
        nonce = str(seq).split(":", 1)[0]
        with self._lock:
            self._rpc_cache[nonce] = (seq, resp)

    # -- introspection ------------------------------------------------------
    def progress(self) -> dict:
        now = time.time()
        with self._lock:
            self._requeue_timeouts_locked()
            return {
                "epoch": self._epoch, "todo": len(self._todo),
                "pending": len(self._pending), "done": len(self._done),
                # per-trainer heartbeat age + per-task lease state: the
                # chaos runner asserts requeue latency from these
                "trainers": {tid: round(now - ts, 4)
                             for tid, ts in self._trainers.items()},
                "leases": [
                    {"task_id": tid, "trainer_id": trainer,
                     "age_s": round(now - leased_at, 4),
                     "expires_in_s": round(deadline - now, 4)}
                    for tid, (t, deadline, trainer, leased_at)
                    in self._pending.items()],
                "requeues": list(self._requeue_log),
            }

    def request_save_model(self, trainer_id: str = "",
                           block_ms: float = 0.0) -> int:
        """Arbitrate model saving: exactly one trainer gets a grant per
        block_ms window (go master RequestSaveModel / etcd-lock semantics,
        consumed by v2 master.client.request_save_model)."""
        with self._lock:
            now = time.time()
            last = getattr(self, "_save_grant_ts", 0.0)
            if (now - last) * 1000.0 >= float(block_ms):
                self._save_grant_ts = now
                return 1
            return 0

    # -- snapshot/recover (service.go:207/:166; etcd → file) ----------------
    def _snapshot_locked(self):
        if not self.snapshot_path:
            return
        state = {
            "epoch": self._epoch,
            "next_id": self._next_id,
            "todo": [(t.task_id, t.payload, t.epoch, t.num_failures)
                     for t in self._todo] +
                    [(ent[0].task_id, ent[0].payload, ent[0].epoch,
                      ent[0].num_failures)
                     for ent in self._pending.values()],
            "done": [(t.task_id, t.payload, t.epoch, t.num_failures)
                     for t in self._done],
        }
        tmp = self.snapshot_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, self.snapshot_path)

    def snapshot(self):
        with self._lock:
            self._snapshot_locked()

    def recover(self):
        with open(self.snapshot_path) as f:
            state = json.load(f)
        with self._lock:
            self._epoch = state["epoch"]
            self._next_id = state["next_id"]
            # pending tasks at snapshot time were not finished → back to todo
            self._todo = [Task(i, p, e, nf) for i, p, e, nf in state["todo"]]
            self._pending = {}
            self._done = [Task(i, p, e, nf) for i, p, e, nf in state["done"]]


# ---------------------------------------------------------------------------
# TCP transport: JSON-lines RPC (thin stand-in for go net/rpc + etcd)


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        svc: MasterService = self.server.service  # type: ignore
        for line in self.rfile:
            try:
                req = json.loads(line)
                method = req["method"]
                args = req.get("args", [])
                seq = req.get("seq")
                if seq is not None:
                    cached = svc.rpc_cached(seq)
                    if cached is not None:
                        resp = cached
                        self.wfile.write((json.dumps(resp) + "\n").encode())
                        self.wfile.flush()
                        continue
                result = getattr(svc, method)(*args)
                resp = {"ok": True, "result": result}
                if seq is not None:
                    svc.rpc_record(seq, resp)
            except Exception as e:  # report, keep serving
                resp = {"ok": False, "error": str(e)}
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()


class MasterServer:
    def __init__(self, service: MasterService, host="127.0.0.1", port=0):
        from .pserver import SeverableThreadingTCPServer

        self._srv = SeverableThreadingTCPServer((host, port), _Handler)
        self._srv.service = service  # type: ignore
        self.addr = self._srv.server_address
        # a short poll keeps stop() (and a failover's rebind) prompt
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        kwargs={"poll_interval": 0.05},
                                        daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._srv.shutdown()
        self._srv.sever()
        self._srv.server_close()


class MasterClient:
    """Trainer-side client (go/master/client.go + python v2/master/client.py
    :28/:70) with reconnect-on-error.  Safe for concurrent use: `call` is
    serialized by an internal lock — the per-nonce seq tokens and the
    framed socket protocol both assume one in-flight request per client
    (ADVICE r2)."""

    def __init__(self, addr, retries: int = 5, backoff_s: float = 0.05,
                 backoff_max_s: float = 2.0, deadline_s: float = 30.0):
        import threading
        import uuid

        self.addr = tuple(addr)
        self.retries = retries
        self.backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        self.deadline_s = deadline_s
        self._sock = None
        self._file = None
        self._nonce = uuid.uuid4().hex[:12]
        self._seq = 0
        self._lock = threading.Lock()

    def _connect(self):
        self._sock = socket.create_connection(self.addr, timeout=30)
        self._file = self._sock.makefile("rwb")

    def call(self, method, *args):
        with self._lock:
            return self._call_locked(method, *args)

    def _call_locked(self, method, *args):
        """Retry with exponential backoff + full jitter under an overall
        deadline (the old 3 immediate 0.1s retries hammered a restarting
        master exactly when it was busiest, and gave up in 0.3s — less
        than any realistic failover window)."""
        last = None
        self._seq += 1
        seq = f"{self._nonce}:{self._seq}"  # same token on every retry
        t0 = time.monotonic()
        attempt = 0  # bound even if retries <= 0 slipped through
        for attempt in range(max(1, self.retries)):
            try:
                if self._file is None:
                    self._connect()
                self._file.write(
                    (json.dumps({"method": method, "args": list(args),
                                 "seq": seq})
                     + "\n").encode())
                self._file.flush()
                resp = json.loads(self._file.readline())
                if not resp["ok"]:
                    raise RuntimeError(resp["error"])
                return resp["result"]
            except (OSError, ValueError) as e:
                last = e
                self._file = None
                elapsed = time.monotonic() - t0
                if attempt + 1 >= self.retries \
                        or elapsed >= self.deadline_s:
                    break
                # full jitter: sleep U(0, min(cap, base*2^attempt)),
                # clipped to the remaining deadline
                ceiling = min(self.backoff_max_s,
                              self.backoff_s * (2 ** attempt))
                time.sleep(min(random.uniform(0, ceiling),
                               max(0.0, self.deadline_s - elapsed)))
        raise ConnectionError(
            f"master unreachable after {attempt + 1} attempt(s) / "
            f"{time.monotonic() - t0:.1f}s: {last}")

    def set_dataset(self, payloads):
        return self.call("set_dataset", list(payloads))

    def get_task(self, trainer_id=""):
        return self.call("get_task", trainer_id)

    def task_finished(self, task_id):
        return self.call("task_finished", task_id)

    def task_failed(self, task_id):
        return self.call("task_failed", task_id)

    def put_back(self, task_id):
        return self.call("put_back", task_id)

    def heartbeat(self, trainer_id):
        return self.call("heartbeat", trainer_id)

    def progress(self):
        return self.call("progress")


def master_reader(client: MasterClient, load_task, trainer_id=""):
    """Reader over master-dispatched tasks (the v2 cluster reader pattern:
    dataset/common.py master-client integration): pulls tasks, yields their
    samples, acks; on loader failure reports task_failed and moves on."""

    def reader():
        while True:
            task = client.get_task(trainer_id)
            if task is None:
                return
            try:
                yield from load_task(task["payload"])
            except Exception:
                client.task_failed(task["task_id"])
                continue
            client.task_finished(task["task_id"])

    return reader
