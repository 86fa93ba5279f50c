"""Host parameter service — the port of
``paddle_tpu/distributed/pserver.py``: the capability equivalent of the
reference's THREE parameter-server generations — C++ `ParameterServer2`
(BSP barriers, async SGD, block-sharded params, sparse rows —
paddle/pserver/ParameterServer2.cpp:250/362/457/559), the Go
fault-tolerant pserver (InitParam/FinishInitParams/SendGrad/GetParam +
disk checkpoint with etcd meta — go/pserver/service.go:229/260/285/311/346),
and the fluid gRPC send/recv pair (operators/send_op.cc, recv_op.cc).

Dense data-parallel gradients ride the mesh's collectives inside a step;
this service covers what stays on the host: embedding tables too large
for the card (sparse row updates), and BSP/async coordination between
trainer processes.  Transport is a length-prefixed JSON-header +
raw-tensor-bytes protocol over TCP (the LightNetwork/ProtoServer role),
with in-process use for tests.  The wire is the JAX package's byte for
byte, so either package's client talks to the other's server.

Server-side optimizers are numpy implementations of the standalone
`paddle/optimizer` C library the Go pserver embedded (optimizer.go:51),
with byte-serializable state (serialization.h parity) for checkpoints.

bfloat16: numpy has no bfloat16 here, so a bf16 value travels as its raw
2-byte words under the dtype name ``"bfloat16"`` (what the JAX package's
``ml_dtypes`` arrays send) and lives in the service as a CPU torch bf16
tensor.  The host optimizers run on it as ``ml_dtypes`` arithmetic does
under numpy 2: two bf16 operands give a bf16 result rounded from f32,
while a bf16 array meeting a Python scalar (or an f32 array) widens to
float32 first — so most update rules turn a bf16 parameter into a
float32 one at its first step, exactly as the JAX service does.  Results
that are not bf16 are numpy arrays again.
"""

from __future__ import annotations

import hashlib
import io as _io
import json
import os
import socket
import socketserver
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Server-side optimizers (paddle/optimizer C library parity)


def _bf(x) -> bool:
    """A bf16 value (a torch tensor: every other dtype is numpy)."""
    return isinstance(x, torch.Tensor)


def _value(x):
    """A value the service computes on: numpy, or a CPU torch tensor
    when it is bfloat16."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


def _same(*xs):
    """The operands in one backend: torch when any is bf16."""
    if any(_bf(x) for x in xs):
        return tuple(_t(x) for x in xs)
    return xs


def _wide(x):
    """A bf16 operand meeting a Python scalar widens to float32 first."""
    return x.float() if _bf(x) else x


def _done(x):
    """A result: bf16 stays a tensor, anything else is numpy."""
    if isinstance(x, torch.Tensor) and x.dtype != torch.bfloat16:
        return x.numpy()
    return x


def _zeros_like(x):
    return torch.zeros_like(x) if _bf(x) else np.zeros_like(x)


def _sqrt(x):
    return torch.sqrt(x) if _bf(x) else np.sqrt(x)


def _copy(x):
    return x.clone() if _bf(x) else x.copy()


def _scatter(out, rows, values, sign):
    """``np.add.at`` (sign +1) or ``np.subtract.at`` (-1) into `out`, in
    place: a bf16 `out` takes each row in turn, rounded to bf16 as the
    ``ml_dtypes`` loop does; a numpy `out` widens bf16 values first."""
    rows = np.asarray(rows).reshape(-1)
    if _bf(out):
        values = _t(values)
        for i, r in enumerate(rows.tolist()):
            out[r] = out[r] + values[i] if sign > 0 else out[r] - values[i]
        return out
    values = _done(_wide(values))
    (np.add if sign > 0 else np.subtract).at(out, rows, values)
    return out


def _storable(x) -> np.ndarray:
    """A value as numpy for ``np.savez``: bf16 as its raw words under the
    ``'<V2'`` dtype (the bytes ``np.savez`` writes for an ``ml_dtypes``
    bfloat16 array)."""
    if _bf(x):
        return x.contiguous().view(torch.int16).numpy().view("V2")
    return np.asarray(x)


def _stored(a: np.ndarray):
    """Inverse of `_storable`."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(np.ascontiguousarray(a).view(
            np.int16).copy()).view(torch.bfloat16)
    return a


class HostOptimizer:
    """Host update rule with serializable state."""

    def __init__(self, lr: float = 0.01):
        self.lr = lr

    def update(self, param, grad):
        raise NotImplementedError

    # Sparse row update: default = dense scatter of the row update rule.
    def update_rows(self, param, rows, values):
        dense = _scatter(_zeros_like(param), rows, values, +1)
        return self.update(param, dense)

    def state_bytes(self) -> bytes:
        buf = _io.BytesIO()
        np.savez(buf, **{k: _storable(v)
                         for k, v in self._state_arrays().items()})
        return buf.getvalue()

    def load_state(self, data: bytes):
        if not data:
            return
        loaded = np.load(_io.BytesIO(data))
        self._set_state_arrays({k: _stored(loaded[k])
                                for k in loaded.files})

    def _state_arrays(self) -> Dict[str, object]:
        return {}

    def _set_state_arrays(self, arrays: Dict[str, object]):
        pass


class HostSGD(HostOptimizer):
    def update(self, param, grad):
        param, grad = _same(param, grad)
        return _done(param - self.lr * _wide(grad))

    def update_rows(self, param, rows, values):
        out = _copy(param)
        return _scatter(out, rows, self.lr * _wide(values), -1)


class HostMomentum(HostOptimizer):
    def __init__(self, lr=0.01, momentum=0.9, use_nesterov=False):
        super().__init__(lr)
        self.mu = momentum
        self.nesterov = bool(use_nesterov)
        self.velocity = None

    def update(self, param, grad):
        if self.velocity is None:
            self.velocity = _zeros_like(param)
        param, grad, vel = _same(param, grad, self.velocity)
        vel = self.mu * _wide(vel) + grad
        self.velocity = _done(vel)
        if self.nesterov:  # momentum_op.h use_nesterov lookahead
            return _done(param - self.lr * _wide(grad + self.mu
                                                 * _wide(vel)))
        return _done(param - self.lr * _wide(vel))

    def _state_arrays(self):
        return {} if self.velocity is None else {"velocity": self.velocity}

    def _set_state_arrays(self, arrays):
        self.velocity = arrays.get("velocity")


class HostAdagrad(HostOptimizer):
    def __init__(self, lr=0.01, epsilon=1e-6):
        super().__init__(lr)
        self.eps = epsilon
        self.moment = None

    def update(self, param, grad):
        if self.moment is None:
            self.moment = _zeros_like(param)
        param, grad, mom = _same(param, grad, self.moment)
        mom = mom + grad * grad
        self.moment = _done(mom)
        return _done(param - self.lr * _wide(grad)
                     / (_wide(_sqrt(mom)) + self.eps))

    def update_rows(self, param, rows, values):
        # Sparse: only touched rows accumulate moment (SparseRowMatrix
        # semantics — rows never seen keep zero state).
        if self.moment is None:
            self.moment = _zeros_like(param)
        out = _copy(param)
        rows = np.asarray(rows).reshape(-1)
        sq = _done(values * values)
        self.moment = _scatter(self.moment, rows, sq, +1)
        picked = self.moment[torch.as_tensor(rows)] if _bf(self.moment) \
            else self.moment[rows]
        denom = _wide(_sqrt(picked)) + self.eps
        step = _same(self.lr * _wide(values), denom)
        return _scatter(out, rows, _done(step[0] / step[1]), -1)

    def _state_arrays(self):
        return {} if self.moment is None else {"moment": self.moment}

    def _set_state_arrays(self, arrays):
        self.moment = arrays.get("moment")


class HostAdam(HostOptimizer):
    def __init__(self, lr=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8):
        super().__init__(lr)
        self.b1, self.b2, self.eps = beta1, beta2, epsilon
        self.m = None
        self.v = None
        self.t = 0

    def update(self, param, grad):
        if self.m is None:
            self.m = _zeros_like(param)
            self.v = _zeros_like(param)
        self.t += 1
        param, grad, m, v = _same(param, grad, self.m, self.v)
        m = self.b1 * _wide(m) + (1 - self.b1) * _wide(grad)
        v = self.b2 * _wide(v) + (1 - self.b2) * _wide(grad) * grad
        self.m, self.v = _done(m), _done(v)
        mhat = _wide(m) / (1 - self.b1 ** self.t)
        vhat = _wide(v) / (1 - self.b2 ** self.t)
        return _done(param - self.lr * mhat / (_sqrt(vhat) + self.eps))

    def _state_arrays(self):
        if self.m is None:
            return {}
        return {"m": self.m, "v": self.v, "t": np.array([self.t])}

    def _set_state_arrays(self, arrays):
        self.m = arrays.get("m")
        self.v = arrays.get("v")
        self.t = int(arrays["t"][0]) if "t" in arrays else 0


_OPTIMIZERS = {"sgd": HostSGD, "momentum": HostMomentum,
               "adagrad": HostAdagrad, "adam": HostAdam}


def make_optimizer(cfg: dict) -> HostOptimizer:
    cfg = dict(cfg or {"type": "sgd"})
    return _OPTIMIZERS[cfg.pop("type", "sgd")](**cfg)


# ---------------------------------------------------------------------------
# Service core (in-process)


class ParameterServerService:
    """Parameter blocks + server-side optimize, BSP or async.

    BSP (ParameterService.proto:24 PSERVER_UPDATE_MODE_ADD_GRADIENT):
    `send_grad` accumulates; once `num_trainers` distinct trainers have
    contributed this round, the optimizer applies the averaged gradient and
    the round barrier releases every waiter.  Async
    (PSERVER_UPDATE_MODE_ASYNC_SGD): each gradient applies immediately.
    """

    def __init__(self, num_trainers: int = 1, mode: str = "bsp",
                 checkpoint_dir: Optional[str] = None):
        assert mode in ("bsp", "async")
        self.num_trainers = num_trainers
        self.mode = mode
        self.checkpoint_dir = checkpoint_dir
        self._params: Dict[str, np.ndarray] = {}
        self._opts: Dict[str, HostOptimizer] = {}
        self._opt_cfgs: Dict[str, dict] = {}
        self._init_done = False
        self._lock = threading.Lock()
        self._round_cv = threading.Condition(self._lock)
        self._round = 0
        self._acc: Dict[str, np.ndarray] = {}
        self._contributed: set = set()
        self._pass_cv = threading.Condition(self._lock)
        self._pass_waiting = 0
        self._pass_arrived = set()
        self._pass_pending_seq: Dict[str, object] = {}
        self._pass_seq: Dict[str, object] = {}
        self._grad_seq: Dict[str, object] = {}
        self._sparse_seq: Dict[str, object] = {}
        self._pass_no = 0

    # -- init barrier (service.go:229/260: trainer 0 seeds params) ----------
    def init_param(self, name: str, value: np.ndarray,
                   optimizer_cfg: Optional[dict] = None):
        with self._lock:
            if self._init_done:
                raise RuntimeError("init after finish_init_params")
            self._params[name] = _copy(_value(value))
            self._opt_cfgs[name] = dict(optimizer_cfg or {"type": "sgd"})
            self._opts[name] = make_optimizer(optimizer_cfg)

    def finish_init_params(self):
        with self._lock:
            self._init_done = True

    def update_lrs(self, lrs: Dict[str, float]):
        """Refresh host-optimizer learning rates mid-training (ADVICE r2
        medium: an LR schedule decaying in the trainer program must reach
        the server-side optimizers or distributed training silently
        diverges from single-process semantics).  Idempotent — no seq
        dedup needed; names this shard doesn't own are ignored (each
        trainer broadcasts the full schedule)."""
        with self._lock:
            for name, lr in lrs.items():
                opt = self._opts.get(name)
                if opt is None:
                    continue
                opt.lr = float(lr)
                # keep the persisted rule in sync so a checkpoint restart
                # resumes with the decayed LR, not the initial one
                if name in self._opt_cfgs:
                    self._opt_cfgs[name]["lr"] = float(lr)

    def initialized(self) -> bool:
        with self._lock:
            return self._init_done

    # -- gradient path (service.go:285 SendGrad / PS2.cpp:362 addGradient) --
    def send_grad(self, trainer_id: str, grads: Dict[str, np.ndarray],
                  timeout: Optional[float] = 120.0, seq=None):
        """`seq` is the client's per-connection monotonic id: a transport
        retry of a request the server already processed (reply lost) must
        not double-apply the gradient or double-count the BSP round."""
        with self._round_cv:
            if not self._init_done:
                raise RuntimeError("send_grad before FinishInitParams")
            duplicate = (seq is not None
                         and self._grad_seq.get(trainer_id) == seq)
            if self.mode == "async":
                if duplicate:
                    return
                for name, g in grads.items():
                    self._params[name] = self._opts[name].update(
                        self._params[name], _value(g))
                if seq is not None:
                    self._grad_seq[trainer_id] = seq
                return
            if duplicate:
                # already accumulated; if its round is still open, wait for
                # it like the original call would, else it completed
                if trainer_id in self._contributed:
                    my_round = self._round
                    if not self._round_cv.wait_for(
                            lambda: self._round > my_round,
                            timeout=timeout):
                        raise TimeoutError(
                            f"BSP round {my_round}: peers missing after "
                            f"{timeout}s")
                return
            for name, g in grads.items():
                # `0 + g` widens a bf16 gradient to f32 (ml_dtypes)
                g = _done(_wide(_value(g)))
                self._acc[name] = self._acc.get(name, 0) + g
            self._contributed.add(trainer_id)
            if seq is not None:
                self._grad_seq[trainer_id] = seq
            my_round = self._round
            if len(self._contributed) >= self.num_trainers:
                for name, total in self._acc.items():
                    avg = total / float(self.num_trainers)
                    self._params[name] = self._opts[name].update(
                        self._params[name], avg)
                self._acc = {}
                self._contributed = set()
                self._round += 1
                self._round_cv.notify_all()
            else:
                # BSP barrier: block until this round's update is applied
                if not self._round_cv.wait_for(
                        lambda: self._round > my_round, timeout=timeout):
                    raise TimeoutError(
                        f"BSP round {my_round}: peers missing after "
                        f"{timeout}s")

    def send_sparse_grad(self, trainer_id: str, name: str,
                         rows: np.ndarray, values: np.ndarray, seq=None):
        """SelectedRows gradient: update only `rows` of the table (sparse
        pserver path — RemoteParameterUpdater.h:265, SparseRowMatrix).
        Always applied immediately (async), matching the reference's
        sparse-remote behavior of row-level updates.  `seq` dedups
        transport retries (see send_grad)."""
        with self._lock:
            if not self._init_done:
                raise RuntimeError("send_grad before FinishInitParams")
            if seq is not None and self._sparse_seq.get(trainer_id) == seq:
                return
            self._params[name] = self._opts[name].update_rows(
                self._params[name], np.asarray(rows), _value(values))
            if seq is not None:
                self._sparse_seq[trainer_id] = seq

    # -- fetch (service.go:311 GetParam / PS2.cpp:559 getParameter) ---------
    def get_param(self, name: str) -> np.ndarray:
        with self._lock:
            return _copy(self._params[name])

    def get_param_rows(self, name: str, rows: np.ndarray) -> np.ndarray:
        """Sparse prefetch: only needed rows travel (getParameterSparse)."""
        with self._lock:
            p = self._params[name]
            rows = np.asarray(rows)
            return p[torch.as_tensor(rows)] if _bf(p) else p[rows].copy()

    def param_names(self) -> List[str]:
        with self._lock:
            return sorted(self._params)

    # -- pass barriers (PS2 waitPassStart/waitPassFinish) -------------------
    def wait_pass_barrier(self, timeout: Optional[float] = 120.0,
                          trainer_id: str = "", seq=None) -> int:
        """All trainers rendezvous; returns the new pass number.  `seq` is
        the client's retry token: a retry of a call whose barrier already
        RELEASED (reply lost) returns immediately instead of counting as a
        fresh arrival for the next pass; a re-arrival while the barrier is
        still open counts once.  Anonymous callers keep plain counting."""
        with self._pass_cv:
            if trainer_id and seq is not None \
                    and self._pass_seq.get(trainer_id) == seq:
                return self._pass_no  # completed-call retry
            if trainer_id:
                if trainer_id not in self._pass_arrived:
                    self._pass_arrived.add(trainer_id)
                    self._pass_pending_seq[trainer_id] = seq
                    self._pass_waiting += 1
            else:
                self._pass_waiting += 1
            if self._pass_waiting >= self.num_trainers:
                self._pass_waiting = 0
                self._pass_seq.update(self._pass_pending_seq)
                self._pass_pending_seq = {}
                self._pass_arrived = set()
                self._pass_no += 1
                self._pass_cv.notify_all()
                return self._pass_no
            target = self._pass_no + 1
            if not self._pass_cv.wait_for(
                    lambda: self._pass_no >= target, timeout=timeout):
                raise TimeoutError("pass barrier timeout")
            return self._pass_no

    # -- checkpoint (service.go:346 checkpoint / :175 LoadCheckpoint) -------
    def save_checkpoint(self, dirname: Optional[str] = None) -> str:
        dirname = dirname or self.checkpoint_dir
        assert dirname, "no checkpoint dir configured"
        os.makedirs(dirname, exist_ok=True)
        with self._lock:
            blob_path = os.path.join(dirname, "pserver.npz")
            arrays = {n: _storable(v) for n, v in self._params.items()}
            for name, opt in self._opts.items():
                arrays[f"__optstate__{name}"] = np.frombuffer(
                    opt.state_bytes(), dtype=np.uint8)
            buf = _io.BytesIO()
            np.savez(buf, **arrays)
            blob = buf.getvalue()
            with open(blob_path, "wb") as f:
                f.write(blob)
            meta = {
                "md5": hashlib.md5(blob).hexdigest(),
                "path": blob_path,
                "timestamp": time.time(),
                "round": self._round,
                "pass": self._pass_no,
                "opt_cfgs": self._opt_cfgs,
                # retry-dedup state: exactly-once must survive the restart
                # (a reply lost across the crash is retried against the
                # reloaded server)
                "grad_seq": self._grad_seq,
                "sparse_seq": self._sparse_seq,
                "pass_seq": self._pass_seq,
            }
            with open(os.path.join(dirname, "pserver.meta.json"), "w") as f:
                json.dump(meta, f)
        return blob_path

    def load_checkpoint(self, dirname: Optional[str] = None) -> bool:
        dirname = dirname or self.checkpoint_dir
        meta_path = os.path.join(dirname or "", "pserver.meta.json")
        if not dirname or not os.path.exists(meta_path):
            return False
        with open(meta_path) as f:
            meta = json.load(f)
        with open(meta["path"], "rb") as f:
            blob = f.read()
        if hashlib.md5(blob).hexdigest() != meta["md5"]:
            raise RuntimeError("pserver checkpoint md5 mismatch")
        loaded = np.load(_io.BytesIO(blob))
        with self._lock:
            self._opt_cfgs = dict(meta.get("opt_cfgs", {}))
            self._params = {}
            self._opts = {}
            for key in loaded.files:
                if key.startswith("__optstate__"):
                    continue
                self._params[key] = _stored(loaded[key])
                cfg = self._opt_cfgs.get(key, {"type": "sgd"})
                opt = make_optimizer(cfg)
                state_key = f"__optstate__{key}"
                if state_key in loaded.files:
                    opt.load_state(loaded[state_key].tobytes())
                self._opts[key] = opt
            self._round = int(meta.get("round", 0))
            self._pass_no = int(meta.get("pass", 0))
            self._grad_seq = dict(meta.get("grad_seq", {}))
            self._sparse_seq = dict(meta.get("sparse_seq", {}))
            self._pass_seq = dict(meta.get("pass_seq", {}))
            self._init_done = True
        return True


# ---------------------------------------------------------------------------
# Wire protocol: 4-byte header length | JSON header | raw payload bytes.
# Arrays travel as raw bytes described by header dtype/shape fields.


def _send_msg(sock: socket.socket, header: dict, payload: bytes = b""):
    h = json.dumps(header).encode()
    sock.sendall(struct.pack(">II", len(h), len(payload)) + h + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """`n` bytes into one preallocated buffer (a payload of a whole model
    arrives in linear time)."""
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if not r:
            raise ConnectionError("peer closed")
        got += r
    return bytes(buf)


def _recv_msg(sock: socket.socket) -> Tuple[dict, bytes]:
    hlen, plen = struct.unpack(">II", _recv_exact(sock, 8))
    header = json.loads(_recv_exact(sock, hlen))
    payload = _recv_exact(sock, plen) if plen else b""
    return header, payload


def _itemsize(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else np.dtype(dtype).itemsize


def _pack_array(a) -> Tuple[dict, bytes]:
    """(desc, bytes) of a numpy array or a torch tensor; bf16 as its raw
    2-byte words under the dtype name "bfloat16"."""
    a = _value(a)
    if _bf(a):
        return ({"dtype": "bfloat16", "shape": list(a.shape)},
                a.contiguous().view(torch.int16).numpy().tobytes())
    a = np.ascontiguousarray(a)
    return {"dtype": str(a.dtype), "shape": list(a.shape)}, a.tobytes()


def _unpack_array(desc: dict, payload: bytes):
    """numpy, or a CPU torch bf16 tensor for "bfloat16"."""
    if desc["dtype"] == "bfloat16":
        words = np.frombuffer(payload, dtype=np.int16).reshape(
            desc["shape"]).copy()
        return torch.from_numpy(words).view(torch.bfloat16)
    return np.frombuffer(payload, dtype=desc["dtype"]).reshape(
        desc["shape"]).copy()


class _PServerHandler(socketserver.BaseRequestHandler):
    def handle(self):
        svc: ParameterServerService = self.server.service  # type: ignore
        try:
            while True:
                header, payload = _recv_msg(self.request)
                try:
                    reply, out = self._dispatch(svc, header, payload)
                except (RuntimeError, KeyError, TimeoutError) as e:
                    reply, out = {"ok": False, "error": str(e)}, b""
                _send_msg(self.request, reply, out)
        except (ConnectionError, OSError):
            return

    def _dispatch(self, svc, header, payload):
        op = header["op"]
        if op == "init_param":
            svc.init_param(header["name"],
                           _unpack_array(header["array"], payload),
                           header.get("optimizer"))
            return {"ok": True}, b""
        if op == "finish_init":
            svc.finish_init_params()
            return {"ok": True}, b""
        if op == "initialized":
            return {"ok": True, "value": svc.initialized()}, b""
        if op == "get_config":
            return {"ok": True, "value": {"num_trainers": svc.num_trainers,
                                          "mode": svc.mode}}, b""
        if op == "send_grad":
            descs = header["arrays"]
            grads, off = {}, 0
            for d in descs:
                n = int(np.prod(d["shape"])) * _itemsize(d["dtype"])
                grads[d["name"]] = _unpack_array(d, payload[off:off + n])
                off += n
            svc.send_grad(header["trainer_id"], grads,
                          seq=header.get("seq"))
            return {"ok": True}, b""
        if op == "send_sparse_grad":
            rd, vd = header["rows"], header["values"]
            rn = int(np.prod(rd["shape"])) * _itemsize(rd["dtype"])
            rows = _unpack_array(rd, payload[:rn])
            values = _unpack_array(vd, payload[rn:])
            svc.send_sparse_grad(header["trainer_id"], header["name"],
                                 rows, values, seq=header.get("seq"))
            return {"ok": True}, b""
        if op == "update_lr":
            svc.update_lrs(header["lrs"])
            return {"ok": True}, b""
        if op == "get_param":
            desc, out = _pack_array(svc.get_param(header["name"]))
            return {"ok": True, "array": desc}, out
        if op == "get_param_rows":
            rows = _unpack_array(header["rows"], payload)
            desc, out = _pack_array(svc.get_param_rows(header["name"], rows))
            return {"ok": True, "array": desc}, out
        if op == "param_names":
            return {"ok": True, "value": svc.param_names()}, b""
        if op == "pass_barrier":
            return {"ok": True, "value": svc.wait_pass_barrier(
                trainer_id=header.get("trainer_id", ""),
                seq=header.get("seq"))}, b""
        if op == "save_checkpoint":
            return {"ok": True,
                    "value": svc.save_checkpoint(header.get("dir"))}, b""
        raise RuntimeError(f"unknown op {op!r}")


class SeverableThreadingTCPServer(socketserver.ThreadingTCPServer):
    """ThreadingTCPServer that can SEVER live handler connections: with
    daemon_threads, shutdown()/server_close() leave accepted sockets open
    and the "stopped" server keeps serving — real failover (and the fault
    injection that tests it) needs the corpse to go quiet."""

    allow_reuse_address = True  # failover rebinds the same endpoint
    daemon_threads = True

    def __init__(self, addr, handler, **kw):
        self._live_requests: set = set()
        self._live_lock = threading.Lock()
        super().__init__(addr, handler, **kw)

    def process_request(self, request, client_address):
        with self._live_lock:
            self._live_requests.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._live_lock:
            self._live_requests.discard(request)
        super().shutdown_request(request)

    def sever(self):
        with self._live_lock:
            live = list(self._live_requests)
            self._live_requests.clear()
        for r in live:
            try:
                r.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                r.close()
            except OSError:
                pass


class PServer(SeverableThreadingTCPServer):
    def __init__(self, host="127.0.0.1", port=0, num_trainers=1, mode="bsp",
                 checkpoint_dir=None):
        super().__init__((host, port), _PServerHandler)
        self.service = ParameterServerService(
            num_trainers=num_trainers, mode=mode,
            checkpoint_dir=checkpoint_dir)
        if checkpoint_dir:
            self.service.load_checkpoint(checkpoint_dir)
        self._thread: Optional[threading.Thread] = None

    @property
    def endpoint(self) -> str:
        return f"{self.server_address[0]}:{self.server_address[1]}"

    def start(self):
        # a short poll keeps stop() (and a failover's rebind) prompt
        self._thread = threading.Thread(target=self.serve_forever,
                                        kwargs={"poll_interval": 0.05},
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self.shutdown()
        self.sever()
        self.server_close()


def server_for(name: str, endpoints: List[str]) -> str:
    """Deterministic param->pserver assignment by name hash (go
    client.go's selection); pure — usable without a client/socket."""
    h = int(hashlib.md5(name.encode()).hexdigest(), 16)
    return endpoints[h % len(endpoints)]


class ParameterClient:
    """Trainer-side client (go/pserver/client/c/cclient.go exports /
    ParameterClient2).  Parameters are assigned to pservers by name hash
    (client.go selects pserver by name hash); each param lives wholly on
    one server, matching the Go design."""

    def __init__(self, endpoints: List[str], trainer_id: str = "0"):
        self.endpoints = list(endpoints)
        self.trainer_id = trainer_id
        self._socks: Dict[str, socket.socket] = {}
        # retry-dedup tokens: a fresh nonce per client instance means a
        # RESTARTED trainer (same trainer_id, new process) can never match
        # a stale server-side entry and lose its first gradient
        import uuid

        self._nonce = uuid.uuid4().hex[:12]
        self._seq = 0
        # bumped whenever a dead socket is dropped (= the far side may have
        # restarted from a checkpoint with stale derived state): consumers
        # holding send-once caches keyed on server state (RemoteUpdater's
        # _last_lr) re-sync when this moves
        self.reconnect_epoch = 0

    def _next_seq(self) -> str:
        self._seq += 1
        return f"{self._nonce}:{self._seq}"

    def _sock(self, endpoint: str) -> socket.socket:
        if endpoint not in self._socks:
            host, port = endpoint.rsplit(":", 1)
            s = socket.create_connection((host, int(port)), timeout=300)
            self._socks[endpoint] = s
        return self._socks[endpoint]

    def _server_for(self, name: str) -> str:
        return server_for(name, self.endpoints)

    def _call(self, endpoint, header, payload=b"", retries: int = 8,
              backoff_s: float = 0.25):
        """One RPC with reconnect-on-error: a pserver restart (the elastic
        story — SURVEY §3.4 'pserver death → trainer reconnects; pserver
        restart → checkpoint reload') shows up here as a broken socket;
        drop it, back off, redial.  Service errors (ok=False) raise
        immediately — only transport failures retry."""
        last = None
        for attempt in range(retries):
            try:
                sock = self._sock(endpoint)
                _send_msg(sock, header, payload)
                reply, out = _recv_msg(sock)
            except (OSError, ConnectionError) as e:
                last = e
                self.reconnect_epoch += 1
                dead = self._socks.pop(endpoint, None)
                if dead is not None:
                    try:
                        dead.close()
                    except OSError:
                        pass
                if attempt + 1 < retries:
                    time.sleep(backoff_s * (attempt + 1))
                continue
            if not reply.get("ok"):
                raise RuntimeError(reply.get("error", "pserver error"))
            return reply, out
        raise ConnectionError(
            f"pserver {endpoint} unreachable after {retries} attempts: "
            f"{last}")

    # paddle_begin_init_params / paddle_init_param / finish (cclient.go)
    def init_param(self, name, value, optimizer=None):
        desc, payload = _pack_array(value)
        self._call(self._server_for(name),
                   {"op": "init_param", "name": name, "array": desc,
                    "optimizer": optimizer}, payload)

    def finish_init_params(self):
        for ep in self.endpoints:
            self._call(ep, {"op": "finish_init"})

    def initialized(self) -> bool:
        return all(self._call(ep, {"op": "initialized"})[0]["value"]
                   for ep in self.endpoints)

    def send_grads(self, grads: Dict[str, np.ndarray]):
        by_server: Dict[str, dict] = {}
        for name, g in grads.items():
            by_server.setdefault(self._server_for(name), {})[name] = g
        # every server this trainer talks to must see one contribution per
        # round, even if no grads hash there
        for ep in self.endpoints:
            batch = by_server.get(ep, {})
            descs, chunks = [], []
            for name, g in batch.items():
                d, b = _pack_array(g)
                d["name"] = name
                descs.append(d)
                chunks.append(b)
            self._call(ep, {"op": "send_grad",
                            "trainer_id": self.trainer_id,
                            "seq": self._next_seq(),
                            "arrays": descs}, b"".join(chunks))

    def update_lrs(self, lrs: Dict[str, float]):
        """Push fresh learning rates to the servers owning each param."""
        by_server: Dict[str, dict] = {}
        for name, lr in lrs.items():
            by_server.setdefault(self._server_for(name), {})[name] = float(lr)
        for ep, batch in by_server.items():
            self._call(ep, {"op": "update_lr", "lrs": batch})

    def send_sparse_grad(self, name, rows, values):
        rd, rb = _pack_array(np.asarray(rows))
        vd, vb = _pack_array(values)
        self._call(self._server_for(name),
                   {"op": "send_sparse_grad", "trainer_id": self.trainer_id,
                    "seq": self._next_seq(),
                    "name": name, "rows": rd, "values": vd}, rb + vb)

    def get_param(self, name) -> np.ndarray:
        reply, out = self._call(self._server_for(name),
                                {"op": "get_param", "name": name})
        return _unpack_array(reply["array"], out)

    def get_param_rows(self, name, rows) -> np.ndarray:
        rd, rb = _pack_array(np.asarray(rows))
        reply, out = self._call(self._server_for(name),
                                {"op": "get_param_rows", "name": name,
                                 "rows": rd}, rb)
        return _unpack_array(reply["array"], out)

    def get_params(self) -> Dict[str, np.ndarray]:
        out = {}
        for ep in self.endpoints:
            names = self._call(ep, {"op": "param_names"})[0]["value"]
            for n in names:
                reply, raw = self._call(ep, {"op": "get_param", "name": n})
                out[n] = _unpack_array(reply["array"], raw)
        return out

    def pass_barrier(self) -> int:
        vals = [self._call(ep, {"op": "pass_barrier",
                                "trainer_id": self.trainer_id,
                                "seq": self._next_seq()})[0]["value"]
                for ep in self.endpoints]
        return max(vals)

    def save_checkpoint(self, dirname=None):
        return [self._call(ep, {"op": "save_checkpoint", "dir": dirname})[0]
                ["value"] for ep in self.endpoints]

    def close(self):
        for s in self._socks.values():
            try:
                s.close()
            except OSError:
                pass
        self._socks.clear()


def serve_forever(host="127.0.0.1", port=7164, num_trainers=1, mode="bsp",
                  checkpoint_dir=None, checkpoint_period_s=600.0):
    """Blocking entry for `paddle pserver` (ParameterServer2Main.cpp:20 /
    cmd/pserver/pserver.go)."""
    server = PServer(host=host, port=port, num_trainers=num_trainers,
                     mode=mode, checkpoint_dir=checkpoint_dir)
    if checkpoint_dir:
        def _periodic():
            while True:
                time.sleep(checkpoint_period_s)
                try:
                    server.service.save_checkpoint(checkpoint_dir)
                except (OSError, RuntimeError):
                    pass
        threading.Thread(target=_periodic, daemon=True).start()
    print(f"pserver listening on {server.endpoint} "
          f"(num_trainers={num_trainers}, mode={mode})")
    server.serve_forever()
