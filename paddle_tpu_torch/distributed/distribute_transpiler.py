"""Fluid DistributeTranspiler (reference python/paddle/v2/fluid/
distribute_transpiler.py:76 DistributeTranspiler.transpile /
:34 split_dense_variable, and distribute_transpiler_simple.py) — the port
of ``paddle_tpu/distributed/distribute_transpiler.py``.

Reference mechanism: rewrite the single-process program into a trainer
program whose grads flow through send/recv gRPC ops and per-pserver
programs that run the optimizer sub-block (recv_op.cc:37 kOptimizeBlock).

Here, as in the JAX package, the split happens at the program level:
transpile() strips the optimizer ops out of the trainer program (the
forward and backward stay one program run by the Executor on the card,
the gradients are fetched) and hands each parameter's update rule to the
host parameter service (distributed/pserver.py, the ParameterServer2/
Go-pserver equivalent).  A RemoteUpdater pushes fetched grads and pulls
fresh params between steps — the RemoteParameterUpdater hot loop
(TrainerInternal.cpp:119) with the same BSP/async semantics, while
in-graph data parallelism stays the job of the mesh's collectives
(``parallel/``, whose ``DistributeTranspiler`` is the sharding one)."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..framework.core import Program, default_main_program
from ..framework.scope import to_numpy
from .pserver import ParameterClient, _value

# host-service update rules (pserver.py _OPTIMIZERS) reachable from the
# graph optimizer ops
_OP_TO_CFG = {
    "sgd": lambda a: {"type": "sgd"},
    "momentum": lambda a: {"type": "momentum",
                           "momentum": float(a.get("mu", 0.9)),
                           "use_nesterov": bool(a.get("use_nesterov",
                                                      False))},
    "adagrad": lambda a: {"type": "adagrad",
                          "epsilon": float(a.get("epsilon", 1e-6))},
    "adam": lambda a: {"type": "adam",
                       "beta1": float(a.get("beta1", 0.9)),
                       "beta2": float(a.get("beta2", 0.999)),
                       "epsilon": float(a.get("epsilon", 1e-8))},
}

OPTIMIZE_OP_TYPES = ("sgd", "momentum", "adagrad", "adam", "adamax",
                     "adadelta", "decayed_adagrad", "proximal_gd",
                     "proximal_adagrad", "ftrl", "rmsprop")


def _static_lr(lr_var_name, startup_program=None):
    """Resolve a constant learning rate from the startup program's init op
    (LR schedules stay dynamic -> resolved from the scope at init time)."""
    if lr_var_name is None:
        return None
    from ..framework.core import default_startup_program
    prog = startup_program or default_startup_program()
    for op in prog.global_block().ops:
        if (op.type == "fill_constant"
                and op.outputs.get("Out") == [lr_var_name]):
            return float(op.attrs.get("value", 0.01))
    return None


class DistributeTranspiler:
    def transpile(self, trainer_id, program: Optional[Program] = None,
                  pservers: str = "", trainers: int = 1,
                  split_method=None, startup_program: Optional[Program] = None):
        """Split the program into trainer + pserver roles (reference
        transpile :76).  `pservers` is the comma-separated endpoint list;
        parameters map to endpoints by name hash (go client.go), whole-var
        (the simple-transpiler split; block-slicing a var buys nothing
        when the update is a host-side numpy op).  Under
        PADDLE_TPU_VERIFY=1 the split runs inside its verified-in/
        verified-out contract (analysis/contracts.py): the trainer
        program must still materialize every gradient the pserver round
        expects, and must PROVE the gradients mean the same thing —
        pruned to the grad fetches, trainer and original canonicalize
        identically (analysis/equivalence.py; a split
        that changes what a gradient computes is PTV022)."""
        from ..analysis import contracts

        if contracts.should_wrap():
            return contracts.checked_distribute_transpile(
                self, trainer_id, program=program, pservers=pservers,
                trainers=trainers, split_method=split_method,
                startup_program=startup_program)
        self.trainer_id = str(trainer_id)
        self.trainers = int(trainers)
        self.endpoints: List[str] = [e.strip() for e in pservers.split(",")
                                     if e.strip()]
        if not self.endpoints:
            raise ValueError("transpile needs at least one pserver "
                             "endpoint (pservers='host:port,...')")
        self.program = program or default_main_program()
        block = self.program.global_block()
        self.param_cfg: Dict[str, dict] = {}
        self.param_grad: Dict[str, str] = {}
        kept = []
        for op in block.ops:
            if op.type in OPTIMIZE_OP_TYPES:
                pname = op.inputs["Param"][0]
                mk = _OP_TO_CFG.get(op.type)
                if mk is None:
                    raise NotImplementedError(
                        f"pserver-side update for {op.type!r} is not "
                        f"implemented (host rules: "
                        f"{sorted(_OP_TO_CFG)}); keep this optimizer "
                        f"local or use a supported rule")
                cfg = mk(op.attrs or {})
                lr = (op.inputs.get("LearningRate") or [None])[0]
                cfg["_lr_var"] = lr
                static = _static_lr(lr, startup_program)  # init-op value
                if static is not None:
                    cfg["lr"] = static
                if lr is not None:
                    # a schedule's LR is a tmp var the executor would
                    # discard; persist it so the updater can read the
                    # CURRENT value each step and forward it to the host
                    # optimizers (step()._sync_lrs) — otherwise a decaying
                    # schedule runs in the trainer while the servers keep
                    # the initial LR forever
                    lr_var = block._find_var_recursive(lr)
                    if lr_var is not None:
                        lr_var.persistable = True
                self.param_cfg[pname] = cfg
                self.param_grad[pname] = op.inputs["Grad"][0]
            else:
                kept.append(op)
        block.ops[:] = kept
        self.program._bump()
        from .pserver import server_for
        self.param_endpoint = {p: server_for(p, self.endpoints)
                               for p in self.param_cfg}
        return self

    # -- role programs ------------------------------------------------------
    def get_trainer_program(self) -> Program:
        """Forward+backward only; one Executor step, grads fetchable."""
        return self.program

    def get_pserver_program(self, endpoint: str) -> Dict[str, dict]:
        """The optimize-block equivalent for one pserver: parameter ->
        host update rule it will run (reference built a sub-program with
        optimizer ops; the host service consumes the rule directly).
        Constant learning rates are resolved into the rule at transpile
        time; an LR-schedule-driven rate is only known at runtime and is
        delivered by trainer-0's init_param instead (rule['lr'] absent
        here marks that case)."""
        return {p: {k: v for k, v in cfg.items() if k != "_lr_var"}
                for p, cfg in self.param_cfg.items()
                if self.param_endpoint[p] == endpoint}

    def get_startup_program(self, endpoint=None, pserver_program=None):
        """Parity shim: pserver state is seeded by trainer-0's init
        (init_param carries values + rule), not by a startup program."""
        from ..framework.core import default_startup_program
        return default_startup_program()

    # -- runtime ------------------------------------------------------------
    def grad_fetch_list(self):
        block = self.program.global_block()
        return [block.var(g) for g in self.param_grad.values()]

    def make_updater(self, scope=None) -> "RemoteUpdater":
        return RemoteUpdater(self, scope)


class SimpleDistributeTranspiler(DistributeTranspiler):
    """reference distribute_transpiler_simple.py: whole-variable placement
    instead of block slicing — which is exactly this transpiler's split."""


class RemoteUpdater:
    """RemoteParameterUpdater / NewRemoteParameterUpdater capability
    (RemoteParameterUpdater.h:55, go cclient): trainer-0 seeds the service,
    then each step pushes grads and pulls fresh params into the scope."""

    def __init__(self, transpiler: DistributeTranspiler, scope=None):
        from ..framework.scope import global_scope

        self.t = transpiler
        self.scope = scope or global_scope()
        self.client = ParameterClient(self.t.endpoints, self.t.trainer_id)
        # last LR sent to the service per param: step() re-sends when the
        # scope's LR var moves (decay schedules run in the trainer program;
        # the host optimizers must follow — ADVICE r2 medium).  Starts
        # empty so the first step always syncs; cleared whenever the client
        # reconnects, because a pserver restarted from a checkpoint holds
        # the LR as of the checkpoint, not as of our last send.
        self._last_lr: Dict[str, float] = {}
        self._lr_epoch = self.client.reconnect_epoch

    def _lr_of(self, cfg, allow_missing: bool = False):
        lr_var = cfg.get("_lr_var")
        if lr_var is None:
            return cfg.get("lr", 0.01)  # no LR var on the op
        v = self.scope.find(lr_var)
        if v is not None:
            return float(to_numpy(v).reshape(-1)[0])
        if "lr" in cfg:
            return cfg["lr"]  # constant resolved at transpile time
        if allow_missing:
            # LR-schedule var with no value yet (the schedule computes it
            # during the first main-program run): the caller defers —
            # step()._sync_lrs delivers the real value before the first
            # gradient is applied
            return None
        raise RuntimeError(
            f"learning-rate var {lr_var!r} not found in the updater's "
            f"scope — run the startup program into this scope before "
            f"init_params() (a silent default would override the "
            f"configured LR)")

    def init_params(self, timeout_s: float = 120.0):
        """paddle_begin_init_params flow: only trainer 0 seeds values
        (cclient.go:145 — others wait on the init barrier, bounded by
        `timeout_s` like the BSP grad barrier)."""
        import time

        # the service's trainer count must match the job's (BSP divisor
        # and barrier width live server-side)
        for ep in self.t.endpoints:
            try:
                cfg_srv = self.client._call(ep, {"op": "get_config"})[0][
                    "value"]
            except RuntimeError:
                continue  # older server without the RPC
            if int(cfg_srv["num_trainers"]) != self.t.trainers:
                raise RuntimeError(
                    f"pserver {ep} is configured for "
                    f"{cfg_srv['num_trainers']} trainers but transpile() "
                    f"declared {self.t.trainers} — BSP averaging would be "
                    f"wrong; start the pserver with num_trainers="
                    f"{self.t.trainers}")
        if self.t.trainer_id in ("0", "trainer_0", ""):
            for pname, cfg in self.t.param_cfg.items():
                # the scope's tensor (a sharded one gathered): a bf16
                # value travels as bf16
                value = self.scope.find(pname)
                if getattr(value, "__sharded__", False):
                    if value.mesh.process_count > 1:
                        # a gather that only trainer 0 called would hang
                        # the other processes of the mesh
                        raise ValueError(
                            f"parameter {pname!r} is sharded over a mesh "
                            f"of {value.mesh.process_count} processes; the "
                            f"pserver updater reads whole values (one "
                            f"process's mesh a trainer)")
                    value = value.gather()
                if value is None:
                    raise RuntimeError(
                        f"parameter {pname!r} not initialized in the "
                        f"updater's scope — run the startup program first")
                rule = {k: v for k, v in cfg.items() if k != "_lr_var"}
                lr = self._lr_of(cfg, allow_missing=True)
                if lr is not None:
                    rule["lr"] = lr
                self.client.init_param(pname, value, rule)
            self.client.finish_init_params()
        else:
            deadline = time.time() + timeout_s
            while not self.client.initialized():
                if time.time() > deadline:
                    raise TimeoutError(
                        f"pservers not initialized after {timeout_s}s — "
                        f"did trainer 0 run init_params()?")
                time.sleep(0.05)
            self.pull_params()

    def step(self, grads: Dict[str, np.ndarray], strict: bool = False):
        """One remote update round: push this trainer's grads (keyed by
        param OR grad name), sync any moved learning rates, then refresh
        local params.  `strict=True` raises instead of warning when an
        expected gradient is absent."""
        import logging

        by_param = {}
        known = set()
        for pname, gname in self.t.param_grad.items():
            known.update((pname, gname))
            if pname in grads:
                by_param[pname] = _value(grads[pname])
            elif gname in grads:
                by_param[pname] = _value(grads[gname])
        # unrecognized extras are filtered (callers may pass every fetched
        # @GRAD) but WARNED about — a typoed grad name would otherwise
        # leave its parameter silently untrained; a push where NOTHING
        # matched would still consume a BSP round, reject that outright
        stray = set(grads) - known
        if stray:
            logging.getLogger(__name__).warning(
                "RemoteUpdater.step: ignoring grads keys %s (no matching "
                "transpiled param/grad; expected among %s)",
                sorted(stray), sorted(known))
        # the symmetric hole (ADVICE r2): an EXPECTED gradient that never
        # arrives leaves its parameter silently frozen on the server
        absent = set(self.t.param_grad) - set(by_param)
        if absent:
            msg = (f"RemoteUpdater.step: no gradient for transpiled "
                   f"param(s) {sorted(absent)} in this round — they will "
                   f"not be updated")
            if strict:
                raise KeyError(msg)
            logging.getLogger(__name__).warning(msg)
        if known and not by_param:
            raise KeyError(
                f"step() grads keys {sorted(grads)} match no transpiled "
                f"param/grad name (expected any of {sorted(known)})")
        self._sync_lrs()
        self.client.send_grads(by_param)
        self.pull_params()

    def _sync_lrs(self):
        """Re-send each param's CURRENT learning rate when it differs from
        the last value this trainer pushed (first step always syncs): LR
        schedules evaluate in the trainer program, and a frozen server-side
        LR would silently diverge from single-process semantics."""
        if self.client.reconnect_epoch != self._lr_epoch:
            # the far side may have restarted from a checkpoint whose LR
            # predates our last send — re-sync everything
            self._lr_epoch = self.client.reconnect_epoch
            self._last_lr.clear()
        changed = {}
        for pname, cfg in self.t.param_cfg.items():
            lr = self._lr_of(cfg, allow_missing=True)
            if lr is not None and self._last_lr.get(pname) != lr:
                changed[pname] = lr
        if changed:
            self.client.update_lrs(changed)
            self._last_lr.update(changed)

    def pull_params(self):
        for pname in self.t.param_cfg:
            self.scope.set(pname, self.client.get_param(pname))

    def close(self):
        self.client.close()
