"""Elastic multi-job training service (the TensorFlow-paper "training
service" stance, PAPERS.md) — the port of
``paddle_tpu/distributed/service.py``.

The control plane — MasterService task queues with timeout requeue,
atomic digest-verified checkpoints, the static device-memory estimator,
the differential equivalence oracle — composes here into a long-running
*service*:

  * **N concurrent jobs** multiplex over one shared device budget.
    Admission is gated by the static memory report (`analysis.memory
    .peak_estimate` + `fits`): a job whose projected peak does not fit
    the free budget is rejected — unless it opts into remat, in which
    case `contracts.checked_memory_optimize` runs under its PTV017
    contract and the PROVEN peak reduction becomes the admission
    certificate (the 16k-context fit-because-remat story).
  * **Workers lease tasks** from their job's master with heartbeats; a
    dead, preempted, or stalled worker's lease expires via the master's
    existing timeout path and the service's monitor notices the
    heartbeat age.
  * **Recovery is rollback-to-checkpoint**: worker death triggers a job
    rollback that restores parameters + optimizer state, the executor's
    RNG step, AND the master task queue from one atomic checkpoint.
    That single consistency point is what makes recovery *provable*:
    replay from any good checkpoint is deterministic (feeds are pure
    functions of task payloads, the random ops are pinned per step via
    ``Executor.run(rng_step=step)``, and the card's kernels on fixed
    shapes on one stream give the same bits each run), so the recovered
    trajectory re-converges bitwise with an uninterrupted run — an
    assertion `prove_job_recovery` discharges with the differential
    oracle instead of a loss-curve eyeball.

The chaos-injection runner (distributed/chaos.py, tools/chaos_run.py)
drives this service through scheduled faults and demands a PROVEN verdict
after every one.  Threading model: workers are daemon threads; one
in-flight training step per job (the `_steplock`) keeps multi-worker
update order well-defined; a generation counter fences zombie workers
that outlive a rollback.  Each job builds under its own program_guard
and unique_name guard, and owns its scope and executor: nothing of the
default programs, the global scope or an executor's step-loop cache is
shared between jobs.

Jobs run on ``place`` (None: ``CUDAPlace(0)``; the tests pass
``CPUPlace()``).  On the card a job takes one warm-up step on a throwaway
copy of its state before its workers start, so that a first use that
builds kernels or initializes a library is not read as a stalled worker
(the leases stay as short as declared).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from ..framework.core import Program, program_guard
from ..framework.executor import Executor
from ..framework.place import CUDAPlace
from ..framework.scope import Scope
from ..framework import unique_name
from ..observability.metrics import REGISTRY as _MET
from ..observability.tracing import TRACER as _TRC
from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .master import MasterService


class WorkerKilled(Exception):
    """A chaos-injected (or fencing) fault: the worker 'process' dies."""


class MasterUnreachable(ConnectionError):
    """Every RPC against a dead master raises this."""


class _DeadMaster:
    """Stand-in installed by chaos 'master death': all calls fail the way
    a severed TCP master does, so workers die realistically."""

    def __getattr__(self, name):
        def _dead(*a, **k):
            raise MasterUnreachable("master dropped (chaos)")

        return _dead


class _NullChaos:
    """No-fault monkey: the reference runs use this."""

    def point(self, where, job, worker=None):
        return None

    def ckpt_hook(self, job, gen):
        return None


@dataclass
class JobSpec:
    """One training job.  `build` runs inside this job's own
    program_guard + unique_name.guard (so identical builders produce
    identical descs — the equivalence proof compares var names) and
    returns ``(feed_fn, fetch_names)`` where ``feed_fn(payload)`` is a
    PURE function of the task payload (determinism contract)."""

    name: str
    build: Callable[[], tuple]
    payloads: Sequence[object]
    epochs: int = 1
    checkpoint_every: int = 3  # steps; 0 = only the final checkpoint
    workers: int = 1
    lease_timeout_s: float = 2.0
    # static-admission knobs
    hbm_batch_size: int = 64  # batch the memory report prices
    allow_remat: bool = False

    @property
    def target_steps(self) -> int:
        return len(list(self.payloads)) * self.epochs


class TrainingJob:
    """A job's runtime state: programs (built once), scope/executor/
    master (rebuilt on every rollback), step + generation counters."""

    def __init__(self, spec: JobSpec, ckpt_dir: str, seed: int = 0,
                 place=None):
        self.spec = spec
        self.place = place if place is not None else CUDAPlace(0)
        self.ckpt_dir = ckpt_dir
        self.seed = int(seed)
        self.main = Program()
        self.startup = Program()
        self.main.random_seed = self.seed
        self.startup.random_seed = self.seed
        with unique_name.guard(), program_guard(self.main, self.startup):
            self.feed_fn, fetch = spec.build()
        self.fetch_names = [f.name if hasattr(f, "name") else str(f)
                            for f in (fetch or [])]
        self.scope: Optional[Scope] = None
        self.exe: Optional[Executor] = None
        self.master = None
        self.step = 0
        self.generation = 0
        self.gen_start_step = 0
        self.status = "admitted"  # -> running -> complete | failed
        self._steplock = threading.Lock()
        self._last_ckpt_step = -1
        self._warmed = False

    # -- lifecycle ------------------------------------------------------
    def bootstrap(self):
        """(Re)build runtime state: init params, then restore the newest
        good checkpoint if one exists (params + executor RNG step +
        master queue all from the same snapshot)."""
        self.scope = Scope()
        if self.exe is None:  # reused across rollbacks: the executor's
            self.exe = Executor(self.place)  # caches survive, state resets
        self.master = MasterService(timeout_s=self.spec.lease_timeout_s)
        self.exe.run(self.startup, scope=self.scope, rng_step=0)
        state = None
        if latest_checkpoint(self.ckpt_dir) is not None:
            state = load_checkpoint(self.exe, self.ckpt_dir, self.main,
                                    master=self.master, scope=self.scope)
        if state is None:
            self.master.set_dataset(list(self.spec.payloads))
            self.step = 0
        else:
            self.step = int(state.get("step", 0))
            self.exe.restore_state(state.get("executor",
                                             {"step": self.step}))
            if sum(self.master.progress()[k]
                   for k in ("todo", "pending", "done")) == 0:
                # checkpoint predates master snapshots: cold queue
                self.master.set_dataset(list(self.spec.payloads))
        self._last_ckpt_step = self.step if state is not None else -1
        # steps completed in THIS generation gate the monitor's stall
        # threshold: until the first step lands, a silent worker is
        # far more likely compiling than stalled
        self.gen_start_step = self.step

    def warm(self):
        """On the card, one step of the main program on a throwaway copy
        of the state, before any worker takes a lease: a first use that
        builds kernels or initializes a library would otherwise read as
        a stalled worker.  The executor's step counter is left as it
        was, so the job's trajectory is unchanged."""
        if self._warmed or self.exe.device.type != "cuda" \
                or not list(self.spec.payloads):
            return
        scratch = Scope()
        for n in self.scope.local_names():
            scratch.set(n, self.scope.find(n).clone())
        step = self.exe.global_step
        self.exe.run(self.main,
                     feed=self.feed_fn(list(self.spec.payloads)[0]),
                     fetch_list=self.fetch_names, scope=scratch,
                     rng_step=step)
        self.exe.restore_state({"step": step})
        self._warmed = True

    def rollback(self, reason: str = ""):
        """The recovery ladder: discard live state, restore everything
        from the newest good checkpoint (falling back past corrupt
        snapshots), restart the pass from there."""
        with self._steplock:
            with _TRC.span("trainsvc.rollback", job=self.spec.name,
                           reason=reason[:120],
                           generation=self.generation):
                self.generation += 1
                self.bootstrap()

    # -- the training step (workers call these) -------------------------
    def run_task(self, task: dict, gen: int, master=None, chaos=None,
                 worker=None):
        """One training step; the lease ack happens INSIDE the step
        critical section so a concurrent worker's checkpoint can never
        snapshot this task as applied-but-still-pending (the rollback
        would then re-dispatch an already-applied batch).  The chaos
        "post_step" window — state advanced, lease not yet acked, the
        classic mid-pass kill — sits between the update and the ack."""
        with self._steplock:
            self._fence(gen)
            feed = self.feed_fn(task["payload"])
            self.exe.run(self.main, feed=feed,
                         fetch_list=self.fetch_names, scope=self.scope,
                         rng_step=self.step)
            self.step += 1
            if chaos is not None:
                chaos.point("post_step", self, worker)
            if master is not None:
                master.task_finished(task["task_id"])

    def maybe_checkpoint(self, gen: int, fault_hook=None):
        every = self.spec.checkpoint_every
        if every and self.step % every == 0 \
                and self.step != self._last_ckpt_step:
            # unlocked read is only the fast path: checkpoint()
            # re-evaluates the cadence under the lock, where `step`
            # cannot move (workers>1: another worker may advance the
            # step between this check and the lock acquisition)
            self.checkpoint(gen, fault_hook, only_if_due=True)

    def checkpoint(self, gen: int, fault_hook=None,
                   only_if_due: bool = False):
        with self._steplock:
            self._fence(gen)
            if only_if_due:
                every = self.spec.checkpoint_every
                if not (every and self.step % every == 0
                        and self.step != self._last_ckpt_step):
                    return
            save_checkpoint(
                self.exe, self.ckpt_dir, self.main,
                trainer_state={"step": self.step,
                               "executor": self.exe.snapshot_state()},
                master=self.master, scope=self.scope,
                fault_hook=fault_hook)
            self._last_ckpt_step = self.step

    def mark_complete(self, gen: int):
        with self._steplock:
            self._fence(gen)
            if self.status == "running":
                self.status = "complete"
        # final state persisted (outside the lock: checkpoint re-locks)
        self.checkpoint_final(gen)

    def checkpoint_final(self, gen: int):
        with self._steplock:
            if gen != self.generation:
                return
            if self.step != self._last_ckpt_step:
                save_checkpoint(
                    self.exe, self.ckpt_dir, self.main,
                    trainer_state={"step": self.step,
                                   "executor":
                                       self.exe.snapshot_state()},
                    master=self.master, scope=self.scope)
                self._last_ckpt_step = self.step

    def _fence(self, gen: int):
        """Zombie fencing: a worker that survived a rollback it did not
        notice must not touch the restored state."""
        if gen != self.generation:
            raise WorkerKilled(
                f"stale generation {gen} (job at {self.generation})")

    def kill_master(self):
        """Chaos hook: sever the job's master as a crash would."""
        self.master = _DeadMaster()


class _Worker(threading.Thread):
    """One leased-task consumer.  Holds its generation's master reference
    so a zombie can never ack tasks against a rolled-back queue."""

    def __init__(self, job: TrainingJob, wid: int, gen: int, chaos):
        super().__init__(daemon=True,
                         name=f"{job.spec.name}-w{wid}-g{gen}")
        self.job = job
        self.wid = wid
        self.gen = gen
        self.chaos = chaos
        self.trainer_id = f"{job.spec.name}/w{wid}/g{gen}"
        self.master = job.master
        self.stop_evt = threading.Event()
        self.dead_reason: Optional[str] = None

    def run(self):
        job = self.job
        try:
            while not self.stop_evt.is_set():
                if job.status != "running" or job.generation != self.gen:
                    return
                self.master.heartbeat(self.trainer_id)
                task = self.master.get_task(self.trainer_id)
                if task is None:
                    time.sleep(0.005)
                    continue
                if task["epoch"] >= job.spec.epochs:
                    # pass boundary: hand the next-epoch task back
                    self.master.put_back(task["task_id"])
                    job.mark_complete(self.gen)
                    return
                self.chaos.point("pre_step", job, self)
                # step + mid-pass kill window + lease ack, all inside
                # the job's step critical section (see run_task)
                job.run_task(task, self.gen, master=self.master,
                             chaos=self.chaos, worker=self)
                job.maybe_checkpoint(
                    self.gen, self.chaos.ckpt_hook(job, self.gen))
                self.chaos.point("post_ckpt", job, self)
        except (WorkerKilled, MasterUnreachable, ConnectionError) as e:
            self.dead_reason = f"{type(e).__name__}: {e}"
        except Exception as e:  # any other crash is also a dead worker
            self.dead_reason = f"{type(e).__name__}: {e}"


class TrainingService:
    """The multi-job control plane: admission, worker fleets per job, a
    monitor that turns missed heartbeats into rollback+respawn."""

    def __init__(self, hbm_budget_bytes: int, root_dir: str,
                 headroom: float = 0.9,
                 monitor_interval_s: float = 0.05,
                 max_recoveries_per_job: int = 8,
                 first_step_grace_s: float = 60.0,
                 telemetry_port: Optional[int] = None, place=None):
        # the jobs' place (None: CUDAPlace(0))
        self.place = place
        self.hbm_budget_bytes = int(hbm_budget_bytes)
        self.root_dir = root_dir
        self.headroom = float(headroom)
        self.monitor_interval_s = monitor_interval_s
        self.max_recoveries_per_job = max_recoveries_per_job
        # opt-in /metrics + /trace HTTP endpoint (observability/httpd.py):
        # None = off (the default — this exposes process internals);
        # 0 = any free port (read .telemetry.port after start())
        self.telemetry_port = telemetry_port
        self.telemetry = None
        # stall threshold before a generation's first step completes: a
        # worker mid-first-step heartbeats nothing for the whole step,
        # and misreading compile as a stall would burn a rollback (and,
        # repeated, the whole recovery budget) on a healthy job
        self.first_step_grace_s = float(first_step_grace_s)
        self.jobs: Dict[str, TrainingJob] = {}
        self.certificates: List[dict] = []
        self.recoveries: List[dict] = []
        self._admitted_peak: Dict[str, int] = {}
        self._workers: Dict[str, List[_Worker]] = {}
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self.chaos = _NullChaos()

    # -- admission (the static-analysis gate) ---------------------------
    def submit(self, spec: JobSpec, seed: int = 0) -> dict:
        """Admit or reject a job on its static memory report; returns the
        admission certificate (always appended to `certificates`)."""
        from ..analysis import memory as amem

        job = TrainingJob(spec, os.path.join(self.root_dir, spec.name),
                          seed, place=self.place)
        bs = spec.hbm_batch_size
        report = amem.peak_estimate(job.main, batch_size=bs)
        free = self.hbm_budget_bytes - sum(self._admitted_peak.values())
        cert = {
            "job": spec.name,
            "budget_bytes": self.hbm_budget_bytes,
            "free_bytes": int(free),
            "headroom": self.headroom,
            "hbm_batch_size": bs,
            "peak_bytes_no_remat": int(report["total_peak_bytes"]),
        }
        if amem.fits(report, free, self.headroom):
            cert.update(admitted=True, peak_bytes=cert[
                "peak_bytes_no_remat"], reason="fits as declared")
        elif spec.allow_remat:
            cert.update(self._remat_admission(job, bs, free, report))
        else:
            cert.update(
                admitted=False, peak_bytes=cert["peak_bytes_no_remat"],
                reason=f"projected peak {report['total_peak_bytes']} "
                       f"exceeds {self.headroom:.0%} of free budget "
                       f"{free} and the job does not allow remat")
        self.certificates.append(cert)
        _MET.counter(
            "trainsvc_admissions_total",
            "job admission decisions by the static memory gate").inc(
            decision="admitted" if cert["admitted"] else "rejected",
            remat="yes" if cert.get("remat") else "no")
        _TRC.instant("trainsvc.admit", job=spec.name,
                     admitted=bool(cert["admitted"]),
                     peak_bytes=int(cert.get("peak_bytes", -1)))
        if cert["admitted"]:
            self.jobs[spec.name] = job
            self._admitted_peak[spec.name] = int(cert["peak_bytes"])
        return cert

    def _remat_admission(self, job: TrainingJob, bs: int, free: int,
                         dense_report: dict) -> dict:
        """The fit-because-remat path: run memory_optimize under its
        PTV017 contract and re-judge fit with the INDEPENDENT estimator
        (analysis/memory.peak_estimate).  The two speak different
        currencies — the planner's projection is optimistic, the
        estimator prices remat residual workspace conservatively — so a
        single pass at the free budget can under-mark; the planner
        target is walked down until the estimator agrees the job fits
        or marking stops making progress."""
        from ..analysis import contracts, memory as amem
        from ..analysis.verifier import VerificationError

        total_marked = 0
        peak_before_planner = None
        peak_after_planner = None
        target = max(1.0, free * self.headroom)
        report2 = dense_report  # submit() just priced the unmarked desc
        for _ in range(8):
            if amem.fits(report2, free, self.headroom):
                break
            rep: dict = {}
            try:
                marked = contracts.checked_memory_optimize(
                    job.main, level=0, batch_size=bs,
                    hbm_bytes=max(1, int(target)), report=rep)
            except VerificationError as e:
                return {"admitted": False, "peak_bytes": -1,
                        "reason": f"remat contract failed (PTV017/"
                                  f"PTV012/PTV022): {e}"}
            if marked:
                if peak_before_planner is None:
                    peak_before_planner = int(rep["peak_before"])
                peak_after_planner = int(rep["peak_after"])
                total_marked += int(marked)
                report2 = amem.peak_estimate(job.main, batch_size=bs)
            elif target <= 1.0:
                break  # planner exhausted: nothing left to mark
            target *= 0.7
        cert = {"peak_bytes": int(report2["total_peak_bytes"])}
        if total_marked:
            cert["remat"] = {
                "marked": total_marked,
                "planner_peak_before": peak_before_planner,
                "planner_peak_after": peak_after_planner,
                "reduction_bytes":
                    peak_before_planner - peak_after_planner,
                "ptv017": "quantified peak reduction proven "
                          "(checked_memory_optimize raised no finding)",
            }
        if amem.fits(report2, free, self.headroom):
            cert.update(
                admitted=True,
                reason=f"fits under remat: estimator peak "
                       f"{report2['total_peak_bytes']} <= "
                       f"{self.headroom:.0%} of free {free}; planner "
                       f"reduction "
                       f"{cert.get('remat', {}).get('reduction_bytes')}"
                       f" bytes over {total_marked} marked grad op(s)")
        else:
            cert.update(
                admitted=False,
                reason=f"still over budget after remat "
                       f"({total_marked} op(s) marked): "
                       f"{report2['total_peak_bytes']} > "
                       f"{self.headroom:.0%} of free {free}")
        return cert

    # -- run ------------------------------------------------------------
    def start(self, chaos=None):
        self.chaos = chaos if chaos is not None else _NullChaos()
        if self.telemetry_port is not None and self.telemetry is None:
            from ..observability.httpd import serve_http

            self.telemetry = serve_http(self.telemetry_port)
        for job in self.jobs.values():
            job.bootstrap()
            job.warm()
            if job.step >= job.spec.target_steps:
                job.status = "complete"
                continue
            job.status = "running"
            self._spawn(job)
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True, name="svc-monitor")
        self._monitor.start()
        return self

    def _spawn(self, job: TrainingJob):
        ws = [_Worker(job, i, job.generation, self.chaos)
              for i in range(job.spec.workers)]
        self._workers[job.spec.name] = ws
        for w in ws:
            w.start()

    def _monitor_loop(self):
        while not self._stop.is_set():
            for job in list(self.jobs.values()):
                if job.status != "running":
                    continue
                try:
                    dead = self._dead_workers(job)
                except (MasterUnreachable, ConnectionError):
                    self._recover(job, "master unreachable")
                    continue
                if dead:
                    self._recover(job, "; ".join(dead))
            self._stop.wait(self.monitor_interval_s)

    def _dead_workers(self, job: TrainingJob) -> List[str]:
        reasons = []
        prog = job.master.progress()  # raises when the master is dead
        beats = prog.get("trainers", {})
        for w in self._workers.get(job.spec.name, []):
            if w.gen != job.generation:
                continue
            if w.dead_reason:
                reasons.append(f"{w.trainer_id}: {w.dead_reason}")
            elif not w.is_alive() and job.status == "running":
                reasons.append(f"{w.trainer_id}: thread exited")
            else:
                age = beats.get(w.trainer_id)
                threshold = job.spec.lease_timeout_s
                if job.step <= job.gen_start_step:
                    threshold = max(threshold, self.first_step_grace_s)
                if age is not None and age > threshold:
                    reasons.append(
                        f"{w.trainer_id}: heartbeat stalled "
                        f"{age:.2f}s > {threshold}s")
        return reasons

    def _recover(self, job: TrainingJob, reason: str):
        event = {"job": job.spec.name, "reason": reason,
                 "at_step": job.step, "generation": job.generation,
                 "time": time.time()}
        _MET.counter("trainsvc_recoveries_total",
                     "rollback-to-checkpoint recoveries triggered").inc(
            job=job.spec.name)
        _TRC.instant("trainsvc.recover", job=job.spec.name,
                     reason=reason[:120], at_step=job.step)
        for w in self._workers.get(job.spec.name, []):
            w.stop_evt.set()
        n_prior = sum(1 for r in self.recoveries
                      if r["job"] == job.spec.name)
        if n_prior >= self.max_recoveries_per_job:
            # a job that keeps dying is a deterministic bug, not chaos:
            # stop burning rollbacks and surface it as failed
            event["gave_up"] = True
            self.recoveries.append(event)
            job.status = "failed"
            return
        try:
            job.rollback(reason)
        except Exception as e:  # e.g. every checkpoint corrupt
            event["rollback_error"] = f"{type(e).__name__}: {e}"
            self.recoveries.append(event)
            job.status = "failed"
            return
        event["resumed_from_step"] = job.step
        self.recoveries.append(event)
        if job.step >= job.spec.target_steps:
            job.status = "complete"
            return
        job.status = "running"
        self._spawn(job)

    def wait(self, timeout_s: float = 120.0) -> bool:
        """Block until every admitted job reaches a terminal state;
        True only when they ALL completed — a job that ended \"failed\"
        (recovery cap hit, unrecoverable rollback) must not read as
        trained-to-completion to callers like the admission demo."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if all(j.status in ("complete", "failed")
                   for j in self.jobs.values()):
                return all(j.status == "complete"
                           for j in self.jobs.values())
            time.sleep(0.02)
        return False

    def stop(self):
        self._stop.set()
        for ws in self._workers.values():
            for w in ws:
                w.stop_evt.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5)
        for ws in self._workers.values():
            for w in ws:
                w.join(timeout=5)
        if self.telemetry is not None:
            self.telemetry.stop()
            self.telemetry = None


# ---------------------------------------------------------------------------
# the recovery proof (the differential oracle as a service-level assertion)


def prove_job_recovery(reference: TrainingJob, recovered: TrainingJob,
                       rtol: float = 0.0, atol: float = 0.0):
    """PROVE the recovered job's written-back parameter state equals the
    uninterrupted reference's, with the differential oracle
    (``analysis.equivalence.differential_run`` under ``prove_equivalent``)
    on the recovered job's place: both programs (identical descs) take
    one step from their final scopes on identical deterministic feeds
    with ``rng_step`` pinned — every fetch and every written-back state
    var must agree, by default EXACTLY (rtol=atol=0: a replayed step on
    fixed shapes gives the same bits, so equality is the honest bar, not
    an allclose eyeball)."""
    from ..analysis.equivalence import prove_equivalent

    return prove_equivalent(
        reference.main, recovered.main,
        fetch_names=list(reference.fetch_names) or None,
        scope_before=reference.scope, scope_after=recovered.scope,
        execute="always", preserve_state=True, rtol=rtol, atol=atol,
        place=recovered.place)
