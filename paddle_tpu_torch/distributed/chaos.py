"""Chaos-injection runner for the elastic training service
(distributed/service.py): scheduled faults, and a PROVEN-recovery verdict
after every one — the port of ``paddle_tpu/distributed/chaos.py``.

Faults are injected *cooperatively* at the service's natural crash
windows (the points a real SIGKILL lands in a single-host worker):

  point "pre_step"   lease held, state not yet advanced
  point "post_step"  state advanced, lease NOT yet acked — the classic
                     mid-pass kill: naive requeue-and-continue would
                     apply the batch twice; rollback-to-checkpoint must
                     not
  ckpt fault_hook    inside save_checkpoint's barriers (state written /
                     before rename / before LATEST) — kill-during-
                     checkpoint must leave only sweepable debris
  point "post_ckpt"  a completed checkpoint — where disk corruption is
                     planted for the fallback scenario

Scenario catalog (`run_scenario` runs one cell; each scenario ends with
`prove_job_recovery` demanding the recovered state PROVEN equal to an
uninterrupted reference run, exact to the bit):

  worker_kill      kill a worker mid-pass (post_step window)
  ckpt_kill        kill during the checkpoint write (random barrier)
  master_kill      drop the master; recovery restores its queue from the
                   checkpoint's snapshot
  heartbeat_stall  a worker stops heartbeating past its lease while
                   holding a task; the master's timeout path requeues it
                   (requeue latency asserted off progress()) and the
                   service reaps the stalled worker
  ckpt_corrupt     flip bytes in the NEWEST checkpoint, then kill a
                   worker: recovery must fall back past the bad snapshot
                   to the previous good one

Fault timing is seeded (`schedule_for(scenario, seed, ...)`) so every
matrix cell is reproducible.  The jobs run on `place` (None:
``CUDAPlace(0)``; the tests pass ``CPUPlace()``).
"""

from __future__ import annotations

import glob
import os
import random
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .service import (JobSpec, TrainingJob, TrainingService, WorkerKilled,
                      prove_job_recovery)

SCENARIOS = ("worker_kill", "ckpt_kill", "master_kill",
             "heartbeat_stall", "ckpt_corrupt")

_CKPT_POINTS = ("state_written", "before_rename", "before_latest")


@dataclass
class Fault:
    kind: str               # one of SCENARIOS
    job: str                # job name it targets
    at_step: int            # fires at the first injection point where
                            # job.step >= at_step
    ckpt_point: str = "before_rename"  # for ckpt_kill


class ChaosMonkey:
    """Injects the scheduled faults; records what actually fired so the
    runner can assert the scenario really happened."""

    def __init__(self, faults: List[Fault]):
        self.faults = list(faults)
        self._fired: set = set()
        self.events: List[dict] = []
        self._lock = threading.Lock()

    # -- service-facing API --------------------------------------------
    def point(self, where: str, job, worker=None):
        f = self._arm(job, where)
        if f is None:
            return
        if f.kind == "worker_kill":
            self._log(f, job, "worker killed mid-pass")
            raise WorkerKilled(f"chaos worker_kill at step {job.step}")
        if f.kind == "master_kill":
            job.kill_master()
            self._log(f, job, "master dropped")
            raise WorkerKilled(f"chaos master_kill at step {job.step}")
        if f.kind == "heartbeat_stall":
            self._stall(f, job, worker)
        if f.kind == "ckpt_corrupt":
            detail = corrupt_latest_checkpoint(job.ckpt_dir)
            self._log(f, job, f"corrupted newest checkpoint: {detail}")
            raise WorkerKilled(
                f"chaos ckpt_corrupt at step {job.step} ({detail})")

    def ckpt_hook(self, job, gen):
        """A save_checkpoint fault_hook, or None when no ckpt_kill fault
        is armed for this job."""
        if not any(f.kind == "ckpt_kill" and f.job == job.spec.name
                   and id(f) not in self._fired for f in self.faults):
            return None

        def hook(point):
            with self._lock:
                cand = [f for f in self.faults
                        if f.kind == "ckpt_kill"
                        and f.job == job.spec.name
                        and id(f) not in self._fired
                        and job.step >= f.at_step
                        and f.ckpt_point == point]
                if not cand:
                    return
                self._fired.add(id(cand[0]))
            self._log(cand[0], job,
                      f"killed during checkpoint at barrier {point!r}")
            raise WorkerKilled(
                f"chaos ckpt_kill at step {job.step} barrier {point}")

        return hook

    # -- internals ------------------------------------------------------
    def _arm(self, job, where: str) -> Optional[Fault]:
        """Claim the next due fault for this (job, point), if any."""
        points = {"worker_kill": "post_step",
                  "master_kill": "post_step",
                  "ckpt_corrupt": "post_ckpt",
                  "heartbeat_stall": "pre_step"}
        with self._lock:
            for f in self.faults:
                if id(f) in self._fired or f.job != job.spec.name:
                    continue
                if points.get(f.kind) == where and job.step >= f.at_step:
                    self._fired.add(id(f))
                    return f
        return None

    def _stall(self, f: Fault, job, worker):
        """Stop heartbeating while holding the lease, watch the master's
        timeout path requeue the task, record the requeue latency, then
        die.  The service's monitor independently reaps us off the
        heartbeat age."""
        master = worker.master if worker is not None else job.master
        lease = job.spec.lease_timeout_s
        deadline = time.monotonic() + 3.0 * lease
        observed = None
        # NOTE: deliberately ignores worker.stop_evt — the monitor may
        # reap us (heartbeat age) before the lease itself expires, but
        # the requeue happens on OUR generation's master (captured by
        # the worker), which stays observable after the rollback swaps
        # in a recovered one
        while time.monotonic() < deadline:
            try:
                prog = master.progress()  # triggers the requeue sweep
            except Exception:
                break
            req = [r for r in prog.get("requeues", [])
                   if r["trainer_id"] == getattr(worker, "trainer_id",
                                                 "")]
            if req:
                observed = req[-1]
                break
            time.sleep(min(0.05, lease / 10.0))
        self._log(f, job, "heartbeat stalled past lease; requeue "
                          f"observed: {observed}")
        if observed is not None:
            self.events[-1]["requeue_overdue_s"] = observed["overdue_s"]
            self.events[-1]["lease_timeout_s"] = \
                observed["lease_timeout_s"]
        raise WorkerKilled(f"chaos heartbeat_stall at step {job.step}")

    def _log(self, f: Fault, job, detail: str):
        self.events.append({
            "kind": f.kind, "job": f.job, "scheduled_step": f.at_step,
            "fired_step": job.step, "detail": detail,
            "time": time.time()})

    @property
    def all_fired(self) -> bool:
        return len(self._fired) == len(self.faults)


def corrupt_latest_checkpoint(ckpt_dir: str) -> str:
    """Flip bytes in the newest checkpoint's first parameter file (the
    disk-rot / torn-write stand-in).  Returns a description."""
    from .checkpoint import latest_checkpoint

    path = latest_checkpoint(ckpt_dir)
    if path is None:
        return "no checkpoint to corrupt"
    npys = sorted(glob.glob(os.path.join(path, "*.npy")))
    if not npys:
        return f"{path} has no parameter files"
    victim = npys[0]
    with open(victim, "r+b") as fh:
        fh.seek(-1, 2)
        b = fh.read(1)
        fh.seek(-1, 2)
        fh.write(bytes([b[0] ^ 0xFF]))
    return f"{os.path.basename(path)}/{os.path.basename(victim)}"


# ---------------------------------------------------------------------------
# seeded schedules


def schedule_for(scenario: str, seed: int, job_name: str,
                 total_steps: int, ckpt_every: int) -> List[Fault]:
    """Deterministic fault schedule for one matrix cell."""
    if scenario not in SCENARIOS:
        raise ValueError(f"unknown scenario {scenario!r} "
                         f"(catalog: {SCENARIOS})")
    rng = random.Random(f"{scenario}:{seed}")
    if scenario == "ckpt_kill":
        # fire inside a checkpoint write (not the first: a prior good
        # checkpoint should exist so recovery is from-snapshot, and the
        # barrier varies with the seed)
        k = rng.randint(2, max(2, total_steps // ckpt_every))
        return [Fault("ckpt_kill", job_name, at_step=k * ckpt_every,
                      ckpt_point=rng.choice(_CKPT_POINTS))]
    if scenario == "ckpt_corrupt":
        # after at least two checkpoints so the fallback has somewhere
        # good to land
        lo = 2 * ckpt_every
        return [Fault("ckpt_corrupt", job_name,
                      at_step=rng.randint(lo, max(lo, total_steps - 1)))]
    # mid-pass faults: anywhere past the first checkpoint
    lo = ckpt_every + 1
    return [Fault(scenario, job_name,
                  at_step=rng.randint(lo, max(lo, total_steps - 2)))]


# ---------------------------------------------------------------------------
# the toy job + scenario runner


def toy_job_spec(name: str = "mlp", seed: int = 0, n_tasks: int = 6,
                 batch: int = 4, epochs: int = 2, ckpt_every: int = 3,
                 lease_timeout_s: float = 2.5) -> JobSpec:
    """A tiny deterministic regression job: feeds are a pure function of
    the task payload (index range into a seed-derived dataset), so any
    replay of the same task sequence is bitwise identical."""
    import paddle_tpu_torch as fluid

    dep = np.random.RandomState(1000 + seed)
    xs = dep.rand(n_tasks * batch, 8).astype(np.float32)
    ys = dep.rand(n_tasks * batch, 1).astype(np.float32)

    def build():
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(input=x, size=8, act="relu")
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)

        def feed_fn(payload):
            lo, hi = payload
            return {"x": xs[lo:hi], "y": ys[lo:hi]}

        return feed_fn, [loss]

    payloads = [[i * batch, (i + 1) * batch] for i in range(n_tasks)]
    return JobSpec(name=name, build=build, payloads=payloads,
                   epochs=epochs, checkpoint_every=ckpt_every,
                   workers=1, lease_timeout_s=lease_timeout_s)


def context16k_spec(seed: int = 0, ctx: int = 16384, depth: int = 6,
                    hbm_batch: int = 64,
                    allow_remat: bool = True) -> JobSpec:
    """The 16k-context fit-because-remat job: a per-position stack over a 16384-wide context — every
    layer_norm+tanh keeps a [batch, 16384] activation alive into the
    backward pass, so at the admission batch the dense program blows the
    budget and ONLY the PTV017-certified remat marking fits it.  The
    runtime batch is tiny so the scenario executes in CPU seconds."""
    import paddle_tpu_torch as fluid

    n_tasks, batch = 2, 2
    dep = np.random.RandomState(7000 + seed)
    xs = dep.rand(n_tasks * batch, ctx).astype(np.float32)
    ys = dep.rand(n_tasks * batch, 1).astype(np.float32)

    def build():
        x = fluid.layers.data(name="x", shape=[ctx], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = x
        for _ in range(depth):
            h = fluid.layers.tanh(fluid.layers.layer_norm(h))
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)

        def feed_fn(payload):
            lo, hi = payload
            return {"x": xs[lo:hi], "y": ys[lo:hi]}

        return feed_fn, [loss]

    return JobSpec(name="ctx16k", build=build,
                   payloads=[[i * batch, (i + 1) * batch]
                             for i in range(n_tasks)],
                   epochs=1, checkpoint_every=2, workers=1,
                   lease_timeout_s=10.0,  # 16k-wide first steps are
                   # slow; a tight lease would misread one as a stall
                   hbm_batch_size=hbm_batch, allow_remat=allow_remat)


def admission_demo(workdir: Optional[str] = None, seed: int = 0,
                   run_jobs: bool = True,
                   wait_timeout_s: float = 180.0, place=None) -> dict:
    """The 16k-context job admitted under multi-job pressure, with
    PTV017's quantified peak reduction as the certificate.

    Two small jobs consume most of a budget sized so the 16k job's
    dense peak does NOT fit the remainder but its max-remat peak does
    (both in the independent estimator's currency — the squeeze is
    real, not staged in the planner's optimistic units).  The 16k job
    is first submitted with remat forbidden (rejected, the no-free-
    lunch control), then with ``allow_remat=True`` (admitted; the
    certificate cites the PROVEN planner reduction), and the whole mix
    then trains to completion under the service."""
    from ..analysis import memory as amem
    from ..framework.core import Program
    from ..memory_optimization_transpiler import memory_optimize

    owns_dir = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="chaos_admission_")
    try:
        headroom = 0.9
        # probe the squeeze window on scratch copies
        probe = TrainingJob(context16k_spec(seed),
                            os.path.join(workdir, "probe"), seed)
        bs = probe.spec.hbm_batch_size
        peak_dense = amem.peak_estimate(
            probe.main, batch_size=bs)["total_peak_bytes"]
        clone = Program.from_json(probe.main.to_json())
        memory_optimize(clone, level=0, batch_size=bs, hbm_bytes=4096)
        peak_remat = amem.peak_estimate(
            clone, batch_size=bs)["total_peak_bytes"]
        free_c = int((peak_dense + peak_remat) / (2 * headroom))

        spec_a = toy_job_spec("job_a", seed, epochs=1)
        spec_b = toy_job_spec("job_b", seed + 1, epochs=1)
        peak_small = [
            amem.peak_estimate(
                TrainingJob(s, os.path.join(workdir, "probe_" + s.name),
                            seed).main,
                batch_size=s.hbm_batch_size)["total_peak_bytes"]
            for s in (spec_a, spec_b)]

        svc = TrainingService(sum(peak_small) + free_c, workdir,
                              headroom=headroom, place=place)
        cert_a = svc.submit(spec_a, seed=seed)
        cert_b = svc.submit(spec_b, seed=seed + 1)
        cert_rejected = svc.submit(
            context16k_spec(seed, allow_remat=False), seed=seed)
        cert_admitted = svc.submit(context16k_spec(seed), seed=seed)
        record = {
            "budget_bytes": svc.hbm_budget_bytes,
            "estimator_peak_dense": int(peak_dense),
            "estimator_peak_full_remat": int(peak_remat),
            "small_jobs": [cert_a, cert_b],
            "cert_rejected_no_remat": cert_rejected,
            "cert_admitted_remat": cert_admitted,
            "ok": (cert_a["admitted"] and cert_b["admitted"]
                   and not cert_rejected["admitted"]
                   and cert_admitted["admitted"]
                   and cert_admitted.get("remat", {}).get(
                       "reduction_bytes", 0) > 0),
        }
        if run_jobs and record["ok"]:
            svc.start()
            record["trained_to_completion"] = svc.wait(wait_timeout_s)
            svc.stop()
            record["final_steps"] = {n: j.step
                                     for n, j in svc.jobs.items()}
            record["ok"] &= record["trained_to_completion"]
        return record
    finally:
        if owns_dir:
            shutil.rmtree(workdir, ignore_errors=True)


def run_scenario(scenario: str, seed: int = 0,
                 workdir: Optional[str] = None,
                 wait_timeout_s: float = 120.0, place=None) -> dict:
    """One matrix cell: run the job under the scheduled fault, run the
    uninterrupted reference, and PROVE the final states equal.  Returns
    the cell record; record["proof"]["equivalent"] is the verdict."""
    owns_dir = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix=f"chaos_{scenario}_")
    budget = 1 << 30  # admission is not under test here
    try:
        spec = toy_job_spec(seed=seed)
        sched = schedule_for(scenario, seed, spec.name,
                             spec.target_steps, spec.checkpoint_every)
        monkey = ChaosMonkey(sched)

        svc = TrainingService(budget, os.path.join(workdir, "rec"),
                              place=place)
        svc.submit(spec, seed=seed)
        svc.start(chaos=monkey)
        finished = svc.wait(wait_timeout_s)
        svc.stop()
        rec_job = svc.jobs[spec.name]

        ref = TrainingService(budget, os.path.join(workdir, "ref"),
                              place=place)
        ref.submit(toy_job_spec(seed=seed), seed=seed)
        ref.start()  # no chaos
        ref_finished = ref.wait(wait_timeout_s)
        ref.stop()
        ref_job = ref.jobs[spec.name]

        record = {
            "scenario": scenario, "seed": seed,
            "faults": [vars(f) for f in sched],
            "fault_events": monkey.events,
            "all_faults_fired": monkey.all_fired,
            "recoveries": svc.recoveries,
            "finished": bool(finished and ref_finished),
            "final_step": rec_job.step,
            "reference_step": ref_job.step,
        }
        ok = (finished and ref_finished and monkey.all_fired
              and len(svc.recoveries) >= 1
              and rec_job.status == "complete")
        if ok:
            proof = prove_job_recovery(ref_job, rec_job)
            record["proof"] = {
                "equivalent": bool(proof.equivalent),
                "tier": proof.tier,
                "findings": [f.format() for f in proof.findings],
            }
        else:
            record["proof"] = {
                "equivalent": False, "tier": "not_run",
                "findings": [
                    "scenario did not complete: "
                    f"finished={finished}/{ref_finished} "
                    f"fired={monkey.all_fired} "
                    f"recoveries={len(svc.recoveries)} "
                    f"status={rec_job.status}"],
            }
        # scenario-specific assertions ride in the record
        if scenario == "heartbeat_stall":
            stall = [e for e in monkey.events
                     if e["kind"] == "heartbeat_stall"]
            record["requeue_overdue_s"] = (
                stall[0].get("requeue_overdue_s") if stall else None)
            # the requeue must land promptly once the lease expired —
            # the timeout sweep runs on every progress()/get_task
            record["requeue_latency_ok"] = (
                record["requeue_overdue_s"] is not None
                and record["requeue_overdue_s"] < spec.lease_timeout_s)
            record["proof"]["equivalent"] &= record[
                "requeue_latency_ok"]
        if scenario == "ckpt_corrupt":
            # the real property: recovery resumed from a step BELOW the
            # corrupted (newest) checkpoint — i.e. the digest check
            # actually skipped it and fell back to the previous good one
            fired = [e["fired_step"] for e in monkey.events
                     if e["kind"] == "ckpt_corrupt"]
            every = spec.checkpoint_every
            corrupt_step = (fired[0] // every) * every if fired else None
            record["corrupted_ckpt_step"] = corrupt_step
            record["fallback_past_corrupt"] = (
                corrupt_step is not None
                and any(r.get("resumed_from_step", corrupt_step)
                        < corrupt_step for r in svc.recoveries))
            record["proof"]["equivalent"] &= record[
                "fallback_past_corrupt"]
        return record
    finally:
        if owns_dir:
            shutil.rmtree(workdir, ignore_errors=True)
