"""The port's chaos tier (``paddle_tpu_torch/distributed/``: checkpoint
crash-robustness, the master's lease and heartbeat state, the elastic
training service's admission gate, oracle-proven fault recovery),
the counterparts of ``tests/test_chaos.py`` on the CPU
(``place=CPUPlace()``).  Beside them, against the JAX package: the seeded
fault schedules and the toy job's payloads are the same, and the
admission gate prices the toy job as the JAX package's does.  JAX's
compile-cache tests belong to ``compiler.py`` (not ported) and have no
counterpart.  Three tests are marked slow, as their JAX counterparts
are: the full scenario catalog over two seeds, the 16k-context
admission demo and the scenario runner in a subprocess."""

import json
import os
import subprocess
import sys
import time

import pytest

import paddle_tpu_torch as tfluid
from paddle_tpu.distributed import chaos as jchaos
from paddle_tpu_torch.distributed import (
    MasterClient, MasterServer, MasterService, load_checkpoint,
    save_checkpoint)
from paddle_tpu_torch.distributed import chaos
from paddle_tpu_torch.distributed.checkpoint import latest_checkpoint
from paddle_tpu_torch.distributed.service import TrainingService

CPU = tfluid.CPUPlace()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    yield


def _tiny_model():
    x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
    tfluid.layers.fc(input=x, size=1)
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    return exe


def test_load_falls_back_past_corrupt_digest(tmp_path):
    exe = _tiny_model()
    ck = str(tmp_path / "ck")
    save_checkpoint(exe, ck, trainer_state={"step": 1})
    save_checkpoint(exe, ck, trainer_state={"step": 2})
    chaos.corrupt_latest_checkpoint(ck)
    assert load_checkpoint(exe, ck) == {"step": 1}
    assert latest_checkpoint(ck, verify=True).endswith("ckpt_0")


def test_load_falls_back_past_truncated_meta(tmp_path):
    exe = _tiny_model()
    ck = str(tmp_path / "ck")
    save_checkpoint(exe, ck, trainer_state={"step": 1})
    save_checkpoint(exe, ck, trainer_state={"step": 2})
    with open(os.path.join(latest_checkpoint(ck), "meta.json"), "w") as f:
        f.write('{"version": 1, "trainer_st')  # torn write
    assert load_checkpoint(exe, ck) == {"step": 1}


class _Boom(RuntimeError):
    pass


def _hook_at(where):
    def hook(point):
        if point == where:
            raise _Boom(point)

    return hook


def test_kill_during_save_leaves_only_sweepable_debris(tmp_path):
    exe = _tiny_model()
    ck = str(tmp_path / "ck")
    save_checkpoint(exe, ck, trainer_state={"step": 1})
    with pytest.raises(_Boom):
        save_checkpoint(exe, ck, trainer_state={"step": 2},
                        fault_hook=_hook_at("before_rename"))
    assert any(d.startswith(".tmp_ckpt_") for d in os.listdir(ck))
    assert latest_checkpoint(ck).endswith("ckpt_0")
    assert load_checkpoint(exe, ck) == {"step": 1}
    save_checkpoint(exe, ck, trainer_state={"step": 3})
    assert not any(d.startswith(".tmp_ckpt_") for d in os.listdir(ck))
    assert load_checkpoint(exe, ck) == {"step": 3}


def test_kill_after_rename_before_latest_still_recovers_newest(tmp_path):
    exe = _tiny_model()
    ck = str(tmp_path / "ck")
    save_checkpoint(exe, ck, trainer_state={"step": 1})
    with pytest.raises(_Boom):
        save_checkpoint(exe, ck, trainer_state={"step": 2},
                        fault_hook=_hook_at("before_latest"))
    assert load_checkpoint(exe, ck) == {"step": 2}


def test_all_checkpoints_bad_raises_not_crashes(tmp_path):
    exe = _tiny_model()
    ck = str(tmp_path / "ck")
    save_checkpoint(exe, ck, trainer_state={"step": 1})
    chaos.corrupt_latest_checkpoint(ck)
    with pytest.raises(IOError):
        load_checkpoint(exe, ck)
    assert load_checkpoint(exe, str(tmp_path / "empty")) is None


def test_master_progress_exposes_leases_and_requeue_latency():
    svc = MasterService(timeout_s=0.05)
    svc.set_dataset(["a", "b"])
    svc.heartbeat("t0")
    t = svc.get_task("t0")
    prog = svc.progress()
    assert "t0" in prog["trainers"]
    lease = [ls for ls in prog["leases"] if ls["task_id"] == t["task_id"]]
    assert lease and lease[0]["trainer_id"] == "t0"
    time.sleep(0.08)
    req = [r for r in svc.progress()["requeues"]
           if r["task_id"] == t["task_id"]]
    assert req and req[0]["trainer_id"] == "t0"
    assert req[0]["overdue_s"] < 0.5


def test_master_client_backoff_deadline():
    c = MasterClient(("127.0.0.1", 1), retries=3, backoff_s=0.01,
                     deadline_s=0.5)
    t0 = time.monotonic()
    with pytest.raises(ConnectionError):
        c.progress()
    assert time.monotonic() - t0 < 5.0


def test_master_client_heartbeat_over_tcp():
    svc = MasterService(timeout_s=30.0)
    svc.set_dataset(["x"])
    srv = MasterServer(svc).start()
    try:
        c = MasterClient(srv.addr, deadline_s=10)
        c.heartbeat("w0")
        assert "w0" in c.progress()["trainers"]
    finally:
        srv.stop()


def test_schedules_and_toy_job_match_jax():
    for sc in chaos.SCENARIOS:
        for seed in (0, 1):
            a = chaos.schedule_for(sc, seed, "mlp", 12, 3)
            b = jchaos.schedule_for(sc, seed, "mlp", 12, 3)
            assert [vars(f) for f in a] == [vars(f) for f in b]
    t, j = chaos.toy_job_spec(seed=0), jchaos.toy_job_spec(seed=0)
    assert (t.payloads, t.epochs, t.checkpoint_every, t.lease_timeout_s,
            t.target_steps) == (j.payloads, j.epochs, j.checkpoint_every,
                                j.lease_timeout_s, j.target_steps)


def test_admission_rejects_over_budget_job(tmp_path):
    from paddle_tpu.distributed.service import TrainingService as JTS

    spec = chaos.toy_job_spec(seed=0)
    svc = TrainingService(hbm_budget_bytes=1, root_dir=str(tmp_path),
                          place=CPU)
    cert = svc.submit(spec, seed=0)
    assert not cert["admitted"] and "exceeds" in cert["reason"]
    assert spec.name not in svc.jobs
    jcert = JTS(hbm_budget_bytes=1, root_dir=str(tmp_path / "j")).submit(
        jchaos.toy_job_spec(seed=0), seed=0)
    assert cert["peak_bytes_no_remat"] == jcert["peak_bytes_no_remat"]
    roomy = TrainingService(1 << 30, str(tmp_path / "r"), place=CPU)
    assert roomy.submit(spec, seed=0)["admitted"]


def test_chaos_worker_kill_recovery_proven(tmp_path):
    rec = chaos.run_scenario("worker_kill", seed=0, workdir=str(tmp_path),
                             place=CPU)
    assert rec["all_faults_fired"], rec["fault_events"]
    assert len(rec["recoveries"]) >= 1
    assert rec["proof"]["equivalent"], rec["proof"]["findings"]
    assert rec["proof"]["tier"] == "differential"  # exact, bit for bit


@pytest.mark.slow
def test_chaos_full_catalog_two_seeds(tmp_path):
    for sc in chaos.SCENARIOS:
        for seed in (0, 1):
            rec = chaos.run_scenario(sc, seed=seed, place=CPU,
                                     workdir=str(tmp_path / sc / str(seed)))
            assert rec["proof"]["equivalent"], (sc, seed, rec["proof"])
            if sc == "heartbeat_stall":
                assert rec["requeue_latency_ok"], rec


@pytest.mark.slow
def test_admission_demo_16k_context_remat(tmp_path):
    rec = chaos.admission_demo(workdir=str(tmp_path), seed=0, place=CPU)
    assert rec["ok"], rec
    cert = rec["cert_admitted_remat"]
    assert cert["remat"]["reduction_bytes"] > 0
    assert "PTV017" not in cert["reason"]
    assert not rec["cert_rejected_no_remat"]["admitted"]
    assert rec["trained_to_completion"]


_RUNNER = r'''
import json, sys
sys.path.insert(0, {repo!r})
import paddle_tpu_torch as fluid
from paddle_tpu_torch.distributed import chaos
rec = chaos.run_scenario("worker_kill", seed=0, place=fluid.CPUPlace())
print(json.dumps({{"ok": bool(rec["proof"]["equivalent"]),
                  "tier": rec["proof"]["tier"]}}))
'''


@pytest.mark.slow
def test_chaos_run_smoke_cli(tmp_path):
    r = subprocess.run([sys.executable, "-c", _RUNNER.format(repo=REPO)],
                       capture_output=True, text=True, cwd=str(tmp_path),
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    art = json.loads(r.stdout.strip().splitlines()[-1])
    assert art == {"ok": True, "tier": "differential"}
