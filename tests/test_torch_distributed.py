"""The port's control plane (``paddle_tpu_torch/distributed/``: master,
checkpoint, launch, cluster_launch) against the JAX package's: each
scenario of ``tests/test_distributed.py`` runs on the port, and where it
has an outcome to compare (queue progress, task order, restored state)
the JAX package runs it too and must agree exactly.  Checkpoints are the
JAX package's layout: one written by either package resumes in the
other with the same loss (1e-6 relative, f32).  A sharded scope under
the ``ParallelExecutor`` is gathered into the checkpoint and re-laid out
at the next run.  Beside them: the port's ``MasterClient`` against the
JAX ``MasterServer`` and the reverse, two processes joining one gloo
group through ``init_distributed`` (and ``global_mesh`` refusing it),
and a local ``cluster_train`` launch.  Every join, client call and
subprocess has its own timeout."""

import glob
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.distributed import master as jmaster
from paddle_tpu_torch.distributed import (
    MasterClient, MasterServer, MasterService, load_checkpoint,
    master_reader, save_checkpoint, shard_reader)
from paddle_tpu_torch.distributed import checkpoint as tckpt
from paddle_tpu_torch.distributed import master as tmaster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    yield


def _drain(svc):
    seen = []
    while True:
        t = svc.get_task()
        if t is None or t["epoch"] > 0:
            break
        seen.append(t["payload"])
        svc.task_finished(t["task_id"])
    return seen


def test_master_dispatch_and_finish():
    seen = []
    for m in (tmaster, jmaster):
        svc = m.MasterService(timeout_s=60)
        svc.set_dataset(["a", "b", "c"])
        seen.append(_drain(svc))
    assert sorted(seen[0][:3]) == ["a", "b", "c"]
    assert seen[0] == seen[1]


def test_master_timeout_requeue_and_failure_cap():
    svc = MasterService(timeout_s=0.05, failure_max=2)
    svc.set_dataset(["x"])
    assert svc.get_task()["payload"] == "x"
    time.sleep(0.08)
    t2 = svc.get_task()  # requeued
    assert t2 is not None and t2["payload"] == "x"
    svc.task_failed(t2["task_id"])  # second failure hits failure_max
    prog = svc.progress()
    assert prog["todo"] == 0 and prog["pending"] == 0
    assert prog["requeues"][0]["task_id"] == t2["task_id"]


def test_master_snapshot_recover(tmp_path):
    out = []
    for m in (tmaster, jmaster):
        snap = str(tmp_path / f"{m.__name__}.json")
        svc = m.MasterService(snapshot_path=snap)
        svc.set_dataset(["t0", "t1", "t2"])
        t = svc.get_task()
        svc.task_finished(t["task_id"])
        svc.get_task()  # left pending: reappears after recovery
        prog = m.MasterService(snapshot_path=snap).progress()
        out.append({k: prog[k] for k in ("epoch", "todo", "pending", "done")})
        with open(snap) as f:
            out.append(f.read())
    assert out[0] == {"epoch": 0, "todo": 2, "pending": 0, "done": 1}
    assert out[0] == out[2] and out[1] == out[3]  # same snapshot bytes


def test_master_over_tcp_with_reader():
    svc = MasterService(timeout_s=30)
    svc.set_dataset([[0, 4], [4, 8], [8, 12]])
    server = MasterServer(svc).start()
    try:
        client = MasterClient(server.addr, deadline_s=10)
        data = np.arange(12)
        got = []
        for s in master_reader(client, lambda r: list(data[r[0]:r[1]]))():
            got.append(s)
            if len(got) >= 12:
                break
        assert sorted(got) == list(range(12))
        assert client.progress()["epoch"] >= 0
    finally:
        server.stop()


def test_master_reader_reports_failures():
    svc = MasterService(timeout_s=30, failure_max=2)
    svc.set_dataset(["good", "bad"])
    server = MasterServer(svc).start()
    try:
        client = MasterClient(server.addr, deadline_s=10)
        calls = {"bad": 0}

        def load(p):
            if p == "bad":
                calls["bad"] += 1
                raise IOError("corrupt chunk")
            return [1, 2]

        got = []
        for s in master_reader(client, load)():
            got.append(s)
            if len(got) >= 4:
                break
        assert calls["bad"] >= 2
    finally:
        server.stop()


@pytest.mark.parametrize("server_pkg,client_pkg", [
    (jmaster, tmaster), (tmaster, jmaster)],
    ids=["port_client_jax_server", "jax_client_port_server"])
def test_master_client_across_packages(server_pkg, client_pkg):
    """Either package's MasterClient drives the other's MasterServer
    through a pass, heartbeats and a failure, as a same-package pair."""
    def run(sp, cp):
        svc = sp.MasterService(timeout_s=30, failure_max=2)
        svc.set_dataset(["a", "b", "c"])
        srv = sp.MasterServer(svc).start()
        try:
            c = cp.MasterClient(srv.addr, deadline_s=10)
            c.heartbeat("w0")
            t = c.get_task("w0")
            c.task_failed(t["task_id"])
            order = [t["payload"]]
            while True:
                t = c.get_task("w0")
                if t is None or t["epoch"] > 0:
                    break
                order.append(t["payload"])
                c.task_finished(t["task_id"])
            prog = c.progress()
            return order, {k: prog[k] for k in ("epoch", "todo", "done")}, \
                sorted(prog["trainers"])
        finally:
            srv.stop()

    assert run(server_pkg, client_pkg) == run(jmaster, jmaster)


def test_shard_reader():
    r = lambda: iter(range(10))  # noqa: E731
    s0 = list(shard_reader(r, 0, 2)())
    s1 = list(shard_reader(r, 1, 2)())
    assert sorted(s0 + s1) == list(range(10))
    assert not (set(s0) & set(s1))
    from paddle_tpu.distributed import shard_reader as jshard

    assert s0 == list(jshard(r, 0, 2)()) and s1 == list(jshard(r, 1, 2)())


def _regression(fluid):
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    pred = fluid.layers.fc(input=x, size=1)
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    eval_prog = fluid.default_main_program().clone(for_test=True)
    fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return loss, eval_prog


def _data():
    rng = np.random.RandomState(0)
    return (rng.rand(64, 8).astype(np.float32),
            rng.rand(64, 1).astype(np.float32))


def test_checkpoint_resume_with_epoch_position(tmp_path):
    loss, eval_prog = _regression(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    xs, ys = _data()
    svc = MasterService(timeout_s=30, snapshot_path=str(tmp_path / "q.json"))
    svc.set_dataset([[i, i + 16] for i in range(0, 64, 16)])
    for _ in range(2):
        t = svc.get_task()
        lo, hi = t["payload"]
        exe.run(feed={"x": xs[lo:hi], "y": ys[lo:hi]}, fetch_list=[loss])
        svc.task_finished(t["task_id"])
    ckpt_dir = str(tmp_path / "ckpts")
    save_checkpoint(exe, ckpt_dir, trainer_state={"pass": 0, "step": 2},
                    master=svc)
    (loss_at_ckpt,) = exe.run(eval_prog, feed={"x": xs, "y": ys},
                              fetch_list=[loss])
    tfluid.reset_global_scope()
    exe2 = tfluid.Executor(tfluid.CPUPlace())
    exe2.run(tfluid.default_startup_program())
    svc2 = MasterService(timeout_s=30)
    assert load_checkpoint(exe2, ckpt_dir, master=svc2) == {"pass": 0,
                                                            "step": 2}
    (loss_resumed,) = exe2.run(eval_prog, feed={"x": xs, "y": ys},
                               fetch_list=[loss])
    np.testing.assert_allclose(loss_at_ckpt, loss_resumed, rtol=1e-6)
    assert svc2.progress()["todo"] == 2 and svc2.progress()["done"] == 2


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, writer):
    """A checkpoint either package writes (Adam state included) resumes
    in the other: the next step's loss and the written state agree
    (1e-6 relative, f32)."""
    xs, ys = _data()
    feed = {"x": xs[:16], "y": ys[:16]}
    sides = {}
    for name, fluid, ck in (("jax", jfluid, None), ("port", tfluid, tckpt)):
        fluid.reset()
        loss, _ = _regression(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(fluid.default_startup_program())
        sides[name] = (fluid, loss, exe)
    jf, jl, jexe = sides["jax"]
    state = {n: np.asarray(jf.global_scope().find_np(n))
             for n in jf.global_scope().local_names()}
    for n, v in state.items():
        tfluid.global_scope().set(n, v)
    jexe.run(feed=feed, fetch_list=[jl])
    sides["port"][2].run(feed=feed, fetch_list=[sides["port"][1]])
    save = {"jax": jfluid.distributed.save_checkpoint,
            "port": save_checkpoint}[writer]
    fluid, _, exe = sides[writer]
    path = save(exe, str(tmp_path), trainer_state={"step": 1})
    assert tckpt.checkpoint_ok(path)
    assert jfluid.distributed.checkpoint.checkpoint_ok(path)
    got = []
    for name, load in (("jax", jfluid.distributed.load_checkpoint),
                       ("port", load_checkpoint)):
        fluid, loss, exe = sides[name]
        fluid.reset_global_scope()
        exe.run(fluid.default_startup_program())
        assert load(exe, str(tmp_path)) == {"step": 1}
        got.append(float(np.asarray(
            exe.run(feed=feed, fetch_list=[loss])[0]).reshape(-1)[0]))
    np.testing.assert_allclose(got[1], got[0], rtol=1e-6)
    for n in state:
        np.testing.assert_allclose(
            tfluid.global_scope().find_np(n),
            np.asarray(jfluid.global_scope().find_np(n)), rtol=1e-6,
            atol=1e-7)


def test_checkpoint_integrity_detects_corruption(tmp_path):
    x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
    tfluid.layers.fc(input=x, size=1)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    ckpt_dir = str(tmp_path / "ck")
    path = save_checkpoint(exe, ckpt_dir)
    victim = glob.glob(os.path.join(path, "*.npy"))[0]
    with open(victim, "r+b") as f:
        f.seek(-1, 2)
        b = f.read(1)
        f.seek(-1, 2)
        f.write(bytes([b[0] ^ 0xFF]))
    tfluid.reset_global_scope()
    with pytest.raises(IOError):
        load_checkpoint(tfluid.Executor(tfluid.CPUPlace()), ckpt_dir)


def test_sharded_checkpoint_roundtrip(tmp_path):
    """Under a ParallelExecutor with ZeRO-1 state: save gathers every
    sharded value whole, a load into a fresh scope is laid out by the
    plan at the next run, and the resumed run equals an uninterrupted one
    (1e-5 relative)."""
    from paddle_tpu_torch.parallel import ParallelExecutor, make_mesh

    x = tfluid.layers.data(name="x", shape=[8], dtype="float32")
    y = tfluid.layers.data(name="y", shape=[1], dtype="float32")
    h = tfluid.layers.fc(input=x, size=16, act="relu")
    loss = tfluid.layers.mean(tfluid.layers.square_error_cost(
        tfluid.layers.fc(input=h, size=1), y))
    tfluid.optimizer.Momentum(0.1, 0.9).minimize(loss)
    xs, ys = _data()
    feed = {"x": xs[:16], "y": ys[:16]}

    def pe():
        return ParallelExecutor(mesh=make_mesh(
            {"dp": 4}, devices=[torch.device("cpu")] * 4),
            zero_dp_states=True)

    exe = pe()
    exe.run(tfluid.default_startup_program())
    exe.run(feed=feed, fetch_list=[loss])
    scope = tfluid.global_scope()
    assert any(getattr(scope.find(n), "__sharded__", False)
               for n in scope.local_names())
    path = save_checkpoint(exe, str(tmp_path), trainer_state={"step": 1})
    for fn in glob.glob(os.path.join(path, "*.npy")):
        name = os.path.basename(fn)[:-4]
        np.testing.assert_array_equal(np.load(fn), scope.find_np(name))
    want = [float(np.asarray(exe.run(feed=feed, fetch_list=[loss])[0])
                  .reshape(-1)[0]) for _ in range(2)]
    tfluid.reset_global_scope()
    exe2 = pe()
    exe2.run(tfluid.default_startup_program())
    assert load_checkpoint(exe2, str(tmp_path)) == {"step": 1}
    got = [float(np.asarray(exe2.run(feed=feed, fetch_list=[loss])[0])
                 .reshape(-1)[0]) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_master_failover_mid_pass(tmp_path):
    snap = str(tmp_path / "master.snap")
    svc = MasterService(timeout_s=30.0, snapshot_path=snap)
    svc.set_dataset([f"chunk-{i}" for i in range(6)])
    srv = MasterServer(svc).start()
    host, port = srv.addr
    c = MasterClient((host, port), deadline_s=20)
    got = []
    for _ in range(3):
        t = c.get_task()
        got.append(t["payload"])
        c.task_finished(t["task_id"])
    srv.stop()
    srv2 = MasterServer(MasterService(timeout_s=30.0, snapshot_path=snap),
                        host=host, port=port).start()
    try:
        while True:
            t = c.get_task()
            if t is None or t["epoch"] > 0:
                break
            got.append(t["payload"])
            c.task_finished(t["task_id"])
        assert sorted(got) == [f"chunk-{i}" for i in range(6)]
    finally:
        srv2.stop()


def test_master_rpc_retry_dedup():
    svc = MasterService(timeout_s=30.0)
    svc.set_dataset(["a", "b"])
    assert svc.rpc_cached("n1:1") is None
    t1 = svc.get_task("t0")
    svc.rpc_record("n1:1", {"ok": True, "result": t1})
    assert svc.rpc_cached("n1:1") == {"ok": True, "result": t1}
    assert svc.progress()["pending"] == 1
    assert svc.rpc_cached("n1:2") is None
    assert svc.get_task("t0")["payload"] != t1["payload"]


def test_master_client_end_to_end_retry_has_seq():
    svc = MasterService(timeout_s=30.0)
    svc.set_dataset(["x"])
    srv = MasterServer(svc).start()
    try:
        assert MasterClient(srv.addr, deadline_s=10).get_task()[
            "payload"] == "x"
        assert svc._rpc_cache
    finally:
        srv.stop()


_GLOO = r'''
import sys
sys.path.insert(0, {repo!r})
import torch
import torch.distributed as dist
import paddle_tpu_torch as fluid
from paddle_tpu_torch.distributed import launch
rank = int(sys.argv[1])
assert launch.init_distributed("127.0.0.1:{port}", num_processes=2,
                               process_id=rank, place=fluid.CPUPlace(),
                               timeout_s=60)
t = torch.tensor([rank + 1.0])
dist.all_reduce(t)
from paddle_tpu_torch.parallel import collectives as col
mesh = launch.global_mesh({{"dp": 2}}, devices=[torch.device("cpu")])
shards = [None, None]
shards[rank] = torch.tensor([rank + 1.0])
total = col.psum(shards, mesh, "dp")[rank]
built = (mesh.size == 2 and mesh.process_count == 2
         and mesh.local == (rank,) and float(total) == 3.0)
dist.barrier()
dist.destroy_process_group()
print("RESULT", rank, float(t), built, flush=True)
'''


def test_init_distributed_two_processes_gloo():
    """Two processes join one gloo group from the env-contract fields;
    an all-reduce sums across them; `global_mesh` builds one mesh over
    both processes (a position each, a psum across them); one process
    joins nothing."""
    import socket

    from paddle_tpu_torch.distributed import launch

    assert launch.init_distributed(num_processes=1) is False
    assert launch.global_mesh({"dp": 2}, devices=[torch.device("cpu")] * 2
                              ).size == 2
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = _GLOO.format(repo=REPO, port=port)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for r, out in enumerate(outs):
        assert procs[r].returncode == 0, out
        assert f"RESULT {r} 3.0 True" in out, out


def test_cluster_train_local(tmp_path):
    """`python -m paddle_tpu_torch cluster_train`: one command spawns two
    localhost trainers with the PADDLE_* env contract and a pserver
    process whose endpoint reaches them; a failing trainer fails the
    job."""
    script = tmp_path / "job.py"
    script.write_text(
        "import os\n"
        "print('RANK', os.environ['PADDLE_TRAINER_ID'],\n"
        "      'WORLD', os.environ['PADDLE_TRAINERS'],\n"
        "      'COORD', os.environ['PADDLE_COORDINATOR'],\n"
        "      'PS', os.environ.get('PADDLE_PSERVERS', '-'))\n")
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "paddle_tpu_torch", "cluster_train",
           "--nproc-per-host", "2", "--pservers", "1",
           "--pserver-base-port", str(port), "--job-dir", str(tmp_path),
           str(script)]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = [ln for ln in out.stdout.splitlines() if "RANK" in ln]
    assert len(lines) == 2
    assert any("[localhost:0] RANK 0 WORLD 2" in ln for ln in lines)
    assert any("[localhost:1] RANK 1 WORLD 2" in ln for ln in lines)
    assert all(f"PS 127.0.0.1:{port}" in ln for ln in lines)
    bad = tmp_path / "bad.py"
    bad.write_text("import sys; sys.exit(3)\n")
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch", "cluster_train",
         "--nproc-per-host", "2", "--job-dir", str(tmp_path), str(bad)],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode == 1
