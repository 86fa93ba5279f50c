"""One-command multi-host job launcher (reference
paddle/scripts/cluster_train/paddle.py — fabric-dispatched pservers +
trainers) — the port of ``paddle_tpu/distributed/cluster_launch.py``:
every trainer gets the env contract of ``distributed/launch.py`` (and
may join one ``torch.distributed`` process group with
``init_distributed``).

    python -m paddle_tpu_torch cluster_train --hosts h1,h2 \
        --nproc-per-host 4 [--pservers 2] train.py --lr 0.1

For each host it starts `nproc-per-host` trainer processes with
PADDLE_TRAINER_ID / PADDLE_TRAINERS / PADDLE_COORDINATOR set (process 0's
host:port is the coordinator), plus optional parameter-server processes
(`python -m paddle_tpu_torch pserver`) whose host:port list reaches
trainers as
PADDLE_PSERVERS.  localhost processes spawn directly; remote hosts go
through `ssh` (key-based auth assumed, job dir synced with scp -r unless
--no-sync) — the same command template either way, so what the smoke test
exercises locally is what ssh runs remotely.

Logs stream line-prefixed `[host:rank]`; SIGINT tears the whole job down
(reference kill_process); exit code is non-zero if any process failed.
"""

from __future__ import annotations

import argparse
import os
import shlex
import signal
import subprocess
import sys
import threading

REPO = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


def _stream(proc, tag, sink):
    for line in proc.stdout:
        sink.write(f"[{tag}] {line}")
        sink.flush()


def _spawn(host, argv, env_extra, job_dir, no_sync, synced_hosts):
    """Local exec or ssh exec with an identical env+command template."""
    if host in ("localhost", "127.0.0.1"):
        env = {**os.environ, **env_extra}
        return subprocess.Popen(argv, env=env, cwd=job_dir,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    if not no_sync and host not in synced_hosts:
        subprocess.run(["scp", "-qr", job_dir,
                        f"{host}:{os.path.dirname(job_dir) or '.'}"],
                       check=True)
        synced_hosts.add(host)
    envs = " ".join(f"{k}={shlex.quote(v)}" for k, v in env_extra.items())
    remote = f"cd {shlex.quote(job_dir)} && {envs} " + \
        " ".join(shlex.quote(a) for a in argv)
    return subprocess.Popen(["ssh", "-o", "BatchMode=yes", host, remote],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="paddle cluster_train",
        description="launch a multi-host paddle_tpu_torch job from one "
                    "command")
    ap.add_argument("--hosts", default="localhost",
                    help="comma-separated host list (default localhost)")
    ap.add_argument("--nproc-per-host", type=int, default=1)
    ap.add_argument("--coordinator-port", type=int, default=8476)
    ap.add_argument("--pservers", type=int, default=0,
                    help="parameter-server processes (round-robin over "
                         "hosts, ports from --pserver-base-port)")
    ap.add_argument("--pserver-base-port", type=int, default=7164)
    ap.add_argument("--job-dir", default=os.getcwd(),
                    help="working dir, scp'd to remote hosts unless "
                         "--no-sync")
    ap.add_argument("--no-sync", action="store_true")
    ap.add_argument("script")
    ap.add_argument("script_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    hosts = [h.strip() for h in args.hosts.split(",") if h.strip()]
    world = len(hosts) * args.nproc_per_host
    # launcher-environment vars that must reach REMOTE processes too:
    # ssh spawns don't inherit os.environ, and device selection happens
    # at interpreter startup — dropping CUDA_VISIBLE_DEVICES would put
    # remote ranks on other cards than local ones
    forwarded = {k: os.environ[k] for k in
                 ("CUDA_VISIBLE_DEVICES",) if k in os.environ}
    forwarded.update({k: v for k, v in os.environ.items()
                      if k.startswith("PADDLE_TPU_")})
    # endpoint addressing: in a single-localhost job loopback is right;
    # in a MIXED host list, remote ranks cannot reach "127.0.0.1", so
    # endpoints advertise the machine's own hostname instead
    import socket as _socket

    all_local = all(h in ("localhost", "127.0.0.1") for h in hosts)

    def _ep_host(h):
        if h in ("localhost", "127.0.0.1"):
            return "127.0.0.1" if all_local else _socket.gethostname()
        return h

    coordinator = f"{_ep_host(hosts[0])}:{args.coordinator_port}"

    procs = []
    synced = set()
    pserver_eps = []
    for i in range(args.pservers):
        host = hosts[i % len(hosts)]
        port = args.pserver_base_port + i // len(hosts)
        pserver_eps.append(f"{_ep_host(host)}:{port}")
        p = _spawn(host,
                   [sys.executable, "-m", "paddle_tpu_torch", "pserver",
                    "--host", "0.0.0.0", "--port", str(port)],
                   {**forwarded,
                    "PYTHONPATH": REPO + os.pathsep
                    + os.environ.get("PYTHONPATH", "")},
                   args.job_dir, args.no_sync, synced)
        procs.append((f"{host}:ps{i}", p))

    for hi, host in enumerate(hosts):
        for r in range(args.nproc_per_host):
            rank = hi * args.nproc_per_host + r
            env_extra = {
                **forwarded,
                "PADDLE_TRAINER_ID": str(rank),
                "PADDLE_TRAINERS": str(world),
                "PADDLE_COORDINATOR": coordinator,
                "PYTHONPATH": REPO + os.pathsep
                + os.environ.get("PYTHONPATH", ""),
            }
            if pserver_eps:
                env_extra["PADDLE_PSERVERS"] = ",".join(pserver_eps)
            p = _spawn(host, [sys.executable, args.script]
                       + args.script_args, env_extra,
                       args.job_dir, args.no_sync, synced)
            procs.append((f"{host}:{rank}", p))

    threads = [threading.Thread(target=_stream,
                                args=(p, tag, sys.stdout), daemon=True)
               for tag, p in procs]
    for t in threads:
        t.start()

    def tear_down(*_):
        for _, p in procs:
            p.terminate()

    signal.signal(signal.SIGINT, tear_down)
    signal.signal(signal.SIGTERM, tear_down)

    rc = 0
    # trainers decide job success; pservers are serve-forever processes
    # torn down once every trainer exits — but a pserver DYING while
    # trainers still run is a job failure (trainers would block on it
    # forever), so the wait loop polls both
    trainer_procs = [(t, p) for t, p in procs if ":ps" not in t]
    pserver_procs = [(t, p) for t, p in procs if ":ps" in t]
    pending = list(trainer_procs)
    while pending:
        still = []
        for tag, p in pending:
            r = p.poll()
            if r is None:
                still.append((tag, p))
            elif r != 0:
                print(f"[cluster_launch] {tag} exited rc={r}",
                      file=sys.stderr)
                rc = 1
        for tag, p in pserver_procs:
            r = p.poll()
            if r is not None:
                print(f"[cluster_launch] {tag} died rc={r} while "
                      f"trainers were running; tearing the job down",
                      file=sys.stderr)
                tear_down()
                rc = 1
                still = []
        pending = still
        if pending:
            import time

            time.sleep(0.5)
    tear_down()
    for t in threads:
        t.join(timeout=5)
    return rc


if __name__ == "__main__":
    sys.exit(main())
