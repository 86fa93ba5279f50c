"""One program over two processes: ``distributed/multihost.py`` starts two
gloo processes with four CPU mesh positions each (``global_mesh`` over
both) and, beside them, one process over eight positions (the
single-process mesh); both run every case, and the tests below read what
they saved (``cluster_train`` runs the LM over four processes of two
positions beside them).  One module-scoped run covers:

- the collectives (psum in f32 and bf16 over one and two axes, pmean,
  all_gather tiled and stacked, ppermute with a destination no pair
  names, all_to_all, axis_index), the gradient of a loss through each and
  the counts one call logs, over ``{"dp": 8}``, ``{"dp": 4, "mp": 2}``
  and ``{"sp": 2, "dp": 4}``;
- the nine ``ParallelExecutor`` modes of ``parallel/modes.py`` and the
  two ``ProgramPipeline`` modes, three steps each at
  ``test_torch_parallel.py``'s sizes from the JAX package's startup state
  carried in;
- the two programs of ``tools/multihost_smoke.py`` (the dp-8 MLP under
  ``fsdp_params`` and the small LM over ``{"sp": 2, "dp": 4}``, sp-major,
  so that each zigzag ring hop crosses the process boundary), four steps
  from the JAX package's state, also held to the JAX package's in-process
  ``ParallelExecutor`` on its eight virtual CPU devices;
- a checkpoint of ``fsdp`` (parameters sharded 1/dp) saved across the
  processes and restored;
- the functional GPipe and MoE steps (``parallel/pipeline.py``,
  ``parallel/moe.py``).

Tolerances: against the single-process mesh, bitwise (the processes add
every psum in the flat order of the single-process mesh, and a value
several processes compute takes its cotangent once); against the JAX
package, losses within 1e-5 relative and the state as
``test_torch_parallel.py`` holds it (1e-5 of each tensor's largest
|value|; Adam, the LM, 1e-4 absolute and relative)."""

import json
import os
import threading

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.parallel import ParallelExecutor as JPE
from paddle_tpu.parallel import modes as jmodes
from paddle_tpu_torch.distributed import multihost as mh
from paddle_tpu_torch.parallel import modes as tmodes

RUNNING = tuple(m.name for m in tmodes.MODES if not m.pipeline)
PIPES = tuple(m.name for m in tmodes.MODES if m.pipeline)
CASES = (["collectives"] + [f"mode:{n}" for n in RUNNING]
         + [f"pipe:{n}" for n in PIPES]
         + ["jax_mlp_fsdp", "jax_lm_sp", "checkpoint", "fn_pipeline",
            "fn_moe"])
TIMEOUT = 240


def _jax_state(prog):
    scope = jfluid.global_scope()
    return {n: np.asarray(scope.find(n))
            for n, v in prog.global_block().vars.items() if v.persistable}


def _save(inputs, case, state):
    """A start state for the jobs."""
    np.savez(os.path.join(inputs, case.replace(":", "_") + ".npz"), **state)


def _jax_programs(inputs):
    """The JAX package's two multihost programs on its 8-device CPU mesh
    after their startup, each in a scope of its own, their start states
    saved for the port: [(case, executor, program, loss, feed, scope)]."""
    from paddle_tpu.models import transformer

    out = []
    jfluid.reset()
    loss, prog = mh.build_jax_mlp(jfluid)
    out.append(("jax_mlp_fsdp", JPE(axes={"dp": 8}, fsdp_params=True),
                prog, loss, mh.jax_mlp_feeds(),
                jfluid.default_startup_program()))
    jfluid.reset()
    loss = mh.build_jax_lm(transformer)
    out.append(("jax_lm_sp", JPE(axes={"sp": 2, "dp": 4}),
                jfluid.default_main_program(), loss, mh.jax_lm_feeds(),
                jfluid.default_startup_program()))
    ready = []
    for case, pe, prog, loss, feed, startup in out:
        scope = jfluid.Scope()
        pe.run(startup, scope=scope)
        _save(inputs, case, {n: np.asarray(scope.find(n))
                             for n, v in prog.global_block().vars.items()
                             if v.persistable})
        ready.append((case, pe, prog, loss, feed, scope))
    return ready


def _jax_steps(ready):
    """{case: (losses, final state)} of four steps of each."""
    out = {}
    for case, pe, prog, loss, feed, scope in ready:
        losses = [float(np.asarray(pe.run(
            prog, feed=feed, fetch_list=[loss], scope=scope)[0]).ravel()[0])
            for _ in range(mh.JAX_STEPS)]
        out[case] = (losses, {n: np.asarray(scope.find(n))
                              for n, v in prog.global_block().vars.items()
                              if v.persistable})
    return out


FOUR = "jax_lm_sp"


def _cluster_train(root, inputs):
    """``cluster_train`` starting ``distributed/multihost.py`` as a job's
    script, unchanged, over four trainers (TCP coordinator) with two
    positions each: (exit code, output)."""
    import socket
    import subprocess
    import sys

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(root / "four")
    os.makedirs(out)
    script = os.path.join(repo, "paddle_tpu_torch", "distributed",
                          "multihost.py")
    cmd = [sys.executable, "-m", "paddle_tpu_torch", "cluster_train",
           "--nproc-per-host", "4", "--coordinator-port", str(port),
           "--job-dir", str(root), script, "--child", "--place", "cpu",
           "--out", out, "--inputs", inputs, "--timeout", str(TIMEOUT),
           FOUR]
    done = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=3 * TIMEOUT, cwd=repo)
    return done.returncode, [done.stdout + done.stderr]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("multihost")
    inputs = str(root / "inputs")
    os.makedirs(inputs)
    ready = _jax_inputs(inputs)
    done = {}

    def job(tag, nproc):
        done[tag] = mh.launch_job(CASES, nproc=nproc, place="cpu",
                                  out=str(root / tag), inputs=inputs,
                                  timeout=TIMEOUT)

    def four():
        done["four"] = _cluster_train(root, inputs)

    threads = [threading.Thread(target=job, args=("two", 2)),
               threading.Thread(target=job, args=("one", 1)),
               threading.Thread(target=four)]
    for t in threads:
        t.start()
    try:
        # the JAX package steps its two programs while the jobs run
        jax_runs = _jax_steps(ready)
    finally:
        for t in threads:
            t.join(timeout=3 * TIMEOUT)
    for tag, (rc, outs) in done.items():
        assert rc == 0, f"{tag}:\n" + "\n".join(o[-3000:] for o in outs)
    assert len(done) == 3
    return {tag: str(root / tag) for tag in done} | {
        "jax": jax_runs, "logs": {t: done[t][1] for t in done}}


def _jax_inputs(inputs):
    """Every mode's start state from the JAX package's startup, and its
    two multihost programs ready to step (``_jax_programs``)."""
    for name in RUNNING + PIPES:
        jfluid.reset()
        mode, prog, _ = jmodes.build_mode(name)
        jfluid.Executor(jfluid.CPUPlace()).run(
            jfluid.default_startup_program())
        _save(inputs, ("pipe:" if name in PIPES else "mode:") + name,
              _jax_state(prog))
    return _jax_programs(inputs)


def _two(runs, case):
    return mh.results(runs["two"], case, 2)


def _one(runs, case):
    return mh.results(runs["one"], case, 1)[0]


def _bitwise(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        assert got[k].dtype == want[k].dtype, (what, k)
        np.testing.assert_array_equal(got[k], want[k],
                                      err_msg=f"{what}: {k}")


# -- the collectives -----------------------------------------------------

KINDS = ("psum_f32", "psum_bf16", "pmean", "all_gather",
         "all_gather_stacked", "ppermute", "all_to_all")


@pytest.mark.parametrize("kind", KINDS)
def test_collective_across_processes(runs, kind):
    """Each collective over every axis of the three meshes (psum also
    over all axes at once): every position's result and the gradient of
    a loss through it equal the single-process mesh's to the bit, and one
    call logs what the single-process mesh logs."""
    (m1, a1), (m2, a2) = _one(runs, "collectives"), _two(runs,
                                                         "collectives")[0]
    keys = [k for k in a1 if k.split("_", 2)[-1].startswith(kind)
            and (k.endswith(kind) or k.endswith(kind + "_grad"))]
    assert keys
    _bitwise({k: a2[k] for k in keys}, {k: a1[k] for k in keys}, kind)
    for k in keys:
        if k in m1["figures"]:
            assert m2["figures"][k] == m1["figures"][k], k
            assert m1["figures"][k], k


def test_axis_index_across_processes(runs):
    """``axis_index`` names every position's index on both processes."""
    a1 = _one(runs, "collectives")[1]
    for meta, a2 in _two(runs, "collectives"):
        for k in a1:
            if k.endswith("axis_index"):
                np.testing.assert_array_equal(a2[k], a1[k])


# -- the modes -----------------------------------------------------------

@pytest.mark.parametrize("name", RUNNING)
def test_mode_over_two_processes(runs, name):
    """Three steps of each ParallelExecutor mode over two processes:
    losses, the first step's gradients and the written state equal the
    single-process mesh's to the bit, on both processes."""
    m1, a1 = _one(runs, f"mode:{name}")
    for rank, (m2, a2) in enumerate(_two(runs, f"mode:{name}")):
        assert m2["losses"] == m1["losses"], (rank, m2["losses"],
                                              m1["losses"])
        _bitwise(a2, a1, f"{name} rank {rank}")
        assert m2["transport"]["backend"] == "gloo"
    assert len(m1["losses"]) == mh.STEPS and np.all(np.isfinite(
        m1["losses"]))


@pytest.mark.parametrize("name", PIPES)
def test_pipeline_over_two_processes(runs, name):
    """ProgramPipeline over two processes (pp-major: the stage hop
    crosses them): losses and the trained parameters equal the
    single-process pipeline's to the bit."""
    m1, a1 = _one(runs, f"pipe:{name}")
    for rank, (m2, a2) in enumerate(_two(runs, f"pipe:{name}")):
        assert m2["losses"] == m1["losses"]
        _bitwise(a2, a1, f"{name} rank {rank}")
    assert len(m1["losses"]) == mh.STEPS and np.all(np.isfinite(
        m1["losses"]))


@pytest.mark.parametrize("case", ("fn_pipeline", "fn_moe"))
def test_functional_step_over_two_processes(runs, case):
    """The functional GPipe and MoE steps over two processes: six
    steps' losses, the collectives they log and the new parameters equal
    the single process's to the bit."""
    m1, a1 = _one(runs, case)
    for m2, a2 in _two(runs, case):
        assert m2["losses"] == m1["losses"]
        assert m2["figures"] == m1["figures"]
        _bitwise(a2, a1, case)
    assert m1["losses"][-1] < m1["losses"][0]


# -- the JAX package's two multihost programs ---------------------------

@pytest.mark.parametrize("case", ("jax_mlp_fsdp", "jax_lm_sp"))
def test_jax_multihost_program(runs, case):
    """``tools/multihost_smoke.py``'s programs, four steps from the JAX
    package's start state: over two processes equal to the port's
    single process to the bit, and within the tolerances of the JAX
    package's ParallelExecutor on its eight devices."""
    jl, jstate = runs["jax"][case]
    m1, a1 = _one(runs, case)
    (m2, a2), _ = _two(runs, case)
    assert m2["losses"] == m1["losses"]
    _bitwise(a2, a1, case)
    np.testing.assert_allclose(m2["losses"], jl, rtol=1e-5)
    adam = case == "jax_lm_sp"
    for n, want in jstate.items():
        got = a2["state/" + n].astype(np.float64)
        want = np.asarray(want, np.float64)
        if adam:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                       err_msg=n)
        else:
            np.testing.assert_allclose(
                got, want, rtol=0,
                atol=1e-5 * max(np.abs(want).max(), 1e-30), err_msg=n)
    if case == "jax_mlp_fsdp":  # each process held 1/dp of every weight
        assert m2["figures"]["sharded_state"]
    assert m2["losses"][-1] < m2["losses"][0]


# -- the checkpoint and the job ------------------------------------------

def test_checkpoint_across_processes(runs):
    """``fsdp`` one step; every process gathers, rank 0 writes, all meet
    at a barrier; each restores the checkpoint into a fresh scope: the
    restored state equals the saved one to the bit, and a step from it
    equals a step from the live scope (and the single process's)."""
    m1, a1 = _one(runs, "checkpoint")
    for m2, a2 in _two(runs, "checkpoint"):
        assert m2["losses"] == m1["losses"]
        assert m2["losses"][1] == m2["losses"][2]
        assert m2["figures"]["trainer_state"] == {"step": 1}
        _bitwise(a2, a1, "checkpoint")
        for k in a2:
            if k.startswith("saved/"):
                n = k[len("saved/"):]
                np.testing.assert_array_equal(a2["restored/" + n], a2[k])
                np.testing.assert_array_equal(a2["after_restored/" + n],
                                              a2["after/" + n])


def test_four_processes_through_cluster_train(runs):
    """``cluster_train`` starts ``distributed/multihost.py`` unchanged
    over four trainers of two positions each, joined over its TCP
    coordinator.  There the LM's re-run groups span processes (their
    copies' gradients are summed across them): the four agree and equal
    the single process to the bit."""
    assert "transport gloo" in runs["logs"]["four"][0]
    assert not mh.disagreements(runs["four"], [FOUR], 4)
    m1, a1 = _one(runs, FOUR)
    m4, a4 = mh.results(runs["four"], FOUR, 4)[0]
    assert m4["losses"] == m1["losses"]
    _bitwise(a4, a1, FOUR)


def test_each_process_logs_its_transport(runs):
    """Both processes join by the env contract and log the transport the
    rule chose and why; the single process joins nothing."""
    for rank, log in enumerate(runs["logs"]["two"]):
        line = [ln for ln in log.splitlines()
                if ln.startswith("TRANSPORT ")]
        info = json.loads(line[0][len("TRANSPORT "):])
        assert info["rank"] == rank and info["world"] == 2
        assert info["transport"]["backend"] == "gloo"
        assert "CPU" in info["transport"]["reason"]
        assert f"rank {rank} of 2 on cpu: transport gloo" in log
    one = runs["logs"]["one"][0]
    assert '"transport": null' in one


def test_a_failing_process_fails_the_job(tmp_path):
    """A case that raises in its processes ends the job with a non-zero
    exit and the error in the output, well inside the timeout."""
    rc, outs = mh.launch_job(["no_such_case"], nproc=2, place="cpu",
                             out=str(tmp_path), timeout=60)
    assert rc != 0
    assert any("no_such_case" in o for o in outs)
