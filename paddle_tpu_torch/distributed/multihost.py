"""One program over several processes, end to end — the port of
``tools/multihost_smoke.py`` as a module.

    python -m paddle_tpu_torch.distributed.multihost --nproc 2 \\
        --place cpu --out DIR jax_mlp_fsdp jax_lm_sp

starts `--nproc` processes with the ``PADDLE_TRAINER_ID`` /
``PADDLE_TRAINERS`` / ``PADDLE_COORDINATOR`` contract (the coordinator a
``file://`` store in a temporary directory, so no port is raced for), each
joining the group through ``launch.init_distributed`` and building its
meshes with ``launch.global_mesh``, an equal share of each mesh's
positions a process (`--place cuda`: on ``cuda:0``, the port's virtual
positions).  Every process runs the named cases in order; each case
writes, for each process, ``<case>.rank<r>.json`` (losses and figures)
and ``<case>.rank<r>.npz`` (the global state it fetched) under `--out`.
The run exits non-zero when a process fails, times out, or the
processes' results differ.  ``--nproc 1`` runs the same cases in one
process: the single-process mesh to hold them against.
``cluster_train`` (``distributed/cluster_launch.py``) can start the
processes instead: ``--child`` reads the env contract.

Cases (``CASES``): ``collectives``; ``mode:<name>`` for the nine modes of
``parallel/modes.py`` that a ``ParallelExecutor`` runs and
``pipe:pp``/``pipe:pp_dp`` for the two a ``ProgramPipeline`` runs, three
steps each at ``tests/test_torch_parallel.py``'s sizes; ``fn_pipeline``
and ``fn_moe``, the functional GPipe and MoE steps; ``jax_mlp_fsdp``
and ``jax_lm_sp``, the two programs of ``tools/multihost_smoke.py`` (a
dp-8 MLP with ``fsdp_params`` and the small LM over ``{"sp": 2, "dp":
4}``, sp-major, so that each zigzag ring partner lives in the other
process); ``checkpoint`` (``distributed/checkpoint.py`` across the
processes); ``gpt_sp``, ``gpt_pipe`` and ``loop_k2``, the card's runs of
the full-width GPT.  `--inputs DIR` may hold ``<case>.npz``: the start
state (name → array), carried in with ``load_persistables``; without it
a case runs its startup program from ``SEED``.  `--opts JSON` overrides
the sizes of ``gpt_sp`` and ``gpt_pipe`` (``GPT``'s keys), so that they
run small on the CPU; their meshes are ``GPT_AXES`` and ``PIPE_AXES``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time
import numpy as np

STEPS = 3
SEED = 0


# -- what a case sees -----------------------------------------------------

class Ctx:
    """A case's view of its process: `place`, `rank` and `world`, the
    start states' directory (`inputs`), the sizes `opts` overrides and
    the output directory."""

    def __init__(self, place, rank, world, inputs, opts, out):
        self.place = place
        self.rank = rank
        self.world = world
        self.inputs_dir = inputs
        self.opts = opts
        self.out = out
        self.seed = SEED

    def mesh(self, axes):
        """The job's mesh over `axes`: this process's positions on its
        place."""
        import torch

        from . import launch

        n = int(np.prod(list(axes.values())))
        return launch.global_mesh(dict(axes), devices=[
            torch.device(self.place.device)] * (n // self.world))

    def start(self, case):
        """The carried-in start state of `case`, or None."""
        if not self.inputs_dir:
            return None
        path = os.path.join(self.inputs_dir, case.replace(":", "_") + ".npz")
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            return {k: z[k] for k in z.files}


def _persistables(prog):
    return sorted(n for n, v in prog.global_block().vars.items()
                  if v.persistable)


def _state(scope, names):
    """The global values of `names` (a sharded one gathered: every
    process calls this, in the same order)."""
    from ..framework.scope import to_numpy

    return {n: to_numpy(scope.find(n)) for n in names
            if scope.find(n) is not None}


def _scalar(x):
    return float(np.asarray(x).ravel()[0])


def _begin(ctx, case, prog, startup, scope, exe):
    """The case's start state into `scope`: carried in, or the startup
    program run by `exe` from the seed."""
    from ..framework.scope import load_persistables

    start = ctx.start(case)
    if start is not None:
        load_persistables(prog, start, scope)
    else:
        startup.random_seed = ctx.seed
        exe.run(startup, scope=scope)


# -- the cases ------------------------------------------------------------

def case_collectives(ctx, case):
    """psum (f32, bf16, over one and two axes), pmean, all_gather,
    ppermute (one pair left out), all_to_all and axis_index over three
    meshes; the gradient of a loss through each; the counts one call of
    each logs.  Every result gathered whole."""
    import torch

    from ..parallel import collectives as col
    from ..parallel import transport

    out, figs = {}, {}
    for tag, axes in (("dp8", {"dp": 8}), ("dpmp", {"dp": 4, "mp": 2}),
                      ("spdp", {"sp": 2, "dp": 4})):
        mesh = ctx.mesh(axes)
        dev = torch.device(ctx.place.device)
        g = torch.Generator().manual_seed(ctx.seed)
        base = [torch.randn(8, 8, generator=g) for _ in range(8)]
        for ax in list(axes) + [tuple(axes)]:
            name = ax if isinstance(ax, str) else "all"
            S = col._size(mesh, ax)
            calls = {
                "psum_f32": lambda s: col.psum(s, mesh, ax),
                "psum_bf16": lambda s: col.psum(
                    [None if t is None else t.to(torch.bfloat16)
                     for t in s], mesh, ax),
                "pmean": lambda s: col.pmean(s, mesh, ax),
                "all_gather": lambda s: col.all_gather(s, mesh, ax, dim=1),
                "all_gather_stacked": lambda s: col.all_gather(
                    s, mesh, ax, dim=0, tiled=False)}
            if isinstance(ax, str):
                calls["ppermute"] = lambda s: col.ppermute(
                    s, mesh, ax, [(i, (i + 1) % S) for i in range(S - 1)])
                calls["all_to_all"] = lambda s: col.all_to_all(
                    s, mesh, ax, 0, 1)
            for kind, fn in calls.items():
                leaves = mesh.local_map(
                    lambda p: base[p].to(dev).requires_grad_(True))
                since = transport.mark(mesh.transport)
                with torch.enable_grad(), col.record() as log:
                    res = fn(leaves)
                    loss = sum((res[p].float() * (p + 1)).sum()
                               for p in mesh.local)
                    ct = torch.ones((), device=dev)
                    grads = transport.grad(mesh.transport, [loss],
                                           [leaves[p] for p in mesh.local],
                                           [ct], since)
                key = f"{tag}_{name}_{kind}"
                gs = [None] * mesh.size
                for p, gr in zip(mesh.local, grads):
                    gs[p] = torch.zeros_like(leaves[p]) if gr is None \
                        else gr
                with torch.no_grad():
                    out[key] = _whole(mesh, res)
                    out[key + "_grad"] = _whole(mesh, gs)
                figs[key] = [list(e[:3]) for e in log]
        out[f"{tag}_axis_index"] = np.asarray(
            [col.axis_index(mesh, a) for a in axes])
    return {"losses": [], "figures": figs}, out


def _whole(mesh, per_position):
    """A per-position list as one array [positions, ...] (a collective)."""
    from ..parallel.sharded import ShardedTensor

    return ShardedTensor(mesh, (tuple(mesh.axis_names),), [
        None if t is None else t.detach().float()[None]
        for t in per_position]).gather().cpu().numpy()


def case_mode(ctx, case):
    """Three steps of a ``ParallelExecutor`` mode over the job's mesh."""
    import paddle_tpu_torch as fluid

    from ..framework.scope import Scope
    from ..parallel import modes
    from ..parallel.parallel_executor import ParallelExecutor

    name = case.split(":", 1)[1]
    mode, prog, loss = modes.build_mode(name)
    startup = fluid.default_startup_program()
    scope = Scope()
    pe = ParallelExecutor(mesh=ctx.mesh(mode.mesh_axes),
                          **mode.executor_kwargs)
    _begin(ctx, case, prog, startup, scope, pe)
    rng = np.random.RandomState(0)
    feeds = [mode.feed_fn(rng, 8) for _ in range(STEPS)]
    grads = [n + "@GRAD" for n, v in prog.global_block().vars.items()
             if v.persistable and getattr(v, "trainable", False)]
    losses, out = [], {}
    for step, f in enumerate(feeds):
        fetch = [loss] + (grads if step == 0 else [])
        got = pe.run(prog, feed=f, fetch_list=fetch, scope=scope)
        losses.append(_scalar(got[0]))
        out.update({"grad/" + n: np.asarray(v)
                    for n, v in zip(grads, got[1:])})
    out.update({"state/" + n: v for n, v in
                _state(scope, _persistables(prog)).items()})
    return {"losses": losses, "figures": {
        "collectives": pe.comm_summary(),
        "reshards": pe.last_step["reshards"]}}, out


def case_pipe(ctx, case):
    """Three steps of a ``ProgramPipeline`` mode over the job's mesh
    (n_micro the mode's pp, SGD 0.1)."""
    import paddle_tpu_torch as fluid

    from ..framework.executor import Executor
    from ..framework.scope import Scope
    from ..parallel import collectives as col
    from ..parallel import modes
    from ..parallel.program_pipeline import ProgramPipeline

    name = case.split(":", 1)[1]
    mode, prog, loss = modes.build_mode(name)
    startup = fluid.default_startup_program()
    scope = Scope()
    _begin(ctx, case, prog, startup, scope, Executor(ctx.place))
    pipe = ProgramPipeline(prog, loss, ctx.mesh(mode.mesh_axes),
                           n_micro=mode.mesh_axes["pp"],
                           optimizer=("sgd", 0.1), scope=scope)
    rng = np.random.RandomState(0)
    feeds = [mode.feed_fn(rng, 8) for _ in range(STEPS)]
    losses = []
    with col.record() as log:
        for f in feeds:
            losses.append(pipe.run(f))
    out = {"state/" + n: v.float().cpu().numpy()
           for n, v in pipe.params().items()}
    kinds = {}
    for kind, _axes, _n, _tag in log:
        kinds[kind] = kinds.get(kind, 0) + 1
    return {"losses": losses, "figures": {"collectives": kinds}}, out


def jax_mlp_feeds():
    """``tools/multihost_smoke.py``'s MLP batch over its eight devices:
    the identical global batch every process feeds."""
    rng = np.random.RandomState(0)
    xs = rng.rand(64, 32).astype(np.float32)
    ys = rng.randint(0, 10, (64, 1)).astype(np.int64)
    return {"x": xs, "y": ys}


def jax_lm_feeds():
    """The LM batch that follows the MLP's in the same stream."""
    rng = np.random.RandomState(0)
    rng.rand(64, 32)
    rng.randint(0, 10, (64, 1))
    toks = rng.randint(0, 128, (8, 64, 1)).astype(np.int64)
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}


def build_jax_mlp(fluid):
    """The dp-8 MLP of ``tools/multihost_smoke.py``: (loss, program)."""
    x = fluid.layers.data(name="x", shape=[32], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="int64")
    h = fluid.layers.fc(input=x, size=64, act="relu")
    logits = fluid.layers.fc(input=h, size=10)
    avg = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, y))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(avg)
    return avg, fluid.default_main_program()


def build_jax_lm(transformer):
    """The small LM of ``tools/multihost_smoke.py``: the loss."""
    return transformer.build_lm_train_program(
        seq_len=64, vocab_size=128, dim=64, n_layers=1, n_heads=2,
        dtype="float32", learning_rate=1e-2)


JAX_STEPS = 4


def case_jax_mlp_fsdp(ctx, case):
    import paddle_tpu_torch as fluid

    from ..framework.scope import Scope
    from ..parallel.parallel_executor import ParallelExecutor

    fluid.reset()
    loss, prog = build_jax_mlp(fluid)
    scope = Scope()
    pe = ParallelExecutor(mesh=ctx.mesh({"dp": 8}), fsdp_params=True)
    _begin(ctx, case, prog, fluid.default_startup_program(), scope, pe)
    feed = jax_mlp_feeds()
    losses = [_scalar(pe.run(prog, feed=feed, fetch_list=[loss],
                             scope=scope)[0]) for _ in range(JAX_STEPS)]
    sharded = sorted(n for n in _persistables(prog)
                     if getattr(scope.find(n), "__sharded__", False))
    out = {"state/" + n: v for n, v in
           _state(scope, _persistables(prog)).items()}
    return {"losses": losses, "figures": {"sharded_state": sharded}}, out


def case_jax_lm_sp(ctx, case):
    import paddle_tpu_torch as fluid

    from ..framework.scope import Scope
    from ..models import transformer
    from ..parallel.parallel_executor import ParallelExecutor

    fluid.reset()
    loss = build_jax_lm(transformer)
    prog = fluid.default_main_program()
    scope = Scope()
    # sp MAJOR: positions are process-contiguous, so each sp partner
    # lives in the other process and every ring hop crosses
    pe = ParallelExecutor(mesh=ctx.mesh({"sp": 2, "dp": 4}))
    _begin(ctx, case, prog, fluid.default_startup_program(), scope, pe)
    feed = jax_lm_feeds()
    losses = [_scalar(pe.run(prog, feed=feed, fetch_list=[loss],
                             scope=scope)[0]) for _ in range(JAX_STEPS)]
    out = {"state/" + n: v for n, v in
           _state(scope, _persistables(prog)).items()}
    return {"losses": losses, "figures": {
        "collectives": pe.comm_summary()}}, out


def case_checkpoint(ctx, case):
    """``fsdp`` (parameters sharded 1/dp) one step; ``save_checkpoint``
    from every process (each gathers, rank 0 writes, all meet at a
    barrier); ``load_checkpoint`` into a fresh scope on every process; one
    more step from each scope."""
    import paddle_tpu_torch as fluid

    from ..framework.scope import Scope
    from ..parallel import modes
    from ..parallel.parallel_executor import ParallelExecutor
    from . import checkpoint

    mode, prog, loss = modes.build_mode("fsdp")
    startup = fluid.default_startup_program()
    scope = Scope()
    pe = ParallelExecutor(mesh=ctx.mesh(mode.mesh_axes),
                          **mode.executor_kwargs)
    _begin(ctx, case, prog, startup, scope, pe)
    rng = np.random.RandomState(0)
    f1, f2 = mode.feed_fn(rng, 8), mode.feed_fn(rng, 8)
    names = _persistables(prog)
    l1 = _scalar(pe.run(prog, feed=f1, fetch_list=[loss], scope=scope)[0])
    saved = _state(scope, names)
    where = os.path.join(ctx.out, "ckpt")
    path = checkpoint.save_checkpoint(pe, where, prog, scope=scope,
                                      trainer_state={"step": 1})
    back = Scope()
    meta = checkpoint.load_checkpoint(pe, where, prog, scope=back)
    restored = _state(back, names)
    l2 = _scalar(pe.run(prog, feed=f2, fetch_list=[loss], scope=scope)[0])
    l2b = _scalar(pe.run(prog, feed=f2, fetch_list=[loss], scope=back)[0])
    out = {}
    for n in names:
        out["saved/" + n] = saved[n]
        out["restored/" + n] = restored[n]
    out.update({"after/" + n: v for n, v in _state(scope, names).items()})
    out.update({"after_restored/" + n: v
                for n, v in _state(back, names).items()})
    return {"losses": [l1, l2, l2b], "figures": {
        "path": os.path.basename(path), "trainer_state": meta}}, out


def case_functional(ctx, case):
    """The functional steps of ``parallel/pipeline.py`` (``fn_pipeline``:
    GPipe over {"pp": 4, "dp": 2}, width 16, n_micro 4) and
    ``parallel/moe.py`` (``fn_moe``: {"ep": 4, "dp": 2}, d 8, h 16,
    capacity 16), six SGD steps each from parameters drawn from the
    seed, at ``tests/test_torch_pipeline.py``'s sizes."""
    import torch

    from ..parallel import collectives as col
    from ..parallel import moe, pipeline

    g = torch.Generator().manual_seed(ctx.seed)
    rng = np.random.RandomState(ctx.seed)
    if case == "fn_pipeline":
        params = pipeline.init_pipeline_params(g, 4, 16)
        step, _ = pipeline.build_pipeline_train_step(
            ctx.mesh({"pp": 4, "dp": 2}), 4, 16, lr=0.2)
        x = rng.randn(16, 16).astype(np.float32)
        y = np.tanh(x @ rng.randn(16, 16).astype(np.float32) * 0.3)
    else:
        params = moe.init_moe_params(g, 4, 8, 16)
        step = moe.build_moe_train_step(ctx.mesh({"ep": 4, "dp": 2}), 8,
                                        16, 16)
        x = rng.randn(32, 8).astype(np.float32)
        y = (x * 2.0 + 0.5).astype(np.float32)
    losses = []
    with col.record() as log:
        for _ in range(6):
            loss, params = step(params, x, y)
            losses.append(float(loss))
    kinds = {}
    for kind, _axes, _n, _tag in log:
        kinds[kind] = kinds.get(kind, 0) + 1
    return {"losses": losses, "figures": {"collectives": kinds}}, {
        k: v.cpu().numpy() for k, v in params.items()}


# -- the card's runs: the full-width GPT ----------------------------------

GPT = {"vocab": 32000, "dim": 512, "layers": 8, "heads": 8, "seq": 1024,
       "bs": 8, "dtype": "bfloat16", "lr": 3e-4, "warm": 2, "timed": 10,
       "held": 4}
# sp major: positions are process-contiguous, so over two processes each
# sp partner lives in the other one and every zigzag hop crosses
GPT_AXES = {"sp": 2, "dp": 4}
# pp major: the stage hop crosses the processes
PIPE_AXES = {"pp": 2, "dp": 2}
PIPE_MICRO = 2


def gpt_feed(o):
    """bench.py's batch: tokens from RandomState(0), targets shifted."""
    rng = np.random.RandomState(0)
    toks = rng.randint(0, o["vocab"], (o["bs"], o["seq"], 1)).astype(
        np.int64)
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}


def _flash_launches():
    from ..ops.cuda_kernels import flash_attention as fa

    return {k: getattr(fa, k).launches for k in (
        "flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv")}


def _digest(state, prefix="sha1/"):
    """name → a hash of the tensor's bytes (equal hashes: equal bits)."""
    import hashlib

    return {prefix + n: np.frombuffer(hashlib.sha1(
        np.ascontiguousarray(a).tobytes()).digest(), dtype=np.uint8)
        for n, a in sorted(state.items())}


def _device_profile(run, n):
    """`n` calls of `run` under torch.profiler: device ms a call and the
    device's busy share of their wall (merged kernel intervals)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return {"profiled": "not measured: the profiler saw no device "
                            "event"}
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return {"device_ms_per_step": busy / 1e3 / n,
            "device_busy_share": busy / wall_us,
            "wall_ms_profiled_per_step": wall_us / 1e3 / n}


def _timed_steps(step, n, tr, on_card, then=None):
    """`n` calls of `step` (each returning its loss), each synchronized
    on the card: losses, ms, peak GB, K4/K5/K6 launches and transport
    tally each.  `then(i)` runs untimed after the i-th call."""
    import torch

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    rows = []
    for i in range(1, n + 1):
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        before = _flash_launches()
        tally0 = dict(tr.tally) if tr is not None else None
        t0 = time.monotonic()
        loss = step()
        sync()
        ms = (time.monotonic() - t0) * 1e3
        after = _flash_launches()
        row = {"loss": loss, "ms": ms,
               "launches": {k: after[k] - before[k] for k in after}}
        if on_card:
            row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if tr is not None:
            row["transport"] = {k: tr.tally[k] - tally0[k]
                                for k in tr.tally}
        rows.append(row)
        if then is not None:
            then(i)
    return rows


def case_gpt_sp(ctx, case):
    """The full-width GPT (``build_lm_train_program``) over ``GPT_AXES``:
    `warm` + `timed` steps from the seed's startup state on the card,
    each timed, then one profiled; the state's digests after the first
    `held` steps (``sha1/``) and, where more ran, after the last
    (``end_sha1/``)."""
    import paddle_tpu_torch as fluid

    from ..framework.executor import Executor
    from ..framework.scope import Scope
    from ..models import transformer
    from ..parallel.parallel_executor import ParallelExecutor
    from . import launch

    o = {**GPT, **ctx.opts}
    fluid.reset()
    loss = transformer.build_lm_train_program(
        seq_len=o["seq"], vocab_size=o["vocab"], dim=o["dim"],
        n_layers=o["layers"], n_heads=o["heads"], dtype=o["dtype"],
        learning_rate=o["lr"])
    prog = fluid.default_main_program()
    startup = fluid.default_startup_program()
    startup.random_seed = ctx.seed
    scope = Scope()
    Executor(ctx.place).run(startup, scope=scope)
    names = _persistables(prog)
    pe = ParallelExecutor(mesh=ctx.mesh(GPT_AXES))
    feed = gpt_feed(o)
    tr = launch.transport()

    def step():
        return _scalar(pe.run(prog, feed=feed, fetch_list=[loss],
                              scope=scope)[0])

    n = o["warm"] + o["timed"]
    held = min(o["held"], n)
    digests = {}

    def take(i):
        if i == held:
            digests.update(_digest(_state(scope, names)))

    on_card = ctx.place.device.type == "cuda"
    rows = _timed_steps(step, n, tr, on_card, take)
    figs = {"steps": rows, "held_steps": held,
            "collectives_per_step": pe.comm_summary(),
            "reshards_per_step": pe.last_step["reshards"],
            "mesh": repr(pe.mesh)}
    if n > held:
        digests.update(_digest(_state(scope, names), "end_sha1/"))
    if on_card:
        figs.update(_device_profile(step, 1))
    return {"losses": [r["loss"] for r in rows], "figures": figs}, digests


def case_gpt_pipe(ctx, case):
    """The bench GPT (``decoder_lm``) cut in two stages by a
    ``pipeline_stage`` marker after its fourth block, through
    ``ProgramPipeline`` over ``PIPE_AXES`` at n_micro ``PIPE_MICRO`` with
    SGD: `warm` + `timed` steps, each timed; the trained parameters'
    digests."""
    import paddle_tpu_torch as fluid

    from ..framework.executor import Executor
    from ..framework.scope import Scope
    from ..models import transformer
    from ..parallel import collectives as col
    from ..parallel.program_pipeline import ProgramPipeline
    from . import launch

    o = {**GPT, "lr": 0.05, "timed": 5, **ctx.opts}
    fluid.reset()
    tok = fluid.layers.data("tokens", shape=[o["seq"], 1], dtype="int64")
    tgt = fluid.layers.data("targets", shape=[o["seq"], 1], dtype="int64")
    logits = transformer.decoder_lm(
        tok, o["vocab"], o["dim"], o["layers"], o["heads"],
        max_len=o["seq"], dtype=o["dtype"],
        stage_every=o["layers"] // PIPE_AXES["pp"])
    loss = transformer.lm_loss(logits, tgt, dtype=o["dtype"])
    prog = fluid.default_main_program()
    startup = fluid.default_startup_program()
    startup.random_seed = ctx.seed
    scope = Scope()
    Executor(ctx.place).run(startup, scope=scope)
    pipe = ProgramPipeline(prog, loss, ctx.mesh(PIPE_AXES),
                           n_micro=PIPE_MICRO,
                           optimizer=("sgd", o["lr"]), scope=scope)
    feed = gpt_feed(o)
    tr = launch.transport()
    on_card = ctx.place.device.type == "cuda"
    with col.record() as log:
        rows = _timed_steps(lambda: pipe.run(feed), o["warm"] + o["timed"],
                            tr, on_card)
    kinds = {}
    for kind, _axes, _n, _tag in log:
        kinds[kind] = kinds.get(kind, 0) + 1
    n = o["warm"] + o["timed"]
    figs = {"steps": rows,
            "collectives_per_step": {k: v / n for k, v in kinds.items()},
            "mesh": repr(pipe.mesh)}
    if on_card:
        figs.update(_device_profile(lambda: pipe.run(feed), 1))
    with __import__("torch").no_grad():
        params = {k: v.float().cpu().numpy()
                  for k, v in pipe.params().items()}
    return {"losses": [r["loss"] for r in rows], "figures": figs}, \
        _digest(params)


def case_loop_k2(ctx, case):
    """``run(steps_per_dispatch=2)`` of f32 ``sp_ring`` over the job's
    mesh, three dispatches, against two ``run()`` calls of another
    executor from the same state each time: the losses and the written
    state, and the safety verdict the executor took (a staged transport
    is a reason: the loud eager route)."""
    import warnings

    import paddle_tpu_torch as fluid

    from ..framework.executor import Executor
    from ..framework.scope import Scope
    from ..parallel import modes
    from ..parallel.parallel_executor import ParallelExecutor

    mode, prog, loss = modes.build_mode("sp_ring")
    startup = fluid.default_startup_program()
    startup.random_seed = ctx.seed
    sa, sb = Scope(), Scope()
    Executor(ctx.place).run(startup, scope=sa)
    names = _persistables(prog)
    for n in names:
        sb.set(n, sa.find(n).clone())
    seq = ParallelExecutor(mesh=ctx.mesh(mode.mesh_axes))
    fused = ParallelExecutor(mesh=ctx.mesh(mode.mesh_axes))
    rng = np.random.RandomState(ctx.seed)
    want, got, warned = [], [], []
    for _ in range(3):
        feeds = [mode.feed_fn(rng, 8) for _ in range(2)]
        want += [_scalar(seq.run(prog, feed=f, fetch_list=[loss],
                                 scope=sa)[0]) for f in feeds]
        stacked = {k: np.stack([f[k] for f in feeds]) for k in feeds[0]}
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            out = fused.run(prog, feed=stacked, fetch_list=[loss],
                            scope=sb, steps_per_dispatch=2)
        got += [float(v) for v in np.asarray(out[0]).reshape(-1)]
        warned += [str(x.message) for x in w]
    reasons = sorted({r for e in fused._loops.values()
                      for r in e.safety["reasons"]})
    sa_state, sb_state = _state(sa, names), _state(sb, names)
    differ = [n for n in names
              if not np.array_equal(sa_state[n], sb_state[n])]
    return {"losses": got, "figures": {
        "sequential_losses": want, "bitwise": got == want and not differ,
        "state_differs": differ, "safety_reasons": reasons,
        "captured": any(e.loop is not None
                        for e in fused._loops.values()),
        "warnings": warned[:3]}}, {}


CASES = {
    "collectives": case_collectives,
    "jax_mlp_fsdp": case_jax_mlp_fsdp,
    "jax_lm_sp": case_jax_lm_sp,
    "checkpoint": case_checkpoint,
    "fn_pipeline": case_functional,
    "fn_moe": case_functional,
    "gpt_sp": case_gpt_sp,
    "gpt_pipe": case_gpt_pipe,
    "loop_k2": case_loop_k2,
}


def case_fn(case):
    if case.startswith("mode:"):
        return case_mode
    if case.startswith("pipe:"):
        return case_pipe
    return CASES[case]


# -- a process ------------------------------------------------------------

def run_cases(ctx, cases, out, tr=None):
    """Run `cases` in this process and write each one's results under
    `out` (``<case>.rank<r>.json|npz``)."""
    import paddle_tpu_torch as fluid

    info = None if tr is None else {"backend": tr.backend,
                                    "staged": tr.staged,
                                    "reason": tr.reason}
    for case in cases:
        fluid.reset()
        if tr is not None:
            tr.reset_tally()
        t0 = time.monotonic()
        meta, arrays = case_fn(case)(ctx, case)
        meta["seconds"] = time.monotonic() - t0
        meta["transport"] = info
        if tr is not None:
            meta["tally"] = dict(tr.tally)
        stem = os.path.join(out, f"{case.replace(':', '_')}.rank{ctx.rank}")
        np.savez(stem + ".npz", **arrays)
        with open(stem + ".json", "w") as f:
            json.dump(meta, f)
        print(f"CASE {case} rank {ctx.rank} {meta['seconds']:.2f}s",
              flush=True)


def run_here(cases, place="cuda", out=None, opts=None):
    """The cases in this process, which owns every position (the
    single-process mesh, as ``--nproc 1`` runs it without starting a
    process)."""
    from ..framework.place import CPUPlace, CUDAPlace

    os.makedirs(out, exist_ok=True)
    ctx = Ctx(CPUPlace() if place == "cpu" else CUDAPlace(0), 0, 1, None,
              opts or {}, out)
    run_cases(ctx, cases, out)


def child(args):
    """One process: join the group, run the cases, write the results."""
    import torch

    from ..framework.place import CPUPlace, CUDAPlace
    from . import launch

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    # one CPU thread a process: the jobs' processes share the host, and
    # the CPU's sums then do not depend on a thread count
    torch.set_num_threads(1)
    place = CPUPlace() if args.place == "cpu" else CUDAPlace(0)
    rank = launch.env_trainer_id()
    world = launch.env_trainer_count()
    launch.init_distributed(place=place, timeout_s=args.timeout)
    tr = launch.transport()
    print("TRANSPORT " + json.dumps({
        "rank": rank, "world": world, "transport": None if tr is None else {
            "backend": tr.backend, "staged": tr.staged,
            "reason": tr.reason}}), flush=True)
    ctx = Ctx(place, rank, world, args.inputs,
              json.loads(args.opts) if args.opts else {}, args.out)
    run_cases(ctx, args.cases, args.out, tr)
    launch.shutdown()


# -- the job --------------------------------------------------------------

def results(out, case, world):
    """[(meta, arrays)] of a case, one a process."""
    got = []
    for r in range(world):
        stem = os.path.join(out, f"{case.replace(':', '_')}.rank{r}")
        with open(stem + ".json") as f:
            meta = json.load(f)
        with np.load(stem + ".npz") as z:
            got.append((meta, {k: z[k] for k in z.files}))
    return got


def disagreements(out, cases, world):
    """[message] where the processes' losses or fetched state differ."""
    bad = []
    for case in cases:
        got = results(out, case, world)
        m0, a0 = got[0]
        for r, (m, a) in enumerate(got[1:], 1):
            if m["losses"] != m0["losses"]:
                bad.append(f"{case}: rank {r} losses {m['losses']} != "
                           f"rank 0's {m0['losses']}")
            for k in a0:
                if k not in a or not np.array_equal(a[k], a0[k],
                                                    equal_nan=True):
                    bad.append(f"{case}: rank {r} {k} differs from rank "
                               f"0's")
                    break
    return bad


def launch_job(cases, nproc=2, place="cuda", out=None, inputs=None,
               opts=None, timeout=300.0):
    """Run the job: (exit code, [each process's output]).  Every
    collective waits at most `timeout` seconds, the job that long twice
    plus a minute."""
    store_dir = tempfile.mkdtemp(prefix="multihost_")
    os.makedirs(out, exist_ok=True)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    pypath = os.environ.get("PYTHONPATH")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.multihost",
           "--child", "--place", place, "--out", out, "--timeout",
           str(timeout)]
    if inputs:
        cmd += ["--inputs", inputs]
    if opts:
        cmd += ["--opts", json.dumps(opts)]
    procs = []
    for r in range(nproc):
        env = dict(os.environ, PADDLE_TRAINER_ID=str(r),
                   PADDLE_TRAINERS=str(nproc),
                   PADDLE_COORDINATOR="file://" + os.path.join(store_dir,
                                                               "store"),
                   PYTHONPATH=root + (os.pathsep + pypath if pypath
                                      else ""))
        procs.append(subprocess.Popen(
            cmd + list(cases), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, cwd=root))
    outs, rc = [], 0
    deadline = time.monotonic() + timeout * 2 + 60
    try:
        for p in procs:
            try:
                o, _ = p.communicate(
                    timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                o, _ = p.communicate()
                o += "\nmultihost: the process timed out"
                rc = rc or 124
            outs.append(o)
            if p.returncode:
                rc = rc or p.returncode
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(store_dir, ignore_errors=True)
    if rc == 0:
        bad = disagreements(out, cases, nproc)
        if bad:
            outs.append("multihost: the processes disagree:\n"
                        + "\n".join(bad))
            rc = 1
    return rc, outs


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("cases", nargs="+")
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--place", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--inputs", default=None)
    ap.add_argument("--opts", default=None)
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a collective may wait")
    ap.add_argument("--child", action="store_true",
                    help="run as one process of the job (the env "
                         "contract names its rank)")
    args = ap.parse_args(argv)
    if args.child:
        child(args)
        return 0
    out = args.out or tempfile.mkdtemp(prefix="multihost_out_")
    rc, outs = launch_job(args.cases, args.nproc, args.place, out,
                          args.inputs,
                          json.loads(args.opts) if args.opts else None,
                          args.timeout)
    for r, o in enumerate(outs):
        sys.stdout.write(f"--- process {r} ---\n{o}\n")
    print(f"MULTIHOST {'OK' if rc == 0 else 'FAILED'} rc={rc} out={out}")
    return rc


if __name__ == "__main__":
    if not __package__:
        # run as a file, as cluster_train starts a job's script: run the
        # module itself
        import runpy

        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        runpy.run_module("paddle_tpu_torch.distributed.multihost",
                         run_name="__main__")
    else:
        sys.exit(main())
