"""Pipeline parallelism for fluid-built Programs over a `pp` mesh axis —
the port of ``paddle_tpu/parallel/program_pipeline.py``.

``pipeline.py`` runs the GPipe schedule on a toy stacked MLP; this module
makes it a framework capability: any Program whose global block is split
by ``layers.pipeline_stage()`` markers runs its stages one a `pp`
position, activations hopping stages through ``collectives.ppermute``.

Design points, as in the JAX package:
- **Heterogeneous stages.** Each stage's ops run through the port's
  emitters (``Executor._run_op``) with ``is_test=False`` and ``ctx.mesh``
  set, under autograd: attention in a stage is ``FlashAttentionTrain``
  (K4 forward; K5 and K6 in the backward).
- **Flat-packed parameters.** Each stage's parameters are flattened into
  one float32 row, padded to the longest stage.  Under `dp` every
  (stage, dp) position holds a row of its own, so the gradients of one
  stage's dp positions meet only in an explicit, counted
  ``collectives.psum``.  A parameter is cast to its declared dtype inside
  the stage; the SGD/momentum update applies to the rows.
- **Fixed-shape hops.** Stage-boundary activations are cast into one
  float32 buffer sized to the largest interface and cast back on the far
  side (bf16 rounding depends on these casts, so their order is JAX's).

A step is a Python loop over ticks, and at each tick every position of
this process whose stage has a microbatch in flight runs it.  JAX
computes every stage every tick and masks the invalid ones to zero; that
masked work adds nothing to the loss or its gradient, so skipping it
gives the same result.  The backward is autograd through the whole
schedule.  Over a mesh of several processes (``distributed.launch.
global_mesh``) a stage runs in the process that owns its positions, a
tick's hop crosses processes where neighbouring stages do, the backward
runs back through the exchanges (``parallel/transport.py``), and the
loss takes its cotangent once, in the process that owns position 0.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..framework.core import torch_dtype
from ..framework.executor import Executor
from ..framework.scope import global_scope
from ..ops.registry import EmitContext
from . import collectives, transport
from .mesh import mesh_axis_sizes
from .pipeline import backward_once


def split_stages(block) -> List[list]:
    """Partition the block's ops at pipeline_stage markers (markers and
    feed/fetch descs excluded)."""
    stages, cur = [], []
    for op in block.ops:
        if op.type == "pipeline_stage":
            stages.append(cur)
            cur = []
        elif op.type not in ("feed", "fetch"):
            cur.append(op)
    stages.append(cur)
    return stages


class _StageInfo:
    def __init__(self):
        self.ops = []
        self.params: List[str] = []      # persistable reads, in first-use order
        self.interface_in: List[str] = []   # activations from the prev stage
        self.produced: set = set()


class _TickContext(EmitContext):
    """A stage's emit context at one tick: its random ops fold the tick
    in, as JAX folds it into the step's key."""

    def __init__(self, device, program, step, tick, mesh, constants):
        super().__init__(device, is_test=False, program=program, step=step,
                         constants=constants)
        self.tick = int(tick)
        self.mesh = mesh
        self.lower_block = lambda idx, env: _run_ops(
            program.blocks[idx].ops, env, self)

    def generator(self, attrs, *fold):
        return super().generator(attrs, self.tick, *fold)


def _run_ops(ops, env, ctx):
    for op in ops:
        Executor._run_op(op, env, ctx)
    return env


class _StepPlan:
    """What a feed-shape signature fixes: the stage functions, the hop
    buffer's length and the dp-local microbatch."""

    def __init__(self, stage_fns, act_len, local_bs):
        self.stage_fns = stage_fns
        self.act_len = act_len
        self.local_bs = local_bs


class ProgramPipeline:
    """Drive one Program as a `pp`-parallel GPipe schedule.

    Usage:
        prog builds ... layers.pipeline_stage() ... loss
        exe.run(startup)                   # init params (host values)
        pipe = ProgramPipeline(prog, loss, mesh, n_micro=8,
                               optimizer=("sgd", 0.1))
        for batch: loss = pipe.run(feed)
        pipe.sync_scope()                  # write trained params back

    The program must be the *forward+loss* graph (clone(for_test=True) of a
    train program, or a program built without minimize()); backward comes
    from autograd over the schedule.  BN running-stat updates inside
    stages are not persisted (batch stats still normalize correctly).
    The positions follow the mesh's devices."""

    def __init__(self, program, loss, mesh, n_micro: int,
                 optimizer=("sgd", 0.1), scope=None, block_id: int = 0):
        self.program = program
        self.mesh = mesh
        self.n_micro = int(n_micro)
        self.loss_name = loss if isinstance(loss, str) else loss.name
        self.scope = scope if scope is not None else global_scope()
        self.block = program.blocks[block_id]
        self.opt_kind = optimizer[0]
        self.opt_args = tuple(float(a) for a in optimizer[1:])
        if self.opt_kind not in ("sgd", "momentum", "none"):
            raise ValueError(f"ProgramPipeline optimizer {self.opt_kind!r}: "
                             f"use 'sgd', 'momentum' or 'none'")

        sizes = mesh_axis_sizes(mesh)
        self.pp = sizes.get("pp", 1)
        self.dp = sizes.get("dp", 1)
        op_stages = split_stages(self.block)
        if len(op_stages) != self.pp:
            raise ValueError(
                f"program has {len(op_stages)} pipeline stages "
                f"(pipeline_stage markers + 1) but mesh 'pp' axis is "
                f"{self.pp}")
        self.stages = self._analyze(op_stages)
        self._stage_of = collectives.axis_index(mesh, "pp")
        self._dp_of = [mesh.coords(p).get("dp", 0) for p in range(mesh.size)]
        self._rows = None         # one [L] float32 row a position
        self._velocity = None
        self._step_fns: Dict[tuple, _StepPlan] = {}  # per feed-shape signature
        self._step = 0
        self._constants = {}

    # ------------------------------------------------------------------
    def _analyze(self, op_stages) -> List[_StageInfo]:
        infos = []
        produced_before: Dict[str, int] = {}
        param_stage: Dict[str, int] = {}
        for s, ops in enumerate(op_stages):
            info = _StageInfo()
            info.ops = ops
            seen = set()
            for op in ops:
                for n in op.input_names():
                    if not n or n in seen or n in info.produced:
                        continue
                    seen.add(n)
                    v = self.block._find_var_recursive(n)
                    if v is not None and v.is_data:
                        continue  # feeds are broadcast to every stage
                    if v is not None and v.persistable:
                        owner = param_stage.get(n)
                        if owner is not None and owner != s:
                            raise ValueError(
                                f"parameter {n!r} is read by stages {owner} "
                                f"and {s}; flat-packed pipeline parameters "
                                f"cannot be shared across stages (gradients "
                                f"would not be summed) — duplicate the "
                                f"weight or keep its users in one stage")
                        param_stage[n] = s
                        info.params.append(n)
                    elif n in produced_before:
                        src = produced_before[n]
                        if src != s - 1:
                            raise ValueError(
                                f"variable {n!r} crosses stage boundary "
                                f"{src}->{s}; pipeline dataflow must be "
                                f"between consecutive stages (rematerialize "
                                f"or move the consumer)")
                        info.interface_in.append(n)
                    else:
                        raise ValueError(
                            f"stage {s} reads {n!r} which no earlier stage "
                            f"produces and is neither a feed nor a "
                            f"parameter")
                for n in op.output_names():
                    if n:
                        info.produced.add(n)
                        produced_before[n] = s
            infos.append(info)
        if self.loss_name not in infos[-1].produced:
            raise ValueError(
                f"loss {self.loss_name!r} must be produced by the LAST "
                f"pipeline stage")
        return infos

    # ------------------------------------------------------------------
    def _var_shape(self, name, micro_bs):
        v = self.block._find_var_recursive(name)
        if v is None or v.shape is None:
            raise ValueError(f"no static shape for interface var {name!r}")
        return tuple(micro_bs if d == -1 else int(d) for d in v.shape)

    def _var_dtype(self, name):
        return torch_dtype(self.block._find_var_recursive(name).dtype)

    def _first_of_stage(self, s: int) -> int:
        return self._stage_of.index(s)

    # ------------------------------------------------------------------
    def initialize(self, scope=None):
        """Pack the scope's initialized parameter values into one float32
        row a position (run the startup program on an Executor first)."""
        scope = scope or self.scope
        self._param_meta = []  # per stage: list of (name, shape, dtype, off)
        flat_stages = []
        for names in (s.params for s in self.stages):
            metas, chunks, off = [], [], 0
            for n in names:
                val = scope.find(n)
                if val is None:
                    raise RuntimeError(
                        f"parameter {n!r} not initialized — run the startup "
                        f"program first")
                if getattr(val, "__sharded__", False):
                    val = val.gather()
                metas.append((n, tuple(val.shape), val.dtype, off))
                chunks.append(val.detach().reshape(-1))
                off += val.numel()
            self._param_meta.append(metas)
            flat_stages.append(chunks)
        L = max((m[-1][3] + int(np.prod(m[-1][1])) for m in
                 self._param_meta if m), default=1) or 1

        def row_of(p):
            dev = self.mesh.device(p)
            row = torch.zeros((L,), dtype=torch.float32, device=dev)
            off = 0
            for c in flat_stages[self._stage_of[p]]:
                row[off:off + c.numel()] = c.to(dev)
                off += c.numel()
            return row

        self._rows = self.mesh.local_map(row_of)
        if self.opt_kind == "momentum":
            self._velocity = [None if r is None else torch.zeros_like(r)
                              for r in self._rows]
        return self

    def _stage_rows(self) -> Dict[int, torch.Tensor]:
        """{stage: the row of the first position that holds it}; over
        several processes a stage's row comes from the process that owns
        that position (every process calls this)."""
        mesh = self.mesh
        firsts = {s: self._first_of_stage(s) for s in range(self.pp)}
        wants = [(s, mesh.process_of(p), k) for s, p in firsts.items()
                 for k in range(mesh.process_count)]
        like = self._rows[mesh.local[0]]
        got = collectives._swap(
            mesh, wants, lambda s: self._rows[firsts[s]],
            lambda s: (tuple(like.shape), like.dtype, like.device))
        return {s: self._rows[p] if mesh.is_local(p) else got[s]
                for s, p in firsts.items()}

    def params(self, cast: bool = True) -> Dict[str, torch.Tensor]:
        """The trained parameters, each sliced from its stage's row (the
        first position that holds the stage) and cast to its declared
        dtype; ``cast=False`` gives the float32 row values."""
        out = {}
        with torch.no_grad():
            rows = self._stage_rows()
        for s, metas in enumerate(self._param_meta):
            row = rows[s]
            for (n, shape, dtype, off) in metas:
                size = int(np.prod(shape)) if shape else 1
                v = row[off:off + size].reshape(shape)
                out[n] = (v.to(dtype) if cast else v).clone()
        return out

    def sync_scope(self, scope=None):
        """Write the trained packed parameters back to scope variables."""
        scope = scope or self.scope
        for n, v in self.params().items():
            scope.set(n, v)

    # ------------------------------------------------------------------
    def _stage_fn(self, s, micro_bs, act_len):
        """(flat_params [L], act_in [act_len] f32, feeds dict, ctx)
        -> act_out [act_len] f32 (last stage: the loss, an f32 scalar)."""
        info = self.stages[s]
        metas = self._param_meta[s]
        in_specs = [(n, self._var_shape(n, micro_bs), self._var_dtype(n))
                    for n in info.interface_in]
        out_names = None
        if s < self.pp - 1:
            out_names = list(self.stages[s + 1].interface_in)
            for n in out_names:  # a missing static shape raises here
                self._var_shape(n, micro_bs)

        def fn(flat, act_in, feeds, ctx):
            env = dict(feeds)
            for (n, shape, dtype, poff) in metas:
                size = int(np.prod(shape)) if shape else 1
                env[n] = flat[poff:poff + size].reshape(shape).to(dtype)
            off = 0
            for (n, shape, dtype) in in_specs:
                size = int(np.prod(shape))
                env[n] = act_in[off:off + size].reshape(shape).to(dtype)
                off += size
            _run_ops(info.ops, env, ctx)
            if out_names is None:
                return env[self.loss_name].to(torch.float32).reshape(())
            parts = [env[n].to(torch.float32).reshape(-1) for n in out_names]
            flat_out = torch.cat(parts) if parts else act_in.new_zeros((0,))
            return torch.nn.functional.pad(
                flat_out, (0, act_len - flat_out.shape[0]))

        return fn

    def _interface_len(self, micro_bs):
        best = 1
        for s in self.stages[1:]:
            tot = sum(int(np.prod(self._var_shape(n, micro_bs)))
                      for n in s.interface_in)
            best = max(best, tot)
        return best

    # ------------------------------------------------------------------
    def _compile(self, feed_shapes) -> _StepPlan:
        """The step plan for one feed-shape signature: the port has
        nothing to compile, so this is the stage functions at the
        dp-local microbatch and the hop buffer's length."""
        batch = next(iter(feed_shapes.values()))[0]
        micro_bs = batch // self.n_micro
        # pp×dp composition: a 'dp' mesh axis splits every microbatch
        # across dp members — same schedule per slice, gradients summed
        # over dp by an explicit psum
        if micro_bs % self.dp:
            raise ValueError(
                f"microbatch {micro_bs} not divisible by dp={self.dp}")
        local_bs = micro_bs // self.dp
        act_len = self._interface_len(local_bs)
        return _StepPlan([self._stage_fn(s, local_bs, act_len)
                          for s in range(self.pp)], act_len, local_bs)

    def _forward_backward(self, plan: _StepPlan, feeds_micro, step):
        """The schedule's loss (position 0's copy) after its backward;
        the rows' leaves carry their gradients."""
        mesh, pp, n_micro = self.mesh, self.pp, self.n_micro
        each = mesh.local_map
        lbs = plan.local_bs

        def feeds_of(p):
            d, dev = self._dp_of[p], mesh.device(p)
            return {k: v[:, d * lbs:(d + 1) * lbs].to(dev)
                    for k, v in feeds_micro.items()}

        local = each(feeds_of)
        leaves = each(lambda p: self._rows[p].detach().requires_grad_(True))
        fwd_perm = [(s, s + 1) for s in range(pp - 1)]
        buf = each(lambda p: torch.zeros((plan.act_len,),
                                         dtype=torch.float32,
                                         device=mesh.device(p)))
        losses = [[] for _ in range(mesh.size)]
        since = transport.mark(mesh.transport)
        for t in range(n_micro + pp - 1):
            ys = [None] * mesh.size
            for p in mesh.local:
                s = self._stage_of[p]
                micro = t - s
                if not 0 <= micro < n_micro:
                    ys[p] = torch.zeros_like(buf[p])
                    continue
                ctx = _TickContext(mesh.device(p), self.program, step, t,
                                   mesh, self._constants)
                y = plan.stage_fns[s](
                    leaves[p], buf[p],
                    {k: v[micro] for k, v in local[p].items()}, ctx)
                if s == pp - 1:
                    losses[p].append(y)
                    y = torch.zeros_like(buf[p])
                ys[p] = y
            buf = collectives.ppermute(ys, mesh, "pp", fwd_perm)
        # only the last stage holds losses; share them.  Under pp×dp each
        # member saw its local_bs slice: the mean over dp gives the global
        # batch mean
        vec = each(lambda p: torch.stack(losses[p])
                   if self._stage_of[p] == pp - 1
                   else torch.zeros((n_micro,), device=mesh.device(p)))
        loss = [None if v is None else v.mean()
                for v in collectives.psum(vec, mesh, "pp")]
        if self.dp > 1:
            loss = collectives.pmean(loss, mesh, "dp")
        return backward_once(mesh, loss, since), leaves

    def _update(self, leaves):
        each = self.mesh.local_map
        grads = each(lambda p: leaves[p].grad if leaves[p].grad is not None
                     else torch.zeros_like(leaves[p]))
        if self.dp > 1:
            grads = collectives.psum(grads, self.mesh, "dp")
        if self.opt_kind == "sgd":
            lr = self.opt_args[0]
            self._rows = each(lambda p: leaves[p].detach() - lr * grads[p])
        elif self.opt_kind == "momentum":
            lr, mu = self.opt_args
            self._velocity = each(lambda p: mu * self._velocity[p]
                                  + grads[p])
            self._rows = each(lambda p: leaves[p].detach()
                              - lr * self._velocity[p])

    # ------------------------------------------------------------------
    def run(self, feed: Dict[str, object], seed: Optional[int] = None):
        """One pipelined train step over `feed` (full batch on dim 0);
        returns the mean microbatch loss."""
        if self._rows is None:
            self.initialize()
        feeds_micro = {}
        shapes = {}
        for name, value in feed.items():
            t = value if isinstance(value, torch.Tensor) \
                else torch.as_tensor(np.asarray(value))
            if t.shape[0] % self.n_micro:
                raise ValueError(
                    f"feed {name!r} batch {t.shape[0]} not divisible by "
                    f"n_micro {self.n_micro}")
            v = self.block._find_var_recursive(name)
            if v is not None and v.dtype is not None:
                t = t.to(torch_dtype(v.dtype))
            shapes[name] = tuple(t.shape)
            feeds_micro[name] = t.reshape(
                (self.n_micro, t.shape[0] // self.n_micro)
                + tuple(t.shape[1:]))
        # one step plan per feed-shape signature (micro_bs / act_len are
        # baked into the stage functions)
        sig = tuple(sorted(shapes.items()))
        plan = self._step_fns.get(sig)
        if plan is None:
            plan = self._compile(shapes)
            self._step_fns[sig] = plan
        step = self._step if seed is None else int(seed)
        self._step += 1
        with torch.enable_grad():
            loss, leaves = self._forward_backward(plan, feeds_micro, step)
        with torch.no_grad():
            self._update(leaves)
        return float(loss)
