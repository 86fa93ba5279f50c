"""Executor: runs one block of a Program eagerly, op by op, on one device.

The JAX package traces a whole block into one XLA computation
(``paddle_tpu/framework/executor.py``); here each op's torch emitter runs
in turn (modelled on its ``_lower_op``), threading a name → tensor
environment.  Inputs come from the feeds (a ragged feed is padded and
gains its ``@LENGTH`` companion), from earlier ops of the block, or from
the scope.  The block's written state — every persistable output, and
every name read from the scope before an op writes it, as the JAX
package's ``analysis/dataflow.state_classes`` classifies them — is
written back to the scope BY REFERENCE: an op that updates a pool in
place hands back the same tensor, so a KV pool is never copied.  An op
whose outputs nothing needs is skipped (``live_ops``): XLA drops such ops
from the JAX package's compiled step, and the fusion pass relies on it
for the batch-norm / ReLU chains whose only reader it replaced.  The
walk runs under
``torch.no_grad()``; only a ``generic_grad`` op turns autograd on, for its
own re-run of the forward op.  An output slot that an op's registry entry
lists as ``unwritten_outputs`` is bound to nothing, and a grad op of it
gets None there; any other name that nothing gives still raises.  A block
that holds grad ops runs with ``is_test`` false.

``run(steps_per_dispatch=K)`` runs K steps a dispatch
(``framework/step_loop.py``): on the card, one replay of a captured CUDA
graph after a first, eager dispatch; on the CPU, K steps in sequence.
``block_id`` picks the block, ``rng_step`` pins the step the random ops'
generators are seeded with, ``check_nan_inf`` scans every fetch and
written value for non-finite numbers, and ``verify=True`` (or
PADDLE_TPU_VERIFY=1 when `verify` is None) runs the static program
verifier (``analysis/verifier.py``) first: errors raise
``VerificationError``, warnings are logged, once a program version and
feed/fetch set.

Telemetry (``observability``): each run counts into
``executor_steps_total`` and opens the JAX executor's spans where the
port has the phase — ``executor.execute`` (the op walk, or a graph
replay), ``executor.writeback`` (state back to the scope) and, for a
K-step dispatch, ``executor.compile`` (the CUDA-graph capture).  A
tracked program (``observability.accounting.track``) reports each run's
time to ``accounting.on_step``, read after a device synchronize on the
card.  With op attribution on, each op runs inside its
``observability.attribution.op_scope`` profiler range.  Block 0 picks up
a stored autotune winner for the program (``autotune.integration``).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..analysis.dataflow import state_classes
from ..autotune import knobs
from ..autotune.integration import maybe_apply_program_winner
from ..observability import accounting as _acct
from ..observability import span as _span
from ..observability.attribution import op_scope
from ..observability.metrics import REGISTRY as _MET, monotime as _monotime
from ..lod import LENGTH_SUFFIX, as_lod_tensor, is_lod_feed
from ..ops.registry import EmitContext, get_op_info, unbound_slots
from .core import GRAD_SUFFIX, Program, default_main_program, torch_dtype
from .place import Place, default_place
from .scope import Scope, global_scope, to_numpy
from . import step_loop

logger = logging.getLogger(__name__)

# counter handle resolved once (families survive REGISTRY.reset()): it
# sits on the per-run hot path
_MET_STEPS = _MET.counter("executor_steps_total",
                          "completed Executor.run invocations")


class OpLoweringError(RuntimeError):
    """An op's emitter failed; the message names the op and its vars."""


def _fetch_name(f) -> str:
    return f if isinstance(f, str) else f.name


def live_ops(block, fetch_names) -> list:
    """Which ops of `block` a run with `fetch_names` needs, one bool per op:
    an op is live when it writes the block's written state (``written``,
    which the run writes back to the scope), a name that a later live op
    reads or the caller fetches, or nothing.  Computed backward from the
    end, so a dead chain goes as a whole; a name is never struck from the
    needed set when an op redefines it, which keeps, never drops, an op in
    doubt.  The state is classified without the feeds, so a fed name that
    an op rewrites also keeps its writer."""
    needed = set(fetch_names) | set(written(block))
    live = [False] * len(block.ops)
    for i in range(len(block.ops) - 1, -1, -1):
        op = block.ops[i]
        outs = [n for n in op.output_names() if n]
        if not outs or any(n in needed for n in outs):
            live[i] = True
            needed.update(n for n in op.input_names() if n)
    return live


def written(block, feed_names=()) -> list:
    """The names a run of `block` writes back to the scope: the
    reference's written state (persistable outputs, and names read from
    the scope before an op writes them)."""
    return state_classes(block, feed_names)[2]


def _stack(per_step, fetch_every, return_numpy):
    """K steps' fetch lists as the fused dispatch returns them."""
    if fetch_every == "last":
        return per_step[-1]
    stack = np.stack if return_numpy else torch.stack
    return [stack([outs[j] for outs in per_step])
            for j in range(len(per_step[0]))]


class Executor:
    """fluid.Executor: ``run(program, feed, fetch_list, scope,
    return_numpy, block_id, verify, rng_step, steps_per_dispatch,
    fetch_every)``.  ``place=None`` means ``default_place()`` — the card.
    ``close()`` releases the captured step loops."""

    def __init__(self, place: Optional[Place] = None):
        self.place = place if place is not None else default_place()
        self.device = self.place.device
        self._step = 0
        # FLAGS_check_nan_inf analog: scan fetches and written state
        self.check_nan_inf = False
        # K-step dispatches are captured as CUDA graphs on the card
        self._captures = self.device.type == "cuda"
        # step_loop.loop_key → step_loop.LoopEntry
        self._loops: Dict[tuple, step_loop.LoopEntry] = {}
        # the memory pool this executor's graphs share, from the first
        # capture until close()
        self._graph_pool = None
        # (op index, op type) being walked, for capture errors
        self._walking = None
        # EmitContext.constants: ops' constants uploaded once, until close()
        self._constants = {}
        # (program token, version, block, feeds, fetches) verified clean
        self._verified = set()
        # (program token, version, block, feed names) run once already:
        # a first run pays kernel builds and uploads (accounting's
        # "compiled" runs)
        self._warm = set()

    @property
    def global_step(self) -> int:
        """Monotonic run counter — the default step the random ops'
        generators are seeded with."""
        return self._step

    def snapshot_state(self) -> dict:
        """JSON-serializable executor state for trainer checkpoints."""
        return {"step": int(self._step)}

    def restore_state(self, state: dict):
        """Inverse of snapshot_state — the checkpoint/resume hook."""
        self._step = int(state.get("step", 0))

    def run(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict[str, object]] = None,
        fetch_list: Optional[Sequence] = None,
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
        block_id: int = 0,
        verify: Optional[bool] = None,
        rng_step: Optional[int] = None,
        steps_per_dispatch: Optional[int] = None,
        fetch_every: str = "all",
    ):
        """One step of `program.blocks[block_id]`, or K with
        ``steps_per_dispatch=K`` (None reads
        PADDLE_TPU_STEPS_PER_DISPATCH): every feed is stacked (K, ...),
        fetches come back stacked (K, ...) (``fetch_every="all"``) or the
        last step's only (``"last"``), the written state is the value
        after K steps, and `rng_step`, which otherwise pins this step's
        generator seed, pins the first step's.  `verify`: run the static
        program verifier first (None reads PADDLE_TPU_VERIFY)."""
        if steps_per_dispatch is None:
            steps_per_dispatch = knobs.steps_per_dispatch(default=1,
                                                          store=False)
        k = int(steps_per_dispatch)
        if k < 1:
            raise ValueError(f"steps_per_dispatch={k} must be >= 1")
        if verify is None:
            from ..analysis.verifier import env_verify_enabled

            verify = env_verify_enabled()
        if verify:
            self._verify_program(
                program if program is not None else default_main_program(),
                block_id, sorted(feed or {}),
                [_fetch_name(f) for f in (fetch_list or [])])
        if k > 1:
            return self._run_loop(program, feed, fetch_list, scope,
                                  return_numpy, block_id, rng_step, k,
                                  fetch_every)
        program = program if program is not None else default_main_program()
        feed = feed or {}
        fetch_names = [_fetch_name(f) for f in (fetch_list or [])]
        scope = scope if scope is not None else global_scope()
        block = program.blocks[block_id]
        if block_id == 0:
            # a stored `tune` winner for this exact program + feeds
            # re-applies its desc-level decisions (one memoized lookup
            # per program version)
            maybe_apply_program_winner(program, feed)
        timed = _acct.needs_sync(program)
        if timed:
            self._sync()
        t_run0 = _monotime()

        env = {}
        for name, value in feed.items():
            env.update(self._feed_tensor(block, name, value))
        feed_names = list(env)
        warm_key = (program._cache_token, program._version, block_id,
                    tuple(sorted(feed_names)))
        first = warm_key not in self._warm
        self._warm.add(warm_key)
        is_test = not any(op.type.endswith("_grad") for op in block.ops)
        ctx = EmitContext(self.device, is_test=is_test, program=program,
                          step=self._step if rng_step is None
                          else int(rng_step), constants=self._constants)
        self._step += 1
        with _span("executor.execute", cache_hit=not first,
                   ops=len(block.ops)):
            self._walk(block, env, fetch_names, scope, ctx)
        new_state = {n: env[n] for n in written(block, feed_names)
                     if n in env}
        with _span("executor.writeback", written=len(new_state)):
            for n, v in new_state.items():
                scope.set(n, v)
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError(f"fetch targets {missing} were not computed")
        fetches = {n: env[n] for n in fetch_names}
        if self.check_nan_inf:
            self._check_finite({**fetches, **new_state})
        _MET_STEPS.inc()
        if timed:
            self._sync()
            _acct.on_step(program, _monotime() - t_run0, first)
        if return_numpy:
            return [to_numpy(fetches[n]) for n in fetch_names]
        return [fetches[n] for n in fetch_names]

    def _sync(self):
        """Wait for the card's work (the accounting clock's edges)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _verify_program(self, program, block_id, feed_names, fetch_names):
        """Static pre-execution check: errors raise, warnings are logged.
        One verification per (program version, feed/fetch set)."""
        key = (program._cache_token, program._version, block_id,
               tuple(feed_names), tuple(fetch_names))
        if key in self._verified:
            return
        from ..analysis.verifier import verify_program

        # no fetches this call -> no fetch CONTEXT: [] would make the
        # dead-op rule treat every unfetched terminal op as dead weight
        report = verify_program(program, feed_names=feed_names,
                                fetch_names=fetch_names or None,
                                block_id=block_id)
        for f in report.warnings:
            logger.warning("program verifier: %s", f.format())
        report.raise_if_errors("Executor.run")
        # a version bump obsoletes older entries for the same program
        for old in [k for k in self._verified
                    if k[0] == program._cache_token
                    and k[1] != program._version]:
            self._verified.discard(old)
        self._verified.add(key)

    def _walk(self, block, env, fetch_names, scope, ctx):
        """Run the live ops of `block` in order on `env`, reading from the
        scope what no feed or earlier op gave.  A control-flow op runs its
        nested blocks through ``ctx.lower_block``."""
        ctx.lower_block = lambda idx, sub_env: self._lower_block(
            ctx, idx, sub_env)
        live = live_ops(block, fetch_names)
        with torch.no_grad():
            for i, (op, keep) in enumerate(zip(block.ops, live)):
                if not keep:
                    continue
                self._walking = (i, op.type)
                skip = unbound_slots(op)
                for slot, names in op.inputs.items():
                    for n in names:
                        if n and n not in env and slot not in skip:
                            env[n] = self._read_state(scope, block, n)
                self._run_op(op, env, ctx)

    def _lower_block(self, ctx, idx, env):
        """Run EVERY op of ``ctx.program.blocks[idx]`` in order on `env`,
        as the JAX package's ``_lower_ops`` traces a sub-block: no
        pruning and no reads from the scope — a control-flow op hands in
        its externals and carries, and a name missing from `env` raises
        (``OpLoweringError`` naming the op)."""
        for op in ctx.program.blocks[idx].ops:
            skip = unbound_slots(op)
            missing = [n for slot, names in op.inputs.items()
                       if slot not in skip for n in names
                       if n and n not in env]
            if missing:
                raise OpLoweringError(
                    f"op {op.type!r} of block {idx} reads {missing}, which "
                    f"neither an earlier op of the block nor its "
                    f"control-flow op's inputs give")
            self._run_op(op, env, ctx)
        return env

    def _check_finite(self, values):
        for n, v in values.items():
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                raise FloatingPointError(
                    f"non-finite values in {n!r} after step {self._step}")

    def _run_loop(self, program, feed, fetch_list, scope, return_numpy,
                  block_id, rng_step, k, fetch_every):
        """K steps a dispatch (framework/step_loop.py): on the card the
        first dispatch of a key runs eagerly and the next captures the K
        steps as one CUDA graph, which every later dispatch replays; on
        the CPU the K steps run in sequence.  Loop-unsafe blocks run K
        sequential steps on either, loudly."""
        if fetch_every not in step_loop.FETCH_MODES:
            raise ValueError(f"fetch_every={fetch_every!r}: use one of "
                             f"{step_loop.FETCH_MODES}")
        program = program if program is not None else default_main_program()
        feed = {n: v if isinstance(v, torch.Tensor) else np.asarray(v)
                for n, v in (feed or {}).items()}
        fetch_names = [_fetch_name(f) for f in (fetch_list or [])]
        scope = scope if scope is not None else global_scope()
        step_loop.check_stacked(feed, k)

        def sequential():
            return _stack([self.run(
                program, feed_i, fetch_list, scope,
                return_numpy=return_numpy, block_id=block_id, verify=False,
                steps_per_dispatch=1,
                rng_step=None if rng_step is None else int(rng_step) + i)
                for i, feed_i in enumerate(step_loop.split_feeds(feed, k))],
                fetch_every, return_numpy)

        self._drop_stale(program)
        key = step_loop.loop_key(program, block_id, scope, feed, fetch_names,
                                 k, fetch_every, self.device)
        entry = self._loops.get(key)
        first = entry is None
        if first:  # the next dispatch of this key captures
            entry = self._loops[key] = step_loop.LoopEntry(
                step_loop.safety_report(program, block_id,
                                        self._loop_transport()))
        if not entry.safety["safe"]:
            step_loop.warn_unsafe(k, entry.safety)
            return sequential()
        if first or not self._captures:
            return sequential()
        if block_id == 0:
            maybe_apply_program_winner(program, feed)
        timed = _acct.needs_sync(program)
        if timed:
            self._sync()
        t_run0 = _monotime()
        captured_now = entry.loop is None
        if captured_now:
            with _span("executor.compile",
                       ops=len(program.blocks[block_id].ops), loop_k=k):
                entry.loop = step_loop.CapturedLoop.capture(
                    self, program, program.blocks[block_id], feed,
                    fetch_names, scope, k, fetch_every,
                    self._step if rng_step is None else int(rng_step))
        loop = entry.loop
        with _span("executor.execute", cache_hit=not captured_now,
                   loop_k=k):
            fetches = loop.replay(feed, scope)
        self._step += k
        _MET_STEPS.inc()
        if timed:
            self._sync()
            _acct.on_step(program, _monotime() - t_run0, captured_now)
        if self.check_nan_inf:
            self._check_finite({**fetches, **loop.written_state()})
        if return_numpy:
            return [to_numpy(fetches[n]) for n in fetch_names]
        return [fetches[n].clone() for n in fetch_names]

    def _loop_transport(self):
        """The exchange between processes a step runs (none for one
        process; a mesh executor's is its mesh's)."""
        return None

    def _drop_stale(self, program):
        """Release the entries (loops and verdicts) of an older version of
        `program`."""
        for key in [key for key in self._loops
                    if key[0] == program._cache_token
                    and key[1] != program._version]:
            self._loops.pop(key).close()

    def close(self):
        """Release every captured step loop, the graphs' shared memory
        pool and the uploaded constants.  The scope keeps its entries; the
        executor stays usable and captures again on demand."""
        for entry in self._loops.values():
            entry.close()
        self._loops.clear()
        self._graph_pool = None
        self._constants.clear()

    def _feed_tensor(self, block, name, value) -> Dict[str, torch.Tensor]:
        """One feed as name → tensor on the executor's device, in the
        declared dtype.  A ragged feed (a LoDTensor, or a list of
        sequences) for a ``lod_level > 0`` variable becomes the
        bucket-padded dense tensor plus its int32 ``<name>@LENGTH``
        companion."""
        var = block.var(name) if block.has_var(name) else None
        dt = torch_dtype(var.dtype) if var is not None and var.dtype else None
        if isinstance(value, torch.Tensor):
            return {name: value.to(device=self.device, dtype=dt)}
        if var is not None and var.lod_level > 0 and is_lod_feed(value):
            padded, lengths = as_lod_tensor(value).to_padded(bucket=True)
            return {
                name: torch.as_tensor(padded).to(device=self.device,
                                                 dtype=dt),
                name + LENGTH_SUFFIX: torch.as_tensor(lengths).to(
                    self.device)}
        t = torch.as_tensor(np.asarray(value))
        return {name: t.to(device=self.device, dtype=dt)}

    def _read_state(self, scope, block, name) -> torch.Tensor:
        v = scope.find(name)
        if v is None:
            bvar = block._find_var_recursive(name)
            if bvar is not None and bvar.is_data:
                raise RuntimeError(
                    f"data variable {name!r} was not fed — add it to `feed`")
            raise RuntimeError(
                f"variable {name!r} used before initialization — run the "
                f"startup program first (fluid semantics)")
        if v.device != self.device:
            # once: the moved tensor replaces the scope entry
            v = v.to(self.device)
            scope.set(name, v)
        return v

    @staticmethod
    def _run_op(op, env, ctx):
        info = get_op_info(op.type)
        skip = unbound_slots(op)
        ins = {slot: [env[n] if n and slot not in skip else None
                      for n in names]
               for slot, names in op.inputs.items()}
        attrs = op.attrs
        if op.type == "generic_grad":
            # the grad op's requested outputs: (forward input slot, index)
            attrs = dict(op.attrs)
            attrs["__wanted__"] = {
                (slot[: -len(GRAD_SUFFIX)], i)
                for slot, names in op.outputs.items()
                for i, n in enumerate(names) if n}
        try:
            with op_scope(op):
                outs = info.emit(ctx, ins, attrs)
        except Exception as e:
            in_names = {s: list(ns) for s, ns in op.inputs.items() if ns}
            out_names = {s: list(ns) for s, ns in op.outputs.items() if ns}
            raise OpLoweringError(
                f"error running op {op.type!r} (inputs={in_names}, "
                f"outputs={out_names}): {type(e).__name__}: {e}") from e
        for slot, names in op.outputs.items():
            vals = outs.get(slot, []) if outs else []
            for i, n in enumerate(names):
                if n and i < len(vals) and vals[i] is not None:
                    env[n] = vals[i]
