"""K training steps a dispatch: ``Executor.run(steps_per_dispatch=K)``.

The port of ``paddle_tpu/framework/step_loop.py``.  There, one dispatch
is a ``lax.scan`` over a leading-stacked feed block with the state carry
resident on the device.  Here, on the card, it is one CUDA graph that
holds K captured steps:

- the first dispatch of a key (``loop_key``) runs the K steps eagerly,
  one ``run()`` each: that is the call's result, and it is the warm-up a
  capture needs (the kernels are built and their attributes set, cuBLAS
  has its handles and workspace, ``generic_grad``'s autograd has run);
- the second captures the K steps (``CapturedLoop.capture``) and every
  dispatch from then on replays them (``CapturedLoop.replay``).

Inside the graph, step i reads slice i of static (K, ...) feed buffers
and the carry, runs the block's live ops, and hands its written state to
step i + 1 as the carry, as the scan does: there is no write-back per
step.  Each step's fetches are copied into static (K, ...) buffers (the
last step's only, under ``fetch_every="last"``).  After step K the final
written state is copied into the static state buffers, which are the
scope's entries: one copy a dispatch, not one a step.

A key names the scope, so a loop only ever trains the scope it was
captured for, and each loop owns its state buffers (clones of the scope's
entries at capture): no two loops, scopes or names share one.  An
executor's graphs share one memory pool: they replay one at a time on
one stream, none reads another's pool memory (feeds and state lie outside
it) and a dispatch's fetches are read out before the next replay.

On the CPU there is no graph: the same call runs the K steps in sequence
and returns the same stacked shapes.  The only other eager route for
K > 1 is the loud one: a block that ``safety_report`` finds unsafe runs
K sequential steps after ``warn_unsafe``.  A capture or replay error
raises, naming the op being walked; it is never retried eagerly.
"""

from __future__ import annotations

import warnings
from typing import Dict, List

import numpy as np
import torch

# fetch_every modes: "all" stacks every step's fetches (K, ...); "last"
# returns only the final step's
FETCH_MODES = ("all", "last")

# op types a fused loop cannot contain: `save` writes host files after
# every step (the write-back is once a dispatch), `load` reads its file
# once where the sequential path reads it every run, and the sub-block
# control-flow ops (but `recompute`) carry data-dependent trip counts and
# shapes
_HOST_IO_TYPES = ("save", "load")


def _draws_rng(op) -> bool:
    """Whether `op` (or the forward op a ``generic_grad`` re-runs) draws
    from ``EmitContext.generator``, as its registration declares."""
    from ..ops.registry import get_op_info, has_op

    return any(has_op(t) and get_op_info(t).draws_rng
               for t in (op.type, op.attrs.get("__fwd_type__")) if t)


def safety_report(program, block_id: int = 0) -> dict:
    """Static loop-safety verdict for one block, from descs alone.

    Returns ``{"safe": bool, "reasons": [str, ...]}``.  Unsafe programs
    make ``Executor.run(steps_per_dispatch=K)`` fall back LOUDLY to K
    sequential steps (same results, none of the overhead amortization).
    Besides the JAX package's reasons (host I/O, nested blocks), two are
    the port's own: an op that draws from ``EmitContext.generator`` (that
    generator is seeded on the host from (seed, step, uid), so a graph
    would replay one step's draws K times), and a ``print`` op, which
    reads its tensor on the host (``jax.debug.print`` runs inside the
    JAX package's compiled loop; a graph would print nothing).  One
    nested block is safe: a ``recompute`` segment (and the re-run of it
    in its ``generic_grad``) is straight-line, so it passes when its
    sub-block's ops pass the same checks, recursively; its reasons name
    the ops inside."""
    reasons = _unsafe_ops(program, block_id)
    return {"safe": not reasons, "reasons": reasons}


def _recompute_block(op):
    """The sub-block a ``recompute`` op, or the ``generic_grad`` that
    re-runs one, runs; else None."""
    if op.type == "recompute":
        return int(op.attrs["sub_block"])
    if op.attrs.get("__fwd_type__") == "recompute":
        return int(op.attrs["__fwd_attrs__"]["sub_block"])
    return None


def _unsafe_ops(program, block_id, where="") -> List[str]:
    from ..analysis import dataflow

    reasons: List[str] = []
    for i, op in enumerate(program.blocks[block_id].ops):
        at = f"{where}op #{i}"
        sub = _recompute_block(op)
        if sub is not None:
            what = "'recompute'" if op.type == "recompute" \
                else f"{op.type!r} of 'recompute'"
            reasons += _unsafe_ops(program, sub,
                                   f"{at} {what} (block {sub}) > ")
        elif op.type in _HOST_IO_TYPES:
            reasons.append(
                f"{at} {op.type!r}: host file I/O cannot ride a "
                f"device-resident loop")
        elif dataflow.sub_block_indices(op):
            reasons.append(
                f"{at} {op.type!r}: nested control-flow block "
                f"(data-dependent trip count/shape)")
        elif op.type == "print":
            reasons.append(
                f"{at} 'print': reads its tensor on the host each step "
                f"(a captured loop would print nothing)")
        elif _draws_rng(op):
            what = repr(op.type) if op.type != "generic_grad" \
                else f"'generic_grad' of {op.attrs['__fwd_type__']!r}"
            reasons.append(
                f"{at} {what}: draws from a generator seeded on "
                f"the host each step (a captured loop would replay one "
                f"step's draws)")
    return reasons


def warn_unsafe(k: int, report: dict):
    """The loud part of the loud fallback."""
    head = "; ".join(report["reasons"][:3])
    more = len(report["reasons"]) - 3
    if more > 0:
        head += f"; +{more} more"
    warnings.warn(
        f"steps_per_dispatch={k} requested but the program is "
        f"loop-unsafe ({head}) — falling back to {k} sequential "
        f"dispatches (correct, but the per-dispatch overhead is not "
        f"amortized)", stacklevel=3)


def split_feeds(feeds: Dict[str, object], k: int) -> List[dict]:
    """Per-step feed dicts from a leading-stacked block (the sequential
    route's slicer)."""
    return [{n: v[i] for n, v in feeds.items()} for i in range(k)]


def check_stacked(feeds: Dict[str, object], k: int):
    """Every feed in a fused dispatch must carry the K leading dim."""
    for n, v in feeds.items():
        shape = getattr(v, "shape", None)
        if not shape or int(shape[0]) != k:
            raise ValueError(
                f"steps_per_dispatch={k}: feed {n!r} must be stacked "
                f"with leading dim {k} (one slice per step), got shape "
                f"{tuple(shape) if shape else shape} — stack K batches "
                f"(reader.decorator.prefetch does this) or drop "
                f"steps_per_dispatch")


def loop_key(program, block_id, scope, feeds, fetch_names, k, fetch_every,
             device) -> tuple:
    """What a captured dispatch is keyed by: the program's token and
    version, the block, the scope's token, each feed's (name, shape,
    dtype) — numpy and torch values of one dtype sign alike — the
    fetches, K, the fetch mode and the device."""
    from .core import canonical_dtype

    feed_sig = tuple((n, tuple(int(s) for s in v.shape),
                      canonical_dtype(v.dtype))
                     for n, v in sorted(feeds.items()))
    return (program._cache_token, program._version, block_id,
            scope._cache_token, feed_sig, tuple(fetch_names), k, fetch_every,
            str(device))


class LoopEntry:
    """An executor's cache entry for one ``loop_key``: the block's
    ``safety_report``, taken at the key's first dispatch, and the
    ``CapturedLoop`` from the key's second dispatch on (card only)."""

    def __init__(self, safety: dict):
        self.safety = safety
        self.loop = None

    def close(self):
        if self.loop is not None:
            self.loop.close()
            self.loop = None


class StepLoopError(RuntimeError):
    """A captured step loop failed to capture or replay; the message names
    the step and the op being walked."""


class CapturedLoop:
    """K steps of one block as one CUDA graph with static feed, state and
    fetch buffers.  Build with ``capture``; ``replay`` runs a dispatch;
    ``close`` releases the graph and its private memory pool."""

    def __init__(self, k, fetch_every, fetch_names):
        self.k = k
        self.fetch_every = fetch_every
        self.fetch_names = list(fetch_names)
        self.graph = None
        self.feeds: Dict[str, torch.Tensor] = {}    # (K, ...) on the card
        self.staging: Dict[str, torch.Tensor] = {}  # pinned host copies
        self.staged = None  # event after the last host-to-card feed copy
        self.state: Dict[str, torch.Tensor] = {}    # the scope's entries
        self.writes: List[str] = []
        self.fetches: Dict[str, torch.Tensor] = {}
        self.at_step = None  # the step being recorded, for errors

    @classmethod
    def prepare(cls, exe, program, block, feeds, fetch_names, scope, k,
                fetch_every, step0):
        """The loop's plan and static buffers, from the scope's current
        state; no kernel but the state's clones runs.  `feeds` give the
        feed buffers' shapes and dtypes only.  The state the live ops read
        or write is cloned into the static state buffers, which become the
        scope's entries: a buffer the loop writes in place is shared with
        no other loop, scope or name."""
        from .executor import live_ops, written

        loop = cls(k, fetch_every, fetch_names)
        loop.program, loop.block, loop.step0 = program, block, step0
        loop.is_test = not any(op.type.endswith("_grad") for op in block.ops)
        feed_names = list(feeds)
        live = [op for op, keep in zip(block.ops,
                                       live_ops(block, fetch_names)) if keep]
        produced, reads = set(feed_names), []
        for op in live:
            for n in op.input_names():
                if n and n not in produced and n not in reads:
                    reads.append(n)
            produced.update(n for n in op.output_names() if n)
        loop.writes = [n for n in written(block, feed_names)
                       if n in produced]
        # written-only state is in the scope too: the eager dispatch that
        # precedes a capture wrote it
        for n in reads + [n for n in loop.writes if n not in reads]:
            loop.state[n] = exe._read_state(scope, block, n).clone()
            scope.set(n, loop.state[n])
        for n, v in feeds.items():
            var = block.var(n) if block.has_var(n) else None
            loop.feeds[n] = torch.empty(tuple(v.shape),
                                        dtype=_feed_dtype(var, v),
                                        device=exe.device)
        return loop

    @classmethod
    def capture(cls, exe, program, block, feeds, fetch_names, scope, k,
                fetch_every, step0):
        """``prepare``, then record the K steps into one CUDA graph."""
        loop = cls.prepare(exe, program, block, feeds, fetch_names, scope, k,
                           fetch_every, step0)
        loop.graph = loop.record_graph(exe)
        return loop

    def record_graph(self, exe):
        """``record`` inside ``torch.cuda.graph``, in the pool the
        executor's graphs share (``exe._graph_pool``)."""
        torch.cuda.synchronize(exe.device)
        if exe._graph_pool is None:
            exe._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=exe._graph_pool,
                                  capture_error_mode="thread_local"):
                self.record(exe)
        except Exception as e:
            # a broken capture can leave its pool marked as recording:
            # later captures take a new one
            exe._graph_pool = None
            if isinstance(e, StepLoopError):
                raise
            if isinstance(e.__context__, StepLoopError):
                # the capture's end raised over record's own error
                raise e.__context__ from e
            raise StepLoopError(
                f"CUDA graph capture of {self.k} steps broke at "
                f"{self.where(exe)}: {type(e).__name__}: {e}") from e
        return graph

    def where(self, exe) -> str:
        """The step and op being walked, for an error message."""
        if self.at_step is None:
            return "the end of the loop (the final state copies)"
        if exe._walking is None:
            return f"step {self.at_step} of {self.k}, before its first op"
        i, op_type = exe._walking
        return f"step {self.at_step} of {self.k}, op #{i} {op_type!r}"

    def record(self, exe):
        """The graph's body: K steps on the static buffers, each step's
        written state the next one's carry, the fetches copied out, the
        final written state copied into the state buffers.  Inside
        ``torch.cuda.graph`` this records the steps; outside it runs them
        (the CPU tests hold that against K ``run()`` calls).  An error
        names the step and op being walked."""
        from ..ops.registry import EmitContext

        k = self.k
        carry = dict(self.state)
        exe._walking = None
        try:
            for i in range(k):
                self.at_step = i
                env = dict(carry)
                env.update({n: buf[i] for n, buf in self.feeds.items()})
                ctx = EmitContext(exe.device, is_test=self.is_test,
                                  program=self.program, step=self.step0 + i,
                                  constants=exe._constants)
                exe._walk(self.block, env, self.fetch_names, None, ctx)
                missing = [n for n in self.fetch_names if n not in env]
                if missing:
                    raise KeyError(
                        f"fetch targets {missing} were not computed")
                for n in self.fetch_names:
                    v = env[n]
                    if self.fetch_every == "all":
                        if i == 0:
                            self.fetches[n] = torch.empty(
                                (k,) + tuple(v.shape), dtype=v.dtype,
                                device=v.device)
                        self.fetches[n][i].copy_(v)
                    elif i == k - 1:
                        self.fetches[n] = v.clone()
                carry.update({n: env[n] for n in self.writes if n in env})
        except Exception as e:
            raise StepLoopError(
                f"step loop of {k} steps broke at {self.where(exe)}: "
                f"{type(e).__name__}: {e}") from e
        self.at_step = None
        # a final value that lies in any static buffer is copied out first:
        # the copies below would otherwise overwrite it before it is read
        owned = {t.untyped_storage().data_ptr() for t in self.state.values()}
        final = {}
        for n in self.writes:
            v, buf = carry[n], self.state[n]
            if v is buf:
                continue
            if v.shape != buf.shape or v.dtype != buf.dtype:
                raise StepLoopError(
                    f"written state {n!r} changes from {tuple(buf.shape)} "
                    f"{buf.dtype} to {tuple(v.shape)} {v.dtype} in a step")
            if v.untyped_storage().data_ptr() in owned:
                v = v.clone()
            final[n] = v
        for n, v in final.items():
            self.state[n].copy_(v)

    def load_feeds(self, feeds):
        """Copy a dispatch's feeds into the static buffers: a card tensor
        by ``copy_``, anything else through pinned host memory."""
        if self.staged is not None:
            self.staged.synchronize()  # the last copy out of staging is done
        host = False
        for n, v in feeds.items():
            buf = self.feeds[n]
            if isinstance(v, torch.Tensor) and v.device.type == "cuda":
                buf.copy_(v)
                continue
            src = v if isinstance(v, torch.Tensor) \
                else torch.from_numpy(np.ascontiguousarray(v))
            if buf.device.type != "cuda":
                buf.copy_(src)
                continue
            stage = self.staging.get(n)
            if stage is None or stage.dtype != src.dtype:
                stage = torch.empty(tuple(src.shape), dtype=src.dtype,
                                    pin_memory=True)
                self.staging[n] = stage
            stage.copy_(src)
            buf.copy_(stage, non_blocking=True)
            host = True
        if host:
            self.staged = torch.cuda.Event()
            self.staged.record()

    def adopt_state(self, scope):
        """Point the scope back at the static state buffers: whatever
        replaced an entry since the capture (an eager ``run()``,
        ``Scope.set``, another program on the scope) is copied in first,
        or the replay would train on stale values."""
        for n, buf in self.state.items():
            cur = scope.find(n)
            if cur is buf:
                continue
            if cur is None:
                raise RuntimeError(
                    f"variable {n!r} used before initialization — run the "
                    f"startup program first (fluid semantics)")
            if tuple(cur.shape) != tuple(buf.shape):
                raise StepLoopError(
                    f"scope entry {n!r} has shape {tuple(cur.shape)}, the "
                    f"captured loop's buffer {tuple(buf.shape)}")
            buf.copy_(cur)
            scope.set(n, buf)

    def replay(self, feeds, scope):
        """One dispatch: feeds in, the scope's state checked by identity,
        one replay.  Returns the static fetch buffers by name; the next
        replay overwrites them."""
        self.load_feeds(feeds)
        self.adopt_state(scope)
        try:
            self.graph.replay()
        except Exception as e:
            raise StepLoopError(
                f"CUDA graph replay of {self.k} steps failed: "
                f"{type(e).__name__}: {e}") from e
        return self.fetches

    def written_state(self) -> Dict[str, torch.Tensor]:
        return {n: self.state[n] for n in self.writes}

    def close(self):
        """Release the graph (its share of the executor's pool) and the
        static buffers (the scope keeps its entries)."""
        self.graph = None
        self.feeds.clear()
        self.staging.clear()
        self.fetches.clear()
        self.state.clear()
        self.staged = None


def _feed_dtype(var, value) -> torch.dtype:
    """A feed buffer's dtype: the variable's declared dtype, else the
    value's own."""
    from .core import canonical_dtype, torch_dtype

    if var is not None and var.dtype:
        return torch_dtype(var.dtype)
    return torch_dtype(canonical_dtype(value.dtype))
