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
own re-run of the forward op.  A block that holds grad ops runs with
``is_test`` false.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..analysis.dataflow import state_classes
from ..lod import LENGTH_SUFFIX, as_lod_tensor, is_lod_feed
from ..ops.registry import EmitContext, get_op_info
from .core import GRAD_SUFFIX, Program, default_main_program, torch_dtype
from .place import Place, default_place
from .scope import Scope, global_scope, to_numpy


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


class Executor:
    """fluid.Executor: ``run(program, feed, fetch_list, scope,
    return_numpy)``.  ``place=None`` means ``default_place()`` — the card."""

    def __init__(self, place: Optional[Place] = None):
        self.place = place if place is not None else default_place()
        self.device = self.place.device
        self._step = 0

    def run(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict[str, object]] = None,
        fetch_list: Optional[Sequence] = None,
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
    ):
        program = program if program is not None else default_main_program()
        feed = feed or {}
        fetch_names = [_fetch_name(f) for f in (fetch_list or [])]
        scope = scope if scope is not None else global_scope()
        block = program.global_block()

        env = {}
        for name, value in feed.items():
            env.update(self._feed_tensor(block, name, value))
        feed_names = list(env)
        is_test = not any(op.type.endswith("_grad") for op in block.ops)
        ctx = EmitContext(self.device, is_test=is_test, program=program,
                          step=self._step)
        self._step += 1
        live = live_ops(block, fetch_names)
        with torch.no_grad():
            for op in (op for op, keep in zip(block.ops, live) if keep):
                for n in op.input_names():
                    if n and n not in env:
                        env[n] = self._read_state(scope, block, n)
                self._run_op(op, env, ctx)
        for n in written(block, feed_names):
            if n in env:
                scope.set(n, env[n])
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError(f"fetch targets {missing} were not computed")
        if return_numpy:
            return [to_numpy(env[n]) for n in fetch_names]
        return [env[n] for n in fetch_names]

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
        ins = {slot: [env[n] if n else None for n in names]
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
