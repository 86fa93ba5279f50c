"""Executor: runs one block of a Program eagerly, op by op, on one device.

The JAX package traces a whole block into one XLA computation
(``paddle_tpu/framework/executor.py``); here each op's torch emitter runs
in turn (modelled on its ``_lower_op``), threading a name → tensor
environment.  Inputs come from the feeds, from earlier ops of the block,
or from the scope; every persistable output is written back to the scope
BY REFERENCE — an op that updates a pool in place hands back the same
tensor, so a KV pool is never copied.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..ops.registry import EmitContext, get_op_info
from .core import Program, default_main_program, torch_dtype
from .place import Place, default_place
from .scope import Scope, global_scope, to_numpy


class OpLoweringError(RuntimeError):
    """An op's emitter failed; the message names the op and its vars."""


def _fetch_name(f) -> str:
    return f if isinstance(f, str) else f.name


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

        env = {name: self._feed_tensor(block, name, value)
               for name, value in feed.items()}
        is_test = not any(op.type.endswith("_grad") for op in block.ops)
        ctx = EmitContext(self.device, is_test=is_test, program=program,
                          step=self._step)
        self._step += 1
        for op in block.ops:
            for n in op.input_names():
                if n and n not in env:
                    env[n] = self._read_state(scope, block, n)
            self._run_op(op, env, ctx)
        for op in block.ops:
            for n in op.output_names():
                v = block._find_var_recursive(n) if n else None
                if v is not None and v.persistable and n in env:
                    scope.set(n, env[n])
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError(f"fetch targets {missing} were not computed")
        if return_numpy:
            return [to_numpy(env[n]) for n in fetch_names]
        return [env[n] for n in fetch_names]

    def _feed_tensor(self, block, name, value) -> torch.Tensor:
        var = block.var(name) if block.has_var(name) else None
        if isinstance(value, torch.Tensor):
            t = value
        else:
            t = torch.as_tensor(np.asarray(value))
        dt = torch_dtype(var.dtype) if var is not None and var.dtype else None
        return t.to(device=self.device, dtype=dt)

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
        try:
            outs = info.emit(ctx, ins, op.attrs)
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
