"""Op registry: type → torch emitter.

An op is a single *emitter*

    emit(ctx, ins, attrs) -> outs

where ``ins``/``outs`` map slot name → list of torch tensors, all on
``ctx.device``.  The registry is the port's own: an op type with no torch
emitter raises ``KeyError`` — nothing falls through to another backend.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


@dataclass
class OpInfo:
    type: str
    emit: Callable
    # grad maker: "default" → generic autograd-based grad (a later slice);
    # None → non-differentiable / stateful
    grad: Optional[object] = "default"
    # slots whose values are integral / non-differentiable even if float
    non_diff_inputs: tuple = ()


_REGISTRY: Dict[str, OpInfo] = {}


def register_op(type: str, emit: Callable = None, **kw):
    """Register an op emitter. Usable as decorator or direct call."""

    def _do(fn):
        if type in _REGISTRY:
            raise ValueError(f"op {type!r} registered twice")
        _REGISTRY[type] = OpInfo(type=type, emit=fn, **kw)
        return fn

    if emit is not None:
        return _do(emit)
    return _do


def get_op_info(type: str) -> OpInfo:
    if type not in _REGISTRY:
        raise KeyError(
            f"no torch emitter registered for op {type!r} "
            f"(registered: {sorted(_REGISTRY)})"
        )
    return _REGISTRY[type]


def has_op(type: str) -> bool:
    return type in _REGISTRY


def registered_ops() -> List[str]:
    return sorted(_REGISTRY)


class EmitContext:
    """Per-run state handed to emitters: the device every tensor lives
    on, train/test mode, and per-op random generators."""

    def __init__(self, device: torch.device, is_test: bool, program=None,
                 step: int = 0):
        self.device = torch.device(device)
        self.is_test = is_test
        self.program = program
        self.step = int(step)

    def generator(self, attrs) -> torch.Generator:
        """A generator on the device, seeded from (program.random_seed,
        run step, op __uid__): each stochastic op draws its own stream,
        and the same (seed, step, uid) replays it."""
        seed = self.program.random_seed if self.program is not None else 0
        uid = int(attrs.get("__uid__", 0))
        mixed = np.random.SeedSequence(
            [int(seed), self.step, uid]).generate_state(2, np.uint32)
        g = torch.Generator(device=self.device)
        g.manual_seed((int(mixed[0]) << 31) ^ int(mixed[1]))
        return g
