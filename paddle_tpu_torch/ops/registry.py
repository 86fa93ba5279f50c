"""Op registry: type → torch emitter, and the generic grad — the port of
``paddle_tpu/ops/registry.py``.

An op is a single *emitter*

    emit(ctx, ins, attrs) -> outs

where ``ins``/``outs`` map slot name → list of torch tensors, all on
``ctx.device``.  The registry is the port's own: an op type with no torch
emitter raises ``KeyError`` — nothing falls through to another backend.

Desc-level autodiff keeps the reference's shape: ``default_grad_maker``
turns a forward op desc into one ``generic_grad`` op desc, and the
``generic_grad`` emitter re-runs the forward emitter on detached copies of
the requested inputs under ``torch.enable_grad()`` and applies the output
cotangents with ``torch.autograd.grad``.  Eager PyTorch does not share
that recomputed forward with the forward op, so every differentiated op
runs its forward twice a step (XLA merges the two on the TPU).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..framework.core import GRAD_SUFFIX


@dataclass
class OpInfo:
    type: str
    emit: Callable
    # "default" → default_grad_maker's generic_grad op; None →
    # non-differentiable / stateful
    grad: Optional[object] = "default"
    # slots whose values are integral / non-differentiable even if float
    non_diff_inputs: tuple = ()
    # output slots never given cotangents (saved statistics, probabilities)
    non_diff_outputs: tuple = ()
    # draws from EmitContext.generator, which is seeded on the host per
    # run: a captured step loop would replay one step's draws K times, so
    # framework/step_loop.safety_report keeps such a block eager
    draws_rng: bool = False
    # output slots the desc declares and the emitter never writes (the
    # reference's warpctc WarpCTCGrad): the executor binds nothing to
    # them and hands a generic_grad of the op None in their place
    unwritten_outputs: tuple = ()
    # analytic cost formula (analysis/cost.py): fn(ins, outs, attrs) ->
    # {"flops": int, "bytes": int}, either key optional, where ins/outs
    # map slot -> [ShapeDtype | None].  None: the analyzer's shape-driven
    # defaults (one flop per output element, inputs read + outputs
    # written)
    cost: Optional[Callable] = None
    # sharding-propagation rule: fn(ctx, ins, outs, attrs) -> {slot:
    # [spec-tuple|None]} where ins/outs map slot -> [ShardedOperand|None]
    # (analysis/sharding.py) and ctx is its PropagationContext (mesh axis
    # sizes + ctx.collective(...) to declare implied communication).
    # None → the analyzer's structural defaults (elementwise join /
    # batch-led propagation).
    sharding: Optional[Callable] = None
    # the op's own execution over a mesh (parallel/parallel_executor.py):
    # fn(ctx, ins, attrs) -> outs with every position's shards at once,
    # ins/outs mapping slot -> [ShardedTensor | tensor]; None → the
    # executor's local rules or its gather-and-run-whole fallback
    mesh_emit: Optional[Callable] = None


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


class ShapeDtype:
    """Static (shape, dtype) of one op operand, as the cost model sees it:
    batch dims already bound, dtype a canonical string."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype="float32"):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def __repr__(self):
        return f"ShapeDtype({self.shape}, {self.dtype})"


def register_cost(type: str, fn: Callable = None):
    """Attach an analytic cost formula to an already-registered op
    (decorator or direct call); the formula lives beside the emitter in
    the op's module.  fn(ins, outs, attrs) -> {"flops": int, "bytes":
    int}, either key optional."""

    def _do(f):
        info = get_op_info(type)
        if info.cost is not None:
            raise ValueError(f"op {type!r} already has a cost formula")
        info.cost = f
        return f

    if fn is not None:
        return _do(fn)
    return _do


def register_sharding(type: str, fn: Callable = None):
    """Attach a sharding-propagation rule to an already-registered op.
    Usable as decorator or direct call; like `register_cost`, the rule
    lives beside the emitter in the op's module (matmul contraction
    resolution, the vocab-sharded lookup, sp ring/all-to-all attention,
    moe dispatch) — this is only the mechanism.  fn(ctx, ins, outs,
    attrs) -> {slot: [spec|None]} with specs as tuples of mesh-axis
    names/None; the rule declares implied collectives through
    ctx.collective(...)."""

    def _do(f):
        info = get_op_info(type)
        if info.sharding is not None:
            raise ValueError(f"op {type!r} already has a sharding rule")
        info.sharding = f
        return f

    if fn is not None:
        return _do(fn)
    return _do


def register_mesh_emit(type: str, fn: Callable = None):
    """Attach a mesh-aware emitter (``OpInfo.mesh_emit``) to an
    already-registered op: the ``ParallelExecutor`` hands it every
    position's shards at once (sequence-parallel attention, the
    expert-parallel ``moe``)."""

    def _do(f):
        info = get_op_info(type)
        if info.mesh_emit is not None:
            raise ValueError(f"op {type!r} already has a mesh emitter")
        info.mesh_emit = f
        return f

    if fn is not None:
        return _do(fn)
    return _do


def get_op_info(type: str) -> OpInfo:
    if type not in _REGISTRY:
        raise KeyError(
            f"no torch emitter registered for op {type!r} "
            f"(registered: {sorted(_REGISTRY)})"
        )
    return _REGISTRY[type]


def unbound_slots(op) -> tuple:
    """The input slots of `op` that name an output no emitter writes: a
    ``generic_grad``'s copies of its forward op's ``unwritten_outputs``
    and their cotangents."""
    if op.type != "generic_grad":
        return ()
    slots = get_op_info(op.attrs["__fwd_type__"]).unwritten_outputs
    return tuple(slots) + tuple(s + GRAD_SUFFIX for s in slots)


def has_op(type: str) -> bool:
    return type in _REGISTRY


def registered_ops() -> List[str]:
    return sorted(_REGISTRY)


class EmitContext:
    """Per-run state handed to emitters: the device every tensor lives
    on, train/test mode, per-op random generators, ``constants`` (the
    executor's device copies of ops' constant attributes, which live
    until it closes), and ``lower_block``, which the executor sets so
    that a control-flow op can run a nested block."""

    def __init__(self, device: torch.device, is_test: bool, program=None,
                 step: int = 0, constants=None):
        self.device = torch.device(device)
        self.is_test = is_test
        self.program = program
        self.step = int(step)
        # id(op attrs) → (attrs, tensor); holding attrs keeps its id unique
        self.constants = {} if constants is None else constants
        # callable(block_idx, env) -> env, set by the executor's walk:
        # runs every op of program.blocks[block_idx] in order on env
        self.lower_block = None

    def generator(self, attrs, *fold) -> torch.Generator:
        """A generator on the device, seeded from (program.random_seed,
        run step, op __uid__, *fold): each stochastic op draws its own
        stream, `fold` splits it further (a decode loop folds in its
        step, as ``jax.random.fold_in`` does), and the same seed words
        replay it."""
        seed = self.program.random_seed if self.program is not None else 0
        uid = int(attrs.get("__uid__", 0))
        mixed = np.random.SeedSequence(
            [int(seed), self.step, uid, *(int(f) for f in fold)]
        ).generate_state(2, np.uint32)
        # a meta-device walk (the analysis tier's shape oracle) draws
        # nothing: its tensors carry shapes only, so a host generator does
        g = torch.Generator(device=self.device
                            if self.device.type != "meta" else "cpu")
        g.manual_seed((int(mixed[0]) << 31) ^ int(mixed[1]))
        return g


# ---------------------------------------------------------------------------
# Generic grad: maker + emitter


def default_grad_maker(op, requires_grad):
    """Build one `generic_grad` op desc from a forward op desc.

    Inputs: forward inputs under their slots, forward outputs under theirs,
    plus `<slot>@GRAD` for each forward output.  Outputs: `<slot>@GRAD` per
    forward input slot, with "" placeholders for vars not requiring grad."""
    info = get_op_info(op.type)
    ins = {}
    for slot, names in op.inputs.items():
        ins[slot] = list(names)
    for slot, names in op.outputs.items():
        if slot in ins:
            raise ValueError(
                f"op {op.type}: output slot {slot} collides with input slot"
            )
        ins[slot] = list(names)
        ins[slot + GRAD_SUFFIX] = [n + GRAD_SUFFIX for n in names]
    outs = {}
    any_grad = False
    for slot, names in op.inputs.items():
        if slot in info.non_diff_inputs:
            continue
        grads = []
        for n in names:
            if n in requires_grad:
                grads.append(n + GRAD_SUFFIX)
                any_grad = True
            else:
                grads.append("")
        outs[slot + GRAD_SUFFIX] = grads
    if not any_grad:
        return []
    attrs = {
        "__fwd_type__": op.type,
        "__fwd_attrs__": dict(op.attrs),
        "__fwd_input_slots__": sorted(op.inputs.keys()),
        "__fwd_output_slots__": sorted(op.outputs.keys()),
        "__uid__": op.attrs.get("__uid__", 0),
    }
    return [("generic_grad", ins, outs, attrs)]


def _generic_grad_emit(ctx, ins, attrs):
    """Re-run the forward emitter on ``detach().requires_grad_()`` copies
    of the requested float inputs and pull the output cotangents back with
    ``torch.autograd.grad``.  The forward attrs carry the op's ``__uid__``,
    so a stochastic op draws the same numbers again.  A missing or
    non-differentiable output takes a zero cotangent (it is left out of
    the autograd call); an input the forward does not reach gets zeros.

    ``__remat__`` (the JAX package's mark for a grad op whose forward
    ``jax.checkpoint`` must recompute instead of sharing it with the
    forward op) is honoured at no extra cost: the port keeps no tape, so
    every grad op already recomputes its forward here, and a marked op
    runs exactly as an unmarked one."""
    fwd_type = attrs["__fwd_type__"]
    fwd_attrs = attrs["__fwd_attrs__"]
    in_slots = attrs["__fwd_input_slots__"]
    out_slots = attrs["__fwd_output_slots__"]
    info = get_op_info(fwd_type)

    full = {s: list(ins.get(s, [])) for s in in_slots}
    # which (slot, idx) to differentiate: the grad op's requested outputs,
    # passed by the executor as attrs["__wanted__"]
    diff_pos = [(s, i) for s in in_slots if s not in info.non_diff_inputs
                for i, v in enumerate(full[s])
                if (s, i) in attrs["__wanted__"] and v is not None
                and v.is_floating_point()]
    leaves = []
    for s, i in diff_pos:
        leaf = full[s][i].detach().requires_grad_(True)
        full[s][i] = leaf
        leaves.append(leaf)

    with torch.enable_grad():
        outs = info.emit(ctx, full, fwd_attrs)
    primals, cts = [], []
    for s in out_slots:
        grads = ins.get(s + GRAD_SUFFIX, [])
        for i, primal in enumerate(outs.get(s, [])[: len(ins.get(s, []))]):
            if (s in info.non_diff_outputs or i >= len(grads)
                    or grads[i] is None or primal is None
                    or not primal.requires_grad):
                continue
            primals.append(primal)
            cts.append(grads[i].to(primal.dtype))
    if primals:
        din = torch.autograd.grad(primals, leaves, cts, allow_unused=True)
    else:
        din = [None] * len(leaves)

    result = {}
    for (s, i), leaf, g in zip(diff_pos, leaves, din):
        by_idx = result.setdefault(s + GRAD_SUFFIX, {})
        by_idx[i] = torch.zeros_like(leaf) if g is None else g
    # densify: the executor zips by position; unrequested slots are absent
    return {s: [by_idx.get(i) for i in range(max(by_idx) + 1)]
            for s, by_idx in result.items()}


register_op("generic_grad", _generic_grad_emit, grad=None)


def _generic_grad_cost(ins, outs, attrs):
    """Backward ≈ 2x the forward's FLOPs (the dL/dX and dL/dW products of
    every matmul/conv); a remat-marked grad op re-runs its forward first,
    so __remat__ adds one more forward."""
    info = _REGISTRY.get(attrs.get("__fwd_type__", ""))
    fwd_ins = {s: ins.get(s, [])
               for s in attrs.get("__fwd_input_slots__", ())}
    fwd_outs = {s: ins.get(s, [])
                for s in attrs.get("__fwd_output_slots__", ())}
    fwd_flops = None
    if info is not None and info.cost is not None:
        try:
            fwd_flops = info.cost(fwd_ins, fwd_outs,
                                  attrs.get("__fwd_attrs__", {})).get("flops")
        except (TypeError, ValueError, IndexError, AttributeError):
            fwd_flops = None
    if fwd_flops is None:
        fwd_flops = sum(v.size for vs in fwd_outs.values()
                        for v in vs if v is not None)
    mult = 3 if attrs.get("__remat__") else 2
    return {"flops": mult * int(fwd_flops)}


register_cost("generic_grad", _generic_grad_cost)
