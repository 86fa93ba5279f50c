"""Program IR: Program/Block/Operator/Variable, the port's copy of
``paddle_tpu/framework/core.py``.

The IR is the same desc graph the JAX package builds: layer functions append
ops and variables, the executor walks a block.  Only the dtype mapping
differs — bfloat16 maps to ``torch.bfloat16``.  A program serializes as
the JAX package's JSON (``Program.to_json``/``from_json``: for one program
the same string, letter for letter) and as its ProgramDef wire bytes
(``to_proto``/``from_proto``, ``framework/proto_io.py``); ``clone`` copies
in memory, so a variable keeps the attributes JSON does not carry
(regularizer, clip).  Every mutation through the IR's methods bumps
``Program._version``, and ``_cache_token`` is a never-reused id: together
they key the executor's captured step loops (``framework/step_loop.py``).
"""

from __future__ import annotations

import copy
import itertools
import json
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import unique_name


class VarType:
    """Variable kinds, mirroring VarDesc::VarType."""

    LOD_TENSOR = "lod_tensor"


_DTYPE_ALIASES = {
    "float32": "float32",
    "fp32": "float32",
    "float64": "float64",
    "fp64": "float64",
    "float16": "float16",
    "bfloat16": "bfloat16",
    "bf16": "bfloat16",
    "int8": "int8",
    "uint8": "uint8",
    "int16": "int16",
    "int32": "int32",
    "int64": "int64",
    "bool": "bool",
}

_TORCH_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}


def canonical_dtype(dtype) -> str:
    if isinstance(dtype, str):
        if dtype not in _DTYPE_ALIASES:
            raise ValueError(f"unknown dtype {dtype!r}")
        return _DTYPE_ALIASES[dtype]
    if isinstance(dtype, torch.dtype):
        return {v: k for k, v in _TORCH_DTYPES.items()}[dtype]
    return _DTYPE_ALIASES[np.dtype(dtype).name]


def np_dtype(dtype: str):
    """numpy dtype of a desc dtype name.  numpy has no bfloat16: such
    values cross to the host as float32."""
    dtype = canonical_dtype(dtype)
    if dtype == "bfloat16":
        return np.dtype(np.float32)
    return np.dtype(dtype)


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype of a desc dtype name."""
    return _TORCH_DTYPES[canonical_dtype(dtype)]


class Variable:
    """A named tensor slot in a Block.  Static metadata only — values live
    in a Scope or in the executor's per-run environment.  A shape entry
    of -1 is bound at feed time (batch axis)."""

    def __init__(
        self,
        block: "Block",
        name: str,
        shape=None,
        dtype="float32",
        type: str = VarType.LOD_TENSOR,
        persistable: bool = False,
        stop_gradient: bool = False,
        lod_level: int = 0,
        is_data: bool = False,
    ):
        self.block = block
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None else None
        self.dtype = canonical_dtype(dtype) if dtype is not None else None
        self.type = type
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.lod_level = lod_level
        self.is_data = is_data
        # the parameter an optimizer accumulator belongs to (moments)
        self.accumulator_for: Optional[str] = None

    # -- Python operators: one elementwise op each (layers/math_helper.py)
    def _binary(self, other, op_type, reverse=False):
        from ..layers import math_helper

        return math_helper.elementwise_binary(self, other, op_type, reverse)

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    def __radd__(self, other):
        return self._binary(other, "elementwise_add", reverse=True)

    def __sub__(self, other):
        return self._binary(other, "elementwise_sub")

    def __rsub__(self, other):
        return self._binary(other, "elementwise_sub", reverse=True)

    def __mul__(self, other):
        return self._binary(other, "elementwise_mul")

    def __rmul__(self, other):
        return self._binary(other, "elementwise_mul", reverse=True)

    def __truediv__(self, other):
        return self._binary(other, "elementwise_div")

    def __repr__(self):
        return (
            f"Variable(name={self.name!r}, shape={self.shape}, dtype={self.dtype}, "
            f"persistable={self.persistable})"
        )

    def to_dict(self):
        d = {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "type": self.type,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "lod_level": self.lod_level,
            "is_data": self.is_data,
        }
        if getattr(self, "accumulator_for", None):
            d["accumulator_for"] = self.accumulator_for
        if isinstance(self, Parameter):
            d["is_parameter"] = True
            d["trainable"] = self.trainable
        return d

    @staticmethod
    def from_dict(block, d):
        if d.get("is_parameter"):
            return Parameter(
                block,
                d["name"],
                shape=d["shape"],
                dtype=d["dtype"],
                trainable=d.get("trainable", True),
                stop_gradient=d["stop_gradient"],
                lod_level=d.get("lod_level", 0),
            )
        v = Variable(
            block,
            d["name"],
            shape=d["shape"],
            dtype=d["dtype"],
            type=d["type"],
            persistable=d["persistable"],
            stop_gradient=d["stop_gradient"],
            lod_level=d.get("lod_level", 0),
            is_data=d.get("is_data", False),
        )
        v.accumulator_for = d.get("accumulator_for")
        return v


class Parameter(Variable):
    """A persistable, trainable Variable."""

    def __init__(self, block, name, shape, dtype, **kw):
        self.trainable = kw.pop("trainable", True)
        self.regularizer = kw.pop("regularizer", None)
        self.gradient_clip_attr = kw.pop("gradient_clip_attr", None)
        self.optimize_attr = kw.pop("optimize_attr", {"learning_rate": 1.0})
        super().__init__(
            block, name, shape=shape, dtype=dtype, persistable=True, **kw
        )


class Operator:
    """One op in a block: ``inputs``/``outputs`` map slot name → list of
    variable names; ``attrs`` is a plain dict."""

    def __init__(self, block, type: str, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs: Dict[str, List[str]] = {
            k: list(v) for k, v in (inputs or {}).items()
        }
        self.outputs: Dict[str, List[str]] = {
            k: list(v) for k, v in (outputs or {}).items()
        }
        self.attrs: Dict[str, Any] = dict(attrs or {})

    def input(self, slot: str) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot: str) -> List[str]:
        return self.outputs.get(slot, [])

    def input_names(self) -> List[str]:
        return [n for vs in self.inputs.values() for n in vs]

    def output_names(self) -> List[str]:
        return [n for vs in self.outputs.values() for n in vs]

    def __repr__(self):
        return f"Operator({self.type}, in={self.inputs}, out={self.outputs})"

    def to_dict(self):
        return {
            "type": self.type,
            "inputs": self.inputs,
            "outputs": self.outputs,
            "attrs": self.attrs,
        }

    @staticmethod
    def from_dict(block, d):
        return Operator(block, d["type"], d["inputs"], d["outputs"], d["attrs"])


class Block:
    """A straight-line op list + symbol table; parent_idx chains lookups
    for nested blocks."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    def create_var(self, name=None, **kw) -> Variable:
        if name is None:
            name = unique_name.generate("tmp")
        v = Variable(self, name, **kw)
        self.vars[name] = v
        self.program._bump()
        return v

    def create_parameter(self, name, shape, dtype, **kw) -> Parameter:
        p = Parameter(self, name, shape, dtype, **kw)
        self.vars[name] = p
        self.program._bump()
        return p

    def var(self, name: str) -> Variable:
        v = self._find_var_recursive(name)
        if v is None:
            raise KeyError(f"variable {name!r} not found in block {self.idx}")
        return v

    def has_var(self, name: str) -> bool:
        return self._find_var_recursive(name) is not None

    def _find_var_recursive(self, name: str) -> Optional[Variable]:
        blk = self
        while True:
            if name in blk.vars:
                return blk.vars[name]
            if blk.parent_idx < 0:
                return None
            blk = self.program.blocks[blk.parent_idx]

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        # stable per-op uid: the RNG salt of stochastic ops
        # (ops/registry.py EmitContext.generator)
        op.attrs.setdefault("__uid__", self.program._take_uid())
        self.ops.append(op)
        self.program._bump()
        return op

    def to_dict(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": [o.to_dict() for o in self.ops],
        }

    @staticmethod
    def from_dict(program, d):
        b = Block(program, d["idx"], d["parent_idx"])
        for vd in d["vars"]:
            v = Variable.from_dict(b, vd)
            b.vars[v.name] = v
        for od in d["ops"]:
            b.ops.append(Operator.from_dict(b, od))
        return b


class Program:
    """A whole model: list of blocks, block 0 is global."""

    # process-wide monotonic id source: unlike id(), tokens are never reused
    # after garbage collection, so an executor's cached step loop cannot
    # alias between a dead Program and a new one at the same address
    _token_counter = itertools.count()

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self.current_block_idx = 0
        self._version = 0  # bumped on mutation; executor cache key component
        self._cache_token = next(Program._token_counter)
        self._next_uid = 0
        self.random_seed = 0

    def _take_uid(self) -> int:
        self._next_uid += 1
        return self._next_uid - 1

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def create_block(self, parent_idx=None) -> Block:
        parent = self.current_block_idx if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent)
        self.blocks.append(b)
        self.current_block_idx = b.idx
        self._bump()
        return b

    def rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    def _bump(self):
        self._version += 1

    def clone(self, for_test: bool = False) -> "Program":
        """A copy with its own blocks, variables and ops (the variables
        keep every attribute: regularizer, clip, accumulator owner); with
        `for_test`, batch_norm and dropout ops get ``is_test``."""
        p = Program()
        p.blocks = []
        for b in self.blocks:
            nb = Block(p, b.idx, b.parent_idx)
            for name, v in b.vars.items():
                nv = copy.copy(v)
                nv.block = nb
                nb.vars[name] = nv
            for op in b.ops:
                nop = Operator(nb, op.type, op.inputs, op.outputs,
                               copy.deepcopy(op.attrs))
                if for_test and op.type in ("dropout", "batch_norm"):
                    nop.attrs["is_test"] = True
                nb.ops.append(nop)
            p.blocks.append(nb)
        p.current_block_idx = self.current_block_idx
        p._next_uid = self._next_uid
        p.random_seed = self.random_seed
        return p

    def __repr__(self):
        return f"Program(blocks={len(self.blocks)}, " \
               f"ops={sum(len(b.ops) for b in self.blocks)})"

    def to_proto(self) -> bytes:
        """Serialized ProgramDef wire bytes (``framework/proto_io.py``)."""
        from . import proto_io

        return proto_io.serialize_program(self)

    @staticmethod
    def from_proto(data: bytes) -> "Program":
        from . import proto_io

        return proto_io.parse_program(data)

    def to_json(self) -> str:
        return json.dumps(
            {
                "version": 1,
                "current_block_idx": self.current_block_idx,
                "random_seed": self.random_seed,
                "blocks": [b.to_dict() for b in self.blocks],
            }
        )

    @staticmethod
    def from_json(s: str) -> "Program":
        d = json.loads(s)
        p = Program()
        p.blocks = [Block.from_dict(p, bd) for bd in d["blocks"]]
        p.current_block_idx = d.get("current_block_idx", 0)
        p.random_seed = d.get("random_seed", 0)
        p._version = 0
        p._recompute_next_uid()
        return p

    def _recompute_next_uid(self):
        """Restore the uid counter after deserialization, so that a new op
        never takes a recorded ``__uid__`` (an RNG salt)."""
        self._next_uid = 1 + max(
            (int(op.attrs.get("__uid__", 0))
             for b in self.blocks for op in b.ops),
            default=-1,
        )


GRAD_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


def drop_orphaned_vars(block: Block, keep=()) -> int:
    """Delete the declarations no op of `block` references (keeping
    persistable and data vars, and the names in `keep`): the passes that
    remove ops (``io.prune``, the BN fold) leave no var-table debris.
    Returns how many were dropped."""
    referenced = set(keep)
    for op in block.ops:
        referenced.update(n for n in op.input_names() if n)
        referenced.update(n for n in op.output_names() if n)
    dropped = 0
    for name in list(block.vars):
        v = block.vars[name]
        if name not in referenced and not v.persistable and not v.is_data:
            del block.vars[name]
            dropped += 1
    return dropped


_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(p: Program) -> Program:
    global _main_program
    prev, _main_program = _main_program, p
    return prev


def switch_startup_program(p: Program) -> Program:
    global _startup_program
    prev, _startup_program = _startup_program, p
    return prev


class program_guard:
    """Context manager scoping the default main/startup programs."""

    def __init__(self, main_program: Program, startup_program: Optional[Program] = None):
        self._main = main_program
        self._startup = startup_program

    def __enter__(self):
        self._prev_main = switch_main_program(self._main)
        if self._startup is not None:
            self._prev_startup = switch_startup_program(self._startup)
        return self

    def __exit__(self, *exc):
        switch_main_program(self._prev_main)
        if self._startup is not None:
            switch_startup_program(self._prev_startup)
        return False
