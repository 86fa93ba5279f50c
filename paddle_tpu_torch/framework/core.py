"""Program IR: Program/Block/Operator/Variable, the port's copy of
``paddle_tpu/framework/core.py``.

The IR is the same desc graph the JAX package builds: layer functions append
ops and variables, the executor walks a block.  Only the dtype mapping
differs — bfloat16 maps to ``torch.bfloat16`` — and only the part of the IR
the serving path uses is carried (no JSON/proto serialization, no clone).
"""

from __future__ import annotations

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

    def __repr__(self):
        return (
            f"Variable(name={self.name!r}, shape={self.shape}, dtype={self.dtype}, "
            f"persistable={self.persistable})"
        )


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

    def input_names(self) -> List[str]:
        return [n for vs in self.inputs.values() for n in vs]

    def output_names(self) -> List[str]:
        return [n for vs in self.outputs.values() for n in vs]

    def __repr__(self):
        return f"Operator({self.type}, in={self.inputs}, out={self.outputs})"


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
        return v

    def create_parameter(self, name, shape, dtype, **kw) -> Parameter:
        p = Parameter(self, name, shape, dtype, **kw)
        self.vars[name] = p
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

    def append_op(self, type, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        # stable per-op uid: the RNG salt of stochastic ops
        # (ops/registry.py EmitContext.generator)
        op.attrs.setdefault("__uid__", self.program._take_uid())
        self.ops.append(op)
        return op


class Program:
    """A whole model: list of blocks, block 0 is global."""

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self.current_block_idx = 0
        self._next_uid = 0
        self.random_seed = 0

    def _take_uid(self) -> int:
        self._next_uid += 1
        return self._next_uid - 1

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def __repr__(self):
        return f"Program(blocks={len(self.blocks)}, " \
               f"ops={sum(len(b.ops) for b in self.blocks)})"


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
