"""Scope: name → torch tensor, the persistent state between executor runs
(parameters, optimizer state, KV pools), and ``load_persistables``,
which carries a program's whole state in from numpy.

Values are torch tensors.  ``set`` accepts numpy, as a CPU tensor; the
Executor moves a tensor that lies on another device than its own to its
device on the first run that reads it and writes it back, so the move
happens once.  Transient op outputs never
enter the scope.  A scope made with a `parent` reads through to it and
writes only itself (the BN fold's overlay in ``io.save_inference_model``).
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Dict, Optional

import numpy as np
import torch


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array (bfloat16 widens to float32: numpy
    has no bfloat16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


class Scope:
    # never-reused ids, as ``Program._cache_token``: an executor's captured
    # step loops are keyed by the scope they train, and id() can alias
    _token_counter = itertools.count()

    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, torch.Tensor] = {}
        self.parent = parent
        self._cache_token = next(Scope._token_counter)

    def set(self, name: str, value):
        """Store a tensor by reference.  numpy (or anything ``np.asarray``
        takes) is copied into a new CPU tensor, so an op that updates the
        value in place never writes into the caller's array."""
        if not isinstance(value, torch.Tensor):
            value = torch.tensor(np.asarray(value))
        self._vars[name] = value

    def find(self, name: str) -> Optional[torch.Tensor]:
        s = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return None

    def has(self, name: str) -> bool:
        return self.find(name) is not None

    def local_names(self):
        return list(self._vars)

    def find_np(self, name: str) -> Optional[np.ndarray]:
        v = self.find(name)
        return None if v is None else to_numpy(v)


def load_persistables(program, arrays, scope: Optional[Scope] = None):
    """Write numpy `arrays` (name → value) into `scope` (the global scope
    by default) for EVERY persistable variable of `program`'s global block:
    parameters, optimizer accumulators, the learning rate.  Each name,
    shape and dtype is checked against the program's declaration (a
    float32 array may stand for a bfloat16 variable: numpy has no
    bfloat16); a missing or unknown name raises.  A value lands on the
    device of the tensor it replaces (the CPU when the name is new)."""
    from .core import canonical_dtype, torch_dtype

    scope = scope if scope is not None else global_scope()
    want = {n: v for n, v in program.global_block().vars.items()
            if v.persistable}
    missing = sorted(set(want) - set(arrays))
    unknown = sorted(set(arrays) - set(want))
    if missing or unknown:
        raise KeyError(f"load_persistables: missing {missing}, not "
                       f"persistable in the program {unknown}")
    for name, var in want.items():
        a = np.asarray(arrays[name])
        if tuple(a.shape) != tuple(var.shape):
            raise ValueError(f"{name}: shape {a.shape} != {var.shape}")
        got = canonical_dtype(a.dtype)
        if got != var.dtype and not (var.dtype == "bfloat16"
                                     and got == "float32"):
            raise TypeError(f"{name}: dtype {got} != {var.dtype}")
        if got == "bfloat16":
            a = a.astype(np.float32)
        old = scope.find(name)
        scope.set(name, torch.tensor(
            a, device=old.device if old is not None else "cpu",
            dtype=torch_dtype(var.dtype)))


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


def reset_global_scope():
    global _global_scope
    _global_scope = Scope()
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope: Scope):
    """with scope_guard(Scope()): ... — swaps the process-global scope."""
    global _global_scope
    prev, _global_scope = _global_scope, scope
    try:
        yield scope
    finally:
        _global_scope = prev
