"""Scope: name → torch tensor, the persistent state between executor runs
(parameters, KV pools).

Values are torch tensors.  ``set`` accepts numpy, as a CPU tensor; the
Executor moves a tensor that lies on another device than its own to its
device on the first run that reads it and writes it back, so the move
happens once.  Transient op outputs never
enter the scope.
"""

from __future__ import annotations

import contextlib
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
    def __init__(self):
        self._vars: Dict[str, torch.Tensor] = {}

    def set(self, name: str, value):
        """Store a tensor by reference.  numpy (or anything ``np.asarray``
        takes) is copied into a new CPU tensor, so an op that updates the
        value in place never writes into the caller's array."""
        if not isinstance(value, torch.Tensor):
            value = torch.tensor(np.asarray(value))
        self._vars[name] = value

    def find(self, name: str) -> Optional[torch.Tensor]:
        return self._vars.get(name)

    def find_np(self, name: str) -> Optional[np.ndarray]:
        v = self.find(name)
        return None if v is None else to_numpy(v)


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
