"""Sequence-length companions: a variable may carry the name of its
``<name>@LENGTH`` var, and shape-preserving layers pass it on."""

from __future__ import annotations

from ..framework.core import Variable


def propagate_length(src: Variable, dst: Variable) -> Variable:
    name = getattr(src, "_length_var_name", None)
    if name is not None:
        dst._length_var_name = name
    return dst
