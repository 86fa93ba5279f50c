"""v2 Parameters, the port of ``paddle_tpu/v2/parameters.py``: numpy get/set
+ tar serialization (reference python/paddle/v2/parameters.py —
to_tar/from_tar).

The tar holds one ``<name>.npy`` per parameter, as the JAX package writes
it, so a tar from either package loads into the other.  A bfloat16 value
travels as its bits under the ``'<V2'`` header (``io.write_value``), and
``set`` reads ``|V2`` and ``<u2`` back as bfloat16, as ``io`` loads a
saved model.  ``set`` puts a torch tensor on the scope in the dtype the
program declares, on the device where the program's values live (that of
the value it replaces, else of any of the program's persistables in the
scope, else the CPU), so a tar loaded into a trainer on the card runs
there."""

from __future__ import annotations

import io
import tarfile

import numpy as np
import torch

from ..framework.core import default_main_program, torch_dtype
from ..framework.scope import global_scope
from ..io import array_to_tensor, write_value


class Parameters:
    def __init__(self, program=None, scope=None):
        self.program = program or default_main_program()
        self.scope = scope or global_scope()

    def names(self):
        return [p.name for p in
                self.program.global_block().all_parameters()]

    def keys(self):
        return self.names()

    def get(self, name) -> np.ndarray:
        v = self.scope.find_np(name)
        if v is None:
            raise KeyError(name)
        return v

    def _device(self, name):
        """The device of the program's values in the scope."""
        block = self.program.global_block()
        for n in [name] + [v.name for v in block.vars.values()
                           if v.persistable]:
            v = self.scope.find(n)
            if isinstance(v, torch.Tensor):
                return v.device
        return torch.device("cpu")

    def set(self, name, value):
        var = self.program.global_block()._find_var_recursive(name)
        declared = var.dtype if var is not None else None
        device = self._device(name)
        if isinstance(value, torch.Tensor):
            value = value.detach().to(
                device=device, copy=True,
                dtype=torch_dtype(declared) if declared else value.dtype)
        else:
            value = array_to_tensor(value, declared, device)
        self.scope.set(name, value)

    __getitem__ = get
    __setitem__ = set

    def to_tar(self, f):
        with tarfile.open(fileobj=f, mode="w") as tar:
            for name in self.names():
                v = self.scope.find(name)
                if v is None:
                    raise KeyError(name)
                buf = io.BytesIO()
                write_value(buf, v)
                data = buf.getvalue()
                info = tarfile.TarInfo(name=name + ".npy")
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))

    def from_tar(self, f):
        with tarfile.open(fileobj=f, mode="r") as tar:
            for member in tar.getmembers():
                name = member.name[:-4]
                # np.load wants a real file handle; buffer the member
                data = io.BytesIO(tar.extractfile(member).read())
                self.set(name, np.load(data, allow_pickle=False))
        return self

    @staticmethod
    def from_tar_new(f, program=None):
        p = Parameters(program)
        return p.from_tar(f)


def create(layers):
    """reference parameters.py:27 create(): Parameters for the program the
    given output layer(s) belong to."""
    ls = layers if isinstance(layers, (list, tuple)) else [layers]
    var = getattr(ls[0], "var", ls[0])
    return Parameters(var.block.program)
