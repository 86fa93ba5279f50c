"""Initializers: write init ops into the startup program (reference
python/paddle/v2/fluid/initializer.py — Constant/Uniform/Normal/Xavier/MSRA)."""

from __future__ import annotations

import math

from .core import Variable


class Initializer:
    def __call__(self, var: Variable, block):
        raise NotImplementedError

    def _fan(self, var):
        shape = var.shape
        if len(shape) == 1:
            return shape[0], shape[0]
        if len(shape) == 2:
            return shape[0], shape[1]
        rf = 1
        for s in shape[2:]:
            rf *= s
        return shape[1] * rf, shape[0] * rf


class ConstantInitializer(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, var, block):
        block.append_op(
            "fill_constant",
            outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "value": self.value,
                   "dtype": var.dtype},
        )


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op(
            "uniform_random",
            outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "min": self.low, "max": self.high,
                   "seed": self.seed, "dtype": var.dtype},
        )


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            "gaussian_random",
            outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "mean": self.loc,
                   "std": self.scale, "seed": self.seed, "dtype": var.dtype},
        )


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform = uniform
        self.fan_in, self.fan_out, self.seed = fan_in, fan_out, seed

    def __call__(self, var, block):
        fi, fo = self._fan(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fi, _ = self._fan(var)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            NormalInitializer(0.0, math.sqrt(2.0 / fi), self.seed)(var, block)


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
