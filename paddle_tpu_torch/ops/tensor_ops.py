"""Tensor creation ops of the startup program: fill_constant,
uniform_random, gaussian_random.  Random ops draw from the context's
per-op generator, on the context's device."""

from __future__ import annotations

import torch

from ..framework.core import torch_dtype
from .registry import register_op


def _shape(attrs):
    return [int(s) for s in attrs["shape"]]


@register_op("fill_constant", grad=None)
def fill_constant(ctx, ins, attrs):
    dt = torch_dtype(attrs.get("dtype", "float32"))
    return {"Out": [torch.full(_shape(attrs), attrs.get("value", 0.0),
                               dtype=dt, device=ctx.device)]}


@register_op("uniform_random", grad=None)
def uniform_random(ctx, ins, attrs):
    dt = torch_dtype(attrs.get("dtype", "float32"))
    lo = float(attrs.get("min", -1.0))
    hi = float(attrs.get("max", 1.0))
    out = torch.empty(_shape(attrs), dtype=torch.float32, device=ctx.device)
    out.uniform_(lo, hi, generator=ctx.generator(attrs))
    return {"Out": [out.to(dt)]}


@register_op("gaussian_random", grad=None)
def gaussian_random(ctx, ins, attrs):
    dt = torch_dtype(attrs.get("dtype", "float32"))
    mean = float(attrs.get("mean", 0.0))
    std = float(attrs.get("std", 1.0))
    out = torch.empty(_shape(attrs), dtype=torch.float32, device=ctx.device)
    out.normal_(mean, std, generator=ctx.generator(attrs))
    return {"Out": [out.to(dt)]}
