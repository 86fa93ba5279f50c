"""Tensor ops, the port of the part of ``paddle_tpu/ops/tensor_ops.py``
that the startup program, the LM tower, the recurrent models and ResNet
use: fill_constant, uniform_random, gaussian_random, assign, cast, concat,
reshape, transpose, slice, lookup_table and top_k.  Random ops draw from the
context's per-op generator, on the context's device.  Shape ops may return
views of their input; no emitter writes into an input."""

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


@register_op("assign")
def assign(ctx, ins, attrs):
    return {"Out": [ins["X"][0]]}


@register_op("cast")
def cast(ctx, ins, attrs):
    return {"Out": [ins["X"][0].to(torch_dtype(attrs["out_dtype"]))]}


@register_op("concat")
def concat(ctx, ins, attrs):
    return {"Out": [torch.cat(ins["X"], dim=int(attrs.get("axis", 0)))]}


@register_op("reshape")
def reshape(ctx, ins, attrs):
    x = ins["X"][0]
    shape = [int(s) for s in attrs["shape"]]
    # paddle semantics: 0 keeps the input dim, -1 infers
    shape = [x.shape[i] if s == 0 else s
             for i, s in enumerate(shape[: x.ndim])] + shape[x.ndim:]
    return {"Out": [x.reshape(shape)]}


@register_op("transpose")
def transpose(ctx, ins, attrs):
    return {"Out": [ins["X"][0].permute(*[int(a) for a in attrs["axis"]])]}


@register_op("slice")
def slice_op(ctx, ins, attrs):
    x = ins["Input"][0]
    idx = [slice(None)] * x.ndim
    for ax, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        idx[int(ax)] = slice(int(s), int(e))
    return {"Out": [x[tuple(idx)]]}


@register_op("lookup_table", non_diff_inputs=("Ids",))
def lookup_table(ctx, ins, attrs):
    """Embedding lookup.  Its grad (autograd of ``index_select``) is a
    scatter-add into W, with atomics on the card."""
    w = ins["W"][0]
    ids = ins["Ids"][0]
    flat = ids.reshape(-1).long()
    emb = w.index_select(0, flat)
    pad = attrs.get("padding_idx")
    if pad is not None and pad >= 0:
        emb = torch.where((flat == int(pad))[:, None],
                          torch.zeros((), dtype=emb.dtype, device=emb.device),
                          emb)
    out_shape = tuple(ids.shape[:-1] if ids.shape[-1] == 1 else ids.shape) \
        + (w.shape[-1],)
    return {"Out": [emb.reshape(out_shape)]}


@register_op("top_k", grad=None)
def top_k(ctx, ins, attrs):
    """The k largest values along the last axis and their int64 indices.
    Equal values keep the lowest indices, as ``jax.lax.top_k`` does: a
    stable descending sort, then the first k (``torch.topk`` picks among
    ties in no fixed order)."""
    k = int(attrs["k"])
    vals, idx = torch.sort(ins["X"][0], dim=-1, descending=True, stable=True)
    return {"Out": [vals[..., :k]], "Indices": [idx[..., :k].to(torch.int64)]}
