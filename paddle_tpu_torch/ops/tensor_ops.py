"""Tensor ops, the port of the part of ``paddle_tpu/ops/tensor_ops.py``
that the startup program, the LM tower, the recurrent models and ResNet
use: fill_constant, uniform_random, gaussian_random, assign, cast, concat,
split, reshape, transpose, slice, lookup_table, top_k, the training
options' print, increment and pruning_mask, generation's
fill_constant_batch_size_like, assign_value, unsqueeze and beam_gather,
and the sequence API's shape, gather and arg_sort.
Random ops draw from the context's per-op generator, on the context's
device.  Shape ops may return views of
their input; no emitter writes into an input.  ``print`` reads its tensor
on the host, so a block holding it never rides a captured step loop
(``framework/step_loop.safety_report``)."""

from __future__ import annotations

import torch

from ..framework.core import torch_dtype
from ..framework.scope import to_numpy
from .registry import register_op


def _shape(attrs):
    return [int(s) for s in attrs["shape"]]


@register_op("fill_constant", grad=None)
def fill_constant(ctx, ins, attrs):
    dt = torch_dtype(attrs.get("dtype", "float32"))
    return {"Out": [torch.full(_shape(attrs), attrs.get("value", 0.0),
                               dtype=dt, device=ctx.device)]}


@register_op("fill_constant_batch_size_like", grad=None)
def fill_constant_batch_size_like(ctx, ins, attrs):
    """fill_constant whose dim `output_dim_idx` is Input's dim
    `input_dim_idx`."""
    shape = _shape(attrs)
    shape[int(attrs.get("output_dim_idx", 0))] = \
        ins["Input"][0].shape[int(attrs.get("input_dim_idx", 0))]
    dt = torch_dtype(attrs.get("dtype", "float32"))
    return {"Out": [torch.full(shape, attrs.get("value", 0.0), dtype=dt,
                               device=ctx.device)]}


@register_op("assign_value", grad=None)
def assign_value(ctx, ins, attrs):
    """Constants carried in the attrs (assign_value_op.cc): fp32_values as
    float32, else int32_values as int32.  The executor's first run of the
    op uploads them (``ctx.constants``); every run returns a device copy
    of that upload, which a captured step loop can replay, as it cannot
    a copy from host memory."""
    entry = ctx.constants.get(id(attrs))
    if entry is None:
        if attrs.get("fp32_values"):
            vals = torch.tensor(attrs["fp32_values"], dtype=torch.float32)
        else:
            vals = torch.tensor(attrs["int32_values"], dtype=torch.int32)
        entry = (attrs, vals.reshape(_shape(attrs)).to(ctx.device))
        ctx.constants[id(attrs)] = entry
    return {"Out": [entry[1].clone()]}


@register_op("uniform_random", grad=None, draws_rng=True)
def uniform_random(ctx, ins, attrs):
    dt = torch_dtype(attrs.get("dtype", "float32"))
    lo = float(attrs.get("min", -1.0))
    hi = float(attrs.get("max", 1.0))
    out = torch.empty(_shape(attrs), dtype=torch.float32, device=ctx.device)
    out.uniform_(lo, hi, generator=ctx.generator(attrs))
    return {"Out": [out.to(dt)]}


@register_op("gaussian_random", grad=None, draws_rng=True)
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


@register_op("split")
def split(ctx, ins, attrs):
    """``jnp.split`` along `axis`: into `num` equal parts (which must
    divide the axis) or by the lengths in `sections`."""
    x = ins["X"][0]
    axis = int(attrs.get("axis", 0))
    if attrs.get("sections"):
        sizes = [int(s) for s in attrs["sections"]]
        if sum(sizes) != x.shape[axis]:
            raise ValueError(f"split: sections {sizes} do not sum to axis "
                             f"{axis}'s {x.shape[axis]}")
    else:
        num = int(attrs["num"])
        if x.shape[axis] % num:
            raise ValueError(f"split: {num} parts do not divide axis "
                             f"{axis}'s {x.shape[axis]}")
        sizes = [x.shape[axis] // num] * num
    return {"Out": list(torch.split(x, sizes, dim=axis))}


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


@register_op("unsqueeze")
def unsqueeze(ctx, ins, attrs):
    x = ins["X"][0]
    for ax in sorted(int(a) for a in attrs["axes"]):
        x = x.unsqueeze(ax)
    return {"Out": [x]}


@register_op("beam_gather", non_diff_inputs=("Index",))
def beam_gather(ctx, ins, attrs):
    """Reorder beam-lane state by parent pointers: X [B,K,...], Index
    [B,K] -> Out[b,k] = X[b, Index[b,k]] (the state shuffle after a
    beam_search step)."""
    x, idx = ins["X"][0], ins["Index"][0].long()
    full = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand(
        idx.shape + x.shape[2:])
    return {"Out": [torch.gather(x, 1, full)]}


@register_op("slice")
def slice_op(ctx, ins, attrs):
    x = ins["Input"][0]
    idx = [slice(None)] * x.ndim
    for ax, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        idx[int(ax)] = slice(int(s), int(e))
    return {"Out": [x[tuple(idx)]]}


class _Gather(torch.autograd.Function):
    """``w.index_select(0, flat)`` whose backward sums the rows'
    cotangents into dW by ``index_put_(accumulate=True)``: on the card
    that sorts the ids and adds each row's cotangents in one order, where
    autograd's ``index_add_`` adds them by atomics in whatever order the
    warps land, so two runs (or a replay and an eager run) from one state
    part.  XLA's scatter-add gives the JAX package one order too."""

    @staticmethod
    def forward(ctx, w, flat):
        ctx.save_for_backward(flat)
        ctx.w_shape = w.shape
        return w.index_select(0, flat)

    @staticmethod
    def backward(ctx, g):
        (flat,) = ctx.saved_tensors
        dw = g.new_zeros(ctx.w_shape).index_put_((flat,), g, accumulate=True)
        return dw, None


@register_op("shape", grad=None)
def shape_op(ctx, ins, attrs):
    """Input's shape as an int64 vector."""
    return {"Out": [torch.tensor(tuple(ins["Input"][0].shape),
                                 dtype=torch.int64, device=ctx.device)]}


@register_op("gather", non_diff_inputs=("Index",))
def gather(ctx, ins, attrs):
    """Rows of X picked along dim 0 by Index (any shape: the output is
    Index's shape + X's row shape)."""
    return {"Out": [ins["X"][0][ins["Index"][0].long()]]}


@register_op("arg_sort", grad=None)
def arg_sort(ctx, ins, attrs):
    """Ascending int64 order along `axis`, equal values in index order as
    ``jnp.argsort`` keeps them (a [B, 1] column sorts as [B])."""
    x = ins["X"][0]
    if x.ndim == 2 and x.shape[1] == 1:
        x = x[:, 0]
    return {"Out": [torch.argsort(x, dim=int(attrs.get("axis", 0)),
                                  stable=True).to(torch.int64)]}


@register_op("lookup_table", non_diff_inputs=("Ids",))
def lookup_table(ctx, ins, attrs):
    """Embedding lookup; its grad is ``_Gather``'s deterministic
    scatter-add into W."""
    w = ins["W"][0]
    ids = ins["Ids"][0]
    flat = ids.reshape(-1).long()
    emb = _Gather.apply(w, flat)
    pad = attrs.get("padding_idx")
    if pad is not None and pad >= 0:
        emb = torch.where((flat == int(pad))[:, None],
                          torch.zeros((), dtype=emb.dtype, device=emb.device),
                          emb)
    out_shape = tuple(ids.shape[:-1] if ids.shape[-1] == 1 else ids.shape) \
        + (w.shape[-1],)
    return {"Out": [emb.reshape(out_shape)]}


def stable_topk(x, k):
    """The k largest values along the last axis and their indices, equal
    values keeping the lowest indices as ``jax.lax.top_k`` does: a stable
    descending sort, then the first k (``torch.topk`` picks among ties in
    no fixed order on the card)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@register_op("top_k", grad=None)
def top_k(ctx, ins, attrs):
    """The k largest values along the last axis and their int64 indices
    (``stable_topk``)."""
    vals, idx = stable_topk(ins["X"][0], int(attrs["k"]))
    return {"Out": [vals], "Indices": [idx.to(torch.int64)]}


@register_op("print")
def print_op(ctx, ins, attrs):
    """Debug print: passes its input through and prints it, after
    ``message``, unless ``print_phase`` is ``"none"``."""
    x = ins["X"][0]
    if attrs.get("print_phase", "forward") != "none":
        print(f"{attrs.get('message', '')}{to_numpy(x)}", flush=True)
    return {"Out": [x]}


@register_op("increment")
def increment(ctx, ins, attrs):
    return {"Out": [ins["X"][0] + attrs.get("step", 1.0)]}


@register_op("pruning_mask", grad=None)
def pruning_mask(ctx, ins, attrs):
    """A static pruning mask from a parameter's magnitudes: the smallest
    ``sparsity_ratio`` of them by count get 0, the rest 1 (f32).  The sort
    is stable, so among equal magnitudes the lowest indices are pruned
    first, as ``jnp.argsort`` orders them."""
    x = ins["X"][0].float()
    ratio = float(attrs.get("sparsity_ratio", 0.5))
    absx = torch.abs(x).reshape(-1)
    n = absx.shape[0]
    k = int(max(0.0, min(1.0, ratio)) * n)
    order = torch.argsort(absx, stable=True)
    mask = torch.zeros(n, dtype=torch.float32, device=x.device)
    mask[order[k:]] = 1.0
    return {"Out": [mask.reshape(x.shape)]}
