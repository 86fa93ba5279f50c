"""Tensor ops, the port of ``paddle_tpu/ops/tensor_ops.py``:
fill_constant, fill_zeros_like, uniform_random, gaussian_random,
truncated_gaussian_random, assign, cast, concat, split, reshape,
transpose, squeeze, unsqueeze, expand, pad, crop, reverse, slice,
lookup_table, top_k, arg_max, one_hot, multiplex, scatter, sequence_mask,
sampling_id, the training options' print, increment and pruning_mask,
generation's fill_constant_batch_size_like, assign_value and beam_gather,
the sequence API's shape, gather and arg_sort, and the host I/O ops save
and load.
Random ops draw from the context's per-op generator, on the context's
device.  Shape ops may return views of
their input; no emitter writes into an input.  ``print`` reads its tensor
on the host, so a block holding it never rides a captured step loop
(``framework/step_loop.safety_report``)."""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..framework.core import np_dtype, torch_dtype
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


@register_op("pipeline_stage", grad=None)
def pipeline_stage(ctx, ins, attrs):
    """Stage-boundary marker for the pipeline executors; a no-op under
    ``Executor`` and ``ParallelExecutor``."""
    return {}


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

@register_op("fill_zeros_like", grad=None)
def fill_zeros_like(ctx, ins, attrs):
    return {"Out": [torch.zeros_like(ins["X"][0])]}


_SQRT2 = math.sqrt(2.0)


@register_op("truncated_gaussian_random", grad=None, draws_rng=True)
def truncated_gaussian_random(ctx, ins, attrs):
    """mean + std·x, x standard normal truncated to [−2, 2] (the
    reference op's bounds), drawn by inverting the normal CDF of a
    uniform over [Φ(−2), Φ(2)] from the op's generator."""
    dt = torch_dtype(attrs.get("dtype", "float32"))
    mean = float(attrs.get("mean", 0.0))
    std = float(attrs.get("std", 1.0))
    edge = math.erf(2.0 / _SQRT2)
    u = torch.empty(_shape(attrs), dtype=torch.float32, device=ctx.device)
    u.uniform_(-edge, edge, generator=ctx.generator(attrs))
    x = torch.clamp(torch.erfinv(u) * _SQRT2, -2.0, 2.0)
    return {"Out": [(mean + std * x).to(dt)]}


@register_op("squeeze")
def squeeze(ctx, ins, attrs):
    """Drop the size-1 `axes` (all size-1 axes when none are given); an
    axis of another size raises, as ``jnp.squeeze`` does."""
    x = ins["X"][0]
    axes = tuple(int(a) % x.ndim for a in attrs.get("axes", ()))
    if not axes:
        return {"Out": [x.squeeze()]}
    bad = [a for a in axes if x.shape[a] != 1]
    if bad:
        raise ValueError(f"squeeze: axes {bad} of shape {tuple(x.shape)} "
                         "are not of size 1")
    return {"Out": [x.squeeze(axes)]}


@register_op("expand")
def expand(ctx, ins, attrs):
    """``jnp.tile`` by `expand_times`."""
    return {"Out": [torch.tile(ins["X"][0],
                               [int(t) for t in attrs["expand_times"]])]}


@register_op("pad")
def pad(ctx, ins, attrs):
    """Constant padding by the flat [lo0, hi0, lo1, hi1, ...] `paddings`
    (``F.pad`` takes the last axis first)."""
    x = ins["X"][0]
    p = [int(v) for v in attrs["paddings"]]
    width = []
    for i in reversed(range(x.ndim)):
        width += [p[2 * i], p[2 * i + 1]]
    return {"Out": [torch.nn.functional.pad(
        x, width, value=float(attrs.get("pad_value", 0.0)))]}


@register_op("crop")
def crop(ctx, ins, attrs):
    """X[offsets : offsets + shape] on every axis; an extent of −1 keeps
    the rest of the axis."""
    x = ins["X"][0]
    idx = tuple(slice(int(o), None if int(n) == -1 else int(o) + int(n))
                for o, n in zip(attrs["offsets"], attrs["shape"]))
    return {"Out": [x[idx]]}


@register_op("reverse")
def reverse(ctx, ins, attrs):
    """Flip along `axis` (an int or a list)."""
    axes = attrs.get("axis", [0])
    axes = axes if isinstance(axes, (list, tuple)) else [axes]
    return {"Out": [torch.flip(ins["X"][0], [int(a) for a in axes])]}


@register_op("sampling_id", grad=None, draws_rng=True)
def sampling_id(ctx, ins, attrs):
    """One int64 id a row of the probabilities X [B, C], drawn as
    ``jax.random.categorical`` draws it: the argmax of log(max(X, 1e-30))
    plus Gumbel noise from the op's generator."""
    x = ins["X"][0]
    logp = torch.log(torch.clamp(x.to(torch.float32), min=1e-30))
    u = torch.rand(logp.shape, generator=ctx.generator(attrs),
                   device=logp.device)
    gumbel = -torch.log(-torch.log(u))
    return {"Out": [torch.argmax(logp + gumbel, dim=-1).to(torch.int64)]}


@register_op("scatter", non_diff_inputs=("Ids",))
def scatter(ctx, ins, attrs):
    """X with its rows Ids replaced by Updates (a new tensor)."""
    x, ids, updates = ins["X"][0], ins["Ids"][0], ins["Updates"][0]
    return {"Out": [x.index_put((ids.long(),), updates.to(x.dtype))]}


@register_op("sequence_mask", grad=None)
def sequence_mask(ctx, ins, attrs):
    """Lengths [N] → mask [N, maxlen] in `out_dtype` (f32 by default)."""
    lengths = ins["X"][0]
    maxlen = int(attrs["maxlen"])
    dt = torch_dtype(attrs.get("out_dtype", "float32"))
    steps = torch.arange(maxlen, device=lengths.device)
    return {"Y": [(steps[None, :] < lengths[:, None]).to(dt)]}


@register_op("multiplex", non_diff_inputs=("Ids",))
def multiplex(ctx, ins, attrs):
    """Row b of the output is row b of candidate X[Ids[b]]."""
    ids = ins["Ids"][0].reshape(-1).long()
    stacked = torch.stack(ins["X"], dim=0)
    return {"Out": [stacked[ids, torch.arange(ids.shape[0],
                                              device=ids.device)]]}


@register_op("one_hot", grad=None)
def one_hot(ctx, ins, attrs):
    """f32 [N, depth] rows of X's ids (an id outside [0, depth) gives a
    row of zeros, as ``jax.nn.one_hot``)."""
    x = ins["X"][0].reshape(-1).long()
    depth = int(attrs["depth"])
    cls = torch.arange(depth, device=x.device)
    return {"Out": [(x[:, None] == cls[None, :]).to(torch.float32)]}


@register_op("arg_max", grad=None)
def arg_max(ctx, ins, attrs):
    """int64 index of the maximum along `axis`; among equal maxima the
    lowest index, as XLA's argmax (``torch.argmax`` returns the first)."""
    return {"Out": [torch.argmax(ins["X"][0], dim=int(attrs.get("axis", -1)))
                    .to(torch.int64)]}


@register_op("save", grad=None)
def save_op(ctx, ins, attrs):
    """Write X to `file_path` in numpy's ``.npy`` layout, through a file
    object so that no ``.npy`` is appended to the path (the JAX
    package's executor writes its save ops so, after the step; the port
    runs eagerly and writes here).  An existing file with ``overwrite``
    false raises.  A shape-only (meta) walk writes nothing."""
    x = ins["X"][0]
    if x.device.type == "meta":
        return {}
    path = str(attrs["file_path"])
    if os.path.exists(path) and not bool(attrs.get("overwrite", True)):
        raise IOError(f"save op: {path!r} exists and overwrite=False "
                      "(save_op.cc semantics)")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        np.save(f, to_numpy(x), allow_pickle=False)
    return {}


@register_op("load", grad=None)
def load_op(ctx, ins, attrs):
    """The array of `file_path` (a ``.npy`` layout, as ``save`` writes
    it), cast to `dtype` when given, on the context's device."""
    with open(str(attrs["file_path"]), "rb") as f:
        arr = np.load(f, allow_pickle=False)
    if attrs.get("dtype"):
        arr = arr.astype(np_dtype(attrs["dtype"]), copy=False)
        out = torch.from_numpy(np.ascontiguousarray(arr)).to(
            torch_dtype(attrs["dtype"]))
    else:
        out = torch.from_numpy(np.ascontiguousarray(arr))
    return {"Out": [out.to(ctx.device)]}

# analytic cost formula (analysis/cost.py; mechanism in registry.py)

from .registry import register_cost  # noqa: E402


def _lookup_table_cost(ins, outs, attrs):
    """Bytes override: an embedding gather reads only the B*D selected
    rows, not the whole table — the generic input-bytes default would
    charge the full vocab to every lookup and wreck the roofline's
    arithmetic-intensity denominator.  FLOPs stay ~0 (copy)."""
    out = outs.get("Out", [None])[0]
    ids = ins.get("Ids", [None])[0]
    if out is None:
        return {}
    item = 2 if str(out.dtype) == "bfloat16" else 4
    read = out.size * item + (ids.size * 8 if ids is not None else 0)
    return {"flops": 0, "bytes": read + out.size * item}


register_cost("lookup_table", _lookup_table_cost)

# ---------------------------------------------------------------------------
# sharding-propagation rule (analysis/sharding.py; mechanism in registry),
# as the JAX package's

from .registry import register_sharding  # noqa: E402


def _lookup_table_sharding(ctx, ins, outs, attrs):
    """Vocab-sharded embedding: a table sharded over a FREE mesh axis
    is looked up masked-locally and the output all-reduced over that
    axis (the mp vocab path); a table sharded over the ids' own batch
    axis (FSDP) is all-gathered instead — the calibrated GSPMD pair."""
    from ..analysis.sharding import entry_axes

    w = ins.get("W", [None])[0]
    ids = ins.get("Ids", [None])[0]
    out = outs.get("Out", [None])[0]
    if w is None or out is None:
        return {}
    batch = set(entry_axes(ids.spec[0])) if ids is not None and ids.spec \
        else set()
    vocab = w.spec[0] if w.spec else None
    lead = ids.spec[0] if ids is not None and ids.spec else None
    ndim = len(out.shape)
    spec = ((lead,) + (None,) * max(0, ndim - 2)
            + ((w.spec[-1],) if ndim >= 2 and len(w.spec) >= 2 else ()))
    spec = tuple(spec[:ndim])
    for a in entry_axes(vocab):
        if ctx.axis_size(a) <= 1:
            continue
        if a in batch:
            ctx.collective("all-gather", (a,), w.global_bytes,
                           var=w.name,
                           why="table sharded over the batch axis is "
                               "gathered for the lookup")
        else:
            ctx.collective("all-reduce", (a,),
                           ctx.device_bytes(out.name, spec),
                           var=out.name,
                           why="masked lookup over the sharded vocab "
                               "dim leaves partial rows",
                           scales_with_axes=True)
    return {"Out": [spec]}


register_sharding("lookup_table", _lookup_table_sharding)
