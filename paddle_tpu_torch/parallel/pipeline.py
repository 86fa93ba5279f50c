"""Pipeline parallelism over a `pp` mesh axis (GPipe fill/drain) — the
port of ``paddle_tpu/parallel/pipeline.py``.

Stage parameters are stacked on a leading axis, one slice a `pp`
position; activations hop stages with ``collectives.ppermute``.  The
port is single-controller (``parallel/mesh.py``): the schedule is a
Python loop over ticks, and at each tick every position whose stage has
a microbatch in flight runs it on its own device.  JAX runs every stage
at every tick inside one ``lax.scan`` and masks the bubbles to zero;
that masked work adds nothing to the loss or its gradient, so skipping
it gives the same result.  Autograd through the schedule is pipeline
backward (a ``.to(device)`` hop transposes to the reverse hop).

Schedule: ``n_micro + n_stages - 1`` ticks a step, one counted hop a
tick."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from . import collectives
from .mesh import axis_size, local_slice, pspec as P


def _stage_fn(params, x):
    """Default per-stage compute: a tanh MLP block on this stage's
    slice of the stacked parameters."""
    return torch.tanh(x @ params["w"] + params["b"])


def init_pipeline_params(generator: torch.Generator, n_stages: int,
                         width: int):
    """Stacked per-stage parameters (leading axis: pipeline stage), drawn
    from `generator` on the CPU (the train step moves each position's
    slice to its device)."""
    w = torch.randn((n_stages, width, width), generator=generator,
                    dtype=torch.float32) * (1.0 / np.sqrt(width))
    return {"w": w, "b": torch.zeros((n_stages, width), dtype=torch.float32)}


def pipeline_apply(params, x_micro, mesh, *, axis_name: str = "pp",
                   stage_fn: Callable = _stage_fn):
    """Run the pipeline over every position of `mesh` at once.

    params: one stage-sliced pytree a position (row-major mesh order).
    x_micro: one [n_micro, micro_bs, width] tensor a position — the
    microbatches, replicated over `axis_name`.  Returns one
    [n_micro, micro_bs, width] tensor a position: the LAST stage's
    outputs, replicated over `axis_name` by a masked psum as in JAX."""
    n_stages = axis_size(mesh, axis_name)
    stage = collectives.axis_index(mesh, axis_name)
    n_micro = x_micro[0].shape[0]
    ticks = n_micro + n_stages - 1
    # stage s sends to s+1; the last stage's output is collected, not
    # forwarded
    fwd_perm = [(s, s + 1) for s in range(n_stages - 1)]
    buf = [torch.zeros_like(x[0]) for x in x_micro]
    outs = [[None] * n_micro for _ in x_micro]
    for t in range(ticks):
        ys = []
        for p, x in enumerate(x_micro):
            s, m = stage[p], t - stage[p]
            if not 0 <= m < n_micro:
                ys.append(torch.zeros_like(buf[p]))
                continue
            x_in = x[m] if s == 0 else buf[p]
            y = stage_fn(params[p], x_in).to(x.dtype)
            if s == n_stages - 1:
                outs[p][m] = y
            ys.append(y)
        buf = collectives.ppermute(ys, mesh, axis_name, fwd_perm)
    masked = [torch.stack(o) if stage[p] == n_stages - 1
              else torch.zeros_like(x_micro[p]) for p, o in enumerate(outs)]
    return collectives.psum(masked, mesh, axis_name)


def _leaves(params, mesh, spec_of):
    """One leaf dict a position: its slice of each stacked parameter (the
    whole of one `spec_of` gives None), on its device, a tensor of its own
    (so a gradient summed over positions goes through an explicit
    psum)."""
    out = []
    for p in range(mesh.size):
        leaf = {}
        for k, v in params.items():
            v = torch.as_tensor(v)
            if spec_of(k):
                v = local_slice(mesh, v, spec_of(k), p).squeeze(0)
            leaf[k] = v.detach().to(mesh.device(p)).clone() \
                .requires_grad_(True)
        out.append(leaf)
    return out


def _restack(leaves, grads, mesh, axis, lr, stacked):
    """New global parameters: each stacked leaf's slices (from the first
    position holding each index along `axis`), replicated ones from
    position 0, each stepped by SGD with its summed gradient."""
    new = {}
    idx = collectives.axis_index(mesh, axis)
    for k in leaves[0]:
        if k in stacked:
            first = {}
            for p, i in enumerate(idx):
                first.setdefault(i, p)
            new[k] = torch.stack([
                (leaves[p][k] - lr * grads[k][p]).detach().to(
                    leaves[0][k].device)
                for _, p in sorted(first.items())])
        else:
            new[k] = (leaves[0][k] - lr * grads[k][0]).detach()
    return new


def _grads(leaves, mesh, axes_of):
    """Each leaf's gradient summed over the positions that hold the same
    value (`axes_of(name)`: the mesh axes it is replicated over), through
    a counted psum."""
    out = {}
    for k in leaves[0]:
        g = [lv[k].grad if lv[k].grad is not None
             else torch.zeros_like(lv[k]) for lv in leaves]
        axes = tuple(a for a in axes_of(k) if axis_size(mesh, a) > 1)
        out[k] = collectives.psum(g, mesh, axes) if axes else g
    return out


def build_pipeline_train_step(mesh, n_micro: int, width: int,
                              lr: float = 0.1,
                              stage_fn: Callable = _stage_fn):
    """(train_step, shard): ``train_step(params, x [B, width], y [B,
    width]) -> (loss, new_params)`` with params stacked over the mesh's
    `pp` axis and data split over `dp`; ``shard`` is the params'
    sharding, ``P("pp")`` over `mesh`."""
    from .mesh import named

    has_dp = "dp" in mesh.axis_names

    def train_step(params, x, y):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        xm = x.reshape(n_micro, x.shape[0] // n_micro, width)
        ym = y.reshape(n_micro, y.shape[0] // n_micro, width)
        with torch.enable_grad():
            leaves = _leaves(params, mesh, lambda k: P("pp"))
            data = P(None, "dp")
            xs = [local_slice(mesh, xm, data, p).to(mesh.device(p))
                  for p in range(mesh.size)]
            ys = [local_slice(mesh, ym, data, p).to(mesh.device(p))
                  for p in range(mesh.size)]
            out = pipeline_apply(leaves, xs, mesh, stage_fn=stage_fn)
            loss = [torch.mean((o - t) ** 2) for o, t in zip(out, ys)]
            if has_dp:
                loss = collectives.pmean(loss, mesh, "dp")
            loss = collectives.pmean(loss, mesh, "pp")
            loss[0].backward()
        grads = _grads(leaves, mesh, lambda k: ("dp",))
        with torch.no_grad():
            new = _restack(leaves, grads, mesh, "pp", lr, set(leaves[0]))
        return loss[0].detach(), new

    return train_step, named(mesh, "pp")
