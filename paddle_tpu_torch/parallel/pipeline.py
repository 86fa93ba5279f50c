"""Pipeline parallelism over a `pp` mesh axis (GPipe fill/drain) — the
port of ``paddle_tpu/parallel/pipeline.py``.

Stage parameters are stacked on a leading axis, one slice a `pp`
position; activations hop stages with ``collectives.ppermute``.  The
schedule is a Python loop over ticks, and at each tick every position
(of this process, over a mesh of several) whose stage has a microbatch
in flight runs it on its own device.  JAX runs every stage
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
    """Run the pipeline over every position of `mesh` at once (over a
    mesh of several processes, this process's).

    params: one stage-sliced pytree a position (row-major mesh order).
    x_micro: one [n_micro, micro_bs, width] tensor a position — the
    microbatches, replicated over `axis_name`.  Returns one
    [n_micro, micro_bs, width] tensor a position: the LAST stage's
    outputs, replicated over `axis_name` by a masked psum as in JAX.
    Positions of other processes hold None throughout."""
    n_stages = axis_size(mesh, axis_name)
    stage = collectives.axis_index(mesh, axis_name)
    n_micro = x_micro[mesh.local[0]].shape[0]
    ticks = n_micro + n_stages - 1
    # stage s sends to s+1; the last stage's output is collected, not
    # forwarded
    fwd_perm = [(s, s + 1) for s in range(n_stages - 1)]
    buf = mesh.local_map(lambda p: torch.zeros_like(x_micro[p][0]))
    outs = [[None] * n_micro for _ in x_micro]
    for t in range(ticks):
        ys = [None] * mesh.size
        for p in mesh.local:
            s, m, x = stage[p], t - stage[p], x_micro[p]
            if not 0 <= m < n_micro:
                ys[p] = torch.zeros_like(buf[p])
                continue
            x_in = x[m] if s == 0 else buf[p]
            y = stage_fn(params[p], x_in).to(x.dtype)
            if s == n_stages - 1:
                outs[p][m] = y
            ys[p] = y
        buf = collectives.ppermute(ys, mesh, axis_name, fwd_perm)
    masked = mesh.local_map(
        lambda p: torch.stack(outs[p]) if stage[p] == n_stages - 1
        else torch.zeros_like(x_micro[p]))
    return collectives.psum(masked, mesh, axis_name)


def _leaves(params, mesh, spec_of):
    """One leaf dict a position of this process: its slice of each
    stacked parameter (the whole of one `spec_of` gives None), on its
    device, a tensor of its own (so a gradient summed over positions goes
    through an explicit psum)."""

    def one(p):
        leaf = {}
        for k, v in params.items():
            v = torch.as_tensor(v)
            if spec_of(k):
                v = local_slice(mesh, v, spec_of(k), p).squeeze(0)
            leaf[k] = v.detach().to(mesh.device(p)).clone() \
                .requires_grad_(True)
        return leaf

    return mesh.local_map(one)


def _restack(leaves, grads, mesh, axis, lr, stacked):
    """New global parameters: each stacked leaf's slices (from the first
    position holding each index along `axis`; over several processes its
    owner computes and sends it), replicated ones from this process's
    first position, each stepped by SGD with its summed gradient."""
    new = {}
    idx = collectives.axis_index(mesh, axis)
    p0 = mesh.local[0]
    first = {}
    for p, i in enumerate(idx):
        first.setdefault(i, p)
    step = {(k, p): (lambda k=k, p=p: (leaves[p][k] - lr * grads[k][p])
                     .detach()) for k in stacked for p in first.values()}
    wants = [((k, p), mesh.process_of(p), dst) for k in sorted(stacked)
             for p in first.values() for dst in range(mesh.process_count)]
    like = {k: leaves[p0][k] for k in stacked}
    got = collectives._swap(mesh, wants, lambda key: step[key](),
                            lambda key: (tuple(like[key[0]].shape),
                                         like[key[0]].dtype,
                                         like[key[0]].device))
    for k in leaves[p0]:
        if k in stacked:
            new[k] = torch.stack([
                (step[(k, p)]() if mesh.is_local(p) else got[(k, p)]).to(
                    leaves[p0][k].device)
                for _, p in sorted(first.items())])
        else:
            new[k] = (leaves[p0][k] - lr * grads[k][p0]).detach()
    return new


def _grads(leaves, mesh, axes_of):
    """Each leaf's gradient summed over the positions that hold the same
    value (`axes_of(name)`: the mesh axes it is replicated over), through
    a counted psum."""
    out = {}
    for k in leaves[mesh.local[0]]:
        g = mesh.local_map(lambda p: leaves[p][k].grad
                           if leaves[p][k].grad is not None
                           else torch.zeros_like(leaves[p][k]))
        axes = tuple(a for a in axes_of(k) if axis_size(mesh, a) > 1)
        out[k] = collectives.psum(g, mesh, axes) if axes else g
    return out


def backward_once(mesh, loss, since):
    """The backward of a loss every position holds the same copy of: the
    process that owns position 0 takes the cotangent, every other passes
    zeros, and every exchange's backward runs on every process
    (``transport.backward``).  Returns this process's copy, detached."""
    from . import transport

    mine = loss[mesh.local[0]]
    ct = torch.ones_like(mine) if mesh.process_of(0) == \
        mesh.process_index else torch.zeros_like(mine)
    transport.backward(mesh.transport, [mine], [ct], since)
    return mine.detach()


def build_pipeline_train_step(mesh, n_micro: int, width: int,
                              lr: float = 0.1,
                              stage_fn: Callable = _stage_fn):
    """(train_step, shard): ``train_step(params, x [B, width], y [B,
    width]) -> (loss, new_params)`` with params stacked over the mesh's
    `pp` axis and data split over `dp`; ``shard`` is the params'
    sharding, ``P("pp")`` over `mesh`."""
    from . import transport
    from .mesh import named

    has_dp = "dp" in mesh.axis_names

    def train_step(params, x, y):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        xm = x.reshape(n_micro, x.shape[0] // n_micro, width)
        ym = y.reshape(n_micro, y.shape[0] // n_micro, width)
        with torch.enable_grad():
            since = transport.mark(mesh.transport)
            leaves = _leaves(params, mesh, lambda k: P("pp"))
            data = P(None, "dp")
            xs, ys = (mesh.local_map(lambda p, v=v: local_slice(
                mesh, v, data, p).to(mesh.device(p))) for v in (xm, ym))
            out = pipeline_apply(leaves, xs, mesh, stage_fn=stage_fn)
            loss = mesh.local_map(lambda p: torch.mean((out[p] - ys[p])
                                                       ** 2))
            if has_dp:
                loss = collectives.pmean(loss, mesh, "dp")
            loss = collectives.pmean(loss, mesh, "pp")
            mine = backward_once(mesh, loss, since)
        grads = _grads(leaves, mesh, lambda k: ("dp",))
        with torch.no_grad():
            new = _restack(leaves, grads, mesh, "pp", lr,
                           set(leaves[mesh.local[0]]))
        return mine, new

    return train_step, named(mesh, "pp")
