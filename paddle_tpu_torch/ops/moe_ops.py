"""Mixture-of-experts op — the port of ``paddle_tpu/ops/moe_ops.py``.

Top-1 gating with a static capacity an expert, so the layer is fixed
shape.  On one device the dispatch, the experts and the combine run
locally (a batched product over the stacked experts).  Under a
``ParallelExecutor`` whose mesh has an 'ep' axis > 1 (``mesh_emit``,
``_moe_sharded``), the expert weights live one expert a member and the
tokens are exchanged with ``collectives.all_to_all`` over 'ep' — the same
dispatch on each member's tokens, so the one-device and the ep-sharded
results agree whenever no token is dropped for capacity."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .registry import (register_cost, register_mesh_emit, register_op,
                       register_sharding)


def _dispatch(x, gate_w, n_exp, capacity):
    """Token -> (expert, slot) routing: (expert [T], src_slot [T], keep
    [T], gatew [T]) — the top-1 expert, the token's slot in that expert's
    capacity buffer, whether it fits, and its gate weight."""
    probs = torch.softmax(x @ gate_w, dim=-1)          # [T, E]
    expert = torch.argmax(probs, dim=-1)               # [T]
    gatew = probs.max(dim=-1).values                   # [T]
    onehot = F.one_hot(expert, n_exp).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0) * onehot         # 1-based slot
    pos_in_expert = pos.sum(-1) - 1                    # [T]
    keep = pos_in_expert < capacity
    src_slot = torch.where(keep, pos_in_expert,
                           torch.full_like(pos_in_expert, capacity - 1))
    return expert, src_slot.long(), keep, gatew


def _scatter_send(x, expert, src_slot, keep, n_exp, capacity):
    send = torch.zeros((n_exp, capacity, x.shape[-1]), dtype=x.dtype,
                       device=x.device)
    vals = torch.where(keep[:, None], x, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))
    return send.index_put((expert, src_slot), vals, accumulate=True)


def _combine(back, expert, src_slot, keep, gatew, x):
    """Expert outputs back in token order; dropped tokens ride the
    residual path."""
    w = torch.where(keep, gatew, torch.zeros((), dtype=gatew.dtype,
                                             device=gatew.device))
    out = back[expert, src_slot] * w[:, None]
    return torch.where(keep[:, None], out.to(x.dtype), x)


def _act(name):
    return {"relu": torch.relu,
            "gelu": lambda t: F.gelu(t, approximate="tanh"),
            "tanh": torch.tanh}[name]


def _ffn(h_in, wi, wo, act):
    return _act(act)(h_in @ wi) @ wo


@register_op("moe")
def moe(ctx, ins, attrs):
    """X [T, D] tokens; Gate [D, E]; WI [E, D, H]; WO [E, H, D] -> Out
    [T, D].  attrs: capacity_factor (1.0), act ('relu').  Capacity is
    ceil(tokens / E * factor)."""
    x = ins["X"][0]
    gate_w = ins["Gate"][0]
    wi, wo = ins["WI"][0], ins["WO"][0]
    n_exp = wi.shape[0]
    factor = float(attrs.get("capacity_factor", 1.0))
    act = str(attrs.get("act", "relu"))
    capacity = max(1, math.ceil(x.shape[0] / n_exp * factor))
    expert, src_slot, keep, gatew = _dispatch(x, gate_w, n_exp, capacity)
    send = _scatter_send(x, expert, src_slot, keep, n_exp, capacity)
    h = _ffn(send, wi, wo, act)  # [E, C, D] batched over experts
    return {"Out": [_combine(h, expert, src_slot, keep, gatew, x)]}


def _moe_sharded(ctx, ins, attrs):
    """The mesh emitter: tokens split over ('dp', 'ep') (the axes of size
    > 1), experts one a member over 'ep'; each member dispatches its
    tokens, ``all_to_all`` sends each expert its tokens, the member's
    expert computes, ``all_to_all`` returns them, and each member
    combines.  None without an 'ep' axis."""
    from ..parallel import collectives as col
    from ..parallel.mesh import axis_size
    from ..parallel.parallel_executor import MeshPlan
    from ..parallel.sharded import ShardedTensor

    mesh = ctx.mesh
    ep = axis_size(mesh, "ep")
    if ep <= 1:
        return None
    x, wi = ins["X"][0], ins["WI"][0]
    n_exp = wi.shape[0]
    if n_exp != ep:
        raise ValueError(
            f"moe op: {n_exp} experts must equal the mesh's ep axis size "
            f"{ep} (one expert per member)")
    token_axes = tuple(a for a in ("dp", "ep") if axis_size(mesh, a) > 1)
    members = 1
    for a in token_axes:
        members *= axis_size(mesh, a)
    T = x.shape[0]
    if T % members:
        raise ValueError(
            f"moe op: token count {T} must divide the token-sharding "
            f"members {members} ({token_axes})")
    factor = float(attrs.get("capacity_factor", 1.0))
    act = str(attrs.get("act", "relu"))
    capacity = max(1, math.ceil(T // members / n_exp * factor))
    tok = (token_axes, None)
    in_specs = {"X": [tok], "Gate": [(None, None)],
                "WI": [(("ep",), None, None)], "WO": [(("ep",), None, None)]}

    def run(view, ctxs):
        each = mesh.local_map
        xs = each(lambda p: view("X", 0, p))
        routes = each(lambda p: _dispatch(xs[p], view("Gate", 0, p), n_exp,
                                          capacity))
        send = each(lambda p: _scatter_send(xs[p], *routes[p][:3], n_exp,
                                            capacity))
        # [E, C, D] -> each member holds every sender's tokens for ITS
        # expert: [senders, C, D]
        recv = col.all_to_all(send, mesh, "ep", split_axis=0,
                              concat_axis=0, tiled=False)
        h = each(lambda p: _ffn(recv[p], view("WI", 0, p)[0],
                                view("WO", 0, p)[0], act))
        back = col.all_to_all(h, mesh, "ep", split_axis=0, concat_axis=0,
                              tiled=False)
        out = each(lambda p: _combine(back[p], *routes[p][:2], routes[p][2],
                                      routes[p][3], xs[p]))
        return {"Out": [ShardedTensor(mesh, tok, out)]}

    return MeshPlan(in_specs, mesh.axis_names, run, mesh_aware=True)


register_mesh_emit("moe", _moe_sharded)


# ---------------------------------------------------------------------------
# analytic cost formula and sharding rule, as the JAX package's


def _moe_cost(ins, outs, attrs):
    """Gate matmul (2*T*D*E) + the two expert matmuls over every routed
    token (4*T*D*H at capacity).  Bytes override adds the all_to_all
    dispatch/return buffers (2 x token bytes each way)."""
    x = ins.get("X", [None])[0]
    gate = ins.get("Gate", [None])[0]
    wi = ins.get("WI", [None])[0]
    if x is None or gate is None or wi is None or len(x.shape) != 2:
        return {}
    t, d = x.shape
    e = gate.shape[1]
    h = wi.shape[2] if len(wi.shape) == 3 else d
    factor = float(attrs.get("capacity_factor", 1.0))
    routed = int(t * max(factor, 1.0))
    flops = 2 * t * d * e + 4 * routed * d * h
    item = 2 if str(x.dtype) == "bfloat16" else 4
    collective = 4 * t * d * item  # dispatch + return, both all_to_all
    return {"flops": flops, "collective_bytes": collective}


register_cost("moe", _moe_cost)


def _moe_sharding(ctx, ins, outs, attrs):
    """Expert-parallel dispatch: tokens ride an all_to_all to their
    expert's member and back (2x the send buffer each direction); the
    backward re-pays both (bwd_retrace)."""
    x = ins.get("X", [None])[0]
    out = outs.get("Out", [None])[0]
    if x is None or out is None:
        return {}
    ep = ctx.axis_size("ep")
    if ep > 1:
        ctx.collective("all-to-all", ("ep",),
                       2 * x.device_bytes(ctx.analysis.axis_sizes),
                       var=out.name,
                       why="token dispatch + return over the expert "
                           "axis", scales_with_axes=True)
    return {"Out": [tuple(x.spec)]}


_moe_sharding.bwd_retrace = True
register_sharding("moe", _moe_sharding)
