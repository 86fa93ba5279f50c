"""Expert parallelism (MoE) over an `ep` mesh axis — the port of
``paddle_tpu/parallel/moe.py``.

Expert weights live one expert an `ep` position; tokens are top-1 gated
and exchanged with ``collectives.all_to_all``, computed by their expert,
and returned.  Capacity is static (`capacity` tokens an expert a sender),
so every shape is fixed: dropped tokens pass through on the residual
path."""

from __future__ import annotations

import numpy as np
import torch

from . import collectives
from .mesh import axis_size, local_slice, pspec as P
from .pipeline import _grads, _leaves, _restack, backward_once


def init_moe_params(generator: torch.Generator, n_experts: int,
                    d_model: int, d_hidden: int):
    """Stacked per-expert FFN params (leading axis: expert) and the
    replicated gate, drawn from `generator` on the CPU."""
    scale = 1.0 / np.sqrt(d_model)

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32)

    return {
        "wi": normal(n_experts, d_model, d_hidden) * scale,
        "wo": normal(n_experts, d_hidden, d_model) * (1.0 / np.sqrt(d_hidden)),
        "gate": normal(d_model, n_experts) * scale,
    }


def moe_apply(params, x, mesh, *, axis_name: str = "ep", capacity: int):
    """Over every position of `mesh` at once (over a mesh of several
    processes, this process's; the others' entries None): x one [tokens,
    d_model] local shard a position; params one dict a position holding
    this member's expert only (wi [d_model, d_hidden], wo [d_hidden,
    d_model]) and the replicated gate [d_model, n_experts]."""
    n_exp = axis_size(mesh, axis_name)
    sends, routes = [None] * mesh.size, [None] * mesh.size
    for p in mesh.local:
        prm, xp = params[p], x[p]
        probs = torch.softmax(xp @ prm["gate"], dim=-1)       # [T, E]
        expert = torch.argmax(probs, dim=-1)                  # [T] top-1
        gatew = torch.max(probs, dim=-1).values               # [T]
        # position of each token within its expert's send buffer
        onehot = torch.nn.functional.one_hot(expert, n_exp)   # [T, E]
        pos = torch.cumsum(onehot, dim=0) * onehot            # 1-based
        pos_in_expert = pos.sum(-1) - 1
        keep = pos_in_expert < capacity
        src_slot = torch.where(keep, pos_in_expert,
                               torch.full_like(pos_in_expert, capacity - 1))
        send = torch.zeros((n_exp, capacity, xp.shape[1]), dtype=xp.dtype,
                           device=xp.device)
        send = send.index_put((expert, src_slot),
                              torch.where(keep[:, None], xp,
                                          torch.zeros_like(xp)),
                              accumulate=True)
        sends[p] = send
        routes[p] = (expert, src_slot, keep, gatew)
    # after the exchange each member holds the tokens every sender routed
    # to ITS expert: [n_senders, capacity, D]
    recv = collectives.all_to_all(sends, mesh, axis_name, 0, 0, tiled=False)
    hs = mesh.local_map(lambda p: torch.relu(recv[p] @ params[p]["wi"])
                        @ params[p]["wo"])
    back = collectives.all_to_all(hs, mesh, axis_name, 0, 0, tiled=False)

    def combine(p):
        expert, src_slot, keep, gatew = routes[p]
        y = back[p][expert, src_slot] * torch.where(
            keep, gatew, torch.zeros_like(gatew))[:, None]
        # dropped tokens ride the residual connection
        return torch.where(keep[:, None], y, x[p])

    return mesh.local_map(combine)


def build_moe_train_step(mesh, d_model: int, d_hidden: int, capacity: int,
                         lr: float = 0.1):
    """``train_step(params, x [tokens, D], y) -> (loss, new_params)``:
    experts split over `ep`, tokens over (`dp`, `ep`)."""
    from . import transport

    spec = {"wi": P("ep"), "wo": P("ep"), "gate": None}
    tokens = P(("dp", "ep"))

    def train_step(params, x, y):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        with torch.enable_grad():
            since = transport.mark(mesh.transport)
            leaves = _leaves(params, mesh, spec.get)
            xs, ys = (mesh.local_map(lambda p, v=v: local_slice(
                mesh, v, tokens, p).to(mesh.device(p))) for v in (x, y))
            out = moe_apply(leaves, xs, mesh, capacity=capacity)
            loss = mesh.local_map(lambda p: torch.mean((out[p] - ys[p])
                                                       ** 2))
            loss = collectives.pmean(collectives.pmean(loss, mesh, "dp"),
                                     mesh, "ep")
            mine = backward_once(mesh, loss, since)
        # an expert is held by its ep member's dp positions; the gate by
        # every position
        grads = _grads(leaves, mesh, lambda k: ("dp",) if spec[k]
                       else ("dp", "ep"))
        with torch.no_grad():
            new = _restack(leaves, grads, mesh, "ep", lr, {"wi", "wo"})
        return mine, new

    return train_step
