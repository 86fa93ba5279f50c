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
from .pipeline import _grads, _leaves, _restack


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
    """Over every position of `mesh` at once: x one [tokens, d_model]
    local shard a position; params one dict a position holding this
    member's expert only (wi [d_model, d_hidden], wo [d_hidden,
    d_model]) and the replicated gate [d_model, n_experts]."""
    n_exp = axis_size(mesh, axis_name)
    sends, routes = [], []
    for prm, xp in zip(params, x):
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
        sends.append(send)
        routes.append((expert, src_slot, keep, gatew))
    # after the exchange each member holds the tokens every sender routed
    # to ITS expert: [n_senders, capacity, D]
    recv = collectives.all_to_all(sends, mesh, axis_name, 0, 0, tiled=False)
    hs = [torch.relu(r @ prm["wi"]) @ prm["wo"]
          for r, prm in zip(recv, params)]
    back = collectives.all_to_all(hs, mesh, axis_name, 0, 0, tiled=False)
    out = []
    for b, xp, (expert, src_slot, keep, gatew) in zip(back, x, routes):
        y = b[expert, src_slot] * torch.where(
            keep, gatew, torch.zeros_like(gatew))[:, None]
        # dropped tokens ride the residual connection
        out.append(torch.where(keep[:, None], y, xp))
    return out


def build_moe_train_step(mesh, d_model: int, d_hidden: int, capacity: int,
                         lr: float = 0.1):
    """``train_step(params, x [tokens, D], y) -> (loss, new_params)``:
    experts split over `ep`, tokens over (`dp`, `ep`)."""
    spec = {"wi": P("ep"), "wo": P("ep"), "gate": None}
    tokens = P(("dp", "ep"))

    def train_step(params, x, y):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        with torch.enable_grad():
            leaves = _leaves(params, mesh, spec.get)
            xs = [local_slice(mesh, x, tokens, p).to(mesh.device(p))
                  for p in range(mesh.size)]
            ys = [local_slice(mesh, y, tokens, p).to(mesh.device(p))
                  for p in range(mesh.size)]
            out = moe_apply(leaves, xs, mesh, capacity=capacity)
            loss = [torch.mean((o - t) ** 2) for o, t in zip(out, ys)]
            loss = collectives.pmean(collectives.pmean(loss, mesh, "dp"),
                                     mesh, "ep")
            loss[0].backward()
        # an expert is held by its ep member's dp positions; the gate by
        # every position
        grads = _grads(leaves, mesh, lambda k: ("dp",) if spec[k]
                       else ("dp", "ep"))
        with torch.no_grad():
            new = _restack(leaves, grads, mesh, "ep", lr, {"wi", "wo"})
        return loss[0].detach(), new

    return train_step
