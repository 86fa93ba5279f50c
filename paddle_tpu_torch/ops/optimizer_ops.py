"""Optimizer ops, the port of ``adam``, ``adam_beta_pow_update`` and
``momentum`` in ``paddle_tpu/ops/optimizer_ops.py``: f32 moments and
velocities, a bf16 parameter updated through f32.  Each output is a new tensor, never an update in
place, so a value fetched earlier in the step (a view of a parameter, such
as the sliced position table) keeps its pre-update value, as in JAX."""

from __future__ import annotations

import torch

from .registry import register_op


@register_op("adam", grad=None)
def adam(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    m, v = ins["Moment1"][0], ins["Moment2"][0]
    lr = ins["LearningRate"][0].reshape(())
    b1p = ins["Beta1Pow"][0].reshape(())
    b2p = ins["Beta2Pow"][0].reshape(())
    b1 = float(attrs.get("beta1", 0.9))
    b2 = float(attrs.get("beta2", 0.999))
    eps = float(attrs.get("epsilon", 1e-8))
    g = g.float()
    m_out = b1 * m + (1 - b1) * g
    v_out = b2 * v + (1 - b2) * g * g
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    p_out = (p.float() - lr_t * m_out / (torch.sqrt(v_out) + eps)).to(p.dtype)
    return {"ParamOut": [p_out], "Moment1Out": [m_out], "Moment2Out": [v_out]}


@register_op("adam_beta_pow_update", grad=None)
def adam_beta_pow_update(ctx, ins, attrs):
    """Advance the Beta1Pow/Beta2Pow accumulators by one step."""
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    return {
        "Beta1PowOut": [b1p * float(attrs["beta1"])],
        "Beta2PowOut": [b2p * float(attrs["beta2"])],
    }


@register_op("momentum", grad=None)
def momentum(ctx, ins, attrs):
    """v' = mu·v + g; p' = p − lr·v' (Nesterov: p − lr·(g + mu·v')), the
    velocity in its own dtype (f32 for a bf16 parameter)."""
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    lr = ins["LearningRate"][0].reshape(())
    mu = float(attrs["mu"])
    g = g.to(v.dtype)
    v_out = mu * v + g
    if attrs.get("use_nesterov", False):
        upd = (g + mu * v_out) * lr
    else:
        upd = lr * v_out
    return {"ParamOut": [(p.float() - upd).to(p.dtype)],
            "VelocityOut": [v_out]}
