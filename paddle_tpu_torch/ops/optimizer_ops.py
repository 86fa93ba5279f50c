"""Optimizer ops, the port of ``paddle_tpu/ops/optimizer_ops.py``: every
update op and ``average_accumulates`` (``ModelAverage``'s window sums).
Adam and Momentum keep f32 moments and velocities and update a bf16
parameter through f32; the others compute in the dtypes JAX promotes
their inputs to, so SGD on a bf16 parameter with an f32 learning rate
hands back an f32 parameter, as it does in JAX.  To get JAX's promotion a
learning rate or step count enters as a ``[1, ..., 1]`` tensor, never a
0-d one: torch lets a 0-d tensor take the other operand's dtype, JAX does
not.  Each output is a new tensor, never an update in place, so a value
fetched earlier in the step (a view of a parameter, such as the sliced
position table) keeps its pre-update value, as in JAX.  Every choice
(``ftrl``'s threshold, the window's rotation) is a ``torch.where`` on the
device: nothing reads a tensor on the host."""

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


def _scalar(ins, slot, like):
    """The [1] input `slot` as a tensor of rank ``like.ndim``."""
    return ins[slot][0].reshape((1,) * like.ndim)


@register_op("sgd", grad=None)
def sgd(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = _scalar(ins, "LearningRate", p)
    return {"ParamOut": [p - lr * g.to(p.dtype)]}


@register_op("adamax", grad=None)
def adamax(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    m, inf = ins["Moment"][0], ins["InfNorm"][0]
    lr = _scalar(ins, "LearningRate", p)
    b1p = _scalar(ins, "Beta1Pow", p)
    b1 = float(attrs.get("beta1", 0.9))
    b2 = float(attrs.get("beta2", 0.999))
    eps = float(attrs.get("epsilon", 1e-8))
    m_out = b1 * m + (1 - b1) * g
    inf_out = torch.maximum(b2 * inf, torch.abs(g))
    p_out = p - (lr / (1 - b1p)) * m_out / (inf_out + eps)
    return {"ParamOut": [p_out], "MomentOut": [m_out],
            "InfNormOut": [inf_out]}


@register_op("adagrad", grad=None)
def adagrad(ctx, ins, attrs):
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    lr = _scalar(ins, "LearningRate", p)
    eps = float(attrs.get("epsilon", 1e-6))
    m_out = m + g * g
    p_out = p - lr * g / (torch.sqrt(m_out) + eps)
    return {"ParamOut": [p_out], "MomentOut": [m_out]}


@register_op("decayed_adagrad", grad=None)
def decayed_adagrad(ctx, ins, attrs):
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    lr = _scalar(ins, "LearningRate", p)
    decay = float(attrs.get("decay", 0.95))
    eps = float(attrs.get("epsilon", 1e-6))
    m_out = decay * m + (1 - decay) * g * g
    p_out = p - lr * g / (torch.sqrt(m_out) + eps)
    return {"ParamOut": [p_out], "MomentOut": [m_out]}


@register_op("adadelta", grad=None)
def adadelta(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    avg_sq, avg_upd = ins["AvgSquaredGrad"][0], ins["AvgSquaredUpdate"][0]
    rho = float(attrs.get("rho", 0.95))
    eps = float(attrs.get("epsilon", 1e-6))
    sq_out = rho * avg_sq + (1 - rho) * g * g
    upd = -torch.sqrt((avg_upd + eps) / (sq_out + eps)) * g
    upd_out = rho * avg_upd + (1 - rho) * upd * upd
    return {"ParamOut": [p + upd], "AvgSquaredGradOut": [sq_out],
            "AvgSquaredUpdateOut": [upd_out]}


@register_op("rmsprop", grad=None)
def rmsprop(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    ms, mom = ins["MeanSquare"][0], ins["Moment"][0]
    lr = _scalar(ins, "LearningRate", p)
    rho = float(attrs.get("decay", 0.95))
    eps = float(attrs.get("epsilon", 1e-6))
    mu = float(attrs.get("momentum", 0.0))
    ms_out = rho * ms + (1 - rho) * g * g
    mom_out = mu * mom + lr * g / torch.sqrt(ms_out + eps)
    return {"ParamOut": [p - mom_out], "MeanSquareOut": [ms_out],
            "MomentOut": [mom_out]}


@register_op("ftrl", grad=None)
def ftrl(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    sq, lin = ins["SquaredAccumulator"][0], ins["LinearAccumulator"][0]
    lr = _scalar(ins, "LearningRate", p)
    l1 = float(attrs.get("l1", 0.0))
    l2 = float(attrs.get("l2", 0.0))
    power = float(attrs.get("lr_power", -0.5))
    new_sq = sq + g * g
    sigma = (new_sq ** -power - sq ** -power) / lr
    lin_out = lin + g - sigma * p
    quad = new_sq ** -power / lr + 2 * l2
    p_out = torch.where(torch.abs(lin_out) > l1,
                        (l1 * torch.sign(lin_out) - lin_out) / quad,
                        torch.zeros_like(p))
    return {"ParamOut": [p_out], "SquaredAccumOut": [new_sq],
            "LinearAccumOut": [lin_out]}


def _proximal(p, lr_t, g, l1, l2):
    prox = p - lr_t * g
    return (torch.sign(prox)
            * torch.clamp_min(torch.abs(prox) - lr_t * l1, 0.0)
            / (1.0 + lr_t * l2))


@register_op("proximal_gd", grad=None)
def proximal_gd(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = _scalar(ins, "LearningRate", p)
    return {"ParamOut": [_proximal(p, lr, g, float(attrs.get("l1", 0.0)),
                                   float(attrs.get("l2", 0.0)))]}


@register_op("proximal_adagrad", grad=None)
def proximal_adagrad(ctx, ins, attrs):
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    lr = _scalar(ins, "LearningRate", p)
    m_out = m + g * g
    p_out = _proximal(p, lr / torch.sqrt(m_out), g,
                      float(attrs.get("l1", 0.0)), float(attrs.get("l2", 0.0)))
    return {"ParamOut": [p_out], "MomentOut": [m_out]}


@register_op("average_accumulates", grad=None)
def average_accumulates(ctx, ins, attrs):
    """``ModelAverage``'s window: the current sum takes the parameter
    every step; when its count reaches ``max_average_window`` it rotates
    into the previous slot and restarts, so the average covers the last
    W..2W updates."""
    p = ins["Param"][0]
    cur_sum, prev_sum = ins["InSum1"][0], ins["InSum2"][0]
    cnt = ins["InNumAccumulates"][0].reshape(())
    old = ins["InOldNumAccumulates"][0].reshape(())
    w = int(attrs.get("max_average_window", 10000))
    cur = cur_sum + p.to(cur_sum.dtype)
    n = cnt + 1
    shift = n >= w
    return {"OutSum1": [torch.where(shift, torch.zeros_like(cur), cur)],
            "OutSum2": [torch.where(shift, cur, prev_sum)],
            "OutNumAccumulates": [torch.where(
                shift, torch.zeros_like(n), n).reshape(1)],
            "OutOldNumAccumulates": [torch.where(shift, n, old).reshape(1)]}
