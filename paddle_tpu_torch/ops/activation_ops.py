"""Activation ops, the port of ``paddle_tpu/ops/activation_ops.py``: the
whole unary table (``ACTIVATIONS``, one layer each in ``layers/ops.py``)
and ``softmax``.

Each entry is the JAX expression written in torch, down to its gradient
at a kink, since ``generic_grad`` differentiates the emitter: ``jnp.clip``
is ``maximum`` then ``minimum``, which split the gradient at a tie
(``brelu``, ``relu6``, ``hard_sigmoid``, ``soft_relu``; ``torch.clamp``
would pass it whole); ``jnp.abs`` passes +1 at 0 (``torch.abs`` passes
0); ``leaky_relu`` and ``elu`` take their ``jnp.where`` branches at 0;
``softplus`` is ``logaddexp(x, 0)`` with no threshold; ``gelu`` is the
tanh form, ``jax.nn.gelu``'s default."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register_op


def _const(x, v):
    """A 0-d tensor of `x`'s dtype and device (a fill, so it captures)."""
    return x.new_full((), float(v))


def jclip(x, lo, hi):
    """``jnp.clip(x, lo, hi)``: ``maximum(lo, x)`` then ``minimum(hi, ·)``,
    whose gradient at a tie is half."""
    return torch.minimum(torch.maximum(x, _const(x, lo)), _const(x, hi))


class _Abs(torch.autograd.Function):
    """``jnp.abs``: its gradient is +1 at 0, where ``torch.abs``'s is 0."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.abs()

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _softshrink(x, a):
    lam = a.get("lambda", 0.5)
    return torch.where(x > lam, x - lam, torch.where(x < -lam, x + lam, 0.0))


def _elu(x, a):
    alpha = a.get("alpha", 1.0)
    pos = x > 0
    return torch.where(pos, x, alpha * torch.expm1(torch.where(pos, 0.0, x)))


def _soft_relu(x, a):
    t = a.get("threshold", 40.0)
    return torch.log(1 + torch.exp(jclip(x, -t, t)))


_TABLE = {
    "sigmoid": lambda x, a: torch.sigmoid(x),
    "logsigmoid": lambda x, a: -_softplus(-x),
    "exp": lambda x, a: torch.exp(x),
    "relu": lambda x, a: torch.relu(x),
    "tanh": lambda x, a: torch.tanh(x),
    "tanh_shrink": lambda x, a: x - torch.tanh(x),
    "softshrink": _softshrink,
    "hard_shrink": lambda x, a: torch.where(
        _Abs.apply(x) > a.get("threshold", 0.5), x, 0.0),
    "sqrt": lambda x, a: torch.sqrt(x),
    "abs": lambda x, a: _Abs.apply(x),
    "ceil": lambda x, a: torch.ceil(x),
    "floor": lambda x, a: torch.floor(x),
    "round": lambda x, a: torch.round(x),
    "reciprocal": lambda x, a: 1.0 / x,
    "log": lambda x, a: torch.log(x),
    "square": lambda x, a: x * x,
    "softplus": lambda x, a: _softplus(x),
    "softsign": lambda x, a: x / (_Abs.apply(x) + 1),
    "brelu": lambda x, a: jclip(x, a.get("t_min", 0.0), a.get("t_max", 24.0)),
    "leaky_relu": lambda x, a: torch.where(x >= 0, x,
                                           a.get("alpha", 0.02) * x),
    "soft_relu": _soft_relu,
    "elu": _elu,
    "relu6": lambda x, a: jclip(x, 0.0, a.get("threshold", 6.0)),
    "pow": lambda x, a: x ** a.get("factor", 1.0),
    "stanh": lambda x, a: a.get("scale_b", 1.7159) * torch.tanh(
        a.get("scale_a", 2.0 / 3.0) * x),
    "thresholded_relu": lambda x, a: torch.where(
        x > a.get("threshold", 1.0), x, 0.0),
    "hard_sigmoid": lambda x, a: jclip(
        a.get("slope", 0.2) * x + a.get("offset", 0.5), 0.0, 1.0),
    "swish": lambda x, a: x * torch.sigmoid(a.get("beta", 1.0) * x),
    "gelu": lambda x, a: F.gelu(x, approximate="tanh"),
    "silu": lambda x, a: x * torch.sigmoid(x),
    "sin": lambda x, a: torch.sin(x),
    "cos": lambda x, a: torch.cos(x),
}


def _make(fn):
    def emit(ctx, ins, attrs):
        return {"Out": [fn(ins["X"][0], attrs)]}

    return emit


for _name, _fn in _TABLE.items():
    register_op(_name, _make(_fn))

ACTIVATIONS = tuple(_TABLE)


@register_op("softmax")
def softmax(ctx, ins, attrs):
    return {"Out": [torch.softmax(ins["X"][0], dim=-1)]}
