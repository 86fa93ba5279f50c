"""Learning-rate schedules as ops over a global step counter, the port of
``paddle_tpu/learning_rate_decay.py``: exponential, natural-exp,
inverse-time, polynomial and piecewise decay.

Each schedule creates a persistable f32 ``global_step`` (0 at startup),
appends an ``increment`` that advances it by one every run (so the first
step reads 1), and appends the ops that turn it into the [1] learning
rate the optimizer reads.  The step is written state, so K steps a
dispatch carry it from step to step like a parameter; the piecewise
schedule picks its segment with ``select``, on the device."""

from __future__ import annotations

from .framework import unique_name
from .framework.initializer import ConstantInitializer
from .framework.layer_helper import LayerHelper


def _global_step(helper):
    step = helper.create_global_variable(
        name=unique_name.generate("global_step"), shape=(1,),
        dtype="float32")
    helper.set_initialized(step, ConstantInitializer(0.0))
    helper.append_op("increment", inputs={"X": [step.name]},
                     outputs={"Out": [step.name]}, attrs={"step": 1.0})
    return step


def _tmp(helper, dtype="float32"):
    return helper.create_tmp_variable(dtype, shape=(1,), stop_gradient=True)


def _op(helper, op_type, x, **attrs):
    """`op_type` of the [1] var `x` into a new [1] var."""
    out = _tmp(helper)
    helper.append_op(op_type, inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs=attrs)
    return out


def _fill(helper, value):
    out = _tmp(helper)
    helper.append_op("fill_constant", outputs={"Out": [out.name]},
                     attrs={"shape": [1], "value": float(value),
                            "dtype": "float32"})
    return out


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr * decay_rate ^ (step / decay_steps)"""
    helper = LayerHelper("exponential_decay")
    step = _global_step(helper)
    ratio = _op(helper, "scale", step, scale=1.0 / decay_steps)
    if staircase:
        ratio = _op(helper, "floor", ratio)
    base = _fill(helper, decay_rate)
    powed = _tmp(helper)
    helper.append_op("elementwise_pow",
                     inputs={"X": [base.name], "Y": [ratio.name]},
                     outputs={"Out": [powed.name]}, attrs={"axis": -1})
    return _op(helper, "scale", powed, scale=float(learning_rate))


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr * exp(-decay_rate * step / decay_steps).  `staircase` is
    accepted and, as in the JAX package, changes nothing."""
    helper = LayerHelper("natural_exp_decay")
    step = _global_step(helper)
    scaled = _op(helper, "scale", step,
                 scale=-float(decay_rate) / decay_steps)
    ex = _op(helper, "exp", scaled)
    return _op(helper, "scale", ex, scale=float(learning_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    """lr / (1 + decay_rate * step / decay_steps).  `staircase` is
    accepted and, as in the JAX package, changes nothing."""
    helper = LayerHelper("inverse_time_decay")
    step = _global_step(helper)
    scaled = _op(helper, "scale", step,
                 scale=float(decay_rate) / decay_steps, bias=1.0)
    inv = _op(helper, "reciprocal", scaled)
    return _op(helper, "scale", inv, scale=float(learning_rate))


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=1e-4,
                     power=1.0):
    """(lr - end) * (1 - min(step, decay_steps) / decay_steps)^power + end"""
    helper = LayerHelper("polynomial_decay")
    step = _global_step(helper)
    capped = _op(helper, "clip", step, min=0.0, max=float(decay_steps))
    frac = _op(helper, "scale", capped, scale=-1.0 / decay_steps, bias=1.0)
    powed = _op(helper, "pow", frac, factor=float(power))
    return _op(helper, "scale", powed,
               scale=float(learning_rate) - float(end_learning_rate),
               bias=float(end_learning_rate))


def piecewise_decay(boundaries, values):
    """values[i] while step < boundaries[i] (the first i that holds), else
    values[-1]."""
    if len(values) != len(boundaries) + 1:
        raise ValueError(
            f"piecewise_decay needs len(values) == len(boundaries)+1, got "
            f"{len(values)} values for {len(boundaries)} boundaries")
    helper = LayerHelper("piecewise_decay")
    step = _global_step(helper)
    lr = _fill(helper, values[-1])
    # walk the segments last to first: lr = step < b ? v : lr
    for b, v in reversed(list(zip(boundaries, values))):
        bound = _fill(helper, b)
        cond = _tmp(helper, "bool")
        helper.append_op("less_than",
                         inputs={"X": [step.name], "Y": [bound.name]},
                         outputs={"Out": [cond.name]})
        seg = _fill(helper, v)
        nxt = _tmp(helper)
        helper.append_op("select",
                         inputs={"Mask": [cond.name], "X": [seg.name],
                                 "Y": [lr.name]},
                         outputs={"Out": [nxt.name]})
        lr = nxt
    return lr
