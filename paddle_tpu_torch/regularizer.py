"""Weight decay as ops on the gradient, the port of
``paddle_tpu/regularizer.py``: ``L2Decay`` appends ``scale`` of the
parameter and a ``sum`` with the gradient, ``L1Decay`` the same over the
parameter's ``sign``.  A parameter's own regularizer (``ParamAttr``)
takes precedence over the optimizer's ``regularization=``; the optimizer
applies the decay after the gradient clips."""

from __future__ import annotations

from .framework import unique_name


class WeightDecayRegularizer:
    def append_ops(self, block, param, grad):
        raise NotImplementedError


def _decayed(block, param, grad, decay_name):
    """grad + the decay term `decay_name`, as a new gradient var."""
    out = block.create_var(
        name=unique_name.generate(grad.name + "_reg"),
        shape=grad.shape, dtype=grad.dtype, stop_gradient=True)
    block.append_op("sum", inputs={"X": [grad.name, decay_name]},
                    outputs={"Out": [out.name]})
    return out


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self.coeff = regularization_coeff

    def append_ops(self, block, param, grad):
        decay = block.create_var(
            name=unique_name.generate(param.name + "_l2decay"),
            shape=param.shape, dtype=param.dtype, stop_gradient=True)
        block.append_op("scale", inputs={"X": [param.name]},
                        outputs={"Out": [decay.name]},
                        attrs={"scale": self.coeff})
        return _decayed(block, param, grad, decay.name)


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self.coeff = regularization_coeff

    def append_ops(self, block, param, grad):
        sign = block.create_var(
            name=unique_name.generate(param.name + "_sign"),
            shape=param.shape, dtype=param.dtype, stop_gradient=True)
        block.append_op("sign", inputs={"X": [param.name]},
                        outputs={"Out": [sign.name]})
        decay = block.create_var(
            name=unique_name.generate(param.name + "_l1decay"),
            shape=param.shape, dtype=param.dtype, stop_gradient=True)
        block.append_op("scale", inputs={"X": [sign.name]},
                        outputs={"Out": [decay.name]},
                        attrs={"scale": self.coeff})
        return _decayed(block, param, grad, decay.name)


def append_regularization_ops(block, params_grads, global_regularization=None):
    """Each (param, grad) with its decayed gradient, where the parameter
    or the optimizer asks for a regularizer."""
    out = []
    for p, g in params_grads:
        reg = getattr(p, "regularizer", None) or global_regularization
        out.append((p, g) if reg is None else (p, reg.append_ops(block, p, g)))
    return out


L2Decay = L2DecayRegularizer
L1Decay = L1DecayRegularizer
