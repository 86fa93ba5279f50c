"""Optimizers: append update ops per parameter — the port of
``Optimizer``, ``AdamOptimizer`` and ``MomentumOptimizer`` in
``paddle_tpu/optimizer.py``, with
the same accumulator names and startup initializers.  The update ops land
in the same block as forward and backward, so one ``Executor.run`` is one
training step.

Not ported yet (each raises ``NotImplementedError``): ``regularization=``,
``global_clip_norm=``, a parameter's ``gradient_clip`` and
``update_hooks`` (ROADMAP.md Queue A item 4); the other optimizers come
with the slices that train with them (item 4).
"""

from __future__ import annotations

from typing import Dict

from .framework import unique_name
from .framework.backward import append_backward
from .framework.core import Variable
from .framework.initializer import ConstantInitializer
from .framework.layer_helper import LayerHelper

_LATER = "ROADMAP.md Queue A item 4"


class Optimizer:
    def __init__(self, learning_rate=0.001, regularization=None,
                 global_clip_norm=None):
        if regularization is not None:
            raise NotImplementedError(
                f"regularization= is not ported yet ({_LATER})")
        if global_clip_norm is not None:
            raise NotImplementedError(
                f"global_clip_norm= is not ported yet ({_LATER})")
        self._lr_value = learning_rate
        self._accumulators: Dict[str, Dict[str, Variable]] = {}
        self.helper = None

    def _create_lr_var(self, block):
        self.helper = LayerHelper(type(self).__name__.lower())
        lr = self.helper.create_global_variable(
            name=unique_name.generate("learning_rate"),
            shape=(1,), dtype="float32")
        self.helper.set_initialized(
            lr, ConstantInitializer(float(self._lr_value)))
        self._lr_var = lr
        return lr

    def _add_accumulator(self, name, param, fill_value=0.0, shape=None,
                         dtype=None):
        acc = self.helper.create_global_variable(
            name=unique_name.generate(f"{param.name}_{name}"),
            shape=shape or param.shape,
            dtype=dtype or "float32")
        acc.accumulator_for = param.name
        self.helper.set_initialized(acc, ConstantInitializer(fill_value))
        self._accumulators.setdefault(name, {})[param.name] = acc
        return acc

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # subclass hooks ----------------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _finish_update(self, block):
        pass

    # ------------------------------------------------------------------
    @staticmethod
    def _check_param_hooks(params_grads):
        for p, _ in params_grads:
            for hook in ("gradient_clip_attr", "update_hooks"):
                if getattr(p, hook, None):
                    raise NotImplementedError(
                        f"parameter {p.name!r} asks for {hook}, which is "
                        f"not ported yet ({_LATER})")

    def create_optimization_pass(self, params_grads, loss):
        block = loss.block
        self._create_lr_var(block)
        self._check_param_hooks(params_grads)
        self._create_accumulators(block, [p for p, _ in params_grads])
        ops = [self._append_optimize_op(block, pg) for pg in params_grads]
        self._finish_update(block)
        return ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        ops = self.create_optimization_pass(params_grads, loss)
        return ops, params_grads


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
        self._beta1_pow = self.helper.create_global_variable(
            name=unique_name.generate("beta1_pow"), shape=(1,),
            dtype="float32")
        self.helper.set_initialized(
            self._beta1_pow, ConstantInitializer(self._beta1))
        self._beta2_pow = self.helper.create_global_variable(
            name=unique_name.generate("beta2_pow"), shape=(1,),
            dtype="float32")
        self.helper.set_initialized(
            self._beta2_pow, ConstantInitializer(self._beta2))

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        return block.append_op(
            "adam",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "Moment1": [m1.name], "Moment2": [m2.name],
                    "LearningRate": [self._lr_var.name],
                    "Beta1Pow": [self._beta1_pow.name],
                    "Beta2Pow": [self._beta2_pow.name]},
            outputs={"ParamOut": [p.name], "Moment1Out": [m1.name],
                     "Moment2Out": [m2.name]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon},
        )

    def _finish_update(self, block):
        block.append_op(
            "adam_beta_pow_update",
            inputs={"Beta1Pow": [self._beta1_pow.name],
                    "Beta2Pow": [self._beta2_pow.name]},
            outputs={"Beta1PowOut": [self._beta1_pow.name],
                     "Beta2PowOut": [self._beta2_pow.name]},
            attrs={"beta1": self._beta1, "beta2": self._beta2},
        )


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            "momentum",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "Velocity": [v.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "VelocityOut": [v.name]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov},
        )


Adam = AdamOptimizer
Momentum = MomentumOptimizer
