"""Optimizers: append update ops per parameter — the port of
``paddle_tpu/optimizer.py``, with the same accumulator names and startup
initializers.  The update ops land in the same block as forward and
backward, so one ``Executor.run`` is one training step.

``minimize`` appends the backward (with ``error_clip_callback``), then
``create_optimization_pass``: each parameter's ``gradient_clip``, the
optimizer's ``global_clip_norm``, the weight decay (the parameter's own
``regularizer``, else ``regularization=``), then one update op per
parameter and its pruning ``update_hooks``.  The learning rate is a
constant or a schedule's variable (``learning_rate_decay``).
``ModelAverage`` keeps windowed parameter sums in the same step and swaps
the averages into the scope on ``apply``.
"""

from __future__ import annotations

import contextlib
from typing import Dict

from . import clip as clip_mod
from .framework import unique_name
from .framework.backward import append_backward
from .framework.core import Variable, default_main_program, \
    default_startup_program
from .framework.initializer import ConstantInitializer
from .framework.layer_helper import LayerHelper
from .framework.scope import global_scope
from .regularizer import append_regularization_ops


class Optimizer:
    def __init__(self, learning_rate=0.001, regularization=None,
                 global_clip_norm=None):
        self._lr_value = learning_rate
        self.regularization = regularization
        self.global_clip_norm = global_clip_norm
        self._accumulators: Dict[str, Dict[str, Variable]] = {}
        self.helper = None

    def _create_lr_var(self, block):
        self.helper = LayerHelper(type(self).__name__.lower())
        if isinstance(self._lr_value, Variable):
            # a schedule from learning_rate_decay: already ops in the block
            self._lr_var = self._lr_value
            return self._lr_var
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

    def _add_beta_pow(self, name, beta):
        """A [1] f32 accumulator of beta's powers, beta at startup."""
        v = self.helper.create_global_variable(
            name=unique_name.generate(name), shape=(1,), dtype="float32")
        self.helper.set_initialized(v, ConstantInitializer(beta))
        return v

    # subclass hooks ----------------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _finish_update(self, block):
        pass

    # ------------------------------------------------------------------
    def _apply_regularization_and_clip(self, block, params_grads):
        """Clip first (each parameter's own clip, then the global norm),
        then add the weight decay, which the clip must not scale down."""
        params_grads = clip_mod.append_gradient_clip_ops(params_grads)
        if self.global_clip_norm is not None:
            params_grads = clip_mod.append_gradient_clip_by_global_norm(
                block, params_grads, self.global_clip_norm)
        return append_regularization_ops(block, params_grads,
                                         self.regularization)

    def create_optimization_pass(self, params_grads, loss):
        block = loss.block
        self._create_lr_var(block)
        params_grads = self._apply_regularization_and_clip(block,
                                                           params_grads)
        self._create_accumulators(block, [p for p, _ in params_grads])
        ops = []
        for pg in params_grads:
            ops.append(self._append_optimize_op(block, pg))
            self._append_update_hooks(block, pg[0])
        self._finish_update(block)
        return ops

    def _append_update_hooks(self, block, param):
        """A static pruning mask (``{"type": "pruning", "sparsity_ratio":
        r}`` in ``update_hooks``): ``pruning_mask`` of the initialized
        parameter in the startup program, multiplied into it there, and
        again after every update, so pruned weights stay exactly 0."""
        hooks = getattr(param, "update_hooks", None)
        if not hooks:
            return
        if isinstance(hooks, dict):
            hooks = [hooks]
        for hk in hooks:
            kind = hk.get("type") if isinstance(hk, dict) else None
            if kind != "pruning":
                raise ValueError(
                    f"unsupported update hook {hk!r} on {param.name!r}: "
                    f"only {{'type': 'pruning', 'sparsity_ratio': r}} is "
                    f"implemented")
            ratio = float(hk.get("sparsity_ratio", 0.5))
            mask = self.helper.create_global_variable(
                name=unique_name.generate(param.name + "_prune_mask"),
                shape=param.shape, dtype="float32")
            sblock = default_startup_program().global_block()
            if mask.name not in sblock.vars:
                sblock.create_var(name=mask.name, shape=mask.shape,
                                  dtype="float32", persistable=True)
            sblock.append_op(
                "pruning_mask", inputs={"X": [param.name]},
                outputs={"Out": [mask.name]},
                attrs={"sparsity_ratio": ratio})
            for b in (sblock, block):
                b.append_op(
                    "elementwise_mul",
                    inputs={"X": [param.name], "Y": [mask.name]},
                    outputs={"Out": [param.name]}, attrs={})

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = append_backward(
            loss, parameter_list, no_grad_set,
            callbacks=[clip_mod.error_clip_callback])
        ops = self.create_optimization_pass(params_grads, loss)
        return ops, params_grads


class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, block, pg):
        p, g = pg
        return block.append_op(
            "sgd",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name]},
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


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m = self._get_accumulator("moment", p)
        return block.append_op(
            "adagrad",
            inputs={"Param": [p.name], "Grad": [g.name], "Moment": [m.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "MomentOut": [m.name]},
            attrs={"epsilon": self._epsilon},
        )


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
        self._beta1_pow = self._add_beta_pow("beta1_pow", self._beta1)
        self._beta2_pow = self._add_beta_pow("beta2_pow", self._beta2)

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


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
        self._beta1_pow = self._add_beta_pow("beta1_pow", self._beta1)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m = self._get_accumulator("moment", p)
        n = self._get_accumulator("inf_norm", p)
        return block.append_op(
            "adamax",
            inputs={"Param": [p.name], "Grad": [g.name], "Moment": [m.name],
                    "InfNorm": [n.name],
                    "LearningRate": [self._lr_var.name],
                    "Beta1Pow": [self._beta1_pow.name]},
            outputs={"ParamOut": [p.name], "MomentOut": [m.name],
                     "InfNormOut": [n.name]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon},
        )

    def _finish_update(self, block):
        block.append_op(
            "scale", inputs={"X": [self._beta1_pow.name]},
            outputs={"Out": [self._beta1_pow.name]},
            attrs={"scale": self._beta1},
        )


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m = self._get_accumulator("moment", p)
        return block.append_op(
            "decayed_adagrad",
            inputs={"Param": [p.name], "Grad": [g.name], "Moment": [m.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "MomentOut": [m.name]},
            attrs={"decay": self._decay, "epsilon": self._epsilon},
        )


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon, self._momentum = rho, epsilon, momentum

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("mean_square", p)
            self._add_accumulator("momentum_acc", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        ms = self._get_accumulator("mean_square", p)
        mom = self._get_accumulator("momentum_acc", p)
        return block.append_op(
            "rmsprop",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "MeanSquare": [ms.name], "Moment": [mom.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "MeanSquareOut": [ms.name],
                     "MomentOut": [mom.name]},
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum},
        )


class AdadeltaOptimizer(Optimizer):
    """Adadelta: the update needs no learning rate (its var is still
    created, as in the JAX package)."""

    def __init__(self, learning_rate=1.0, rho=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon = rho, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("avg_sq_grad", p)
            self._add_accumulator("avg_sq_update", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        sq = self._get_accumulator("avg_sq_grad", p)
        upd = self._get_accumulator("avg_sq_update", p)
        return block.append_op(
            "adadelta",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "AvgSquaredGrad": [sq.name],
                    "AvgSquaredUpdate": [upd.name]},
            outputs={"ParamOut": [p.name], "AvgSquaredGradOut": [sq.name],
                     "AvgSquaredUpdateOut": [upd.name]},
            attrs={"rho": self._rho, "epsilon": self._epsilon},
        )


class ModelAverage:
    """Sliding-window parameter averaging.

    Build it AFTER ``minimize()``: it appends one ``average_accumulates``
    op per trainable parameter, so the window sums update inside the same
    step (under K steps a dispatch, inside the captured graph).  At eval
    time::

        ma = fluid.optimizer.ModelAverage(max_average_window=500)
        ... train steps ...
        with ma.apply(exe):      # params <- windowed average
            evaluate / save
        # params restored on exit (restore() also public)

    ``apply`` puts new tensors in the scope for the parameters and
    ``restore`` puts back copies of the raw ones; a captured step loop
    sees the replaced entries and copies them into its state buffers on
    its next replay, so training after ``restore`` starts from the raw
    parameters.  ``average_window_rate`` and ``min_average_window`` are
    accepted for API parity; the window is ``max_average_window``
    updates (the average covers the last W..2W).
    """

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, program=None):
        self.max_average_window = int(max_average_window)
        self.average_window_rate = average_window_rate
        self.min_average_window = min_average_window
        program = program if program is not None else default_main_program()
        self.block = program.global_block()
        # vars and their init ops go to this program and its startup twin
        self.helper = LayerHelper("model_average", main_program=program)
        self._params = [v for v in self.block.vars.values()
                        if v.persistable and getattr(v, "trainable", False)]
        if not self._params:
            raise ValueError(
                "ModelAverage found no trainable parameters: construct it "
                "AFTER building the model (and after minimize())")
        self._accs = {}
        for p in self._params:
            names = {}
            for suffix, shape in (("sum_1", p.shape), ("sum_2", p.shape),
                                  ("num_acc", (1,)), ("old_num_acc", (1,))):
                v = self.helper.create_global_variable(
                    name=unique_name.generate(f"{p.name}_avg_{suffix}"),
                    shape=shape, dtype="float32")
                v.accumulator_for = p.name
                self.helper.set_initialized(v, ConstantInitializer(0.0))
                names[suffix] = v.name
            self.block.append_op(
                "average_accumulates",
                inputs={"Param": [p.name], "InSum1": [names["sum_1"]],
                        "InSum2": [names["sum_2"]],
                        "InNumAccumulates": [names["num_acc"]],
                        "InOldNumAccumulates": [names["old_num_acc"]]},
                outputs={"OutSum1": [names["sum_1"]],
                         "OutSum2": [names["sum_2"]],
                         "OutNumAccumulates": [names["num_acc"]],
                         "OutOldNumAccumulates": [names["old_num_acc"]]},
                attrs={"max_average_window": self.max_average_window,
                       "average_window_rate": float(average_window_rate),
                       "min_average_window": int(min_average_window)})
            self._accs[p.name] = names
        self._backup = None

    def apply(self, executor=None, scope=None, need_restore=True):
        """Swap every trainable parameter to its windowed average (a
        parameter with no accumulated step keeps its raw value).  Returns
        a context manager that restores on exit when `need_restore`."""
        scope = scope if scope is not None else global_scope()
        if self._backup is not None:
            raise RuntimeError(
                "ModelAverage.apply() while a previous apply() is still "
                "active: restore() first (nesting would back up the "
                "averaged values and lose the raw parameters)")
        self._backup = {}
        for p in self._params:
            names = self._accs[p.name]
            raw = scope.find(p.name)
            self._backup[p.name] = raw.clone()
            total = float(scope.find(names["num_acc"]).reshape(-1)[0]) + \
                float(scope.find(names["old_num_acc"]).reshape(-1)[0])
            if total > 0:
                s = scope.find(names["sum_1"]) + scope.find(names["sum_2"])
                scope.set(p.name, (s / total).to(raw.dtype))

        @contextlib.contextmanager
        def _guard():
            try:
                yield self
            finally:
                if need_restore:
                    self.restore(scope=scope)

        return _guard()

    def restore(self, executor=None, scope=None):
        """Put the raw (not averaged) parameter values back."""
        scope = scope if scope is not None else global_scope()
        if not self._backup:
            return
        for name, raw in self._backup.items():
            scope.set(name, raw)
        self._backup = None


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
Adadelta = AdadeltaOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
RMSProp = RMSPropOptimizer
