"""v1 optimizer settings (reference trainer_config_helpers/optimizers.py:
settings(), MomentumOptimizer, AdamOptimizer, ...).

`settings()` records the global training hyperparameters the way v1 configs
did; `to_fluid()` materializes the equivalent fluid optimizer to pass to
Optimizer.minimize / v2 SGD."""

from __future__ import annotations

from .. import optimizer as fluid_opt


class BaseSGDOptimizer:
    def to_fluid(self, learning_rate):
        raise NotImplementedError


class MomentumOptimizer(BaseSGDOptimizer):
    def __init__(self, momentum=0.9, sparse=False):
        self.momentum = momentum

    def to_fluid(self, learning_rate):
        return fluid_opt.Momentum(learning_rate=learning_rate,
                                  momentum=self.momentum)


class AdamOptimizer(BaseSGDOptimizer):
    def __init__(self, beta1=0.9, beta2=0.999, epsilon=1e-8):
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def to_fluid(self, learning_rate):
        return fluid_opt.Adam(learning_rate=learning_rate, beta1=self.beta1,
                              beta2=self.beta2, epsilon=self.epsilon)


class AdamaxOptimizer(BaseSGDOptimizer):
    def __init__(self, beta1=0.9, beta2=0.999):
        self.beta1, self.beta2 = beta1, beta2

    def to_fluid(self, learning_rate):
        return fluid_opt.Adamax(learning_rate=learning_rate,
                                beta1=self.beta1, beta2=self.beta2)


class AdaGradOptimizer(BaseSGDOptimizer):
    def to_fluid(self, learning_rate):
        return fluid_opt.Adagrad(learning_rate=learning_rate)


class DecayedAdaGradOptimizer(BaseSGDOptimizer):
    def __init__(self, rho=0.95, epsilon=1e-6):
        self.rho, self.epsilon = rho, epsilon

    def to_fluid(self, learning_rate):
        return fluid_opt.DecayedAdagrad(learning_rate=learning_rate,
                                        decay=self.rho, epsilon=self.epsilon)


class AdaDeltaOptimizer(BaseSGDOptimizer):
    def __init__(self, rho=0.95, epsilon=1e-6):
        self.rho, self.epsilon = rho, epsilon

    def to_fluid(self, learning_rate):
        return fluid_opt.Adadelta(learning_rate=learning_rate, rho=self.rho,
                                  epsilon=self.epsilon)


class RMSPropOptimizer(BaseSGDOptimizer):
    def __init__(self, rho=0.95, epsilon=1e-6):
        self.rho, self.epsilon = rho, epsilon

    def to_fluid(self, learning_rate):
        return fluid_opt.RMSProp(learning_rate=learning_rate, rho=self.rho,
                                 epsilon=self.epsilon)


_settings = {}


def settings(batch_size=None, learning_rate=1e-3, learning_method=None,
             regularization=None, gradient_clipping_threshold=None, **kw):
    """Record global config (optimizers.py settings()).  Returns the dict;
    `optimizer_from_settings()` builds the fluid optimizer."""
    global _settings
    _settings = dict(batch_size=batch_size, learning_rate=learning_rate,
                     learning_method=learning_method,
                     regularization=regularization,
                     gradient_clipping_threshold=gradient_clipping_threshold,
                     **kw)
    return _settings


def settings_dict():
    """The last settings() call's recorded config (empty if none)."""
    return dict(_settings)


class L2Regularization:
    """v1 regularization declaration (reference default_decay_rate style)."""

    def __init__(self, rate: float):
        self.rate = float(rate)

    def to_fluid(self):
        from ..regularizer import L2DecayRegularizer

        return L2DecayRegularizer(regularization_coeff=self.rate)


class L1Regularization:
    def __init__(self, rate: float):
        self.rate = float(rate)

    def to_fluid(self):
        from ..regularizer import L1DecayRegularizer

        return L1DecayRegularizer(regularization_coeff=self.rate)


def optimizer_from_settings():
    """Build the fluid optimizer from settings(), carrying regularization
    and gradient clipping through (not just lr/method)."""
    lm = _settings.get("learning_method")
    lr = _settings.get("learning_rate", 1e-3)
    opt = fluid_opt.SGD(learning_rate=lr) if lm is None else lm.to_fluid(lr)
    reg = _settings.get("regularization")
    if reg is not None:
        if hasattr(reg, "to_fluid"):
            reg = reg.to_fluid()
        elif isinstance(reg, (int, float)):
            from ..regularizer import L2DecayRegularizer

            reg = L2DecayRegularizer(regularization_coeff=float(reg))
        opt.regularization = reg
    clip = _settings.get("gradient_clipping_threshold")
    if clip:
        opt.global_clip_norm = float(clip)
    return opt
