"""v1 parameter/layer attributes (reference trainer_config_helpers/attrs.py:
ParameterAttribute, ExtraLayerAttribute)."""

from __future__ import annotations


class HookAttribute:
    """Parameter update hook (attrs.py:59 HookAttribute): e.g.
    HookAttribute('pruning', 0.6) — a static magnitude-pruning mask
    generated at init and re-applied after every update."""

    SUPPORTED = ("pruning",)

    def __init__(self, type, sparsity_ratio=None):
        if type not in self.SUPPORTED:
            raise ValueError(f"hook type {type!r}: supported "
                             f"{self.SUPPORTED}")
        if sparsity_ratio is not None \
                and not 0.0 <= float(sparsity_ratio) <= 1.0:
            raise ValueError("sparsity_ratio must be in [0, 1]")
        self.type = type
        self.sparsity_ratio = sparsity_ratio

    def to_hook_dict(self) -> dict:
        d = {"type": self.type}
        if self.sparsity_ratio is not None:
            d["sparsity_ratio"] = float(self.sparsity_ratio)
        return d


class ParameterAttribute:
    """Maps onto the fluid param_attr dict: name, initializer, l2 decay."""

    def __init__(self, name=None, initial_std=None, initial_mean=None,
                 initial_max=None, initial_min=None, l1_rate=None,
                 l2_rate=None, learning_rate=1.0, is_static=False,
                 sparse_update=False, update_hooks=None):
        self.name = name
        self.initial_std = initial_std
        self.initial_mean = initial_mean
        self.initial_max = initial_max
        self.initial_min = initial_min
        self.l2_rate = l2_rate
        self.learning_rate = learning_rate
        self.is_static = is_static
        self.sparse_update = sparse_update
        self.update_hooks = update_hooks

    def to_param_attr(self) -> dict:
        from ..framework.initializer import (NormalInitializer,
                                             UniformInitializer)

        attr = {}
        if self.name:
            attr["name"] = self.name
        if self.initial_std is not None or self.initial_mean is not None:
            attr["initializer"] = NormalInitializer(
                float(self.initial_mean or 0.0), float(self.initial_std or 0.01))
        elif self.initial_max is not None or self.initial_min is not None:
            attr["initializer"] = UniformInitializer(
                float(self.initial_min or -1.0), float(self.initial_max or 1.0))
        if self.update_hooks is not None:
            hooks = self.update_hooks
            if not isinstance(hooks, (list, tuple)):
                hooks = [hooks]
            attr["update_hooks"] = [
                h.to_hook_dict() if isinstance(h, HookAttribute) else h
                for h in hooks]
        return attr


ParamAttr = ParameterAttribute


class ExtraLayerAttribute:
    """drop_rate / device placement knobs (attrs.py ExtraLayerAttribute)."""

    def __init__(self, error_clipping_threshold=None, drop_rate=None,
                 device=None):
        self.error_clipping_threshold = error_clipping_threshold
        self.drop_rate = drop_rate
        self.device = device


ExtraAttr = ExtraLayerAttribute


def to_param_attr(attr):
    if attr is None:
        return None
    if isinstance(attr, ParameterAttribute):
        return attr.to_param_attr()
    return attr
