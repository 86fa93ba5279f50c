"""fluid ParamAttr (reference python/paddle/v2/fluid/param_attr.py):
declarative parameter attributes.  A dict subclass so every layer call
site that branches on `isinstance(param_attr, dict)` accepts it
unchanged — the keys are exactly what LayerHelper.create_parameter
consumes (name/initializer/learning_rate/regularizer/trainable/
gradient_clip)."""

from __future__ import annotations

__all__ = ["ParamAttr"]


class ParamAttr(dict):
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, gradient_clip=None):
        super().__init__()
        if name is not None:
            self["name"] = name
        if initializer is not None:
            self["initializer"] = initializer
        if learning_rate != 1.0:
            self["learning_rate"] = float(learning_rate)
        if regularizer is not None:
            self["regularizer"] = regularizer
        if not trainable:
            self["trainable"] = False
        if gradient_clip is not None:
            self["gradient_clip"] = gradient_clip

    # attribute-style reads used by reference-ported code
    def __getattr__(self, item):
        try:
            return self[item]
        except KeyError:
            defaults = {"name": None, "initializer": None,
                        "learning_rate": 1.0, "regularizer": None,
                        "trainable": True, "gradient_clip": None}
            if item in defaults:
                return defaults[item]
            raise AttributeError(item)
