"""v1 sequence pooling types (reference trainer_config_helpers/poolings.py)."""

from __future__ import annotations


class BasePoolingType:
    name: str = ""


def _make(cls_name, pool_name):
    return type(cls_name, (BasePoolingType,), {"name": pool_name})


MaxPooling = _make("MaxPooling", "max")
AvgPooling = _make("AvgPooling", "average")
SumPooling = _make("SumPooling", "sum")
SqrtAvgPooling = _make("SqrtAvgPooling", "sqrt")
FirstPooling = _make("FirstPooling", "first")
LastPooling = _make("LastPooling", "last")


def pool_name(p) -> str:
    if isinstance(p, str):
        return p
    if isinstance(p, type):
        p = p()
    return p.name
