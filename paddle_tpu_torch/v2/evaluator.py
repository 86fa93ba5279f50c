"""v2 evaluators, the port of ``paddle_tpu/v2/evaluator.py`` (reference
python/paddle/v2/evaluator.py): the port's v1
evaluator functions under their suffix-stripped v2 names
(`paddle.evaluator.classification_error(...)`)."""

from ..v1 import evaluators as _v1

__all__ = []

for _name in dir(_v1):
    if _name.endswith("_evaluator"):
        _v2_name = _name[: -len("_evaluator")]
        globals()[_v2_name] = getattr(_v1, _name)
        __all__.append(_v2_name)
del _name, _v2_name
