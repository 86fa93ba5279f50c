"""v1 activation objects (reference trainer_config_helpers/activations.py).

Each activation is a class whose instance names the activation op the layer
appends; `LinearActivation` means none.  The reference serialized `.name`
into LayerConfig.active_type — here it selects the op-emitter suffix."""

from __future__ import annotations


class BaseActivation:
    name: str = ""

    def __repr__(self):
        return f"{type(self).__name__}()"


def _make(cls_name, op_name):
    cls = type(cls_name, (BaseActivation,), {"name": op_name})
    return cls


LinearActivation = _make("LinearActivation", "")
IdentityActivation = LinearActivation
ReluActivation = _make("ReluActivation", "relu")
BReluActivation = _make("BReluActivation", "brelu")
SoftReluActivation = _make("SoftReluActivation", "soft_relu")
STanhActivation = _make("STanhActivation", "stanh")
SigmoidActivation = _make("SigmoidActivation", "sigmoid")
TanhActivation = _make("TanhActivation", "tanh")
SoftmaxActivation = _make("SoftmaxActivation", "softmax")
SequenceSoftmaxActivation = _make("SequenceSoftmaxActivation",
                                  "sequence_softmax")
ExpActivation = _make("ExpActivation", "exp")
LogActivation = _make("LogActivation", "log")
AbsActivation = _make("AbsActivation", "abs")
SquareActivation = _make("SquareActivation", "square")
SqrtActivation = _make("SqrtActivation", "sqrt")
ReciprocalActivation = _make("ReciprocalActivation", "reciprocal")


def act_name(act) -> str | None:
    """Activation object (or string, or None) → op name or None."""
    if act is None:
        return None
    if isinstance(act, str):
        return act or None
    return act.name or None
