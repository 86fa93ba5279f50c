"""v2 activations, the port of ``paddle_tpu/v2/activation.py`` (reference
python/paddle/v2/activation.py): the port's v1
activation classes under their v2 names (`paddle.activation.Relu()`)."""

from ..v1.activations import (AbsActivation as Abs,  # noqa: F401
                              BReluActivation as BRelu,
                              ExpActivation as Exp,
                              IdentityActivation as Identity,
                              LinearActivation as Linear,
                              LogActivation as Log,
                              ReluActivation as Relu,
                              SequenceSoftmaxActivation as SequenceSoftmax,
                              SigmoidActivation as Sigmoid,
                              SoftReluActivation as SoftRelu,
                              SoftmaxActivation as Softmax,
                              SquareActivation as Square,
                              STanhActivation as STanh,
                              TanhActivation as Tanh)
