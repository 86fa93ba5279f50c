"""Op emitters; importing this package registers them."""

from . import (  # noqa: F401
    activation_ops,
    attention_ops,
    beam_ops,
    control_flow_ops,
    crf_ops,
    loss_ops,
    math_ops,
    nn_ops,
    optimizer_ops,
    sequence_ops,
    tensor_ops,
    transformer_ops,
)
