from .nn import (  # noqa: F401
    data,
    embedding,
    fc,
    layer_norm,
    mean,
    multi_head_attention,
    softmax_with_cross_entropy,
)
from .fluid_compat import create_parameter  # noqa: F401
from .sequence import propagate_length  # noqa: F401
from .tensor import cast, elementwise_add, reshape, transpose  # noqa: F401
