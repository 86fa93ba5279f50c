from .nn import data, embedding, fc, layer_norm, multi_head_attention  # noqa: F401
from .fluid_compat import create_parameter  # noqa: F401
from .sequence import propagate_length  # noqa: F401
from .tensor import elementwise_add  # noqa: F401
