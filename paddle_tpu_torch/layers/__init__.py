from .nn import (  # noqa: F401
    accuracy,
    batch_norm,
    conv2d,
    cross_entropy,
    data,
    embedding,
    fc,
    layer_norm,
    mean,
    multi_head_attention,
    pool2d,
    softmax,
    softmax_with_cross_entropy,
    square_error_cost,
    topk,
)
from .ops import *  # noqa: F401,F403
from .control_flow import increment  # noqa: F401
from .fluid_compat import create_parameter  # noqa: F401
from .sequence import (  # noqa: F401
    dynamic_gru,
    dynamic_lstm,
    get_length_var,
    propagate_length,
    sequence_data,
    sequence_embedding,
    sequence_fc,
    sequence_pool,
    sequence_reverse,
)
from .tensor import (  # noqa: F401
    cast,
    concat,
    elementwise_add,
    reshape,
    scale,
    transpose,
)
