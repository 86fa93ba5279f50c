"""v1 config API (reference python/paddle/trainer_config_helpers/), the
port of ``paddle_tpu/v1/``: the
declarative layer functions + networks presets + activation/pooling/attr
objects + settings()-style optimizer config, re-based onto the Program IR.

    from paddle_tpu_torch.v1 import *

    settings(batch_size=128, learning_rate=1e-3,
             learning_method=AdamOptimizer())
    img = data_layer("pixel", size=784)
    hidden = fc_layer(img, size=200, act=TanhActivation())
    pred = fc_layer(hidden, size=10, act=SoftmaxActivation())
    cost = classification_cost(pred, data_layer("label", size=10,
                                                dtype="int64"))
    prog = parse_network(cost)  # the Program IS the parsed config
"""

from .activations import *  # noqa: F401,F403
from ..trainer.config_parser import (  # noqa: F401
    get_config_arg, set_config_args)
from .attrs import ExtraAttr, ExtraLayerAttribute, HookAttribute, ParamAttr, \
    ParameterAttribute  # noqa: F401
from .evaluators import (auc_evaluator, chunk_evaluator,  # noqa: F401
                         classification_error_evaluator, ctc_error_evaluator,
                         pnpair_evaluator, precision_recall_evaluator)
from .layers import *  # noqa: F401,F403
from .layers import LayerOutput  # noqa: F401
from .networks import (bidirectional_gru, bidirectional_lstm,  # noqa: F401
                       gru_group, gru_unit, img_conv_group, lstmemory_group,
                       lstmemory_unit, sequence_conv_pool, simple_attention,
                       simple_gru, simple_gru2, simple_img_conv_pool,
                       simple_lstm, text_conv_pool, vgg_16_network)
from .optimizers import (AdaDeltaOptimizer, AdaGradOptimizer,  # noqa: F401
                         AdamOptimizer, AdamaxOptimizer,
                         DecayedAdaGradOptimizer, MomentumOptimizer,
                         RMSPropOptimizer, optimizer_from_settings, settings)
from .poolings import (AvgPooling, FirstPooling, LastPooling,  # noqa: F401
                       MaxPooling, SqrtAvgPooling, SumPooling)
from .data_provider import (CacheType, dense_vector,  # noqa: F401
                            dense_vector_sequence, define_py_data_sources2,
                            integer_value, integer_value_sequence, provider,
                            sparse_binary_vector, sparse_float_vector,
                            sparse_value)
from .trainer import V1Trainer  # noqa: F401


def reset_v1_config():
    """Clear v1 per-config globals (declared outputs + registered data
    sources) — called by paddle_tpu_torch.reset()."""
    from . import layers as _layers
    from .data_provider import reset_data_sources

    _layers._declared_outputs.clear()
    reset_data_sources()
