"""reference python/paddle/trainer/PyDataProvider2.py:365 — the @provider
data-provider API.  Implementation: v1/data_provider.py (slot types,
init_hook, bounded-pool shuffle, pass cache); this module is the
reference import path (`from paddle.trainer.PyDataProvider2 import
provider, integer_value, dense_vector`)."""

from ..v1.data_provider import *  # noqa: F401,F403
from ..v1.data_provider import (  # noqa: F401
    CacheType,
    InputType,
    Settings,
    dense_vector,
    dense_vector_sequence,
    integer_value,
    integer_value_sequence,
    provider,
    sparse_binary_vector,
    sparse_float_vector,
)
