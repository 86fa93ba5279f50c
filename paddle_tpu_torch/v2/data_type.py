"""v2 data types, the port of ``paddle_tpu/v2/data_type.py`` (reference
python/paddle/v2/data_type.py): slot
declarations shared with the v1 @provider machinery — `dense_vector(784)`,
`integer_value(10)`, sparse and `*_sequence` variants."""

from ..v1.data_provider import (  # noqa: F401
    InputType,
    dense_vector,
    dense_vector_sequence,
    integer_value,
    integer_value_sequence,
    sparse_binary_vector,
    sparse_float_vector,
    sparse_value,
    sparse_vector,
)
