"""Op emitters; importing this package registers them."""

from . import attention_ops, tensor_ops  # noqa: F401
