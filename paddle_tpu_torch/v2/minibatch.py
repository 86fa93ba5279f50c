"""v2 minibatch module, the port of ``paddle_tpu/v2/minibatch.py``
(reference python/paddle/v2/minibatch.py:18):
`paddle.v2.minibatch.batch` is the same reader transformer exported at
the package top level (paddle_tpu_torch.reader.batch)."""

from ..reader import batch  # noqa: F401

__all__ = ["batch"]
