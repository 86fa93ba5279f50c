"""v2 poolings, the port of ``paddle_tpu/v2/pooling.py`` (reference
python/paddle/v2/pooling.py): the port's v1 poolings under their v2 names."""

from ..v1.poolings import (AvgPooling as Avg,  # noqa: F401
                           FirstPooling as First,
                           LastPooling as Last,
                           MaxPooling as Max,
                           SqrtAvgPooling as SqrtAvg,
                           SumPooling as Sum)
