"""v2-style API, the port of ``paddle_tpu/v2`` (reference
python/paddle/v2/__init__.py): the reader-driven SGD.train event loop,
Parameters with tar serialization, batching, datasets — over the
fluid-style layer graph, on the card unless a place says otherwise.

    import paddle_tpu_torch.v2 as paddle
    cost = ...  # build with paddle.layer.* or paddle_tpu_torch.layers
    trainer = paddle.trainer.SGD(cost=cost,
                                 update_equation=paddle.optimizer.Adam(...))
    trainer.train(paddle.batch(paddle.dataset.mnist.train(), 64),
                  num_passes=2, event_handler=handler)

``image`` needs PIL and ``plot`` renders with matplotlib; both import them
inside the functions that use them, so this package imports without
either.
"""

from .. import dataset  # noqa: F401
from .. import optimizer  # noqa: F401
from .. import reader  # noqa: F401
from ..reader import batch  # noqa: F401
from . import activation  # noqa: F401
from . import attr  # noqa: F401
from . import data_type  # noqa: F401
from . import event  # noqa: F401
from . import image  # noqa: F401
from . import layer  # noqa: F401
from . import pooling  # noqa: F401
from . import plot  # noqa: F401
from . import trainer  # noqa: F401
from . import op  # noqa: F401
from . import minibatch  # noqa: F401
from .data_feeder import DataFeeder  # noqa: F401
from . import fluid  # noqa: F401
from . import master  # noqa: F401
from . import topology  # noqa: F401
from .topology import Topology  # noqa: F401
from ..framework.core import (  # noqa: F401
    default_main_program,
    default_startup_program,
)
from ..v1 import networks  # noqa: F401
from . import evaluator  # noqa: F401
from . import parameters  # noqa: F401
from .parameters import Parameters  # noqa: F401
from .trainer import SGD, infer  # noqa: F401
from .inference import SequenceGenerator  # noqa: F401


def init(use_gpu=False, trainer_count=1, **kw):
    """Process init (reference paddle.init → swig init), kept for API
    parity and doing nothing: the device comes from each trainer's,
    ``infer``'s or ``SequenceGenerator``'s `place` (the card by default),
    so ``use_gpu=False`` does not move a run to the CPU."""
    return None
