"""paddle_tpu_torch: the PyTorch and CUDA port of paddle_tpu.

Fluid-style usage, on the card unless the caller asks for the CPU:

    import paddle_tpu_torch as fluid

    exe = fluid.Executor()              # CUDAPlace(0); raises without CUDA
    exe = fluid.Executor(fluid.CPUPlace())

Training: ``optimizer.Adam(...).minimize(loss)`` (or SGD, Momentum,
Adagrad, Adamax, DecayedAdagrad, RMSProp, Adadelta) appends the
desc-level backward, the gradient clips (``clip``), the weight decay
(``regularizer``) and the updates, with a constant learning rate or a
schedule (``learning_rate_decay``); ``optimizer.ModelAverage`` keeps
windowed parameter averages.  One ``exe.run`` is one step, and
``exe.run(steps_per_dispatch=K)`` is K, on the card one replay of a
captured CUDA graph (``framework/step_loop.py``).  ``reader`` and
``DataFeeder``/``DeviceFeeder`` feed it.  ``io`` saves and loads
persistables and inference models in the JAX package's layout, and
``fuse_batch_norm`` folds inference-mode BatchNorm into convolutions.

The JAX package ``paddle_tpu`` is the reference this package is held
against; nothing here imports it or JAX."""

from . import layers  # noqa: F401
from . import ops  # noqa: F401  (registers the op emitters)
from . import optimizer  # noqa: F401
from . import regularizer  # noqa: F401
from . import clip  # noqa: F401
from . import io  # noqa: F401
from . import nets  # noqa: F401
from . import learning_rate_decay  # noqa: F401
from . import dataset  # noqa: F401
from . import evaluator  # noqa: F401
from . import reader  # noqa: F401
from .data_feeder import DataFeeder, DeviceFeeder  # noqa: F401
from .framework import unique_name
from .framework.backward import append_backward, calc_gradient  # noqa: F401
from .framework.core import (  # noqa: F401
    Program,
    default_main_program,
    default_startup_program,
    program_guard,
    switch_main_program,
    switch_startup_program,
)
from .framework.executor import Executor  # noqa: F401
from .inference_transpiler import InferenceTranspiler, fuse_batch_norm  # noqa: F401
from .framework.param_attr import ParamAttr  # noqa: F401
from .framework.place import CPUPlace, CUDAPlace, default_place  # noqa: F401
from .framework.scope import (  # noqa: F401
    Scope,
    global_scope,
    load_persistables,
    reset_global_scope,
    scope_guard,
)


def reset():
    """Fresh default programs + scope + name counters (test isolation)."""
    switch_main_program(Program())
    switch_startup_program(Program())
    reset_global_scope()
    unique_name.reset()
