"""paddle_tpu_torch: the PyTorch and CUDA port of paddle_tpu.

Fluid-style usage, on the card unless the caller asks for the CPU:

    import paddle_tpu_torch as fluid

    exe = fluid.Executor()              # CUDAPlace(0); raises without CUDA
    exe = fluid.Executor(fluid.CPUPlace())

The JAX package ``paddle_tpu`` is the reference this package is held
against; nothing here imports it or JAX."""

from . import layers  # noqa: F401
from . import ops  # noqa: F401  (registers the op emitters)
from .framework import unique_name
from .framework.core import (  # noqa: F401
    Program,
    default_main_program,
    default_startup_program,
    program_guard,
    switch_main_program,
    switch_startup_program,
)
from .framework.executor import Executor  # noqa: F401
from .framework.place import CPUPlace, CUDAPlace, default_place  # noqa: F401
from .framework.scope import (  # noqa: F401
    Scope,
    global_scope,
    reset_global_scope,
    scope_guard,
)


def reset():
    """Fresh default programs + scope + name counters (test isolation)."""
    switch_main_program(Program())
    switch_startup_program(Program())
    reset_global_scope()
    unique_name.reset()
