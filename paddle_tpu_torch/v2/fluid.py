"""`paddle.v2.fluid` namespace alias, the port of ``paddle_tpu/v2/fluid.py``
(reference python/paddle/v2/fluid/): the fluid API lives at the
paddle_tpu_torch package root; reference book/test scripts written as

    import paddle.v2 as paddle
    import paddle.v2.fluid as fluid
    from paddle.v2.fluid.layers import fc

run against this module unchanged (module identity is preserved, so
`fluid.layers is paddle_tpu_torch.layers`)."""

from __future__ import annotations

import sys as _sys

import paddle_tpu_torch as _root
from paddle_tpu_torch import *  # noqa: F401,F403
from paddle_tpu_torch import (  # noqa: F401
    DataFeeder,
    DistributeTranspiler,
    Executor,
    ParamAttr,
    SimpleDistributeTranspiler,
    layers,
    nets,
    optimizer,
    regularizer,
    clip,
    evaluator,
    io,
    profiler,
)
from paddle_tpu_torch.framework import backward, core, initializer  # noqa: F401
from paddle_tpu_torch.framework.backward import append_backward  # noqa: F401
from paddle_tpu_torch.lod import LoDTensor  # noqa: F401
from paddle_tpu_torch.memory_optimization_transpiler import (  # noqa: F401
    memory_optimize,
)

Tensor = LoDTensor  # reference fluid alias (__init__.py Tensor)

# make `import paddle_tpu_torch.v2.fluid.<sub>` resolve to the root modules
for _name, _mod in {
    "layers": _root.layers,
    "nets": _root.nets,
    "optimizer": _sys.modules["paddle_tpu_torch.optimizer"],
    "regularizer": _sys.modules["paddle_tpu_torch.regularizer"],
    "clip": _sys.modules["paddle_tpu_torch.clip"],
    "evaluator": _sys.modules["paddle_tpu_torch.evaluator"],
    "io": _sys.modules["paddle_tpu_torch.io"],
    "profiler": _sys.modules["paddle_tpu_torch.profiler"],
    "initializer": _sys.modules["paddle_tpu_torch.framework.initializer"],
    "backward": _sys.modules["paddle_tpu_torch.framework.backward"],
    "core": _sys.modules["paddle_tpu_torch.framework.core"],
    "framework": _sys.modules["paddle_tpu_torch.framework.core"],
    "executor": _sys.modules["paddle_tpu_torch.framework.executor"],
    "param_attr": _sys.modules["paddle_tpu_torch.framework.param_attr"],
}.items():
    _sys.modules[__name__ + "." + _name] = _mod
    setattr(_sys.modules[__name__], _name, _mod)
