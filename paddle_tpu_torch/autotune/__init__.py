"""Analyzer-guided autotuner — the port of ``paddle_tpu/autotune``.

A typed search space (hand-written kernel variants and their
parameters, page sizes, speculation depth, steps per dispatch, remat),
the static cost and memory analyzers as the ranking prior so only the
predicted-top-k candidates are ever measured, a timed measurement
harness with telemetry, and a persistent winner store that the knobs and
the executor read back.

Entry points:

  * ``python -m paddle_tpu_torch tune <workload|saved-model-dir>``
  * :func:`tune` — the library face
  * :mod:`paddle_tpu_torch.autotune.knobs` — where kernels and the
    serving tier resolve tuning parameters (trial override > env >
    winner store > default)

Import-light: the workloads build real programs and load on first use.
"""

from __future__ import annotations

from . import knobs, store  # noqa: F401  (import-light)
from .store import WinnerStore, default_store  # noqa: F401


def tune(workload, **kw):
    """Tune a workload object or a registered workload name; see
    autotune.tuner.tune for the knobs."""
    from . import tuner, workloads

    if isinstance(workload, str):
        workload = workloads.get_workload(workload)
    return tuner.tune(workload, **kw)
