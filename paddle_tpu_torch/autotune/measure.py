"""Measurement harness: time the predicted-top-k candidates — the port of
``paddle_tpu/autotune/measure.py``.

``warmup`` runs first (kernel builds and first-use costs are never
timed), then ``repeats`` passes of ``iters`` steps each.  Every pass
ends in the runner's ``barrier()`` — a device synchronize on the card —
before the clock is read, so a pass times the device's work, not the
host's launch queue.  Best-of-N is the capability number and the median
the steady-state one; both are reported, with every pass.

Every trial runs inside ``knobs.trial_overrides`` pinning the
candidate's kernel parameters (the resolution order's top layer) and an
``autotune.trial`` tracer span; counters and histograms go to the
shared registry.  A trial that raises propagates: the tune fails loudly
(``prior``'s ``feasible`` hooks exist so that no trial launches a kernel
that raises).  The JAX package's fresh-process trials for XLA-flag
candidates have no counterpart (the port has no ``xla_flags`` axis).

:class:`MockMeasurer` is the deterministic stand-in for tests and the
smoke: nothing runs, no clock — time is a pure function of the candidate
digest (or an injected ``time_fn``).
"""

from __future__ import annotations

import statistics
from typing import List

from ..observability.metrics import REGISTRY, monotime
from ..observability.tracing import TRACER
from . import knobs


def _result(passes_s: List[float], steps: int, how: str) -> dict:
    return {
        "best_s": min(passes_s),
        "median_s": statistics.median(passes_s),
        "passes_ms": [round(p * 1e3, 4) for p in passes_s],
        "steps": steps,
        "how": how,
    }


class TimedMeasurer:
    """The real thing: timed trials on the workload's place.  A runner
    gives ``step()``, ``barrier()`` (wait for the device) and
    ``close()``."""

    def __init__(self, warmup: int = 2, iters: int = 8, repeats: int = 3):
        self.warmup = max(0, int(warmup))
        self.iters = max(1, int(iters))
        self.repeats = max(1, int(repeats))

    def measure(self, workload, candidate) -> dict:
        with knobs.trial_overrides(candidate.knob_params()), \
                TRACER.span("autotune.trial", workload=workload.name,
                            candidate=candidate.digest):
            t0 = monotime()
            runner = workload.build_runner(candidate)
            try:
                # warmup=0 is honored: the first timed pass then pays
                # the first-use costs — an explicit choice, not a clamp
                with TRACER.span("autotune.warmup", runs=self.warmup):
                    for _ in range(self.warmup):
                        runner.step()
                    runner.barrier()
                passes = []
                for _ in range(self.repeats):
                    with TRACER.span("autotune.pass", iters=self.iters):
                        p0 = monotime()
                        for _ in range(self.iters):
                            runner.step()
                        runner.barrier()
                        passes.append((monotime() - p0) / self.iters)
                extra = runner.report() if hasattr(runner, "report") \
                    else {}
            finally:
                runner.close()
            REGISTRY.histogram(
                "autotune_trial_seconds",
                "wall time of whole autotune trials").observe(
                monotime() - t0, workload=workload.name)
        REGISTRY.counter(
            "autotune_trials_total",
            "autotune candidates by workload and outcome").inc(
            workload=workload.name, outcome="measured")
        res = _result(passes, self.iters,
                      f"best_of_{self.repeats}x{self.iters}_iters")
        res.update(extra)
        return res


class MockMeasurer:
    """Deterministic measurer for tests and the smoke: nothing runs.

    Default time = 1ms * (1 + digest-derived fraction) — stable across
    processes; inject ``time_fn(workload, candidate) -> seconds`` to
    script outcomes.  Records every candidate it is asked to measure
    (the never-measure-infeasible assertion reads it)."""

    def __init__(self, time_fn=None):
        self.time_fn = time_fn
        self.measured: List = []

    def measure(self, workload, candidate) -> dict:
        self.measured.append(candidate)
        REGISTRY.counter(
            "autotune_trials_total",
            "autotune candidates by workload and outcome").inc(
            workload=workload.name, outcome="mock")
        if self.time_fn is not None:
            t = float(self.time_fn(workload, candidate))
        else:
            t = 1e-3 * (1.0 + int(candidate.digest, 16) % 997 / 997.0)
        return _result([t, t, t], 1, "mock")
