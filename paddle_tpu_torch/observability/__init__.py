"""paddle_tpu_torch.observability — the port of ``paddle_tpu.observability``.

One namespace over:

  * :mod:`.metrics` — the process-global ``REGISTRY`` of counters /
    gauges / histograms with labels; Prometheus text and JSON snapshot
    exports; the bench-artifact metric-name authority
    (``artifact_metric``);
  * :mod:`.tracing` — the process-global ``TRACER``: nested spans in a
    bounded ring, Chrome/Perfetto trace-event export;
  * :mod:`.accounting` — predicted-vs-measured: static cost and memory
    predictions attached per program, measured step times and device
    peaks recorded against them, error ratios materialized as metrics;
  * :mod:`.attribution` — per-op device-time attribution: op identity
    as ``torch.profiler`` ranges, the profile capture and the segment
    oracle, and the per-op predicted-vs-measured table;
  * :mod:`.calibration` — the sealed per-(op type, chip, dtype)
    correction-factor store the attribution tables feed and the cost
    model and autotune prior consume.

Usage:

    from paddle_tpu_torch import observability as obs

    obs.enable_tracing()
    with obs.span("my.phase", detail="..."):
        ...
    obs.TRACER.export("trace.json")      # open in ui.perfetto.dev
    print(obs.REGISTRY.render_prometheus())

A span also opens a ``torch.profiler.record_function`` range of its own
name, whether or not tracing is on, so one name is seen by the tracer
and by a profiler trace.  With tracing off a span costs that range and
one attribute check.
"""

from torch.profiler import record_function

from . import accounting  # noqa: F401
from . import attribution  # noqa: F401
from . import calibration  # noqa: F401
from . import metrics  # noqa: F401
from . import tracing  # noqa: F401
from .httpd import TelemetryServer, serve_http  # noqa: F401
from .metrics import (  # noqa: F401
    REGISTRY,
    MetricsRegistry,
    MirroredCounters,
    artifact_metric,
    monotime,
    validate_snapshot,
)
from .tracing import (  # noqa: F401
    NOOP_SPAN,
    TRACER,
    Tracer,
    chrome_envelope,
    concat_windows,
    validate_chrome_trace,
)


class _RangedSpan:
    """A tracer span (or the no-op one) inside a profiler range of the
    same name; ``with`` yields the span, so ``.note()`` works as on the
    tracer's own."""

    __slots__ = ("_range", "_span")

    def __init__(self, name, span):
        self._range = record_function(name)
        self._span = span

    def __enter__(self):
        self._range.__enter__()
        return self._span.__enter__()

    def __exit__(self, *exc):
        try:
            self._span.__exit__(*exc)
        finally:
            self._range.__exit__(*exc)
        return False


def span(name: str, cat: str = "pdtpu", **args):
    """Open a span on the global tracer inside a profiler range of the
    same name (the tracer's part is a no-op singleton when it is off)."""
    return _RangedSpan(name, TRACER.span(name, cat=cat, **args))


def instant(name: str, cat: str = "pdtpu", **args):
    return TRACER.instant(name, cat=cat, **args)


def enable_tracing(capacity=None):
    TRACER.enable(capacity)


def disable_tracing():
    TRACER.disable()


def export_telemetry(trace_obj=None, trace_path=None,
                     metrics_obj=None, metrics_path=None):
    """Write and schema-validate telemetry artifacts in one place.

    `metrics_obj` is either a bare registry snapshot or the multi-run
    form ``{"runs": [{"snapshot": ...}, ...]}``; every snapshot inside
    is validated.  Returns problem strings (empty = artifacts written
    and schema-clean); files are written regardless so a failed
    validation still leaves the evidence on disk."""
    import json

    problems = []
    if trace_path is not None and trace_obj is not None:
        problems += [f"trace: {p}"
                     for p in validate_chrome_trace(trace_obj)]
        with open(trace_path, "w") as f:
            json.dump(trace_obj, f)
    if metrics_path is not None and metrics_obj is not None:
        snaps = (metrics_obj.get("runs")
                 if isinstance(metrics_obj, dict)
                 and "runs" in metrics_obj
                 else [{"snapshot": metrics_obj}])
        for rec in snaps:
            problems += [f"metrics: {p}"
                         for p in validate_snapshot(rec["snapshot"])]
        with open(metrics_path, "w") as f:
            json.dump(metrics_obj, f)
    return problems


def reset():
    """Fresh registry, tracer, accounting and attribution state (the
    ``paddle_tpu_torch.reset()`` hook — clears series and the ring in
    place, so held handles stay valid)."""
    REGISTRY.reset()
    TRACER.reset()
    accounting.reset()
    attribution.reset()
