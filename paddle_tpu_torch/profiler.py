"""Profiler (reference paddle/platform/profiler.h Event/RecordEvent RAII +
EventItem report, python/paddle/v2/fluid/profiler.py cuda_profiler) —
the port of ``paddle_tpu/profiler.py``.

A thin face over ``paddle_tpu_torch.observability``: ``RecordEvent``
records into the shared metrics registry (histogram
``host_event_seconds{name=...}``) and, when tracing is enabled, opens a
span in the shared tracer, so legacy ``RecordEvent`` call sites appear
in the Perfetto trace beside the executor and serving spans.

Device tracing: ``profiler(trace_dir=...)`` runs its body under
``torch.profiler`` and writes a Chrome trace (``trace.json``) into
`trace_dir`; ``cuda_profiler`` and ``CudaProfiler`` start and stop
``torch.cuda.profiler`` (the nvprof / Nsight capture-range hooks).
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

from .observability.metrics import REGISTRY as _MET, monotime as _monotime
from .observability.tracing import TRACER as _TRC

_EVENT_FAMILY = "host_event_seconds"
_HELP = "RecordEvent host timers (profiler.py compatibility face)"

# handle resolved once (families survive REGISTRY.reset()): RecordEvent
# sits in per-step loops, where a per-event family lookup would be pure
# overhead
_HOST_EVENTS = _MET.histogram(_EVENT_FAMILY, _HELP)


def _family():
    return _HOST_EVENTS


def enable_profiler():
    """API-parity no-op: recording is governed by the shared registry's
    own gate (on by default; PADDLE_TPU_TELEMETRY=0 opts the process
    out), which the legacy switch must not override."""


def disable_profiler():
    # not registry.disable(): the registry serves every subsystem, and
    # the legacy profiler switch must not silence the serving/executor
    # counters recorded beside these events
    pass


def reset_profiler():
    _family().clear()


class RecordEvent:
    """RAII timer (profiler.h:102). Usable as context manager/decorator."""

    def __init__(self, name: str):
        self.name = name
        self._span = None

    def __enter__(self):
        self._span = _TRC.span(f"host.{self.name}", cat="host_event")
        self._span.__enter__()
        self._t0 = _monotime()
        return self

    def __exit__(self, *exc):
        dt = _monotime() - self._t0
        self._span.__exit__(*(exc or (None, None, None)))
        _family().observe(dt, name=self.name)
        return False


def record_event(name):
    return RecordEvent(name)


def get_report():
    """EventItem aggregation (profiler.cc report): name → stats dict,
    read back from the shared registry."""
    out = {}
    for labels, s in _family().series_stats():
        out[labels.get("name", "")] = {
            "calls": s["count"], "total_s": s["sum"],
            "avg_s": s["avg"], "max_s": s["max"], "min_s": s["min"]}
    return out


def print_report(sorted_by="total_s"):
    rep = get_report()
    rows = sorted(rep.items(), key=lambda kv: -kv[1][sorted_by])
    print(f"{'Event':40s} {'Calls':>8s} {'Total(s)':>10s} {'Avg(ms)':>10s} "
          f"{'Max(ms)':>10s}")
    for name, s in rows:
        print(f"{name:40s} {s['calls']:8d} {s['total_s']:10.4f} "
              f"{s['avg_s']*1e3:10.3f} {s['max_s']*1e3:10.3f}")
    return rows


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: Optional[str] = None,
             trace_dir: Optional[str] = None):
    """fluid.profiler.profiler context: host timers + optional device
    trace.  With `trace_dir` set the body runs under ``torch.profiler``
    (CPU, and CUDA when a card is present) and its Chrome trace lands in
    ``trace_dir/trace.json`` (open it in ui.perfetto.dev)."""
    import torch

    reset_profiler()
    enable_profiler()
    if trace_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(trace_dir, exist_ok=True)
        with profile(activities=acts) as prof:
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    else:
        yield
    if sorted_key:
        print_report({"calls": "calls", "total": "total_s",
                      "ave": "avg_s", "max": "max_s"}.get(sorted_key,
                                                          "total_s"))


@contextlib.contextmanager
def cuda_profiler(output_file=None, output_mode=None, config=None):
    """fluid.profiler.cuda_profiler (profiler.py:32): the body runs
    inside ``torch.cuda.profiler``'s capture range (cudaProfilerStart /
    Stop), which an external CUDA profiler records."""
    with CudaProfiler(output_file, output_mode, config):
        yield


class CudaProfiler:
    """Class form of the reference's nvprof hooks
    (platform/cuda_profiler.h): ``start``/``stop`` call
    ``torch.cuda.profiler.start``/``stop``.  Without a card both are
    no-ops."""

    def __init__(self, output_file=None, output_mode=None, config=None):
        self.output_file = output_file
        self._on = False

    def start(self):
        import torch

        if torch.cuda.is_available():
            torch.cuda.profiler.start()
            self._on = True

    def stop(self):
        import torch

        if self._on:
            torch.cuda.synchronize()
            torch.cuda.profiler.stop()
            self._on = False

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
