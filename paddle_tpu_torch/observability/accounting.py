"""Predicted-vs-measured accounting — the port of
``paddle_tpu/observability/accounting.py``.

``analysis.cost.program_cost`` prices a step (roofline) and
``analysis.memory.peak_estimate`` prices its device-memory peak.  Any
program registered with :func:`track` gets that static prediction
attached, every executor step reports its measured duration through
:func:`on_step` (wired into ``Executor.run``), and the registry
materializes the error ratios

    pred_vs_measured_step_time_ratio{program=...}  = predicted/measured
    pred_vs_measured_peak_ratio{program=...}       = predicted/measured

which :func:`artifact_rows` emits in the bench artifact schema.

Ratio convention: predicted/measured — 1.0 is a perfect model, >1 the
static model over-prices, <1 it under-prices.

Measured step time is the MEDIAN of steady-state runs.  On the card
the executor reads it after a device synchronize at both ends of the
step (``needs_sync``), never from the host clock alone.  Runs that
built something — a program's first run on an executor (kernel builds,
uploaded constants) and the dispatch that captures a K-step CUDA graph
— count as ``compiled`` and stay out of the steady-state window.
Measured peak (:func:`record_measured_peak`) is the growth of
``torch.cuda.max_memory_allocated`` over one step plus the bytes of the
state and feeds the step reads: the argument + temporary footprint the
JAX package reads from XLA's buffer assignment.
"""

from __future__ import annotations

import statistics
import threading
from typing import Dict, List, Optional

from .metrics import REGISTRY
from .tracing import TRACER

_MAX_DURATIONS = 256  # per-program bounded measurement window

# per-step family handles resolved once (families survive
# REGISTRY.reset()) — on_step rides the Executor.run hot path
_HIST_STEP = REGISTRY.histogram(
    "executor_step_seconds",
    "measured wall time of tracked executor steps")
_RATIO_STEP = REGISTRY.gauge(
    "pred_vs_measured_step_time_ratio",
    "predicted/measured step time (1.0 = perfect model)")


class _Tracked:
    # no reference to the Program itself: the cache token is the
    # identity, and pinning the whole block/op graph here would keep
    # every tracked program alive until the next reset
    __slots__ = ("label", "batch_size", "predicted_step_s",
                 "predicted_peak_bytes", "durations", "compile_runs",
                 "measured_peak_bytes")

    def __init__(self, label, batch_size, predicted_step_s,
                 predicted_peak_bytes):
        self.label = label
        self.batch_size = batch_size
        self.predicted_step_s = predicted_step_s
        self.predicted_peak_bytes = predicted_peak_bytes
        self.durations: List[float] = []
        self.compile_runs = 0
        self.measured_peak_bytes: Optional[int] = None


_lock = threading.Lock()
_tracked: Dict[int, _Tracked] = {}  # program._cache_token -> entry


def track(program, label: str, batch_size: int = 64,
          chip: Optional[str] = None) -> dict:
    """Attach the static cost/memory prediction to `program` and start
    collecting its measured step times.  Returns the prediction dict.
    `label` becomes the bounded-cardinality ``program=`` metric label —
    use a model name, never a per-request string.  `chip` defaults to
    the detected one (``h100-sxm`` on the card, ``cpu-host`` without)."""
    from ..analysis import cost as acost
    from ..analysis import memory as amem

    cost = acost.program_cost(program, batch_size=batch_size,
                              chip=chip or acost.detect_chip())
    mem = amem.peak_estimate(program, batch_size=batch_size)
    entry = _Tracked(str(label), int(batch_size),
                     float(cost["predicted_step_time_s"]),
                     int(mem["total_peak_bytes"]))
    with _lock:
        _tracked[program._cache_token] = entry
    REGISTRY.gauge(
        "pred_step_time_seconds",
        "static roofline step-time prediction (analysis.cost)").set(
        entry.predicted_step_s, program=entry.label)
    REGISTRY.gauge(
        "pred_peak_bytes",
        "static HBM-peak prediction (analysis.memory)").set(
        entry.predicted_peak_bytes, program=entry.label)
    return {"label": entry.label,
            "predicted_step_time_s": entry.predicted_step_s,
            "predicted_peak_bytes": entry.predicted_peak_bytes,
            "chip": cost["chip"]}


def needs_sync(program) -> bool:
    """Whether the executor must synchronize the device around this
    run: only a tracked program's steps are timed (one unlocked dict
    read, like ``on_step``'s fast path)."""
    return bool(_tracked) and program._cache_token in _tracked


def on_step(program, dur_s: float, compiled: bool):
    """Executor hook: one run of `program` took `dur_s` seconds.  Cheap
    for untracked programs; compile runs are counted but never enter the
    steady-state window."""
    # unlocked fast path: with nothing tracked the executor hot path must
    # not serialize on one module-global lock.  The race is benign:
    # _tracked only grows via track() (reset() empties it wholesale).
    if not _tracked:
        return
    with _lock:
        entry = _tracked.get(program._cache_token)
        if entry is None:
            return
        if compiled:
            entry.compile_runs += 1
        else:
            if len(entry.durations) >= _MAX_DURATIONS:
                entry.durations.pop(0)
            entry.durations.append(float(dur_s))
    _HIST_STEP.observe(dur_s, program=entry.label,
                       kind="compile" if compiled else "steady")
    _refresh_ratio(entry)


def _refresh_ratio(entry: _Tracked):
    if not entry.durations:
        return
    measured = statistics.median(entry.durations)
    if measured > 0 and entry.predicted_step_s > 0:
        _RATIO_STEP.set(entry.predicted_step_s / measured,
                        program=entry.label)


def _argument_bytes(program, feed, scope, block_id=0) -> int:
    """Bytes of the state the block reads or writes (what is resident
    in the scope) plus the feeds: the step's arguments."""
    from ..analysis.dataflow import state_classes
    from ..framework.scope import global_scope

    scope = scope if scope is not None else global_scope()
    block = program.blocks[block_id]
    ext, rw, _ = state_classes(block, list(feed or {}))
    total = 0
    for name in set(ext) | set(rw):
        v = scope.find(name)
        if v is not None and hasattr(v, "element_size"):
            total += v.numel() * v.element_size()
    for v in (feed or {}).values():
        nbytes = getattr(v, "nbytes", None)
        if nbytes is None and hasattr(v, "element_size"):
            nbytes = v.numel() * v.element_size()
        total += int(nbytes or 0)
    return int(total)


def record_measured_peak(program, executor, feed=None, fetch_list=None,
                         scope=None) -> Optional[int]:
    """Run one step of a tracked program and record its measured device
    peak: the growth of ``torch.cuda.max_memory_allocated`` over the step
    plus the bytes of the state and feeds it reads (the argument +
    temporary footprint).  Materializes the peak error ratio.  A CPU
    executor has no device allocator to read: returns None and records
    nothing."""
    import torch

    with _lock:
        entry = _tracked.get(program._cache_token)
    if entry is None:
        return None
    dev = executor.device
    if dev.type != "cuda":
        return None
    with TRACER.span("accounting.memory_stats", program=entry.label):
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        executor.run(program, feed=feed, fetch_list=fetch_list,
                     scope=scope)
        torch.cuda.synchronize(dev)
        growth = max(torch.cuda.max_memory_allocated(dev) - base, 0)
    peak = int(growth + _argument_bytes(program, feed, scope))
    entry.measured_peak_bytes = peak
    REGISTRY.gauge(
        "measured_peak_bytes",
        "measured device-memory peak of one step (argument + temporary "
        "bytes)").set(peak, program=entry.label)
    if peak > 0:
        REGISTRY.gauge(
            "pred_vs_measured_peak_ratio",
            "predicted/measured HBM peak (1.0 = perfect model)").set(
            entry.predicted_peak_bytes / peak, program=entry.label)
    return peak


def report() -> List[dict]:
    """One row per tracked program: predictions, steady-state measured
    median, and the predicted/measured error ratios."""
    rows = []
    with _lock:
        entries = list(_tracked.values())
    for e in sorted(entries, key=lambda e: e.label):
        measured = (statistics.median(e.durations)
                    if e.durations else None)
        rows.append({
            "program": e.label,
            "batch_size": e.batch_size,
            "predicted_step_time_s": e.predicted_step_s,
            "measured_step_time_s": measured,
            "steady_runs": len(e.durations),
            "compile_runs": e.compile_runs,
            "step_time_ratio": (e.predicted_step_s / measured
                                if measured else None),
            "predicted_peak_bytes": e.predicted_peak_bytes,
            "measured_peak_bytes": e.measured_peak_bytes,
            "peak_ratio": (e.predicted_peak_bytes / e.measured_peak_bytes
                           if e.measured_peak_bytes else None),
        })
    return rows


def artifact_rows() -> List[dict]:
    """report() in the bench artifact schema; skips programs with no
    measurement yet."""
    from .metrics import artifact_metric

    out = []
    for r in report():
        if r["step_time_ratio"] is not None:
            out.append(artifact_metric(
                f"predvmeas_step_ratio_{r['program']}",
                round(r["step_time_ratio"], 4), "predicted/measured",
                predicted_s=round(r["predicted_step_time_s"], 6),
                measured_s=round(r["measured_step_time_s"], 6),
                steady_runs=r["steady_runs"]))
        if r["peak_ratio"] is not None:
            out.append(artifact_metric(
                f"predvmeas_peak_ratio_{r['program']}",
                round(r["peak_ratio"], 4), "predicted/measured",
                predicted_bytes=r["predicted_peak_bytes"],
                measured_bytes=r["measured_peak_bytes"]))
    return out


def reset():
    """Forget every tracked program (``reset()`` / test isolation)."""
    with _lock:
        _tracked.clear()
