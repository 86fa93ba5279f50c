"""Structured step tracing: nested spans in a bounded ring buffer,
exportable as Chrome/Perfetto trace-event JSON — the port's own copy of
``paddle_tpu/observability/tracing.py`` (stdlib only).

Callers open spans around their phases (the replica router's
``serve.route``); a trace window is then one artifact a human opens in
https://ui.perfetto.dev (or chrome://tracing).

Cost model:

  * **disabled (default)** — ``span()`` returns a module-level no-op
    singleton: no allocation, no clock read, one attribute check.  The
    hot serving/executor paths stay instrumented at all times because
    the instrumentation is free until someone turns it on;
  * **enabled** — one clock read per span edge plus one dict append into
    a ``deque(maxlen=capacity)`` ring: a long-lived service traces
    forever in bounded memory, keeping the most recent window.

Nesting is tracked per thread (a stack of open spans) so exported
events carry a ``depth`` arg and parent names, and Chrome's flame view
reconstructs the hierarchy from ts/dur containment per tid.

Stdlib-only and free of package-relative imports (file-loadable by
tools that must not import the framework).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import List, Optional

_clock = time.perf_counter


class _NoopSpan:
    """The disabled-path span: a shared, stateless context manager."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **kw):  # post-hoc args are dropped when disabled
        return self


NOOP_SPAN = _NoopSpan()


class _Span:
    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "_tid",
                 "_depth")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def note(self, **kw):
        """Attach args discovered after entry (e.g. admitted count)."""
        if self.args:
            self.args.update(kw)
        else:
            self.args = kw
        return self

    def __enter__(self):
        tr = self._tracer
        stack = tr._stack()
        self._depth = len(stack)
        stack.append(self.name)
        self._tid = threading.get_ident()
        self._t0 = _clock()
        return self

    def __exit__(self, exc_type, *exc):
        t1 = _clock()
        tr = self._tracer
        stack = tr._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        args = self.args or {}
        if self._depth:
            args = dict(args)
            args["depth"] = self._depth
        if exc_type is not None:
            args = dict(args)
            args["error"] = exc_type.__name__
        tr._record({
            "name": self.name, "cat": self.cat, "ph": "X",
            "ts": round((self._t0 - tr._epoch) * 1e6, 3),
            "dur": round((t1 - self._t0) * 1e6, 3),
            "pid": tr._pid, "tid": self._tid,
            **({"args": args} if args else {}),
        })
        return False


class Tracer:
    """Bounded-ring span recorder with Chrome trace-event export."""

    def __init__(self, enabled: Optional[bool] = None,
                 capacity: Optional[int] = None):
        if enabled is None:
            enabled = os.environ.get("PADDLE_TPU_TRACE", "0") == "1"
        if capacity is None:
            try:
                capacity = int(os.environ.get(
                    "PADDLE_TPU_TRACE_CAPACITY", "65536"))
            except ValueError:
                capacity = 65536
        self.enabled = bool(enabled)
        self.capacity = max(1, int(capacity))
        self._ring = collections.deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._epoch = _clock()
        self._pid = os.getpid()

    # -- recording --------------------------------------------------------
    def span(self, name: str, cat: str = "pdtpu", **args):
        """Open a span context.  Disabled -> the shared no-op singleton
        (zero allocation: the identity is asserted in tests)."""
        if not self.enabled:
            return NOOP_SPAN
        return _Span(self, name, cat, args or None)

    def instant(self, name: str, cat: str = "pdtpu", **args):
        """A point event (lease grant, rollback, fault injection...)."""
        if not self.enabled:
            return
        self._record({
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": round((_clock() - self._epoch) * 1e6, 3),
            "pid": self._pid, "tid": threading.get_ident(),
            **({"args": args} if args else {}),
        })

    def _stack(self) -> list:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def _record(self, ev: dict):
        with self._lock:
            self._ring.append(ev)

    # -- export -----------------------------------------------------------
    def events(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON object format — loadable by Perfetto
        (ui.perfetto.dev) and chrome://tracing."""
        return chrome_envelope(self.events())

    def export(self, path: str) -> str:
        obj = self.to_chrome()
        with open(path, "w") as f:
            json.dump(obj, f)
        return path

    # -- control ----------------------------------------------------------
    def enable(self, capacity: Optional[int] = None):
        if capacity is not None and capacity != self.capacity:
            self.capacity = max(1, int(capacity))
            with self._lock:
                self._ring = collections.deque(self._ring,
                                               maxlen=self.capacity)
        self.enabled = True

    def disable(self):
        self.enabled = False

    def reset(self):
        with self._lock:
            self._ring.clear()
        self._epoch = _clock()


def chrome_envelope(events) -> dict:
    """The Chrome trace-event export envelope — the ONE place its
    schema lives.  ``Tracer.to_chrome`` and every tool writing a merged
    multi-window trace build through here, so envelope changes (and the
    validator's expectations) can never drift across files."""
    return {
        "traceEvents": list(events),
        "displayTimeUnit": "ms",
        "otherData": {"producer": "paddle_tpu_torch.observability",
                      "schema": "chrome-trace-events"},
    }


def concat_windows(windows, gap_us: float = 1000.0) -> List[dict]:
    """Merge event lists captured in SEPARATE tracer windows (each
    re-anchored at ts~0 by ``Tracer.reset()``, e.g. the benches'
    per-run ``fluid.reset()``) onto one timeline: every window is
    shifted to start after the previous window's end plus a small gap,
    so the merged trace renders as sequential runs in Perfetto instead
    of impossibly overlapping same-track slices."""
    out: List[dict] = []
    base = 0.0
    for evs in windows:
        end = base
        for e in evs:
            ev = dict(e)
            ev["ts"] = round(float(ev.get("ts", 0.0)) + base, 3)
            end = max(end, ev["ts"] + float(ev.get("dur", 0.0)))
            out.append(ev)
        if evs:
            base = end + gap_us
    return out


def validate_chrome_trace(obj) -> List[str]:
    """Schema check for to_chrome() output (and for the files the smoke
    tier lints): returns problem strings, empty when Perfetto-loadable."""
    problems = []
    if not isinstance(obj, dict):
        return ["trace is not a JSON object"]
    evs = obj.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        for k in ("name", "ph", "ts", "pid", "tid"):
            if k not in ev:
                problems.append(f"event {i} ({ev.get('name')}): "
                                f"missing {k!r}")
        if ev.get("ph") == "X" and not isinstance(
                ev.get("dur"), (int, float)):
            problems.append(f"event {i} ({ev.get('name')}): complete "
                            f"event without numeric dur")
        if not isinstance(ev.get("ts"), (int, float)):
            problems.append(f"event {i} ({ev.get('name')}): "
                            f"non-numeric ts")
        if "args" in ev and not isinstance(ev["args"], dict):
            problems.append(f"event {i} ({ev.get('name')}): args not "
                            f"an object")
    try:
        json.dumps(obj)
    except (TypeError, ValueError) as e:
        problems.append(f"trace not JSON-serializable: {e}")
    return problems


# the process-global tracer
TRACER = Tracer()
