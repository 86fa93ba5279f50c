"""Metrics registry: counters / gauges / histograms with labels — the
port's own copy of ``paddle_tpu/observability/metrics.py`` (stdlib only,
so the text and snapshots it renders are the JAX package's byte for
byte).

Design points:

  * **near-zero cost when disabled** — every record path starts with one
    attribute check; ``enabled=False`` returns before any allocation;
  * **labels with a cardinality guard** — a family holds at most
    ``max_series`` distinct label sets; overflow observations are dropped
    into ``telemetry_series_dropped_total`` (warn once per family)
    instead of growing without bound under a label-per-request bug;
  * **two exports** — Prometheus text exposition (``render_prometheus``)
    and a JSON snapshot (``snapshot``), both pure functions of registry
    state;
  * **namespace ownership** — ``artifact_metric`` is the single
    constructor for bench-artifact rows; it enforces the naming grammar
    and the ``serve_v2``/``_solo`` ownership rule.

Free of package-relative imports, so a tool can load it from its file
path.
"""

from __future__ import annotations

import json
import re
import threading
import time
import warnings
from typing import Dict, List, Optional, Tuple

# the one monotonic timing clock of the package, so every timing site
# is findable (and swappable) here
monotime = time.perf_counter

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")
_LABEL_VALUE_MAX = 128  # a label value is an identifier, not a payload


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)[:_LABEL_VALUE_MAX])
                        for k, v in labels.items()))


class _Family:
    """One named metric family: a map from label set -> series state."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str):
        self.registry = registry
        self.name = name
        self.help = help
        self.series: Dict[tuple, object] = {}
        self._warned_cardinality = False

    def _series(self, labels: Dict[str, str]):
        key = _label_key(labels) if labels else ()
        s = self.series.get(key)
        if s is None:
            if len(self.series) >= self.registry.max_series:
                self.registry._drop_series(self)
                return None
            s = self._new_series()
            self.series[key] = s
        return s

    def _new_series(self):
        raise NotImplementedError

    def clear(self):
        with self.registry._lock:
            self.series.clear()


class Counter(_Family):
    kind = "counter"

    def _new_series(self):
        return [0.0]

    def inc(self, n: float = 1, **labels):
        reg = self.registry
        if not reg.enabled:
            return
        with reg._lock:
            s = self._series(labels)
            if s is not None:
                s[0] += n

    def value(self, **labels) -> float:
        key = _label_key(labels) if labels else ()
        s = self.series.get(key)
        return float(s[0]) if s is not None else 0.0


class Gauge(_Family):
    kind = "gauge"

    def _new_series(self):
        return [0.0]

    def set(self, v: float, **labels):
        reg = self.registry
        if not reg.enabled:
            return
        with reg._lock:
            s = self._series(labels)
            if s is not None:
                s[0] = float(v)

    def inc(self, n: float = 1, **labels):
        reg = self.registry
        if not reg.enabled:
            return
        with reg._lock:
            s = self._series(labels)
            if s is not None:
                s[0] += n

    def value(self, **labels) -> float:
        key = _label_key(labels) if labels else ()
        s = self.series.get(key)
        return float(s[0]) if s is not None else 0.0


# histogram default buckets: seconds-scale latencies from 10us to ~2min
DEFAULT_BUCKETS = (1e-5, 1e-4, 1e-3, 1e-2, 0.1, 0.5, 1.0, 5.0, 30.0,
                   120.0)


class _HistSeries:
    __slots__ = ("count", "sum", "min", "max", "buckets")

    def __init__(self, n_buckets: int):
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = 0.0
        self.buckets = [0] * (n_buckets + 1)  # +inf tail


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, registry, name, help,
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(registry, name, help)
        self.bounds = tuple(sorted(buckets))

    def _new_series(self):
        return _HistSeries(len(self.bounds))

    def observe(self, v: float, **labels):
        reg = self.registry
        if not reg.enabled:
            return
        v = float(v)
        with reg._lock:
            s = self._series(labels)
            if s is None:
                return
            s.count += 1
            s.sum += v
            if v < s.min:
                s.min = v
            if v > s.max:
                s.max = v
            for i, b in enumerate(self.bounds):
                if v <= b:
                    s.buckets[i] += 1
                    return
            s.buckets[-1] += 1

    def stats(self, **labels) -> Optional[dict]:
        key = _label_key(labels) if labels else ()
        s = self.series.get(key)
        if s is None:
            return None
        return {"count": s.count, "sum": s.sum,
                "min": s.min if s.count else 0.0, "max": s.max,
                "avg": s.sum / s.count if s.count else 0.0}

    def series_stats(self) -> List[Tuple[Dict[str, str], dict]]:
        """(labels, stats) for every series, snapshotted under the
        registry lock — the public readback consumers (profiler.py's
        legacy report) use instead of iterating internals."""
        with self.registry._lock:
            items = [(dict(key), s.count, s.sum, s.min, s.max)
                     for key, s in self.series.items()]
        return [(labels,
                 {"count": n, "sum": tot,
                  "min": mn if n else 0.0, "max": mx,
                  "avg": tot / n if n else 0.0})
                for labels, n, tot, mn, mx in items]


class _Timed:
    """Context manager: observe the elapsed seconds into a histogram."""

    __slots__ = ("_hist", "_labels", "_t0")

    def __init__(self, hist: Histogram, labels: Dict[str, str]):
        self._hist = hist
        self._labels = labels

    def __enter__(self):
        self._t0 = monotime()
        return self

    def __exit__(self, *exc):
        self._hist.observe(monotime() - self._t0, **self._labels)
        return False


class MetricsRegistry:
    """Thread-safe named-family registry.  One process-global instance
    (``REGISTRY``) backs the framework; tests may build private ones."""

    def __init__(self, enabled: Optional[bool] = None,
                 max_series: int = 256):
        import os

        if enabled is None:
            enabled = os.environ.get("PADDLE_TPU_TELEMETRY", "1") != "0"
        self.enabled = bool(enabled)
        self.max_series = int(max_series)
        self._lock = threading.RLock()
        self._families: Dict[str, _Family] = {}
        self._dropped: Dict[str, int] = {}

    # -- family constructors (get-or-create, type-checked) --------------
    def _family(self, cls, name: str, help: str, **kw) -> _Family:
        if not _NAME_RE.match(name):
            raise ValueError(f"metric name {name!r}: must match "
                             f"{_NAME_RE.pattern}")
        with self._lock:
            f = self._families.get(name)
            if f is None:
                f = cls(self, name, help, **kw)
                self._families[name] = f
            elif not isinstance(f, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{f.kind}, not {cls.kind}")
            return f

    def counter(self, name: str, help: str = "") -> Counter:
        return self._family(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._family(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._family(Histogram, name, help, buckets=buckets)

    def timed(self, name: str, help: str = "", **labels) -> _Timed:
        return _Timed(self.histogram(name, help), labels)

    # -- cardinality guard ----------------------------------------------
    def _drop_series(self, family: _Family):
        """Called under the lock when a family is at max_series."""
        self._dropped[family.name] = self._dropped.get(family.name, 0) + 1
        if not family._warned_cardinality:
            family._warned_cardinality = True
            warnings.warn(
                f"metric family {family.name!r} hit the cardinality "
                f"guard ({self.max_series} series); further label sets "
                f"are dropped (telemetry_series_dropped_total)")

    # -- export -----------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able registry state (the /metrics.json body and the bench
        artifact attachment)."""
        with self._lock:
            fams = {}
            for name, f in sorted(self._families.items()):
                series = []
                for key, s in sorted(f.series.items()):
                    labels = dict(key)
                    if isinstance(s, _HistSeries):
                        series.append({
                            "labels": labels, "count": s.count,
                            "sum": s.sum,
                            "min": s.min if s.count else 0.0,
                            "max": s.max,
                            # "+Inf" is the canonical Prometheus
                            # spelling — promtool/OpenMetrics reject
                            # lowercase "+inf"
                            "buckets": dict(zip(
                                [str(b) for b in f.bounds] + ["+Inf"],
                                s.buckets))})
                    else:
                        series.append({"labels": labels,
                                       "value": float(s[0])})
                fams[name] = {"type": f.kind, "help": f.help,
                              "series": series}
            if self._dropped:
                fams["telemetry_series_dropped_total"] = {
                    "type": "counter",
                    "help": "series dropped by the cardinality guard",
                    "series": [{"labels": {"family": k},
                                "value": float(v)}
                               for k, v in sorted(self._dropped.items())]}
            return {"schema": "paddle_tpu.metrics.v1", "families": fams}

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (the /metrics body)."""

        def esc(v: str) -> str:
            return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
                    .replace('"', '\\"'))

        def lset(labels: Dict[str, str], extra=()) -> str:
            items = [f'{k}="{esc(v)}"' for k, v in
                     list(labels.items()) + list(extra)]
            return "{" + ",".join(items) + "}" if items else ""

        out: List[str] = []
        snap = self.snapshot()["families"]
        for name, fam in snap.items():
            if fam["help"]:
                out.append(f"# HELP {name} {esc(fam['help'])}")
            out.append(f"# TYPE {name} {fam['type']}")
            for s in fam["series"]:
                if fam["type"] == "histogram":
                    acc = 0
                    for b, n in s["buckets"].items():
                        acc += n
                        out.append(f"{name}_bucket"
                                   f"{lset(s['labels'], [('le', b)])}"
                                   f" {acc}")
                    out.append(f"{name}_sum{lset(s['labels'])} "
                               f"{s['sum']}")
                    out.append(f"{name}_count{lset(s['labels'])} "
                               f"{s['count']}")
                else:
                    out.append(f"{name}{lset(s['labels'])} "
                               f"{s['value']}")
        return "\n".join(out) + "\n"

    def reset(self):
        """Clear every series (test isolation; fluid.reset()).  Family
        OBJECTS survive so cached handles (MirroredCounters, module-level
        families) keep recording into the live registry afterwards."""
        with self._lock:
            for f in self._families.values():
                f.series.clear()
            self._dropped.clear()

    def enable(self):
        self.enabled = True

    def disable(self):
        self.enabled = False


def validate_snapshot(obj) -> List[str]:
    """Schema check for a snapshot() body; returns problem strings."""
    problems = []
    if not isinstance(obj, dict) or obj.get("schema") != \
            "paddle_tpu.metrics.v1":
        return ["missing/unknown snapshot schema tag"]
    fams = obj.get("families")
    if not isinstance(fams, dict):
        return ["families is not a dict"]
    for name, fam in fams.items():
        if not _NAME_RE.match(name):
            problems.append(f"bad family name {name!r}")
        if fam.get("type") not in ("counter", "gauge", "histogram"):
            problems.append(f"{name}: bad type {fam.get('type')!r}")
        for s in fam.get("series", []):
            if not isinstance(s.get("labels"), dict):
                problems.append(f"{name}: series without labels dict")
            if fam.get("type") == "histogram":
                if "count" not in s or "buckets" not in s:
                    problems.append(f"{name}: histogram series missing "
                                    f"count/buckets")
            elif "value" not in s:
                problems.append(f"{name}: series missing value")
    try:
        json.dumps(obj)
    except (TypeError, ValueError) as e:
        problems.append(f"snapshot not JSON-serializable: {e}")
    return problems


# ---------------------------------------------------------------------------
# the process-global registry

REGISTRY = MetricsRegistry()


class MirroredCounters(dict):
    """A plain-dict counter map whose writes also land in the registry.

    ``ServingEngine.counters``: callers keep the dict API (``c["k"] +=
    1``, iteration, reset-to-zero), while every write is mirrored into a
    registry gauge family so the shared snapshot sees the serving
    counters.  After ``REGISTRY.reset()`` the mirror
    re-seeds key by key on the NEXT write — hot keys reappear within a
    step; holders are expected to be rebuilt after ``fluid.reset()``
    anyway (write every key each cycle, not only on improvement, if a
    key must never go missing)."""

    def __init__(self, base: Dict[str, float], family: str,
                 registry: Optional[MetricsRegistry] = None, **labels):
        self._registry = registry if registry is not None else REGISTRY
        # the family handle is cached so the per-write cost is one
        # enabled-check inside Gauge.set, not a registry lookup
        self._gauge = self._registry.gauge(family)
        self._labels = {k: str(v) for k, v in labels.items()}
        super().__init__()
        for k, v in base.items():
            self[k] = v  # through __setitem__: seed the mirror too

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self._gauge.set(value, counter=key, **self._labels)

    def update(self, *args, **kw):  # route through the mirror
        for k, v in dict(*args, **kw).items():
            self[k] = v

    def setdefault(self, key, default=0):
        if key not in self:
            self[key] = default
        return self[key]

    # destructive ops would leave the registry mirror frozen at stale
    # values with no error anywhere — counter maps are fixed-key, so
    # fail loudly instead of desyncing silently (reset by assigning 0)
    def _no_removal(self, *a, **kw):
        raise TypeError(
            "MirroredCounters keys are fixed (registry-mirrored): "
            "reset by assigning 0, never by removing keys")

    clear = pop = popitem = __delitem__ = _no_removal


# ---------------------------------------------------------------------------
# artifact-metric namespace ownership (the names the benches mint)

# grammar: snake_case with optional config probes (_bs64, _seq1024 ...)
_ARTIFACT_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*[a-z0-9]$")
# ownership rule: the plain serve_v2_decode_* series belongs to the
# ab comparison artifact (real vs_baseline + token-identity fields);
# standalone v2 runs must use the serve_v2_solo_* series; plain serve_*
# (no scheduler tag) is the longitudinal fifo capture.
_SERVE_V2_HEADLINE = re.compile(r"^serve_v2_(?!solo_)")


def artifact_metric(metric: str, value, unit: str,
                    ab_artifact: bool = False, **fields) -> dict:
    """Construct one bench-schema artifact row, validating the metric
    name against the owned namespace.  The single place such names are
    minted."""
    if not _ARTIFACT_NAME_RE.match(metric):
        raise ValueError(f"artifact metric {metric!r} violates the "
                         f"namespace grammar {_ARTIFACT_NAME_RE.pattern}")
    if _SERVE_V2_HEADLINE.match(metric) and not ab_artifact:
        raise ValueError(
            f"artifact metric {metric!r}: the serve_v2_* series is "
            f"owned by the A/B comparison artifact; a standalone v2 "
            f"run must emit serve_v2_solo_* (ownership rule)")
    row = {"metric": metric, "value": value, "unit": unit}
    row.update(fields)
    return row
