"""Measured calibration of the static cost model — the port of
``paddle_tpu/observability/calibration.py`` (stdlib only).

Per-(op type, chip, dtype) AFFINE corrections learned from attribution
tables: ``measured ~= factor * predicted + overhead`` fitted by least
squares over that op type's individual op samples (ops of different
sizes within one attribution run give the fit its spread).  The
intercept charges each op a constant floor — per-op dispatch and launch
overhead, which a pure ratio cannot express.  With fewer than three
samples, or no size spread, the fit degrades to the ratio
(``overhead_s = 0``).  Blending across runs stays weight-proportional
per key.  ``cost.program_cost`` prices each op as ``factor * t_op +
overhead`` into ``calibrated_step_time_s`` (the raw model is ALWAYS
reported alongside), and ``autotune/prior.py`` prefers the calibrated
time when ranking.

Persistence, as the autotune winner store:

  * **sealed** — magic prefix + sha256 content digest around the JSON
    payload, so truncation or bit rot reads as corrupt;
  * **atomic** — same-directory temp file (a suffix no reader globs)
    published via ``os.replace``;
  * **evict-on-read** — corrupt, unsealed or schema-mismatched entries
    are deleted and read as empty.

One file per chip (``h100-sxm``, ``cpu-host``: the chip is the key, so
factors measured on the card never price the CPU path, nor the
reverse), named ``<chip>.calib`` under ``$PADDLE_TPU_CALIBRATION_CACHE``,
by default the package's own ``_cache/calibration`` directory.
``PADDLE_TPU_CALIBRATION=0`` disables consumption everywhere; the store
itself stays writable.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

_SEAL_MAGIC = b"pdtpu-cal1\x00"
_SEAL_LEN = len(_SEAL_MAGIC) + 32
_ENTRY_SUFFIX = ".calib"
SCHEMA = "paddle_tpu.calibration.v1"

# factors outside this band are clamped: wide enough to express cpu-host
# dispatch overhead on microscopic ops (10^3-ish) without letting one
# broken measurement send a candidate's price to infinity/zero
FACTOR_MIN = 2.0 ** -10
FACTOR_MAX = 2.0 ** 12

_ENV_GATE = "PADDLE_TPU_CALIBRATION"

# the package's own directory: nothing outside the checkout is written
_DEFAULT_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_cache",
    "calibration")


def calibration_enabled() -> bool:
    """Consumption gate: PADDLE_TPU_CALIBRATION=0 turns the calibrated
    layer off everywhere (raw roofline only)."""
    return os.environ.get(_ENV_GATE, "1") not in ("", "0", "false")


def seal_entry(payload: bytes) -> bytes:
    return _SEAL_MAGIC + hashlib.sha256(payload).digest() + payload


def unseal_entry(raw: Optional[bytes]) -> Optional[bytes]:
    if raw is None or len(raw) < _SEAL_LEN \
            or not raw.startswith(_SEAL_MAGIC):
        return None
    body = raw[_SEAL_LEN:]
    if hashlib.sha256(body).digest() != raw[len(_SEAL_MAGIC):_SEAL_LEN]:
        return None
    return body


def factor_key(op_type: str, dtype: str) -> str:
    return f"{op_type}|{dtype or 'float32'}"


def clamp(f: float) -> float:
    return min(max(float(f), FACTOR_MIN), FACTOR_MAX)


def _fit_affine(samples) -> tuple:
    """(factor, overhead_s) for one key's (predicted_s, measured_s)
    samples: least-squares slope/intercept when the samples can support
    it (>=3 points, predicted-time spread, positive slope), else the
    total-ratio with zero overhead.  The intercept is the per-op
    dispatch floor a pure ratio cannot express (module docstring)."""
    sp = sum(p for p, _ in samples)
    sm = sum(m for _, m in samples)
    ratio = clamp(sm / sp) if sp > 0 else 1.0
    n = len(samples)
    if n < 3:
        return ratio, 0.0
    mp, mm = sp / n, sm / n
    var = sum((p - mp) ** 2 for p, _ in samples)
    if var <= 0.0 or mp <= 0.0 or var < (1e-6 * mp) ** 2:
        return ratio, 0.0  # no size spread: slope is unidentifiable
    cov = sum((p - mp) * (m - mm) for p, m in samples)
    slope = cov / var
    if slope <= 0.0:
        return ratio, 0.0  # pathological data: stay with the ratio
    f = clamp(slope)
    return f, max(0.0, mm - f * mp)


def _count(result: str):
    from .metrics import REGISTRY

    REGISTRY.counter(
        "calibration_store_total",
        "calibration-store reads by outcome").inc(result=result)


class CalibrationStore:
    """File-backed factor store with an in-memory read cache (lookup is
    free after the first hit per chip; ``update`` writes through it)."""

    def __init__(self, root: Optional[str] = None):
        self.root = os.path.abspath(
            root
            or os.environ.get("PADDLE_TPU_CALIBRATION_CACHE")
            or _DEFAULT_ROOT)
        self._lock = threading.Lock()
        self._mem: Dict[str, Optional[dict]] = {}

    def _path(self, chip: str) -> str:
        return os.path.join(self.root, chip + _ENTRY_SUFFIX)

    # -- reads ----------------------------------------------------------
    def entry(self, chip: str) -> Optional[dict]:
        """The chip's full entry dict, or None.  Corrupt/unsealed/
        schema-mismatched files are EVICTED and read as a miss."""
        with self._lock:
            if chip in self._mem:
                return self._mem[chip]
        path = self._path(chip)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            _count("miss")
            with self._lock:
                self._mem[chip] = None
            return None
        body = unseal_entry(raw)
        entry = None
        if body is not None:
            try:
                entry = json.loads(body)
            except ValueError:
                entry = None
        if not isinstance(entry, dict) or entry.get("schema") != SCHEMA \
                or not isinstance(entry.get("factors"), dict):
            entry = None
        if entry is None:
            try:
                os.remove(path)
            except OSError:
                pass
            _count("evicted_corrupt")
            with self._lock:
                self._mem[chip] = None
            return None
        _count("hit")
        with self._lock:
            self._mem[chip] = entry
        return entry

    def factors(self, chip: str) -> Dict[str, dict]:
        """{op_type|dtype: {"factor", "weight", ...}} — empty when the
        chip has no (valid) entry."""
        entry = self.entry(chip)
        return dict(entry["factors"]) if entry else {}

    def factor(self, chip: str, op_type: str, dtype: str,
               default: float = 1.0) -> float:
        e = self.factors(chip).get(factor_key(op_type, dtype))
        return float(e["factor"]) if e else default

    # -- writes ---------------------------------------------------------
    def update(self, chip: str, observations: List[dict]) -> dict:
        """Blend observations into the chip's entry and atomically
        republish it.  Each observation:
        ``{"op_type", "dtype", "measured_s", "predicted_s", "count"}``
        (count defaults to 1) and is ONE fit sample.  Per key: a
        least-squares affine fit ``measured = factor * predicted +
        overhead_s`` when >=3 samples with predicted-time spread exist
        (per-op attribution rows give that); otherwise the ratio with
        zero overhead.  Both parameters blend with the stored entry by
        observation weight; the factor is clamped to
        [FACTOR_MIN, FACTOR_MAX] and the overhead floored at zero."""
        factors = self.factors(chip)
        agg: Dict[str, dict] = {}
        for ob in observations:
            pred = float(ob.get("predicted_s") or 0.0)
            meas = float(ob.get("measured_s") or 0.0)
            if pred <= 0.0 or meas <= 0.0:
                continue
            k = factor_key(str(ob["op_type"]), str(ob.get("dtype")
                                                   or "float32"))
            a = agg.setdefault(k, {"measured_s": 0.0, "predicted_s": 0.0,
                                   "weight": 0.0, "samples": []})
            a["measured_s"] += meas
            a["predicted_s"] += pred
            a["weight"] += float(ob.get("count", 1))
            a["samples"].append((pred, meas))
        for k, a in agg.items():
            new_f, new_c = _fit_affine(a["samples"])
            old = factors.get(k)
            if old:
                w_old = float(old.get("weight", 1.0))
                w_new = a["weight"]
                f = clamp((w_old * float(old["factor"]) + w_new * new_f)
                          / (w_old + w_new))
                c = max(0.0, (w_old * float(old.get("overhead_s") or 0.0)
                              + w_new * new_c) / (w_old + w_new))
                weight = w_old + w_new
            else:
                f, c, weight = new_f, new_c, a["weight"]
            factors[k] = {"factor": f, "overhead_s": c, "weight": weight,
                          "measured_s": a["measured_s"],
                          "predicted_s": a["predicted_s"]}
        entry = {"schema": SCHEMA, "chip": chip, "factors": factors,
                 "updated_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                              time.gmtime())}
        payload = json.dumps(entry, sort_keys=True).encode()
        os.makedirs(self.root, exist_ok=True)
        path = self._path(chip)
        # the temp name never carries the entry suffix: a killed
        # writer's debris stays invisible to readers
        tmp = path + f".tmp-{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                f.write(seal_entry(payload))
            os.replace(tmp, path)
        finally:
            try:
                os.remove(tmp)
            except OSError:
                pass
        from .metrics import REGISTRY

        REGISTRY.counter(
            "calibration_store_puts_total",
            "calibration entries written").inc(chip=chip)
        with self._lock:
            self._mem[chip] = entry
        return entry

    def record_attribution(self, table: dict) -> Optional[dict]:
        """Learn factors from one attribution table (attribution.py's
        ``build_table`` output); returns the updated entry or None when
        the table carries nothing usable."""
        # per-OP rows, not the by_type roll-up: the affine fit needs
        # ops of different sizes as separate samples
        obs = [{"op_type": r["op_type"],
                "dtype": r.get("dtype") or "float32",
                "measured_s": r["measured_s"],
                "predicted_s": r["pred_time_s"]}
               for r in (table.get("rows") or [])]
        obs = [o for o in obs
               if o["measured_s"] > 0 and o["predicted_s"] > 0]
        if not obs:
            return None
        return self.update(table["chip"], obs)

    def forget(self):
        with self._lock:
            self._mem.clear()


_default: Dict[str, CalibrationStore] = {}
_default_lock = threading.Lock()


def default_store() -> CalibrationStore:
    """Process-wide store for the root the environment currently names
    (keyed per root)."""
    root = os.environ.get("PADDLE_TPU_CALIBRATION_CACHE") or _DEFAULT_ROOT
    root = os.path.abspath(root)
    with _default_lock:
        s = _default.get(root)
        if s is None:
            s = CalibrationStore(root)
            _default[root] = s
        return s
