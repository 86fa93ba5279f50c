"""Persistent autotune winner store — the port of
``paddle_tpu/autotune/store.py`` (stdlib only).

Winners are keyed by a content digest of what was tuned (the program
desc JSON for program-level winners, the kernel site signature — shapes
and dtype — for kernel-level ones) combined with the device kind and the
backend, so a winner measured on the card never configures the CPU path,
nor the reverse.

Entries are:

  * **sealed** — a version-stamped magic prefix + sha256 content digest
    wraps the JSON payload, so truncation or bit rot reads as corrupt,
    not as a half-parsed winner;
  * **atomic** — writes land in a same-directory temp file (a suffix no
    reader globs) and publish via ``os.replace``;
  * **evict-on-read** — a corrupt or unsealed entry is deleted and
    reported as a miss, so a poisoned winner can never wedge tuning (the
    next ``tune`` simply re-measures).

The platform tag is supplied by callers (``knobs.platform()``).

Layout: one file per entry under ``$PADDLE_TPU_AUTOTUNE_CACHE``, by
default the package's own ``_cache/autotune`` directory, named
``<sha256(key)>.winner``.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Dict, Optional

_SEAL_MAGIC = b"pdtpu-at1\x00"
_SEAL_LEN = len(_SEAL_MAGIC) + 32
_ENTRY_SUFFIX = ".winner"
SCHEMA = "paddle_tpu.autotune.v1"

# the package's own directory: nothing outside the checkout is written
_DEFAULT_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_cache",
    "autotune")


def seal_entry(payload: bytes) -> bytes:
    return _SEAL_MAGIC + hashlib.sha256(payload).digest() + payload


def unseal_entry(raw: Optional[bytes]) -> Optional[bytes]:
    """Payload bytes if `raw` is sealed with a valid digest, else None."""
    if raw is None or len(raw) < _SEAL_LEN \
            or not raw.startswith(_SEAL_MAGIC):
        return None
    body = raw[_SEAL_LEN:]
    if hashlib.sha256(body).digest() != raw[len(_SEAL_MAGIC):_SEAL_LEN]:
        return None
    return body


def store_key(kind: str, site: Dict[str, object], device_kind: str,
              backend: str) -> str:
    """Deterministic entry key: kind + canonical-JSON site + platform.
    `site` carries whatever identifies the tuned thing — a program
    digest + feed signature, or a kernel's shape/dtype signature."""
    blob = json.dumps({"kind": kind, "site": site,
                       "device_kind": device_kind, "backend": backend},
                      sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def digest_bytes(data: bytes) -> str:
    """Content digest helper for program descs / site blobs."""
    return hashlib.sha256(data).hexdigest()


def _count(result: str):
    from ..observability.metrics import REGISTRY

    REGISTRY.counter(
        "autotune_store_total",
        "winner-store reads by outcome").inc(result=result)


class WinnerStore:
    """File-backed winner cache with an in-memory read cache.

    The read cache makes kernel-knob resolution free after the first
    hit; ``record`` writes through it so an in-process tune is
    immediately visible to later runs."""

    def __init__(self, root: Optional[str] = None):
        self.root = os.path.abspath(
            root
            or os.environ.get("PADDLE_TPU_AUTOTUNE_CACHE")
            or _DEFAULT_ROOT)
        self._lock = threading.Lock()
        self._mem: Dict[str, Optional[dict]] = {}

    # -- plumbing -------------------------------------------------------
    def _path(self, key: str) -> str:
        return os.path.join(self.root, key + _ENTRY_SUFFIX)

    def has_entries(self) -> bool:
        """Cheap is-there-anything-at-all gate for hot-path callers
        (Executor.run): an absent/empty store means every lookup would
        miss, so callers skip digesting entirely.  Never cached — the
        store may gain its first entry mid-process (a tune run)."""
        try:
            with os.scandir(self.root) as it:
                return any(e.name.endswith(_ENTRY_SUFFIX) for e in it)
        except OSError:
            return False

    # -- reads ----------------------------------------------------------
    def lookup(self, kind: str, site: Dict[str, object],
               device_kind: str, backend: str) -> Optional[dict]:
        """The stored entry dict (winner + metadata) or None.  Corrupt,
        unsealed, or schema-mismatched entries are EVICTED and read as
        a miss."""
        key = store_key(kind, site, device_kind, backend)
        with self._lock:
            if key in self._mem:
                return self._mem[key]
        path = self._path(key)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            _count("miss")
            with self._lock:
                self._mem[key] = None
            return None
        body = unseal_entry(raw)
        entry = None
        if body is not None:
            try:
                entry = json.loads(body)
            except ValueError:
                entry = None
        if not isinstance(entry, dict) or entry.get("schema") != SCHEMA:
            entry = None
        if entry is None:
            try:
                os.remove(path)
            except OSError:
                pass
            _count("evicted_corrupt")
            with self._lock:
                self._mem[key] = None
            return None
        _count("hit")
        with self._lock:
            self._mem[key] = entry
        return entry

    def winner(self, kind: str, site: Dict[str, object],
               device_kind: str, backend: str) -> Optional[dict]:
        entry = self.lookup(kind, site, device_kind, backend)
        if entry is None:
            return None
        w = entry.get("winner")
        return w if isinstance(w, dict) else None

    # -- writes ----------------------------------------------------------
    def record(self, kind: str, site: Dict[str, object],
               device_kind: str, backend: str, winner: Dict[str, object],
               **meta) -> dict:
        """Atomically publish a winner entry; returns the entry dict."""
        key = store_key(kind, site, device_kind, backend)
        entry = {"schema": SCHEMA, "kind": kind, "site": site,
                 "device_kind": device_kind, "backend": backend,
                 "winner": dict(winner),
                 "created_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                              time.gmtime())}
        entry.update(meta)
        payload = json.dumps(entry, sort_keys=True).encode()
        os.makedirs(self.root, exist_ok=True)
        path = self._path(key)
        # the temp name never carries the entry suffix: a killed
        # writer's debris stays invisible to readers and has_entries
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
        from ..observability.metrics import REGISTRY

        REGISTRY.counter("autotune_store_puts_total",
                         "winner-store entries written").inc(kind=kind)
        with self._lock:
            self._mem[key] = entry
        return entry

    def forget(self):
        """Drop the in-memory read cache (tests, external mutation)."""
        with self._lock:
            self._mem.clear()


_default: Dict[str, WinnerStore] = {}
_default_lock = threading.Lock()


def default_store() -> WinnerStore:
    """Process-wide store for the root the environment currently names.
    Keyed per-root so tests that repoint PADDLE_TPU_AUTOTUNE_CACHE get a
    fresh instance instead of another test's read cache."""
    root = os.environ.get("PADDLE_TPU_AUTOTUNE_CACHE") or _DEFAULT_ROOT
    root = os.path.abspath(root)
    with _default_lock:
        s = _default.get(root)
        if s is None:
            s = WinnerStore(root)
            _default[root] = s
        return s
