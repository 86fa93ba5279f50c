"""Transparent winner pickup for the executor — the port of
``paddle_tpu/autotune/integration.py``.

``Executor.run`` calls :func:`maybe_apply_program_winner` for block 0.
When the winner store holds an entry for this exact (program digest,
feed signature, device kind, backend) — a previous ``tune`` of this
program on this hardware — the winner's program-level decisions are
re-applied: the desc-level blanket remat marking (attrs-only, the same
``memory_optimize(level=1)`` the winning trial was measured with).
Kernel-level winners (bn-conv variant and O block, page size,
speculation depth) need nothing here: the knobs resolve them from the
store when they are read.

Cost discipline (this sits on Executor.run):

  * disabled entirely by ``PADDLE_TPU_AUTOTUNE=0``;
  * memoized per (program cache token, version) — one lookup per
    program, not per step;
  * the store's ``has_entries`` gate short-circuits before any digest
    is computed, so a machine that never tuned pays one ``scandir``;
  * stands down inside an active measurement trial
    (``knobs.in_trial``) — a stored winner must never contaminate the
    A/B that might replace it.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from . import knobs
from . import store as _store

_applied: Dict[tuple, Optional[dict]] = {}
_digests: Dict[tuple, str] = {}


def enabled() -> bool:
    return os.environ.get("PADDLE_TPU_AUTOTUNE", "1") != "0"


def program_site(program, feeds) -> dict:
    """The store site for a program + its feeds: desc digest + feed
    signature.  The one site mint — workloads.ProgramWorkload.site()
    and the executor hook both call this, so tune-time keys and
    run-time lookups cannot drift."""
    pkey = (program._cache_token, program._version)
    digest = _digests.get(pkey)
    if digest is None:
        digest = _store.digest_bytes(program.to_json().encode())
        if len(_digests) > 4096:
            _digests.clear()
        _digests[pkey] = digest
    # a torch dtype prints "torch.int64": the site keys numpy's spelling,
    # so a numpy feed and the same feed staged on the card agree
    sig = sorted(
        (str(n), [int(d) for d in getattr(v, "shape", ())],
         str(getattr(v, "dtype", "")).replace("torch.", ""))
        for n, v in feeds.items())
    return {"program_digest": digest,
            "feed_sig": [list(s) for s in sig]}


def _mark_remat(program) -> int:
    """Blanket remat marks on the top block (attrs-only — exactly the
    level=1 pass the winning trial measured); returns #newly marked."""
    n = 0
    for op in program.global_block().ops:
        if op.type == "generic_grad" and not op.attrs.get("__remat__"):
            op.attrs["__remat__"] = True
            n += 1
    if n:
        program._bump()
    return n


def maybe_apply_program_winner(program, feeds) -> Optional[dict]:
    """Look up + apply the stored winner for `program`; returns the
    winner dict when one applied (or matched with nothing to do)."""
    if not enabled() or knobs.in_trial():
        return None
    key = (program._cache_token, program._version)
    if key in _applied:
        return _applied[key]
    st = _store.default_store()
    if not st.has_entries():
        if len(_applied) > 4096:
            _applied.clear()
        _applied[key] = None
        return None
    device_kind, backend = knobs.platform()
    if backend == "none":
        # CUDA not initialized yet (a first run before any device
        # touch): the lookup would be keyed wrong — skip WITHOUT
        # memoizing so the next run retries
        return None
    entry = st.lookup("program", program_site(program, feeds),
                      device_kind, backend)
    if entry is None and not feeds:
        # no feed signature: the desc-only twin
        entry = st.lookup("program_desc",
                          {"program_digest":
                           program_site(program, feeds)["program_digest"]},
                          device_kind, backend)
    winner = entry.get("winner") if entry else None
    applied = None
    if isinstance(winner, dict):
        applied = dict(winner)
        if winner.get("remat"):
            _mark_remat(program)
        from ..observability.metrics import REGISTRY

        REGISTRY.counter(
            "autotune_winner_applied_total",
            "programs that picked up a stored autotune winner").inc(
            workload=str(entry.get("workload", "")))
    if len(_applied) > 4096:
        _applied.clear()
    _applied[key] = applied
    # the remat bump moved the version: memoize the new key too so the
    # next run doesn't re-digest (and re-mark a no-op)
    _applied[(program._cache_token, program._version)] = applied
    return applied


def reset():
    """Forget memoized applications/digests (tests)."""
    _applied.clear()
    _digests.clear()
