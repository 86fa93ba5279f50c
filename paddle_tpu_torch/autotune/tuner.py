"""The search loop: space -> prior -> top-k trials -> persisted winner —
the port of ``paddle_tpu/autotune/tuner.py``.

One call to :func:`tune`:

  1. winner-store lookup first — a prior tune of the same (site, device,
     backend) returns its winner with NO re-measurement;
  2. enumerate the workload's typed space, price every candidate with
     the static analyzers (prior.py) and drop what cannot run;
  3. measure the predicted-top-k (plus the default configuration,
     always — the winner is only a winner against the measured
     baseline), each under trial overrides + tracer spans.  A trial that
     raises fails the tune: nothing is swallowed;
  4. pick the measured best, persist it (program entry + desc-only
     entry + per-kernel-site entries so the knobs pick it up), and
     report the prior's rank error.
"""

from __future__ import annotations

from typing import List, Optional

from ..observability.metrics import REGISTRY
from ..observability.tracing import TRACER
from . import knobs, prior as _prior
from . import measure as _measure
from . import store as _store


def tune(workload, measurer=None, top_k: int = 5,
         chip: Optional[str] = None, store=None, force: bool = False,
         measure_all: bool = False, hbm_bytes: Optional[int] = None
         ) -> dict:
    """Tune one workload; returns the report dict (see bottom).

    `measure_all` measures EVERY feasible candidate instead of top-k —
    the sweep tool uses it so rank error is judged against the true
    measured winner, not the prior's own shortlist."""
    st = store if store is not None else _store.default_store()
    measurer = measurer or _measure.TimedMeasurer()
    # init=True: the platform tag is the winner's identity — recording
    # before CUDA is up would key the entry ("unknown", "none") and every
    # later lookup would miss
    device_kind, backend = knobs.platform(init=True)
    site = workload.site()

    if not force:
        entry = st.lookup("program", site, device_kind, backend)
        if entry is not None:
            REGISTRY.counter(
                "autotune_trials_total",
                "autotune candidates by workload and outcome").inc(
                workload=workload.name, outcome="cache_hit")
            return {"workload": workload.name, "cache_hit": True,
                    "winner": entry["winner"], "entry": entry,
                    "site": site}

    space = workload.space()
    candidates = space.candidates()
    default = space.default()
    with TRACER.span("autotune.rank", workload=workload.name,
                     candidates=len(candidates)):
        feasible, rejected = _prior.rank(workload, candidates,
                                         chip=chip, hbm_bytes=hbm_bytes)
    if not feasible:
        raise RuntimeError(
            f"autotune {workload.name}: every candidate rejected "
            f"({[p.reject_reason for p in rejected[:3]]}...)")

    selected: List[_prior.PricedCandidate] = (
        list(feasible) if measure_all else feasible[:max(1, top_k)])
    if not any(p.candidate.digest == default.digest for p in selected):
        # the baseline is measured even when the prior dislikes it —
        # "winner >= default" must be a measured claim, never inferred
        base = next((p for p in feasible
                     if p.candidate.digest == default.digest), None)
        if base is not None:
            selected.append(base)

    rows = []
    for p in selected:
        res = measurer.measure(workload, p.candidate)
        rows.append({**p.row(), **res})

    winner_row = min(rows, key=lambda r: r["best_s"])
    default_row = next((r for r in rows
                        if r["digest"] == default.digest), None)

    # prior exam: where did the measured winner sit in predicted order?
    predicted_order = [p.candidate.digest for p in feasible]
    rank_of_winner = predicted_order.index(winner_row["digest"]) + 1
    in_top_k = rank_of_winner <= max(1, top_k)
    REGISTRY.gauge(
        "autotune_rank_error",
        "1-based predicted rank of the measured winner "
        "(1 = the prior nailed it)").set(rank_of_winner,
                                         workload=workload.name)

    meta = {
        "workload": workload.name,
        "measured_s": winner_row["best_s"],
        "measured_median_s": winner_row["median_s"],
        "predicted_s": winner_row["predicted_step_s"],
        "baseline_s": default_row["best_s"] if default_row else None,
        "baseline_median_s": (default_row["median_s"]
                              if default_row else None),
        "rank_of_winner": rank_of_winner,
        "top_k": int(top_k),
        "trials": len(rows),
        "rejected": len(rejected),
    }
    entry = st.record("program", site, device_kind, backend,
                      winner=winner_row["params"], **meta)
    # desc-only twin: a lookup without a feed signature keys on it
    desc_site = {k: v for k, v in site.items() if k != "feed_sig"}
    if desc_site != site:
        st.record("program_desc", desc_site, device_kind, backend,
                  winner=winner_row["params"], **meta)
    # kernel-site entries: what the knobs resolve on the next run
    for ns, ksite, fields in workload.kernel_sites():
        kwin = {field: winner_row["params"][knob]
                for field, knob in fields.items()
                if knob in winner_row["params"]}
        if kwin:
            st.record(ns, ksite, device_kind, backend, winner=kwin,
                      workload=workload.name,
                      measured_s=winner_row["best_s"])
    # drop the executor pickup's per-program memos: a program that
    # already ran in this process (and memoized a store miss) must see
    # the winner just recorded on its next run
    from . import integration

    integration.reset()

    return {
        "workload": workload.name,
        "cache_hit": False,
        "site": site,
        "chip": chip,
        "space_size": space.size,
        "n_feasible": len(feasible),
        "n_rejected": len(rejected),
        "rejected": [p.row() for p in rejected],
        "trials": rows,
        "winner": winner_row["params"],
        "winner_row": winner_row,
        "default_row": default_row,
        "rank_of_winner": rank_of_winner,
        "in_top_k": in_top_k,
        "entry": entry,
    }
