"""Cost-model prior: rank candidates BEFORE anything is measured — the
port of ``paddle_tpu/autotune/prior.py``.

The prior is the static analyzers:

  * ``analysis.cost.program_cost`` prices each candidate's program desc
    (remat marks change generic_grad FLOPs 2x -> 3x in the registered
    cost metadata, so the remat axis is priced for free), calibrated
    when the calibration store holds factors for the chip;
  * the workload's ``byte_delta`` adds kernel-parameter effects the op
    registry cannot see;
  * ``analysis.memory.peak_estimate`` + ``fits`` REJECTS candidates
    that will not fit the card's memory, and the workload's ``feasible``
    hook rejects what a hand-written kernel refuses (its shared memory,
    head-dim and tile limits) — so no trial launches a kernel that
    raises;
  * kernel workloads supply ``analytic_cost`` (flops/bytes) and get the
    same roofline treatment.

Only the predicted-top-k go on to be measured.  The tuner's published
rank error is this module's standing exam.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

from ..analysis import cost as _cost


def _resolve_chip(chip: Optional[str]) -> str:
    """Explicit arg > $PADDLE_TPU_CHIP > the detected card
    (``h100-sxm``; ``cpu-host`` without a card)."""
    if chip:
        return chip
    if os.environ.get("PADDLE_TPU_CHIP"):
        return os.environ["PADDLE_TPU_CHIP"]
    return _cost.detect_chip()


class PricedCandidate:
    __slots__ = ("candidate", "predicted_step_s", "predicted_peak_bytes",
                 "feasible", "reject_reason", "bound",
                 "raw_step_s", "calibrated")

    def __init__(self, candidate, predicted_step_s, predicted_peak_bytes,
                 feasible=True, reject_reason="", bound="",
                 raw_step_s=None, calibrated=False):
        self.candidate = candidate
        self.predicted_step_s = predicted_step_s
        self.predicted_peak_bytes = predicted_peak_bytes
        self.feasible = feasible
        self.reject_reason = reject_reason
        self.bound = bound
        # the raw (uncalibrated) roofline price is ALWAYS carried
        # alongside: calibration never hides the raw model
        self.raw_step_s = (predicted_step_s if raw_step_s is None
                           else raw_step_s)
        self.calibrated = calibrated

    def row(self) -> dict:
        return {"params": dict(self.candidate.params),
                "digest": self.candidate.digest,
                "predicted_step_s": self.predicted_step_s,
                "predicted_raw_step_s": self.raw_step_s,
                "calibrated": self.calibrated,
                "predicted_peak_bytes": self.predicted_peak_bytes,
                "feasible": self.feasible,
                "reject_reason": self.reject_reason,
                "bound": self.bound}


def price(workload, candidate, chip: Optional[str] = None,
          hbm_bytes: Optional[int] = None,
          _desc_cache: Optional[Dict] = None) -> PricedCandidate:
    """One candidate's static price + feasibility verdict.

    `_desc_cache` (rank() supplies one) memoizes the program build +
    cost/peak analysis per desc-affecting key (the workload's
    ``desc_key`` hook; by default only the `remat` axis changes the
    desc), so candidates differing in kernel knobs/flags share one
    analysis instead of rebuilding identical programs."""
    from ..analysis import memory as _mem

    spec = _cost.chip_spec(_resolve_chip(chip))
    budget = int(hbm_bytes if hbm_bytes is not None
                 else spec["hbm_gib"] * (1 << 30))

    ok, why = True, ""
    feas = getattr(workload, "feasible", None)
    if feas is not None:
        ok, why = feas(candidate, spec)
    if not ok:
        return PricedCandidate(candidate, float("inf"), 0, False, why)

    desc_key = getattr(workload, "desc_key",
                       lambda c: bool(c.get("remat")))(candidate)
    cached = (_desc_cache or {}).get(desc_key)
    if cached is not None:
        report, peak = cached  # skips the program rebuild entirely
    else:
        analytic = getattr(workload, "analytic_cost", None)
        built = workload.program_for(candidate)
        if built is None:
            if analytic is None:
                raise ValueError(
                    f"workload {workload.name!r} offers neither a "
                    f"program nor an analytic cost")
            c = analytic(candidate, spec)
            rate = spec["flops_bf16"] * _cost.dtype_rate(
                spec, c.get("dtype", "float32"))
            t_compute = c["flops"] / rate
            t_memory = c["bytes"] / (spec["hbm_gbps"] * 1e9)
            comm_fn = getattr(workload, "comm_cost", None)
            if comm_fn is not None:
                # mesh-layout-style workloads: compute/memory tie across
                # candidates, the per-link-class wire time is the ranking
                # signal — fold it through the comm-aware roofline
                folded = _cost.roofline_with_comm(
                    {"compute_time_s": t_compute,
                     "memory_time_s": t_memory},
                    comm_fn(candidate, spec),
                    devices=int(c.get("devices", 1)))
                return PricedCandidate(
                    candidate, folded["predicted_step_time_s"],
                    int(c.get("peak_bytes", c["bytes"])),
                    bound=folded["predicted_bound"])
            # step-loop-style workloads price a per-dispatch host
            # overhead the candidate amortizes (analysis/cost.py
            # DEFAULT_DISPATCH_OVERHEAD_S): additive on top of the
            # roofline max, since the host floor overlaps with neither
            # compute nor memory traffic
            step = (max(t_compute, t_memory)
                    + float(c.get("overhead_s") or 0.0))
            return PricedCandidate(
                candidate, step, int(c.get("peak_bytes", c["bytes"])),
                bound="compute" if t_compute >= t_memory else "memory")

        program, batch_size = built
        report = _cost.program_cost(program, batch_size=batch_size,
                                    chip=spec["chip"])
        peak = _mem.peak_estimate(program, batch_size=batch_size)
        if _desc_cache is not None:
            _desc_cache[desc_key] = (report, peak)
    if not _mem.fits(peak, budget):
        return PricedCandidate(
            candidate, float("inf"), int(peak["total_peak_bytes"]),
            False,
            f"projected HBM peak {peak['total_peak_bytes']} B exceeds "
            f"90% of {budget} B ({spec['chip']})")

    extra = float(getattr(workload, "byte_delta",
                          lambda c, s: 0.0)(candidate, spec))
    t_memory = (report["hbm_bytes"] + extra) / (spec["hbm_gbps"] * 1e9)
    t_compute = report["compute_time_s"]
    raw_step = max(t_compute, t_memory)
    # when measured calibration factors exist for this chip
    # ($PADDLE_TPU_CALIBRATION gate, observability/calibration.py) the
    # candidate is RANKED by the calibrated per-op time; the raw
    # roofline price rides along in every row.  The kernel-analytic
    # path above stays raw — factors are keyed by desc op type.
    cal = report.get("calibrated_step_time_s")
    step = (float(cal) + extra / (spec["hbm_gbps"] * 1e9)
            if cal is not None else raw_step)
    return PricedCandidate(
        candidate, step, int(peak["total_peak_bytes"]),
        bound="compute" if t_compute >= t_memory else "memory",
        raw_step_s=raw_step, calibrated=cal is not None)


def rank(workload, candidates, chip: Optional[str] = None,
         hbm_bytes: Optional[int] = None
         ) -> Tuple[List[PricedCandidate], List[PricedCandidate]]:
    """(feasible candidates by predicted step time ascending, rejected).
    Stable under price ties (enumeration order, default first)."""
    desc_cache: Dict = {}
    priced = [price(workload, c, chip=chip, hbm_bytes=hbm_bytes,
                    _desc_cache=desc_cache)
              for c in candidates]
    feasible = [p for p in priced if p.feasible]
    rejected = [p for p in priced if not p.feasible]
    feasible.sort(key=lambda p: p.predicted_step_s)
    if rejected:
        from ..observability.metrics import REGISTRY

        REGISTRY.counter(
            "autotune_trials_total",
            "autotune candidates by workload and outcome").inc(
            len(rejected), workload=workload.name,
            outcome="rejected_infeasible")
    return feasible, rejected
