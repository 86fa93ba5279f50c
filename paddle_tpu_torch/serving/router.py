"""ReplicaRouter: N ServingEngine replicas behind one front door — the
port of ``paddle_tpu/serving/router.py``.

Scale-OUT serving: rather than growing one engine's slot count (and its
static program shapes) without bound, run N independent replicas — each
with its own KV pool, scheduler, and programs — and route requests
between them.  The router reuses the analysis tier instead of inventing
heuristics:

  * ADMISSION — a replica is only eligible if its static
    ``hbm_report()["total_peak_bytes"]`` (pools + worst transient
    program peak) fits the per-card memory budget.  An over-budget
    replica is rejected at ROUTER CONSTRUCTION, loudly: it would run out
    of memory the first time its worst program ran.
  * PLACEMENT — cheapest predicted FINISH: each replica's per-token
    device time comes from the cost analyzer (``analysis.cost
    .program_cost`` over its decode program at its batch shape; an
    optional per-replica comm report is folded through
    ``roofline_with_comm`` for sharded replicas), multiplied by the
    decode tokens already committed to that replica (queued + running
    remaining budgets) plus the newcomer's own.  Identical replicas
    degrade to join-shortest-queue in tokens; heterogeneous replicas
    (different batch shapes or chips) weight the queue by the model's
    speed.

Draining uses the engines' own ``pop_finished()`` — the router adds no
completion path of its own, and per-request results are merged by rid
(rids are process-global, so replicas never collide).  The engines are
the caller's: each runs where it was built (the card unless the caller
asked for the CPU).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..observability.tracing import TRACER as _TRC
from .scheduler import Request


class ReplicaRouter:
    """Route requests over ``engines`` by HBM admission + predicted cost.

    `hbm_budget_bytes`: per-replica HBM capacity; replicas whose static
    report exceeds it are rejected with ValueError at construction
    (default: no budget — every replica admissible).
    `comm_reports`: optional per-replica comm dicts
    (``analysis.sharding.comm_report``) folded into the placement cost
    for replicas whose decode step implies collectives.  `chip` names the
    cost model's chip spec (default: $PADDLE_TPU_CHIP, then
    ``h100-sxm``)."""

    def __init__(self, engines: List[object],
                 hbm_budget_bytes: Optional[int] = None,
                 comm_reports: Optional[List[Optional[dict]]] = None,
                 chip: Optional[str] = None):
        from ..analysis.cost import program_cost, roofline_with_comm

        if not engines:
            raise ValueError("ReplicaRouter needs at least one engine")
        self.engines = list(engines)
        self.hbm_reports = [e.hbm_report() for e in self.engines]
        if hbm_budget_bytes is not None:
            for i, rep in enumerate(self.hbm_reports):
                if rep["total_peak_bytes"] > int(hbm_budget_bytes):
                    raise ValueError(
                        f"replica {i} ({self.engines[i].name}) needs "
                        f"{rep['total_peak_bytes']} B of device memory "
                        f"(pools + worst program peak) but the budget "
                        f"is {int(hbm_budget_bytes)} B — shrink "
                        f"num_pages/max_batch_size or raise the budget")
        # per-replica predicted seconds per decode STEP at its batch
        # shape; per-token cost divides by the slots that step serves (a
        # wider replica amortizes the step over more tokens)
        self.step_cost_s: List[float] = []
        for i, e in enumerate(self.engines):
            rep = program_cost(e.programs()["decode"],
                               batch_size=e.num_slots, chip=chip)
            comm = comm_reports[i] if comm_reports else None
            if comm:
                rep = roofline_with_comm(rep, comm)
            self.step_cost_s.append(float(rep["predicted_step_time_s"]))
        self.token_cost_s = [s / max(1, e.num_slots)
                             for s, e in zip(self.step_cost_s,
                                             self.engines)]
        # decode tokens committed per replica but not yet delivered
        self._pending_tokens = [0] * len(self.engines)
        self._replica_of: Dict[int, int] = {}
        self.placements = [0] * len(self.engines)

    # ------------------------------------------------------------------
    def _load_s(self, i: int) -> float:
        """Predicted seconds of decode work already owed by replica i."""
        return self._pending_tokens[i] * self.token_cost_s[i]

    def submit(self, prompt, max_new_tokens: int, **kw) -> int:
        """Place one request on the replica with the cheapest predicted
        finish (current owed work + this request, in analyzer seconds)
        and submit it there; returns the request id."""
        costs = [self._load_s(i)
                 + (len(prompt) + int(max_new_tokens))
                 * self.token_cost_s[i]
                 for i in range(len(self.engines))]
        i = min(range(len(self.engines)), key=lambda j: (costs[j], j))
        rid = self.engines[i].submit(prompt, max_new_tokens, **kw)
        self._replica_of[rid] = i
        self._pending_tokens[i] += int(max_new_tokens)
        self.placements[i] += 1
        with _TRC.span("serve.route", replica=i, rid=rid,
                       predicted_s=costs[i]):
            pass
        return rid

    def replica_of(self, rid: int) -> int:
        return self._replica_of[rid]

    def outstanding(self) -> int:
        """Requests admitted/queued but not yet finished, summed over
        replicas — same contract as ServingEngine.outstanding(), so code
        written against one engine can serve through a router."""
        return sum(e.outstanding() for e in self.engines)

    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One iteration of every replica; True while any has work."""
        alive = False
        for e in self.engines:
            if e.step():
                alive = True
        return alive

    def pop_finished(self) -> Dict[int, Request]:
        """Merge every replica's drain (rids are process-global)."""
        out: Dict[int, Request] = {}
        for i, e in enumerate(self.engines):
            done = e.pop_finished()
            for rid, r in done.items():
                self._pending_tokens[i] = max(
                    0, self._pending_tokens[i] - r.max_new_tokens)
            out.update(done)
        return out

    def run(self, max_steps: int = 100000) -> Dict[int, Request]:
        """Drive all replicas until drained; returns the merged drain."""
        out: Dict[int, Request] = {}
        for _ in range(max_steps):
            alive = self.step()
            out.update(self.pop_finished())
            if not alive:
                return out
        raise RuntimeError(
            "router still has outstanding requests after "
            f"{max_steps} steps")

    def stats(self) -> dict:
        return {
            "replicas": len(self.engines),
            "placements": list(self.placements),
            "step_cost_s": list(self.step_cost_s),
            "pending_tokens": list(self._pending_tokens),
            "engines": {e.name: e.stats() for e in self.engines},
        }
