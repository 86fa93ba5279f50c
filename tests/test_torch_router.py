"""The port's ReplicaRouter against the JAX package's on the CPU.

The same small decoder LM is built in both packages and the JAX
startup's parameters are carried across with ``DecoderLM.load_params``;
each package then puts v2 engine replicas behind its router.  The
routers must agree: admission, each replica's predicted decode-step cost
(within 1e-12 relative under the ``cpu-host`` chip spec), every
placement, and every request's greedy tokens; pending tokens return to
0 and no page leaks.  Held as ``tests/test_speculative.py`` holds the JAX
router."""

import os
import sys

import numpy as np
import pytest

import paddle_tpu_torch as tfluid
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving.router import ReplicaRouter as JRouter
from paddle_tpu_torch.observability import TRACER
from paddle_tpu_torch.serving import ReplicaRouter as TRouter
from paddle_tpu_torch.serving import ServingEngine as TEngine

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_serving_v2 import _build_pair  # noqa: E402

V2 = dict(scheduler="v2", page_size=8, chunk_size=8)


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    yield


def _replicas(lm, engine, slots, place, num_pages=10):
    return [engine(lm, max_batch_size=n, num_pages=num_pages, place=place,
                   name=f"r{i}", **V2) for i, n in enumerate(slots)]


def _prompts(n, seed=1, lo=4, hi=12):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 50, size=int(k)).tolist()
            for k in rng.randint(lo, hi, size=n)]


def _drain(router, prompts, budget):
    rids = [router.submit(p, budget) for p in prompts]
    assert router.outstanding() == len(prompts)
    fin = router.run()
    assert sorted(fin) == sorted(rids)
    return ([router.replica_of(r) for r in rids],
            [fin[r].generated for r in rids])


def _leak_free(engines):
    for e in engines:
        e.cache.prefix.clear()
        assert e.cache.allocator.available() == e.num_pages - 1, e.name


@pytest.mark.parametrize("slots,n_req,budget", [
    ((1, 2), 4, 4), ((2, 1), 6, 5), ((1, 1), 4, 3), ((2, 2, 1), 7, 4)])
def test_router_matches_jax(slots, n_req, budget):
    """Heterogeneous replicas: the first request goes to the replica whose
    token cost x (prompt + budget) is cheapest, later ones by predicted
    finish, and the merged drains are token-exact against JAX's router
    over the same replicas."""
    import paddle_tpu as jfluid

    jlm, tlm = _build_pair()
    jr = JRouter(_replicas(jlm, JEngine, slots, jfluid.CPUPlace()),
                 chip="cpu-host")
    tr = TRouter(_replicas(tlm, TEngine, slots, tfluid.CPUPlace()),
                 chip="cpu-host")
    for got, want in zip(tr.step_cost_s, jr.step_cost_s):
        assert got == pytest.approx(want, rel=1e-12, abs=0)
    assert tr.hbm_reports == jr.hbm_reports
    prompts = _prompts(n_req)
    want_first = min(range(len(slots)), key=lambda i: (
        (len(prompts[0]) + budget) * tr.token_cost_s[i], i))
    t_place, t_tok = _drain(tr, prompts, budget)
    j_place, j_tok = _drain(jr, prompts, budget)
    assert t_place[0] == want_first
    assert t_place == j_place
    assert t_tok == j_tok
    for r in (tr, jr):
        st = r.stats()
        assert sum(st["placements"]) == n_req
        assert st["pending_tokens"] == [0] * len(slots)
        assert r.outstanding() == 0
    assert tr.stats()["placements"] == jr.stats()["placements"]
    assert tr.stats()["engines"].keys() == jr.stats()["engines"].keys()
    _leak_free(tr.engines)


def test_router_rejects_over_budget_replica():
    """A replica whose static memory report (pools + worst program peak)
    exceeds the budget is rejected at construction; one that exactly fits
    is admitted — the same bytes as the JAX engine's report."""
    import paddle_tpu as jfluid

    jlm, tlm = _build_pair()
    te = TEngine(tlm, max_batch_size=1, num_pages=6,
                 place=tfluid.CPUPlace(), **V2)
    je = JEngine(jlm, max_batch_size=1, num_pages=6,
                 place=jfluid.CPUPlace(), **V2)
    need = te.hbm_report()["total_peak_bytes"]
    assert need == je.hbm_report()["total_peak_bytes"]
    with pytest.raises(ValueError, match="budget"):
        TRouter([te], hbm_budget_bytes=need - 1)
    r = TRouter([te], hbm_budget_bytes=need, chip="cpu-host")
    assert r.step_cost_s[0] > 0
    with pytest.raises(ValueError, match="at least one engine"):
        TRouter([])


def test_identical_replicas_join_shortest_queue():
    _, tlm = _build_pair()
    router = TRouter(_replicas(tlm, TEngine, (1, 1), tfluid.CPUPlace(),
                               num_pages=8), chip="cpu-host")
    for _ in range(4):
        router.submit([1, 2, 3, 4], 3)
    assert router.stats()["placements"] == [2, 2]
    router.run()
    _leak_free(router.engines)


def test_comm_reports_fold_into_the_step_cost_as_in_jax():
    import paddle_tpu as jfluid

    jlm, tlm = _build_pair()
    comm = [None, {"comm_time_s": 1.0, "collective_bytes": 64}]
    jr = JRouter(_replicas(jlm, JEngine, (1, 2), jfluid.CPUPlace()),
                 comm_reports=comm, chip="cpu-host")
    tr = TRouter(_replicas(tlm, TEngine, (1, 2), tfluid.CPUPlace()),
                 comm_reports=comm, chip="cpu-host")
    assert tr.step_cost_s[1] == jr.step_cost_s[1] == 1.0
    assert tr.step_cost_s[0] == pytest.approx(jr.step_cost_s[0], rel=1e-12)


def test_comm_reports_from_comm_report_fold_as_in_jax():
    """`comm_reports` made by each package's `analysis.sharding.
    comm_report` (the lm_dp_sp mode's plan, priced on cpu-host): the
    routers' step costs agree."""
    import paddle_tpu as jfluid
    from paddle_tpu.analysis import sharding as jsh
    from paddle_tpu.parallel import modes as jmodes
    from paddle_tpu_torch.analysis import sharding as tsh
    from paddle_tpu_torch.parallel import modes as tmodes

    reports = []
    for modes, sh in ((jmodes, jsh), (tmodes, tsh)):
        mode, prog, _ = modes.build_mode("lm_dp_sp")
        mesh, plan, prov = modes.mode_plan(mode, prog)
        reports.append(sh.comm_report(sh.propagate(
            prog, mesh=mesh, plan=plan, batch_size=8, provenance=prov),
            chip="cpu-host"))
    jlm, tlm = _build_pair()
    jr = JRouter(_replicas(jlm, JEngine, (1, 2), jfluid.CPUPlace()),
                 comm_reports=[None, reports[0]], chip="cpu-host")
    tr = TRouter(_replicas(tlm, TEngine, (1, 2), tfluid.CPUPlace()),
                 comm_reports=[None, reports[1]], chip="cpu-host")
    assert reports[1]["comm_time_s"] > 0
    for i in (0, 1):
        assert tr.step_cost_s[i] == pytest.approx(jr.step_cost_s[i],
                                                  rel=1e-12)


def test_the_router_default_chip_is_the_card(monkeypatch):
    from paddle_tpu_torch.analysis import cost

    monkeypatch.delenv("PADDLE_TPU_CHIP", raising=False)
    _, tlm = _build_pair()
    e = _replicas(tlm, TEngine, (2,), tfluid.CPUPlace())
    r = TRouter(e)
    want = cost.program_cost(e[0].programs()["decode"], batch_size=2,
                             chip="h100-sxm")["predicted_step_time_s"]
    assert r.step_cost_s == [want]
    assert r.token_cost_s == [want / 2]


def test_each_placement_is_a_serve_route_span():
    _, tlm = _build_pair()
    router = TRouter(_replicas(tlm, TEngine, (1, 2), tfluid.CPUPlace()),
                     chip="cpu-host")
    TRACER.enable()
    try:
        rids = [router.submit(p, 2) for p in _prompts(3)]
        spans = [e for e in TRACER.events() if e["name"] == "serve.route"]
    finally:
        TRACER.disable()
    assert [s["args"]["rid"] for s in spans] == rids
    assert [s["args"]["replica"] for s in spans] == \
        [router.replica_of(r) for r in rids]
    assert all(s["args"]["predicted_s"] > 0 for s in spans)
    router.run()
