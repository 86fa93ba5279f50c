"""The port's autotuner against the JAX package's on the CPU: the search
spaces of every shared axis, candidate digests, the mock tune's winner
and predicted ranking on ``lstm`` and ``mlp_depth`` (the program descs
are the same JSON bytes, so the store sites agree too), the knob
resolution order and its error messages, the winner store's eviction
and platform keys, the executor's winner pickup, the measurer, the
kernel workloads' feasibility, timed CPU tunes whose winners the engine,
the fused 3x3 op and the step loop then pick up, and the CLI's
``tune``, ``metrics``, ``trace`` and ``attribute``."""

import json
import os

import numpy as np
import pytest

import paddle_tpu_torch as tfluid
from paddle_tpu.autotune import knobs as jknobs
from paddle_tpu.autotune import space as jspace
from paddle_tpu.autotune import store as jstore
from paddle_tpu.autotune import tuner as jtuner
from paddle_tpu.autotune import workloads as jworkloads
from paddle_tpu.autotune.measure import MockMeasurer as JMock
from paddle_tpu_torch import cli as tcli
from paddle_tpu_torch.autotune import integration as tint
from paddle_tpu_torch.autotune import knobs as tknobs
from paddle_tpu_torch.autotune import measure as tmeasure
from paddle_tpu_torch.autotune import space as tspace
from paddle_tpu_torch.autotune import store as tstore
from paddle_tpu_torch.autotune import tuner as ttuner
from paddle_tpu_torch.autotune import workloads as tworkloads

CPU = tfluid.CPUPlace()

_KNOB_ENV = ("PADDLE_TPU_BNCONV_VARIANT", "PADDLE_TPU_BNCONV_V2",
             "PADDLE_TPU_BNCONV_BO", "PADDLE_TPU_PAGE_SIZE",
             "PADDLE_TPU_SPEC_K", "PADDLE_TPU_SPEC_DRAFT_LAYERS",
             "PADDLE_TPU_STEPS_PER_DISPATCH")


@pytest.fixture(autouse=True)
def _fresh_port(tmp_path, monkeypatch):
    """A throwaway winner store for both packages, no knob variables."""
    tfluid.reset()
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_CACHE", str(tmp_path / "at"))
    monkeypatch.setenv("PADDLE_TPU_CALIBRATION_CACHE", str(tmp_path / "cal"))
    for v in _KNOB_ENV:
        monkeypatch.delenv(v, raising=False)
    tint.reset()
    yield
    tint.reset()


def _axes(space):
    return {a.name: a.values for a in space.axes}


# -- spaces ---------------------------------------------------------------------


@pytest.mark.parametrize("builder,args", [
    ("bn_conv_space", (64,)), ("bn_conv_space", (128,)),
    ("bn_conv_space", (256,)), ("bn_conv_space", (512,)),
    ("paged_space", (16,)), ("paged_space", (1024,)),
    ("spec_decode_space", (4, 12)), ("spec_decode_space", (2, 3)),
    ("spec_decode_space", (8, 6)), ("step_loop_space", ((1, 2, 4),)),
    ("mlp_depth_space", ()), ("remat_space", ())])
def test_space_equals_jax_on_shared_axes(builder, args):
    t = getattr(tspace, builder)(*args)
    j = getattr(jspace, builder)(*args)
    ta, ja = _axes(t), _axes(j)
    shared = set(ta) & set(ja)
    assert shared and shared == set(ta)  # every port axis is JAX's
    for name in shared:
        assert ta[name] == ja[name], name
    if set(ta) == set(ja):
        assert [c.digest for c in t.candidates()] == \
            [c.digest for c in j.candidates()]
        assert t.default().digest == j.default().digest


def test_xla_and_flash_axes_are_not_ported():
    assert tspace.PROGRAM_AXES == ("remat",)
    assert not hasattr(tspace, "flash_space")
    assert not hasattr(tknobs, "flash_blocks")


def test_candidate_and_space_contracts():
    c = tspace.Candidate({"remat": True, "bn_conv.variant": "v2"})
    assert c.knob_params() == {"bn_conv.variant": "v2"}
    assert c.digest == jspace.Candidate(dict(c.params)).digest
    with pytest.raises(ValueError, match="duplicate"):
        tspace.SearchSpace([tspace.Choice("a", (1,)),
                            tspace.Choice("a", (2,))])
    with pytest.raises(ValueError, match="no values"):
        tspace.Choice("a", ())


# -- the mock tune against JAX ----------------------------------------------------


def _mock_tune(pkg, name, time_fn=None):
    if pkg == "jax":
        wl = jworkloads.get_workload(name)
        return jtuner.tune(wl, measurer=JMock(time_fn), top_k=2,
                           chip="cpu-host",
                           store=jstore.WinnerStore(os.environ[
                               "PADDLE_TPU_AUTOTUNE_CACHE"] + "_j"))
    wl = tworkloads.get_workload(name, place=CPU)
    return ttuner.tune(wl, measurer=tmeasure.MockMeasurer(time_fn), top_k=2,
                       chip="cpu-host")


def _remat_time(wl, cand):
    return 1e-3 * (2.0 if cand.get("remat") else 1.0)


@pytest.mark.parametrize("name,time_fn", [("mlp_depth", None),
                                          ("lstm", _remat_time)])
def test_mock_tune_picks_jaxs_winner_and_ranking(name, time_fn):
    j = _mock_tune("jax", name, time_fn)
    t = _mock_tune("torch", name, time_fn)
    strip = (lambda p: {k: v for k, v in p.items() if k != "xla_flags"})
    assert strip(t["winner"]) == strip(j["winner"])
    assert [strip(r["params"]) for r in t["trials"]] == \
        [strip(r["params"]) for r in j["trials"]]
    assert [r["predicted_step_s"] for r in t["trials"]] == pytest.approx(
        [r["predicted_step_s"] for r in j["trials"]], rel=1e-12)
    assert t["site"] == j["site"]  # same desc bytes, same digest
    assert t["rank_of_winner"] == j["rank_of_winner"]
    again = _mock_tune("torch", name, time_fn)
    assert again["cache_hit"] and again["winner"] == t["winner"]


def test_tune_rejects_before_measuring():
    wl = tworkloads.get_workload("mlp_depth", place=CPU)
    m = tmeasure.MockMeasurer()
    with pytest.raises(RuntimeError, match="every candidate rejected"):
        ttuner.tune(wl, measurer=m, chip="cpu-host", hbm_bytes=1 << 10)
    assert not m.measured


# -- knobs ----------------------------------------------------------------------


KNOBS = [
    ("bnconv_variant", (), "PADDLE_TPU_BNCONV_VARIANT", "v2", "v3",
     "bn_conv.variant", "reference"),
    ("bnconv_block_o", (), "PADDLE_TPU_BNCONV_BO", "128", "x",
     "bn_conv.block_o", 256),
    ("paged_page_size", (16,), "PADDLE_TPU_PAGE_SIZE", "32", "24",
     "paged_attention.page_size", 64),
    ("speculation_k", (4,), "PADDLE_TPU_SPEC_K", "2", "-1",
     "spec_decode.speculation_k", 8),
    ("spec_draft_layers", (2,), "PADDLE_TPU_SPEC_DRAFT_LAYERS", "3", "zz",
     "spec_decode.draft_layers", 1),
    ("steps_per_dispatch", (1,), "PADDLE_TPU_STEPS_PER_DISPATCH", "4", "0",
     "step_loop.steps_per_dispatch", 8),
]


@pytest.mark.parametrize("knob,args,var,good,bad,trial_key,trial_val",
                         KNOBS, ids=[k[0] for k in KNOBS])
def test_knob_order_and_messages_equal_jax(knob, args, var, good, bad,
                                           trial_key, trial_val,
                                           monkeypatch):
    t, j = getattr(tknobs, knob), getattr(jknobs, knob)
    assert t(*args) == j(*args)  # the default
    monkeypatch.setenv(var, good)
    assert t(*args) == j(*args)
    with tknobs.trial_overrides({trial_key: trial_val}), \
            jknobs.trial_overrides({trial_key: trial_val}):
        assert t(*args) == j(*args) == trial_val
        assert tknobs.in_trial()
    assert not tknobs.in_trial()
    monkeypatch.setenv(var, bad)
    with pytest.raises(ValueError) as te:
        t(*args)
    with pytest.raises(ValueError) as je:
        j(*args)
    assert str(te.value) == str(je.value)


def test_stored_winners_resolve_below_env(monkeypatch):
    kind, backend = tknobs.platform()
    assert (kind, backend) == ("cpu", "cpu")
    st = tstore.default_store()
    st.record("bn_conv", {}, kind, backend,
              winner={"variant": "v2", "block_o": 128})
    st.record("paged_attention", {}, kind, backend, winner={"page_size": 32})
    st.record("spec_decode", {}, kind, backend,
              winner={"speculation_k": 2, "draft_layers": 1})
    st.record("step_loop", {}, kind, backend,
              winner={"steps_per_dispatch": 4})
    assert tknobs.bnconv_variant() == "v2"
    assert tknobs.bnconv_block_o() == 128
    assert tknobs.paged_page_size() == 32
    assert tknobs.speculation_k() == 2
    assert tknobs.spec_draft_layers(3) == 1
    assert tknobs.steps_per_dispatch(1, store=True) == 4
    assert tknobs.steps_per_dispatch(1, store=False) == 1
    monkeypatch.setenv("PADDLE_TPU_BNCONV_V2", "1")
    monkeypatch.setenv("PADDLE_TPU_BNCONV_VARIANT", "v1")
    assert tknobs.bnconv_variant() == "v1"  # the new variable wins
    monkeypatch.setenv("PADDLE_TPU_BNCONV_BO", "0")
    assert tknobs.bnconv_block_o() == 0  # the sentinel beats the winner
    # a winner keyed to the card never configures the CPU path
    st2 = tstore.WinnerStore(os.environ["PADDLE_TPU_AUTOTUNE_CACHE"])
    st2.record("paged_attention", {}, "NVIDIA H100 80GB HBM3", "cuda",
               winner={"page_size": 64})
    assert tknobs.paged_page_size() == 32


# -- the store ------------------------------------------------------------------


def test_store_evicts_corrupt_entries_and_keys_platforms(tmp_path):
    st = tstore.WinnerStore(str(tmp_path))
    assert not st.has_entries()
    st.record("program", {"a": 1}, "cpu", "cpu", winner={"remat": True})
    assert st.has_entries()
    key = tstore.store_key("program", {"a": 1}, "cpu", "cpu")
    assert key == jstore.store_key("program", {"a": 1}, "cpu", "cpu")
    fresh = tstore.WinnerStore(str(tmp_path))
    assert fresh.winner("program", {"a": 1}, "cpu", "cpu") == {"remat": True}
    assert fresh.winner("program", {"a": 1}, "NVIDIA H100", "cuda") is None
    path = os.path.join(str(tmp_path), key + ".winner")
    with open(path, "r+b") as f:
        f.seek(15)
        f.write(b"\xff\xfe")
    assert tstore.WinnerStore(str(tmp_path)).lookup(
        "program", {"a": 1}, "cpu", "cpu") is None
    assert not os.path.exists(path)
    assert not [n for n in os.listdir(str(tmp_path)) if ".tmp-" in n]


def test_default_store_root(monkeypatch, tmp_path):
    monkeypatch.delenv("PADDLE_TPU_AUTOTUNE_CACHE", raising=False)
    assert tstore.default_store().root == os.path.join(
        os.path.dirname(tfluid.__file__), "_cache", "autotune")


# -- the executor's winner pickup -------------------------------------------------


def _grad_ops(program):
    return [op for op in program.global_block().ops
            if op.type == "generic_grad"]


def test_executor_applies_the_stored_program_winner(monkeypatch):
    # a training program so the remat winner has grad ops to mark
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.framework.core import Program, program_guard

    main, startup = Program(), Program()
    with unique_name.guard(), program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4])
        y = fluid.layers.data(name="y", shape=[1])
        cost = fluid.layers.mean(fluid.layers.square_error_cost(
            fluid.layers.fc(input=x, size=1), y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(cost)
    feed = {"x": np.ones((2, 4), np.float32),
            "y": np.zeros((2, 1), np.float32)}
    kind, backend = tknobs.platform()
    tstore.default_store().record("program", tint.program_site(main, feed),
                                  kind, backend, winner={"remat": True},
                                  workload="t")
    exe = fluid.Executor(CPU)
    exe.run(startup)
    with tknobs.trial_overrides({"x": 1}):
        exe.run(main, feed=feed, fetch_list=[cost])
    assert not any(op.attrs.get("__remat__") for op in _grad_ops(main))
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE", "0")
    exe.run(main, feed=feed, fetch_list=[cost])
    assert not any(op.attrs.get("__remat__") for op in _grad_ops(main))
    monkeypatch.delenv("PADDLE_TPU_AUTOTUNE")
    v0 = main._version
    exe.run(main, feed=feed, fetch_list=[cost])
    assert _grad_ops(main) and all(op.attrs.get("__remat__")
                                   for op in _grad_ops(main))
    assert main._version == v0 + 1
    exe.run(main, feed=feed, fetch_list=[cost])  # memoized: no re-mark
    assert main._version == v0 + 1


def test_workload_builds_are_name_deterministic():
    wl = tworkloads.get_workload("lstm", place=CPU)
    assert wl.build(None).main.to_json() == wl.build(None).main.to_json()
    assert wl.site() == tworkloads.get_workload("lstm", place=CPU).site()


# -- the measurer ---------------------------------------------------------------


class _Runner:
    def __init__(self, log, fail=False):
        self.log, self.fail = log, fail

    def step(self):
        if self.fail:
            raise RuntimeError("kernel refused the trial")
        self.log.append("step")

    def barrier(self):
        self.log.append("barrier")

    def close(self):
        self.log.append("close")


class _Workload:
    name = "fake"

    def __init__(self, fail=False):
        self.log, self.fail = [], fail

    def build_runner(self, cand):
        self.log.append(dict(tknobs._tls.stack[-1]))
        return _Runner(self.log, self.fail)


def test_timed_measurer_passes_end_in_a_barrier():
    wl = _Workload()
    cand = tspace.Candidate({"bn_conv.variant": "v2", "remat": False})
    res = tmeasure.TimedMeasurer(warmup=1, iters=2, repeats=3).measure(wl, cand)
    assert wl.log[0] == {"bn_conv.variant": "v2"}
    assert wl.log[1:] == ["step", "barrier"] + \
        ["step", "step", "barrier"] * 3 + ["close"]
    assert res["steps"] == 2 and len(res["passes_ms"]) == 3
    assert res["best_s"] <= res["median_s"]


def test_a_failed_trial_fails_the_tune_loudly():
    wl = _Workload(fail=True)
    with pytest.raises(RuntimeError, match="refused"):
        tmeasure.TimedMeasurer(0, 1, 1).measure(
            wl, tspace.Candidate({"remat": False}))
    assert wl.log[-1] == "close"


def test_mock_measurer_times_as_jax():
    cand = tspace.Candidate({"mlp.depth": 4})
    jc = jspace.Candidate({"mlp.depth": 4})
    wl = type("W", (), {"name": "w"})()
    assert tmeasure.MockMeasurer().measure(wl, cand)["best_s"] == \
        JMock().measure(wl, jc)["best_s"]


# -- workloads ------------------------------------------------------------------


def test_mesh_layout_raises_naming_the_queue_item():
    """The mesh_layout axis (once refused): each layout's feasibility and
    priced communication equal the JAX package's (with its v5e link
    rates), and a layout's runner takes a step on eight CPU positions;
    an unknown name still raises."""
    wl = tworkloads.get_workload("mesh_layout", place=CPU)
    jwl = jworkloads.get_workload("mesh_layout")
    assert wl.LAYOUTS == jwl.LAYOUTS and wl.site() == jwl.site()
    for layout in wl.LAYOUTS:
        cand = tspace.Candidate({"mesh_layout.layout": layout})
        jcand = jspace.Candidate({"mesh_layout.layout": layout})
        got = wl.comm_cost(cand, {"chip": "tpu-v5e"})
        want = jwl.comm_cost(jcand, {"chip": "v5e"})
        assert got["link_bytes"] == want["link_bytes"]
        assert got["per_kind"] == want["per_kind"]
        np.testing.assert_allclose(got["comm_time_s"], want["comm_time_s"],
                                   rtol=1e-12)
        assert wl.feasible(cand, {}) == jwl.feasible(jcand, {})
    run = wl.build_runner(tspace.Candidate(
        {"mesh_layout.layout": "2x4"}))
    run.step()
    run.barrier()
    run.close()
    with pytest.raises(KeyError, match="unknown workload"):
        tworkloads.get_workload("nope", place=CPU)


def test_paged_feasibility_follows_the_kernels_limits():
    spec = {"chip": "h100-sxm"}
    ok = tworkloads.PagedDecodeWorkload(N=8, nh=8, dh=64, max_ctx=1024)
    for ps in (16, 32, 64):
        assert ok.feasible(tspace.Candidate(
            {"paged_attention.page_size": ps}), spec)[0]
    big = ok.feasible(tspace.Candidate(
        {"paged_attention.page_size": 1024}), spec)
    assert not big[0] and "shared memory" in big[1]
    wide = tworkloads.PagedDecodeWorkload(dh=256)
    assert not wide.feasible(tspace.Candidate(
        {"paged_attention.page_size": 16}), spec)[0]


def test_paged_tune_sets_the_engines_default_page_size():
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.serving import ServingEngine

    wl = tworkloads.PagedDecodeWorkload(place=CPU)
    rep = ttuner.tune(wl, measurer=tmeasure.TimedMeasurer(0, 1, 1),
                      chip="cpu-host")
    assert {t["launches"]["paged_attention"] for t in rep["trials"]} == {0}
    ps = rep["winner"]["paged_attention.page_size"]
    assert tknobs.paged_page_size() == ps
    lm = transformer.DecoderLM(30, 16, 1, 2, max_len=64, dtype="float32")
    lm.logits(tfluid.layers.data("tokens", shape=[64, 1], dtype="int64"))
    tfluid.Executor(CPU).run(tfluid.default_startup_program())
    assert ServingEngine(lm, max_batch_size=2, place=CPU).page_size == ps
    hit = ttuner.tune(tworkloads.PagedDecodeWorkload(place=CPU),
                      measurer=tmeasure.MockMeasurer(), chip="cpu-host")
    assert hit["cache_hit"]


def test_bn_conv_tune_routes_every_variant_and_persists():
    from paddle_tpu_torch.ops.cuda_kernels import bn_conv as bc

    wl = tworkloads.BnConvWorkload(N=1, H=4, W=4, K=16, O=128, place=CPU)
    m = tmeasure.TimedMeasurer(0, 1, 1)
    rep = ttuner.tune(wl, measurer=m, chip="cpu-host", measure_all=True)
    variants = {t["params"]["bn_conv.variant"] for t in rep["trials"]}
    assert variants == {"v1", "v2", "reference"}
    for t in rep["trials"]:  # the CPU takes the plain versions
        assert t["launches"] == {"bn_conv3x3_fwd": 0,
                                 "bn_conv3x3_fwd_v2": 0}
    assert tknobs.bnconv_variant() == rep["winner"]["bn_conv.variant"]
    with tknobs.trial_overrides({"bn_conv.block_o": 64}):
        assert bc._v2_block_o(128) == 64
        assert bc._v2_block_o(96) == 96  # 64 does not divide 96


def test_step_loop_tune_persists_the_dispatch_depth():
    wl = tworkloads.StepLoopWorkload(batch_size=2, total_steps=4, place=CPU)
    rep = ttuner.tune(wl, measurer=tmeasure.TimedMeasurer(0, 1, 1),
                      chip="cpu-host", measure_all=True)
    assert len(rep["trials"]) == 3
    assert tknobs.steps_per_dispatch(1, store=True) == \
        rep["winner"]["step_loop.steps_per_dispatch"]


def test_spec_decode_workload_serves_under_the_trial():
    wl = tworkloads.SpecDecodeWorkload(vocab=30, dim=16, layers=2, heads=2,
                                       max_len=32, max_new=4, n_requests=2,
                                       place=CPU)
    cand = wl.space().default()
    res = tmeasure.TimedMeasurer(0, 1, 1).measure(wl, cand)
    assert res["steps"] == 1 and res["best_s"] > 0


# -- the CLI --------------------------------------------------------------------


@pytest.mark.parametrize("workload", ["lstm", "paged_decode",
                                      "step_loop"])
def test_cli_tune_smoke(workload, capsys):
    assert tcli.main(["tune", workload, "--smoke", "--place", "cpu"]) == 0
    assert "autotune smoke OK" in capsys.readouterr().err


def test_cli_tune_mock_then_cache_hit(tmp_path, capsys):
    store = str(tmp_path / "s")
    args = ["tune", "mlp_depth", "--mock", "--store", store, "--place",
            "cpu", "--chip", "cpu-host"]
    assert tcli.main(args) == 0
    out = capsys.readouterr().out
    assert "prior rank of measured winner" in out
    assert tcli.main(args + ["--json"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["cache_hit"]


def _saved_mlp(tmp_path):
    x = tfluid.layers.data(name="x", shape=[4])
    y = tfluid.layers.data(name="y", shape=[1])
    cost = tfluid.layers.mean(tfluid.layers.square_error_cost(
        tfluid.layers.fc(input=x, size=1), y))
    tfluid.optimizer.SGD(learning_rate=0.1).minimize(cost)
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    d = str(tmp_path / "model")
    tfluid.io.save_inference_model(d, ["x"], [cost], exe)
    return d


def test_cli_metrics_trace_attribute_on_a_saved_model(tmp_path, capsys):
    d = _saved_mlp(tmp_path)
    assert tcli.main(["metrics", d, "--steps", "3", "--place", "cpu",
                      "--json"]) == 0
    body = json.loads(capsys.readouterr().out)
    assert "executor_steps_total" in body["families"]
    (row,) = body["pred_vs_measured"]
    assert row["steady_runs"] == 2 and row["compile_runs"] == 1
    assert tcli.main(["metrics", d, "--place", "cpu"]) == 0
    assert "# TYPE executor_steps_total counter" in capsys.readouterr().out
    out = str(tmp_path / "t.json")
    assert tcli.main(["trace", d, "--out", out, "--place", "cpu"]) == 0
    assert "events" in capsys.readouterr().out
    names = {e["name"] for e in json.load(open(out))["traceEvents"]}
    assert {"executor.execute", "telemetry.step"} <= names
    assert tcli.main(["attribute", d, "--place", "cpu", "--smoke",
                      "--json", "--profile", str(tmp_path / "prof"),
                      "--steps", "2", "--update-calibration",
                      "--calibration-root", str(tmp_path / "cal")]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["metric"] == "op_attribution_model"
    assert row["mode"] == "cpu-oracle" and row["calibration_updated"]
    assert row["profile_coverage"] == 1.0


def test_cli_attribute_standing_program(capsys):
    assert tcli.main(["attribute", "fit_a_line", "--place", "cpu",
                      "--repeats", "1"]) == 0
    captured = capsys.readouterr()
    assert "attribution fit_a_line (cpu-oracle, chip cpu-host)" in \
        captured.err
