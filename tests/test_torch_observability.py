"""The port's observability tier against the JAX package's on the CPU: the
metrics registry (text and snapshots byte for byte), the artifact-name
authority, ``MirroredCounters``, spans as profiler ranges, the legacy
profiler face, ``memory``'s CPU accounting, the telemetry endpoint, the
executor's spans, counter and accounting hook, and the v2 engine's
mirrored counters with weights carried by ``load_params``."""

import json
import os
import sys
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import memory as jmemory
from paddle_tpu import observability as jobs
from paddle_tpu import profiler as jprofiler
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu_torch import memory as tmemory
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch import profiler as tprofiler
from paddle_tpu_torch.observability import metrics as tmetrics

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_serving_v2 import (  # noqa: E402
    JEngine, TEngine, _build_pair, _prefix_prompts)


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    yield
    tobs.disable_tracing()


# -- the registry ---------------------------------------------------------------


def _ops_counters(reg):
    c = reg.counter("requests_total", "requests by route")
    c.inc(route="/a")
    c.inc(2.5, route="/b")
    c.inc(route="/a")
    reg.counter("plain_total").inc(7)


def _ops_gauges(reg):
    g = reg.gauge("queue_depth", 'depth "with" quotes\nand a newline')
    g.set(3, pool="x\\y")
    g.inc(2, pool="x\\y")
    g.set(-1.25, pool="z")


def _ops_histograms(reg):
    h = reg.histogram("latency_seconds", "latency")
    for v in (1e-6, 3e-4, 0.2, 0.2, 7.0, 500.0):
        h.observe(v, op="read")
    h.observe(0.05)
    h2 = reg.histogram("custom_seconds", "custom buckets",
                       buckets=(0.5, 0.1, 2.0))
    h2.observe(0.3, k="v")


def _ops_guard(reg):
    c = reg.counter("per_request_total")
    for i in range(6):
        c.inc(rid=str(i))


def _ops_mirrored(reg, mod):
    m = mod.MirroredCounters({"a": 0, "b": 1.5}, family="serve_counters",
                             registry=reg, engine="v2", scheduler="v2")
    m["a"] += 3
    m.update(b=2)
    m.setdefault("c", 4)


OPS = {"counters": _ops_counters, "gauges": _ops_gauges,
       "histograms": _ops_histograms, "guard": _ops_guard,
       "mirrored": None, "disabled": _ops_counters}


@pytest.mark.parametrize("case", sorted(OPS))
def test_registry_renders_as_jax(case, recwarn):
    regs = []
    for mod in (jmetrics, tmetrics):
        reg = mod.MetricsRegistry(enabled=case != "disabled", max_series=4)
        if case == "mirrored":
            _ops_mirrored(reg, mod)
        else:
            OPS[case](reg)
        regs.append(reg)
    j, t = regs
    assert t.render_prometheus() == j.render_prometheus()
    assert t.snapshot() == j.snapshot()
    assert tmetrics.validate_snapshot(t.snapshot()) == []
    j.reset()
    t.reset()
    assert t.snapshot() == j.snapshot()


@pytest.mark.parametrize("name,kw", [
    ("serve_decode_tok_s", {}), ("serve_v2_solo_decode_tok_s", {}),
    ("serve_v2_decode_tok_s", {}), ("serve_v2_decode_tok_s",
                                    {"ab_artifact": True}),
    ("resnet50_bs128", {}), ("Bad_name", {}), ("trailing_", {}),
    ("9lead", {}), ("op_attribution_gpt", {})])
def test_artifact_metric_accepts_and_refuses_as_jax(name, kw):
    def outcome(mod):
        try:
            return mod.artifact_metric(name, 1.5, "x", note="n", **kw)
        except ValueError:
            return "refused"

    assert outcome(tmetrics) == outcome(jmetrics)


@pytest.mark.parametrize("bad", [
    None, {"schema": "other"}, {"schema": "paddle_tpu.metrics.v1"},
    {"schema": "paddle_tpu.metrics.v1", "families": {
        "Bad": {"type": "nope", "series": [{"labels": 1}]},
        "h": {"type": "histogram", "series": [{"labels": {}}]},
        "c": {"type": "counter", "series": [{"labels": {}}]}}}])
def test_validate_snapshot_as_jax(bad):
    assert tmetrics.validate_snapshot(bad) == jmetrics.validate_snapshot(bad)


def test_mirrored_counters_refuse_removal_and_reseed():
    reg = tmetrics.MetricsRegistry(enabled=True)
    m = tmetrics.MirroredCounters({"k": 0}, family="f", registry=reg, e="1")
    with pytest.raises(TypeError):
        del m["k"]
    with pytest.raises(TypeError):
        m.pop("k")
    m["k"] += 2
    assert reg.gauge("f").value(counter="k", e="1") == 2.0
    reg.reset()
    assert reg.gauge("f").value(counter="k", e="1") == 0.0
    m["k"] += 1  # the next write re-seeds the mirror
    assert reg.gauge("f").value(counter="k", e="1") == 3.0


def test_monotime_is_the_one_clock():
    assert tmetrics.monotime is jmetrics.monotime


# -- spans ----------------------------------------------------------------------


def test_span_opens_a_profiler_range_with_tracing_off():
    from torch.profiler import ProfilerActivity, profile

    assert not tobs.TRACER.enabled
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tobs.span("phase.x", k=1) as sp:
            assert sp is tobs.NOOP_SPAN
            sp.note(a=1)
    names = [e.name for e in prof.events()]
    assert "phase.x" in names
    assert tobs.TRACER.events() == []


def test_span_records_on_the_tracer_when_on():
    tobs.enable_tracing()
    with tobs.span("outer", a=1):
        with tobs.span("inner") as sp:
            sp.note(n=2)
    tobs.instant("mark", k=3)
    evs = tobs.TRACER.events()
    assert [e["name"] for e in evs] == ["inner", "outer", "mark"]
    assert evs[0]["args"] == {"n": 2, "depth": 1}
    assert tobs.validate_chrome_trace(tobs.TRACER.to_chrome()) == []


def test_export_telemetry_validates_like_jax(tmp_path):
    tobs.enable_tracing()
    with tobs.span("s"):
        pass
    snap = tobs.REGISTRY.snapshot()
    got = tobs.export_telemetry(
        tobs.TRACER.to_chrome(), str(tmp_path / "t.json"),
        {"runs": [{"snapshot": snap}, {"snapshot": {"schema": "x"}}]},
        str(tmp_path / "m.json"))
    want = jobs.export_telemetry(
        None, None, {"runs": [{"snapshot": snap},
                              {"snapshot": {"schema": "x"}}]},
        str(tmp_path / "jm.json"))
    assert got == want and len(got) == 1
    assert json.load(open(tmp_path / "t.json"))["traceEvents"]


def test_reset_clears_registry_tracer_and_accounting():
    tobs.enable_tracing()
    tobs.REGISTRY.counter("x_total").inc()
    with tobs.span("s"):
        pass
    tobs.accounting._tracked[-1] = object()
    tobs.attribution.enable()
    tfluid.reset()
    assert tobs.REGISTRY.counter("x_total").value() == 0.0
    assert tobs.TRACER.events() == []
    assert not tobs.accounting._tracked
    assert not tobs.attribution.enabled()


# -- profiler.py ----------------------------------------------------------------


def test_record_event_report_as_jax(capsys):
    for mod in (jprofiler, tprofiler):
        mod.reset_profiler()
        for name in ("a", "b", "a"):
            with mod.RecordEvent(name):
                pass
        with mod.record_event("c"):
            pass
    j, t = jprofiler.get_report(), tprofiler.get_report()
    assert sorted(t) == sorted(j) == ["a", "b", "c"]
    assert {k: v["calls"] for k, v in t.items()} == \
        {k: v["calls"] for k, v in j.items()}
    rows = tprofiler.print_report()
    assert [r[0] for r in rows][:1] and "Event" in capsys.readouterr().out


def test_profiler_writes_a_chrome_trace(tmp_path):
    with tprofiler.profiler(trace_dir=str(tmp_path)):
        with tobs.span("inside.profiler"):
            torch.ones(4).sum()
    trace = json.load(open(tmp_path / "trace.json"))
    assert any(e.get("name") == "inside.profiler"
               for e in trace["traceEvents"])
    with tprofiler.cuda_profiler():  # no card: the capture range is empty
        pass
    with tprofiler.CudaProfiler("x") as p:
        assert not p._on


# -- memory.py ------------------------------------------------------------------


def test_memory_cpu_accounting_as_jax():
    jp, tp = jfluid.CPUPlace(), tfluid.CPUPlace()
    j0, t0 = jmemory.used(jp), tmemory.used(tp)
    ja = jmemory.alloc((256, 256), "float32", jp)
    ta = tmemory.alloc((256, 256), "float32", tp)
    assert tmemory.used(tp) - t0 == jmemory.used(jp) - j0 == 256 * 256 * 4
    assert tmemory.peak(tp) >= tmemory.used(tp)
    assert isinstance(tmemory.memory_stats(tp), dict)
    assert tmemory.total(tp) == jmemory.total(jp)
    assert tmemory.available(tp) == jmemory.available(jp)
    jmemory.free(ja)
    tmemory.free(ta)
    assert tmemory.used(tp) - t0 == jmemory.used(jp) - j0 == 0
    assert ta.dtype == torch.float32 and tuple(ta.shape) == (256, 256)


def test_memory_copy_and_host_staging():
    src = np.arange(6, dtype=np.float32)
    dev = tmemory.Copy(tfluid.CPUPlace(), src)
    np.testing.assert_array_equal(dev.numpy(), src)
    st = tmemory.HostStaging()
    b1 = st.stage("x", np.ones((2, 3), np.float32))
    b2 = st.stage("x", np.zeros((2, 3), np.float32))
    b3 = st.stage("y", np.zeros((2, 3), np.float32))
    assert b1 is b2 and b1 is not b3 and st.nbytes() == 48
    st.clear()
    assert st.nbytes() == 0


# -- the telemetry endpoint -----------------------------------------------------


def test_http_endpoint_serves_registry_and_trace():
    reg = tmetrics.MetricsRegistry(enabled=True)
    reg.counter("hits_total", "hits").inc(3)
    srv = tobs.serve_http(0, registry=reg)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        body = urllib.request.urlopen(base + "/metrics").read().decode()
        assert body == reg.render_prometheus()
        snap = json.loads(urllib.request.urlopen(
            base + "/metrics.json").read())
        assert snap == reg.snapshot()
        trace = json.loads(urllib.request.urlopen(base + "/trace").read())
        assert tobs.validate_chrome_trace(trace) == []
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope")
    finally:
        srv.stop()
    with pytest.raises(ValueError, match="localhost"):
        tobs.TelemetryServer(0, host="0.0.0.0")


# -- the executor's telemetry ---------------------------------------------------


def _mlp_program():
    x = tfluid.layers.data(name="x", shape=[4])
    y = tfluid.layers.data(name="y", shape=[1])
    pred = tfluid.layers.fc(input=x, size=1)
    cost = tfluid.layers.mean(tfluid.layers.square_error_cost(pred, y))
    tfluid.optimizer.SGD(learning_rate=0.01).minimize(cost)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    feed = {"x": np.ones((2, 4), np.float32),
            "y": np.zeros((2, 1), np.float32)}
    return cost, tfluid.default_main_program(), exe, feed


def test_executor_spans_counter_and_accounting():
    cost, main, exe, feed = _mlp_program()
    tobs.enable_tracing()
    steps = tobs.REGISTRY.counter("executor_steps_total")
    before = steps.value()
    pred = tobs.accounting.track(main, "mlp", batch_size=2)
    assert pred["chip"] == "cpu-host"
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[cost])
    assert steps.value() - before == 3
    names = [e["name"] for e in tobs.TRACER.events()]
    assert names.count("executor.execute") == 3
    assert names.count("executor.writeback") == 3
    hits = [e["args"]["cache_hit"] for e in tobs.TRACER.events()
            if e["name"] == "executor.execute"]
    assert hits == [False, True, True]
    (row,) = tobs.accounting.report()
    assert row["compile_runs"] == 1 and row["steady_runs"] == 2
    assert row["step_time_ratio"] > 0 and row["measured_peak_bytes"] is None
    # no device allocator on the CPU: no measured peak
    assert tobs.accounting.record_measured_peak(main, exe, feed,
                                                [cost]) is None
    rows = tobs.accounting.artifact_rows()
    assert [r["metric"] for r in rows] == ["predvmeas_step_ratio_mlp"]
    assert tobs.REGISTRY.gauge("pred_vs_measured_step_time_ratio").value(
        program="mlp") == pytest.approx(row["step_time_ratio"])


def test_accounting_prediction_matches_jax():
    jfluid.reset()
    x = jfluid.layers.data(name="x", shape=[4])
    y = jfluid.layers.data(name="y", shape=[1])
    jcost = jfluid.layers.mean(jfluid.layers.square_error_cost(
        jfluid.layers.fc(input=x, size=1), y))
    jfluid.optimizer.SGD(learning_rate=0.01).minimize(jcost)
    _, tmain, _, _ = _mlp_program()
    j = jobs.accounting.track(jfluid.default_main_program(), "mlp",
                              batch_size=2, chip="cpu-host")
    t = tobs.accounting.track(tmain, "mlp", batch_size=2, chip="cpu-host")
    jobs.accounting.reset()
    assert t["predicted_peak_bytes"] == j["predicted_peak_bytes"]
    assert t["predicted_step_time_s"] == pytest.approx(
        j["predicted_step_time_s"], rel=1e-12)


# -- the v2 engine's mirrored counters -------------------------------------------


def test_engine_counters_mirror_and_match_jax():
    """Same requests, same weights (load_params): every counter both
    engines keep is equal, the registry mirrors equal the dicts, the
    snapshot validates, and the decode/mixed-step span counts are the
    engine's step counts."""
    jfluid.reset()
    jlm, tlm = _build_pair()
    prompts = _prefix_prompts(6)
    tobs.enable_tracing()
    engines = {}
    for name, Engine, lm, place in (
            ("jax", JEngine, jlm, jfluid.CPUPlace()),
            ("torch", TEngine, tlm, tfluid.CPUPlace())):
        eng = Engine(lm, place=place, scheduler="v2", max_batch_size=3,
                     page_size=8, chunk_size=8, name="obs_v2")
        for i, p in enumerate(prompts):
            eng.submit(p, 5, arrival=float(i))
        eng.run()
        engines[name] = eng
    j, t = engines["jax"], engines["torch"]
    shared = sorted(set(j.counters) & set(t.counters))
    assert len(shared) == 10
    for k in shared:
        assert t.counters[k] == j.counters[k], k
    stats = t.stats()
    gauge = tobs.REGISTRY.gauge("serve_counters")
    for k, v in t.counters.items():
        assert stats[k] == v
        assert gauge.value(counter=k, engine="obs_v2", scheduler="v2") \
            == pytest.approx(float(v))
    assert tobs.validate_snapshot(tobs.REGISTRY.snapshot()) == []
    names = [e["name"] for e in tobs.TRACER.events()]
    assert names.count("serve.decode") == stats["decode_steps"] > 0
    assert names.count("serve.mixed_step") == stats["mixed_steps"] > 0
    assert names.count("serve.admit") > 0
