"""The port's attribution and calibration against the JAX package's on the
CPU: the schedule on the GPT training program, ResNet-18 and the SRL
network; the per-op tables ``build_table`` and ``table_from_scopes``
make from one measured dict under ``cpu-host`` (to 1e-12 relative);
the segment walk and the profile capture on the CPU; the trace parser's
device-time attribution on a synthetic CUDA trace; and the calibration
store's fits, persistence and pricing (``program_cost`` and
``step_loop_cost`` with the same factors, to 1e-12 relative)."""

import json
import os
import sys

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.analysis import cost as jcost
from paddle_tpu.observability import attribution as jattr
from paddle_tpu.observability import calibration as jcal
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.analysis import cost as tcost
from paddle_tpu_torch.observability import attribution as tattr
from paddle_tpu_torch.observability import calibration as tcal

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_analysis import _pair  # noqa: E402

REL = 1e-12


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    yield


def _close(a, b, path=""):
    """Equal structures, floats to REL relative."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=REL, abs=1e-300), path
    else:
        assert a == b, path


# -- the schedule ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["gpt_train", "resnet18_train",
                                  "srl_train"])
def test_schedule_equals_jax(name):
    (_, jp), (_, tp) = _pair(name)
    got = tattr.schedule(tp.global_block())
    assert got == jattr.schedule(jp.global_block())
    assert sorted(got) == list(range(len(tp.global_block().ops)))


def test_scope_names_parse_as_jax():
    (_, jp), (_, tp) = _pair("gpt_train")
    for jop, top in zip(jp.global_block().ops, tp.global_block().ops):
        assert tattr.scope_name(top) == jattr.scope_name(jop)
    for text in ("pdop__elementwise_add__u12", "x/pdop__mul__u3/y",
                 "nothing", "", "pdop__generic_grad__u7 extra"):
        assert tattr.parse_scope(text) == jattr.parse_scope(text)


# -- the tables -----------------------------------------------------------------


def _measured(n, seed=0):
    rng = np.random.RandomState(seed)
    return [None if i % 7 == 3 else float(rng.rand() * 1e-3 + 1e-6)
            for i in range(n)]


_JAX_KEYS = ("mode", "chip", "batch_size", "total_s", "attributed_s",
             "coverage", "n_ops", "pred_total_s", "top_op", "rows",
             "by_type")


@pytest.mark.parametrize("name", ["gpt_train", "resnet18_train",
                                  "gpt_forward"])
def test_build_table_equals_jax(name):
    (_, jp), (_, tp) = _pair(name)
    m = _measured(len(tp.global_block().ops))
    total = sum(x for x in m if x) * 1.25
    got = tattr.build_table(tp.global_block(), m, total, batch_size=4,
                            chip="cpu-host", repeats=2)
    want = jattr.build_table(jp.global_block(), m, total, batch_size=4,
                             chip="cpu-host", repeats=2)
    _close({k: got[k] for k in _JAX_KEYS + ("repeats",)},
           {k: want[k] for k in _JAX_KEYS + ("repeats",)})
    assert got["unattributed_s"] == 0.0


@pytest.mark.parametrize("name", ["gpt_forward", "mlp_forward"])
def test_table_from_scopes_equals_jax(name):
    (_, jp), (_, tp) = _pair(name)
    ops = tp.global_block().ops
    rng = np.random.RandomState(3)
    by_scope = {(op.type, int(op.attrs["__uid__"])): float(rng.rand())
                for op in ops[::2]}
    got = tattr.table_from_scopes(tp.global_block(), by_scope,
                                  batch_size=4, chip="cpu-host")
    want = jattr.table_from_scopes(jp.global_block(), by_scope,
                                   batch_size=4, chip="cpu-host")
    _close({k: got[k] for k in _JAX_KEYS}, {k: want[k] for k in _JAX_KEYS})


def test_table_from_scopes_keeps_grad_rows_and_unattributed_time():
    """A grad op carries its forward op's uid: the port keys the profile
    by (type, uid), so both keep a row (the JAX package folds them), and
    time outside every op's range is a row of its own."""
    (_, _), (_, tp) = _pair("gpt_train")
    block = tp.global_block()
    by_scope = {(op.type, int(op.attrs["__uid__"])): 1e-4
                for op in block.ops}
    t = tattr.table_from_scopes(block, by_scope, batch_size=4,
                                chip="cpu-host", unattributed_s=2e-3)
    assert t["n_ops"] == len(block.ops)
    assert [r["index"] for r in t["rows"][:-1]] == list(range(len(block.ops)))
    last = t["rows"][-1]
    assert last["op_type"] == tattr.UNATTRIBUTED and last["index"] == -1
    assert t["total_s"] == pytest.approx(len(block.ops) * 1e-4 + 2e-3)
    assert t["coverage"] == pytest.approx(len(block.ops) * 1e-4 / t["total_s"])
    assert tattr.UNATTRIBUTED not in t["by_type"]
    row = tattr.artifact_row(t, "gpt")
    assert row["metric"] == "op_attribution_gpt"
    assert row["op_table"][-1]["uid"] == -1


# -- the segment walk and the capture on the CPU ----------------------------------


def _tiny_gpt():
    from paddle_tpu_torch.models import transformer

    loss = transformer.build_lm_train_program(
        seq_len=8, vocab_size=40, dim=16, n_layers=1, n_heads=2,
        dtype="float32", learning_rate=1e-3)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    rng = np.random.RandomState(0)
    toks = rng.randint(0, 40, (2, 8, 1)).astype(np.int64)
    return loss, tfluid.default_main_program(), exe, {
        "tokens": toks, "targets": np.roll(toks, -1, 1)}


def test_segment_walk_times_every_op_and_leaves_the_scope():
    loss, main, exe, feed = _tiny_gpt()
    scope = tfluid.global_scope()
    before = {n: scope.find(n).clone() for n in ("embedding_0.w_0",)
              if scope.find(n) is not None}
    t = tattr.attribute_cpu(main, feed, batch_size=2, chip="cpu-host",
                            repeats=2, place=tfluid.CPUPlace())
    assert t["mode"] == "cpu-oracle" and t["repeats"] == 2
    assert t["n_ops"] == len(main.global_block().ops)
    assert 0.5 < t["coverage"] <= 1.0
    for n, v in before.items():
        assert bool((scope.find(n) == v).all())
    tattr.publish(t, "tiny")
    snap = tobs.REGISTRY.snapshot()["families"]
    assert snap["op_attribution_coverage"]["series"][0]["value"] == \
        pytest.approx(t["coverage"])


def test_capture_profile_on_the_cpu_rows_every_op(tmp_path):
    loss, main, exe, feed = _tiny_gpt()
    assert not tattr.enabled()
    cap = tattr.capture_profile(
        lambda i: exe.run(main, feed=feed, fetch_list=[loss]),
        str(tmp_path), steps=2, place=tfluid.CPUPlace())
    assert not tattr.enabled()  # restored
    assert cap["mode"] == "profile-cpu" and cap["steps"] == 2
    assert os.path.exists(cap["trace_file"])
    t = tattr.table_from_scopes(main.global_block(), cap["by_scope"],
                                batch_size=2, chip="cpu-host",
                                mode=cap["mode"])
    assert t["n_ops"] == len(main.global_block().ops)
    assert t["coverage"] == 1.0


def _ev(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1, "args": args}


def test_trace_parser_attributes_device_time_by_launch():
    """Kernels go to the op range whose interval holds their launch
    (correlation id) — on any thread; nested ranges fold into the
    outermost; a launch outside every range is unattributed."""
    evs = [
        _ev("pdop__mul__u4", "user_annotation", 100, 50),
        _ev("pdop__relu__u9", "user_annotation", 110, 5),  # nested
        _ev("pdop__generic_grad__u4", "user_annotation", 200, 100),
        _ev("pdop__mul__u4", "gpu_user_annotation", 0, 999),
        _ev("cudaLaunchKernel", "cuda_runtime", 105, 1, correlation=1),
        _ev("cudaLaunchKernel", "cuda_runtime", 112, 1, correlation=2),
        dict(_ev("cudaLaunchKernel", "cuda_runtime", 250, 1,
                 correlation=3), tid=2),  # autograd's device thread
        _ev("cudaLaunchKernel", "cuda_runtime", 400, 1, correlation=4),
        _ev("gemm", "kernel", 106, 30, correlation=1),
        _ev("relu_k", "kernel", 140, 10, correlation=2),
        _ev("flash_dq_mma_kernel", "kernel", 260, 40, correlation=3),
        _ev("Memcpy HtoD", "gpu_memcpy", 401, 8, correlation=4),
    ]
    p = tattr.parse_trace_events(evs, device=True)
    assert p["by_scope"] == {("mul", 4): pytest.approx(40e-6),
                             ("generic_grad", 4): pytest.approx(40e-6)}
    assert p["kernels_by_scope"][("generic_grad", 4)] == {
        "flash_dq_mma_kernel": pytest.approx(40e-6)}
    assert p["unattributed_s"] == pytest.approx(8e-6)
    assert p["device_total_s"] == pytest.approx(88e-6)
    host = tattr.parse_trace_events(evs, device=False)
    assert host["by_scope"][("mul", 4)] == pytest.approx(50e-6)


# -- calibration ----------------------------------------------------------------


SAMPLES = {
    "ratio_two": [(1e-5, 3e-5), (2e-5, 5e-5)],
    "affine": [(1e-6, 5e-5), (1e-5, 6e-5), (1e-4, 1.5e-4), (1e-3, 1.05e-3)],
    "no_spread": [(1e-5, 2e-5)] * 4,
    "negative_slope": [(1e-6, 9e-5), (1e-5, 5e-5), (1e-4, 1e-5)],
    "clamped": [(1e-9, 1.0), (2e-9, 1.0), (3e-9, 1.0)],
}


@pytest.mark.parametrize("case", sorted(SAMPLES))
def test_fit_affine_equals_jax(case):
    got = tcal._fit_affine(SAMPLES[case])
    want = jcal._fit_affine(SAMPLES[case])
    _close(list(got), list(want))


def test_store_helpers_equal_jax():
    assert tcal.factor_key("mul", None) == jcal.factor_key("mul", None)
    assert tcal.factor_key("mul", "bfloat16") == \
        jcal.factor_key("mul", "bfloat16")
    for f in (0.0, 1e-9, 3.0, 1e9):
        assert tcal.clamp(f) == jcal.clamp(f)
    assert tcal.SCHEMA == jcal.SCHEMA


def test_store_round_trip_chip_keys_and_corrupt_eviction(tmp_path):
    st = tcal.CalibrationStore(str(tmp_path))
    obs = [{"op_type": "mul", "dtype": "float32", "measured_s": 2e-5,
            "predicted_s": 1e-5}]
    st.update("h100-sxm", obs)
    fresh = tcal.CalibrationStore(str(tmp_path))
    assert fresh.factor("h100-sxm", "mul", "float32") == 2.0
    assert fresh.factors("cpu-host") == {}  # another chip: a miss
    # the JAX package reads the same sealed file
    assert jcal.CalibrationStore(str(tmp_path)).factor(
        "h100-sxm", "mul", "float32") == 2.0
    path = os.path.join(str(tmp_path), "h100-sxm.calib")
    with open(path, "r+b") as f:
        f.seek(20)
        f.write(b"\x00\x01")
    assert tcal.CalibrationStore(str(tmp_path)).factors("h100-sxm") == {}
    assert not os.path.exists(path)


def test_default_store_root(monkeypatch, tmp_path):
    monkeypatch.delenv("PADDLE_TPU_CALIBRATION_CACHE", raising=False)
    root = tcal.default_store().root
    assert root == os.path.join(os.path.dirname(tfluid.__file__), "_cache",
                                "calibration")
    monkeypatch.setenv("PADDLE_TPU_CALIBRATION_CACHE", str(tmp_path))
    assert tcal.default_store().root == str(tmp_path)


@pytest.mark.parametrize("name", ["gpt_train", "resnet18_train"])
def test_calibrated_costs_equal_jax(name, tmp_path, monkeypatch):
    """The same attribution rows feed one store (both packages read the
    same sealed file); program_cost and step_loop_cost then agree."""
    (_, jp), (_, tp) = _pair(name)
    m = _measured(len(tp.global_block().ops), seed=5)
    table = tattr.build_table(tp.global_block(), m, sum(x for x in m if x),
                              batch_size=4, chip="cpu-host")
    monkeypatch.setenv("PADDLE_TPU_CALIBRATION_CACHE", str(tmp_path))
    store = tcal.CalibrationStore(str(tmp_path))
    assert store.record_attribution(table) is not None
    for cal in (True, None, store):
        got = tcost.program_cost(tp, 4, chip="cpu-host", calibration=cal)
        want = jcost.program_cost(jp, 4, chip="cpu-host", calibration=True)
        assert got["calibration"]["factors_applied"] > 0
        _close(got, want)
    for k in (1, 4):
        _close(tcost.step_loop_cost(tp, k, 4, chip="cpu-host",
                                    calibration=store),
               jcost.step_loop_cost(jp, k, 4, chip="cpu-host",
                                    calibration=True))
    raw = tcost.program_cost(tp, 4, chip="cpu-host", calibration=False)
    assert "calibrated_step_time_s" not in raw
    monkeypatch.setenv("PADDLE_TPU_CALIBRATION", "0")
    assert "calibrated_step_time_s" not in tcost.program_cost(
        tp, 4, chip="cpu-host")


def test_calibration_true_reads_the_default_store(tmp_path, monkeypatch):
    """calibration=True prices through the default store: raw alone while
    the store is empty, calibrated once it holds this chip's factors."""
    (_, tp) = _pair("mlp_train")[1]
    monkeypatch.setenv("PADDLE_TPU_CALIBRATION_CACHE", str(tmp_path))
    rep = tcost.program_cost(tp, 8, chip="cpu-host", calibration=True)
    assert "calibrated_step_time_s" not in rep
    tcal.default_store().update("cpu-host", [
        {"op_type": op.type, "dtype": "float32", "measured_s": 1e-4,
         "predicted_s": 1e-6} for op in tp.global_block().ops])
    rep = tcost.program_cost(tp, 8, chip="cpu-host", calibration=True)
    assert rep["calibrated_step_time_s"] > rep["predicted_step_time_s"]
    assert tcost.step_loop_cost(tp, 2, 8, chip="cpu-host",
                                calibration=True)["step_source"] == \
        "calibrated"
