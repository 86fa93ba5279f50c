"""The port's analysis tier against the JAX package's on the CPU: dataflow,
the memory estimate, the cost model, the verifier's rule catalog and
findings, the equivalence engine, the batch-norm fold's contract,
``Executor.run(verify=)``, the tracer, and the ``lint``/``analyze``/
``diff`` subcommands.

Both packages build the same descs from their own layer code; every
comparison is on those descs: dataflow results, byte and FLOP counts and
findings exactly, predicted times within 1e-12 relative under one chip
spec (``cpu-host``), canonical forms as JSON bytes, CLI output as text."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import cli as jcli
from paddle_tpu.analysis import contracts as jcontracts
from paddle_tpu.analysis import cost as jcost
from paddle_tpu.analysis import dataflow as jdataflow
from paddle_tpu.analysis import equivalence as jeq
from paddle_tpu.analysis import memory as jmemory
from paddle_tpu.analysis import verifier as jverifier
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu_torch import cli as tcli
from paddle_tpu_torch.analysis import contracts as tcontracts
from paddle_tpu_torch.analysis import cost as tcost
from paddle_tpu_torch.analysis import dataflow as tdataflow
from paddle_tpu_torch.analysis import equivalence as teq
from paddle_tpu_torch.analysis import memory as tmemory
from paddle_tpu_torch.analysis import verifier as tverifier
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.observability import TRACER

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_srl import srl_net  # noqa: E402

KERNEL_ACTS = {"gate_activation": "sigmoid", "cell_activation": "tanh",
               "candidate_activation": "tanh"}


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    yield


# -- the programs both packages build ----------------------------------------


def _mlp(f, train=True):
    x = f.layers.data(name="x", shape=[4])
    y = f.layers.data(name="y", shape=[1])
    h = f.layers.fc(input=x, size=8, act="relu")
    pred = f.layers.fc(input=h, size=1)
    cost = f.layers.mean(f.layers.square_error_cost(pred, y))
    if train:
        f.optimizer.SGD(learning_rate=0.01).minimize(cost)
    return cost, f.default_main_program()


def _gpt(f, transformer):
    f.reset()
    loss = transformer.build_lm_train_program(
        seq_len=16, vocab_size=50, dim=32, n_layers=2, n_heads=2,
        dtype="float32", learning_rate=1e-3)
    return loss, f.default_main_program()


def _gpt_forward(f, transformer):
    f.reset()
    lm = transformer.DecoderLM(50, 32, 2, 2, max_len=16, dtype="float32")
    logits = lm.logits(f.layers.data("tokens", shape=[16, 1],
                                     dtype="int64"))
    return logits, f.default_main_program()


def _resnet18(f, resnet):
    f.reset()
    loss = resnet.build_train_program(
        batch_size=4, depth=18, class_dim=10, image_shape=(3, 32, 32),
        dtype="float32", learning_rate=0.001, layout="NHWC", fuse_bn=True)
    return loss, f.default_main_program()


def _srl(f):
    f.reset()
    net = srl_net(f, 200, 16, 2, KERNEL_ACTS)
    return net["cost"], f.default_main_program()


PROGRAMS = {
    "mlp_train": (lambda: (jfluid.reset(), _mlp(jfluid))[1],
                  lambda: (tfluid.reset(), _mlp(tfluid))[1]),
    "mlp_forward": (lambda: (jfluid.reset(), _mlp(jfluid, False))[1],
                    lambda: (tfluid.reset(), _mlp(tfluid, False))[1]),
    "gpt_train": (lambda: _gpt(jfluid, jtransformer),
                  lambda: _gpt(tfluid, ttransformer)),
    "gpt_forward": (lambda: _gpt_forward(jfluid, jtransformer),
                    lambda: _gpt_forward(tfluid, ttransformer)),
    "resnet18_train": (lambda: _resnet18(jfluid, jresnet),
                       lambda: _resnet18(tfluid, tresnet)),
    "srl_train": (lambda: _srl(jfluid), lambda: _srl(tfluid)),
}
_BUILT = {}


def _pair(name):
    """((jax fetch, jax program), (port fetch, port program)), built once
    a module; the programs are never mutated by the tests that share
    them."""
    if name not in _BUILT:
        jb, tb = PROGRAMS[name]
        _BUILT[name] = (jb(), tb())
    return _BUILT[name]


def _remat(program):
    """A copy of `program` with every grad op marked for remat (the mark
    the JAX package's memory_optimize sets)."""
    p = type(program).from_json(program.to_json())
    for op in p.global_block().ops:
        if op.type == "generic_grad":
            op.attrs["__remat__"] = True
    return p


# -- dataflow -----------------------------------------------------------------

DATAFLOW = ("def_use", "dependency_graph", "happens_before", "hazards",
            "var_intervals", "state_classes")


@pytest.mark.parametrize("fn", DATAFLOW)
@pytest.mark.parametrize("prog", ["gpt_train", "resnet18_train",
                                  "srl_train"])
def test_dataflow_equals_jax(prog, fn):
    (_, jp), (_, tp) = _pair(prog)
    got = getattr(tdataflow, fn)(tp.global_block())
    want = getattr(jdataflow, fn)(jp.global_block())
    assert got == want


@pytest.mark.parametrize("prog", ["gpt_train", "resnet18_train",
                                  "srl_train"])
def test_forward_closure_equals_jax(prog):
    (_, jp), (_, tp) = _pair(prog)
    params = [p.name for p in jp.global_block().all_parameters()][:3]
    for name in params:
        assert tdataflow.forward_closure(
            tp.global_block(), {name}, stop_types=("generic_grad",)) == \
            jdataflow.forward_closure(jp.global_block(), {name},
                                      stop_types=("generic_grad",))


# -- the memory estimate ------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("infer", [False, True])
@pytest.mark.parametrize("prog", list(PROGRAMS))
def test_peak_estimate_equals_jax(prog, infer, remat):
    (_, jp), (_, tp) = _pair(prog)
    if remat:
        jp, tp = _remat(jp), _remat(tp)
    for bs in (8, 64):
        got = tmemory.peak_estimate(tp, batch_size=bs, infer_shapes=infer)
        want = jmemory.peak_estimate(jp, batch_size=bs, infer_shapes=infer)
        assert got == want
    for donate in (False,):
        assert tmemory.peak_estimate(tp, 8, donate=donate,
                                     infer_shapes=infer) == \
            jmemory.peak_estimate(jp, 8, donate=donate, infer_shapes=infer)


@pytest.mark.parametrize("prog", ["gpt_train", "resnet18_train"])
def test_abstract_sizes_equal_jax(prog):
    (_, jp), (_, tp) = _pair(prog)
    assert tmemory.abstract_sizes(tp, 0, 4) == \
        jmemory.abstract_sizes(jp, 0, 4)


def test_memory_fits_and_render_equal_jax():
    (_, jp), (_, tp) = _pair("gpt_train")
    got = tmemory.peak_estimate(tp, 8)
    want = jmemory.peak_estimate(jp, 8)
    assert tmemory.render(got) == jmemory.render(want)
    total = got["total_peak_bytes"]
    for budget in (total, int(total / 0.9) + 1, total - 1):
        assert tmemory.fits(got, budget) == jmemory.fits(want, budget)


def test_memory_plan_raises_naming_the_queue_item():
    """Per-shard accounting (once refused, ported with the sharding tier):
    a plan of bare specs and one of the dp mode's NamedShardings price as
    the JAX package's do."""
    (_, jp), (_, tp) = _pair("mlp_train")
    bare = {"x": ("dp",), "fc_0.w_0": ("dp", None)}
    assert tmemory.peak_estimate(tp, 8, plan=bare) == \
        jmemory.peak_estimate(jp, 8, plan=bare)
    assert tmemory.shard_divisor(("dp",)) == jmemory.shard_divisor(("dp",))
    assert tmemory.shard_divisor(None) == 1
    from paddle_tpu.parallel import ParallelExecutor as JPE
    from paddle_tpu_torch.parallel import ParallelExecutor as TPE
    from paddle_tpu_torch.parallel.mesh import make_mesh

    jplan = JPE(axes={"dp": 8}, fsdp_params=True).static_plan(jp)
    tplan = TPE(mesh=make_mesh({"dp": 8}, devices=[torch.device("cpu")] * 8),
                fsdp_params=True).static_plan(tp)
    got = tmemory.peak_estimate(tp, 8, plan=tplan)
    assert got == jmemory.peak_estimate(jp, 8, plan=jplan)
    assert got["per_shard"] and tmemory.shard_divisor(
        tplan["fc_0.w_0"]) == jmemory.shard_divisor(jplan["fc_0.w_0"])


# -- the cost model -----------------------------------------------------------


@pytest.mark.parametrize("prog", list(PROGRAMS))
def test_op_cost_equals_jax(prog):
    (_, jp), (_, tp) = _pair(prog)
    jb, tb = jp.global_block(), tp.global_block()
    for jop, top in zip(jb.ops, tb.ops):
        assert tcost.op_cost(tb, top, 8) == jcost.op_cost(jb, jop, 8), \
            top.type


def _close(got, want, path=""):
    """Equal, except floats within 1e-12 relative."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-12, abs=0), path
    else:
        assert got == want, path


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("prog", list(PROGRAMS))
def test_program_cost_equals_jax(prog, remat):
    (_, jp), (_, tp) = _pair(prog)
    if remat:
        jp, tp = _remat(jp), _remat(tp)
    for bs in (8, 64):
        got = tcost.program_cost(tp, bs, chip="cpu-host", calibration=False)
        want = jcost.program_cost(jp, bs, chip="cpu-host",
                                  calibration=False)
        _close(got, want)
        assert tcost.render(got) == jcost.render(want)


def test_step_loop_cost_and_comm_fold_equal_jax():
    (_, jp), (_, tp) = _pair("gpt_train")
    for k in (1, 4):
        _close(tcost.step_loop_cost(tp, k, 8, chip="cpu-host",
                                    calibration=False),
               jcost.step_loop_cost(jp, k, 8, chip="cpu-host",
                                    calibration=False))
    comm = {"comm_time_s": 3e-3, "collective_bytes": 4096,
            "per_kind": {"all_reduce": {"count": 2, "bytes": 4096}}}
    for devices in (1, 8):
        _close(tcost.roofline_with_comm(
            tcost.program_cost(tp, 8, chip="cpu-host", calibration=False),
            comm, devices),
            jcost.roofline_with_comm(
                jcost.program_cost(jp, 8, chip="cpu-host",
                                   calibration=False), comm, devices))


def test_chip_table_is_the_ports_own(monkeypatch):
    h100 = tcost.chip_spec("h100-sxm")
    assert h100["flops_bf16"] == 989e12 and h100["hbm_gbps"] == 3350.0
    assert h100["hbm_gib"] * 2**30 == pytest.approx(80e9)
    # f32 runs 3xTF32: a third of the 495 TFLOP/s TF32 rate
    assert tcost.dtype_rate(h100, "float32") * 989e12 == pytest.approx(165e12)
    assert tcost.dtype_rate(tcost.chip_spec("cpu-host"), "float32") == 0.5
    assert set(tcost.CHIP_SPECS) == {"h100-sxm", "cpu-host"}
    assert set(tcost.DEFAULT_DISPATCH_OVERHEAD_S) == set(tcost.CHIP_SPECS)
    assert tcost.DEFAULT_DISPATCH_OVERHEAD_S["h100-sxm"] > 0
    monkeypatch.delenv("PADDLE_TPU_CHIP", raising=False)
    assert tcost.chip_spec()["chip"] == "h100-sxm"
    monkeypatch.setenv("PADDLE_TPU_CHIP", "cpu-host")
    assert tcost.chip_spec()["chip"] == "cpu-host"
    with pytest.raises(ValueError, match="unknown chip"):
        tcost.chip_spec("v5e")
    assert tcost.detect_chip() == "cpu-host"  # no card here


# -- the verifier -------------------------------------------------------------


def test_rule_catalog_equals_jax():
    assert list(tverifier.RULES) == list(jverifier.RULES)
    for rid, rule in jverifier.RULES.items():
        got = tverifier.RULES[rid]
        assert (got.id, got.title, got.severity, got.doc) == \
            (rule.id, rule.title, rule.severity, rule.doc)


def _key(report):
    return [(f.rule, f.severity, f.block, f.op, f.var)
            for f in report.findings]


def _first_mul_out(block):
    return next(op for op in block.ops if op.type == "mul").output_names()[0]


def _use_before_def(f, cost, prog):
    block = prog.global_block()
    op0 = next(op for op in block.ops if op.type == "mul")
    block.ops.remove(op0)
    block.ops.append(op0)
    return dict(feed_names=["x", "y"], fetch_names=[cost.name],
                check_shapes=False)


def _unregistered(f, cost, prog):
    prog.global_block().append_op("totally_bogus_op",
                                  outputs={"Out": ["z"]})
    return dict(check_shapes=False)


def _dangling(f, cost, prog):
    return dict(feed_names=["nope"], fetch_names=["also_nope"],
                check_shapes=False)


def _bad_sub_block(f, cost, prog):
    prog.global_block().append_op("while", inputs={}, outputs={},
                                  attrs={"sub_block": 42})
    return dict(check_shapes=False)


def _duplicate_write(f, cost, prog):
    block = prog.global_block()
    block.append_op("fill_constant", outputs={"Out": [_first_mul_out(block)]},
                    attrs={"shape": [1], "value": 0.0, "dtype": "float32"})
    return dict(feed_names=["x", "y"], fetch_names=[cost.name],
                check_shapes=False)


def _missing_grad(f, cost, prog):
    block = prog.global_block()
    gname = "fc_0.w_0@GRAD"
    drop = [i for i, op in enumerate(block.ops)
            if gname in op.output_names()
            or (op.type == "sgd" and "fc_0.w_0" in op.inputs["Param"])]
    block.ops[:] = [op for i, op in enumerate(block.ops) if i not in drop]
    return dict(feed_names=["x", "y"], fetch_names=[cost.name],
                check_shapes=False)


def _dead_op(f, cost, prog):
    block = prog.global_block()
    block.create_var(name="orphan", shape=(1,), dtype="float32")
    block.append_op("fill_constant", outputs={"Out": ["orphan"]},
                    attrs={"shape": [1], "value": 1.0, "dtype": "float32"})
    return dict(feed_names=["x", "y"], fetch_names=[cost.name],
                check_shapes=False)


def _suppressed(f, cost, prog):
    _duplicate_write(f, cost, prog)
    prog.global_block().ops[-1].attrs["__verify_suppress__"] = \
        "PTV007,PTV008"
    return dict(feed_names=["x", "y"], fetch_names=[cost.name],
                check_shapes=False, suppress={"PTV010"})


def _donated_race(f, cost, prog):
    prog.global_block().append_op(
        "fill_constant", outputs={"Out": ["fc_0.w_0"]},
        attrs={"shape": [4, 8], "value": 0.0, "dtype": "float32"})
    return dict(feed_names=["x", "y"], fetch_names=[cost.name],
                check_shapes=False)


def _duplicated_subgraph(f, cost, prog):
    blk = prog.global_block()
    mul_i, mul = next((i, op) for i, op in enumerate(blk.ops)
                      if op.type == "mul")
    blk.create_var(name="dup_out", shape=(-1, 8), dtype="float32")
    blk.append_op("mul", inputs={k: list(v) for k, v in mul.inputs.items()},
                  outputs={"Out": ["dup_out"]}, attrs=dict(mul.attrs))
    blk.append_op("print", inputs={"In": ["dup_out"]}, outputs={},
                  attrs={"message": "dup", "first_n": -1,
                         "summarize": -1})
    save_op = blk.ops.pop()
    dup_op = blk.ops.pop()
    blk.ops.insert(mul_i + 1, save_op)
    blk.ops.insert(mul_i + 1, dup_op)
    return dict(feed_names=["x", "y"], fetch_names=[cost.name],
                check_shapes=False)


def _clean(f, cost, prog):
    return dict(feed_names=["x", "y"], fetch_names=[cost.name])


MUTATIONS = {"clean": _clean, "ptv001": _use_before_def,
             "ptv002": _unregistered, "ptv003_004": _dangling,
             "ptv005": _bad_sub_block, "ptv007": _duplicate_write,
             "ptv009": _missing_grad, "ptv010": _dead_op,
             "suppressed": _suppressed, "ptv015": _donated_race,
             "ptv023": _duplicated_subgraph}


@pytest.mark.parametrize("case", list(MUTATIONS))
def test_findings_on_broken_programs_equal_jax(case):
    jfluid.reset()
    jc, jp = _mlp(jfluid)
    tc, tp = _mlp(tfluid)
    jkw = MUTATIONS[case](jfluid, jc, jp)
    tkw = MUTATIONS[case](tfluid, tc, tp)
    got = tverifier.verify_program(tp, **tkw)
    want = jverifier.verify_program(jp, **jkw)
    assert _key(got) == _key(want)
    assert got.render() == want.render()
    if case not in ("clean", "suppressed"):
        assert got.findings


def test_shape_mismatch_ptv006_equals_jax():
    def build(f):
        f.layers.data(name="x", shape=[4])
        block = f.default_main_program().global_block()
        block.create_var(name="bad", shape=(3, 3), dtype="float32")
        block.create_var(name="bad_dtype", shape=(-1, 4), dtype="int32")
        block.append_op("scale", inputs={"X": ["x"]},
                        outputs={"Out": ["bad"]}, attrs={"scale": 2.0})
        block.append_op("scale", inputs={"X": ["x"]},
                        outputs={"Out": ["bad_dtype"]}, attrs={"scale": 2.0})
        return f.default_main_program()

    jfluid.reset()
    want = jverifier.verify_program(build(jfluid), feed_names=["x"],
                                    fetch_names=["bad", "bad_dtype"])
    got = tverifier.verify_program(build(tfluid), feed_names=["x"],
                                   fetch_names=["bad", "bad_dtype"])
    assert [f for f in _key(got) if f[0] == "PTV006"] == \
        [f for f in _key(want) if f[0] == "PTV006"] != []
    assert got.render() == want.render()


@pytest.mark.parametrize("prog", list(PROGRAMS))
def test_clean_programs_verify_as_jax(prog):
    (_, jp), (_, tp) = _pair(prog)
    got = tverifier.verify_program(tp, batch_size=2)
    want = jverifier.verify_program(jp, batch_size=2)
    assert _key(got) == _key(want) and not got.errors


def test_meta_walk_matches_the_declared_shapes():
    """The oracle runs each emitter on meta tensors: a kernel wrapper
    takes its plain version there, and nothing is computed."""
    (_, tp) = _pair("gpt_train")[1]
    env, findings = tverifier.abstract_walk(tp, 0, 2)
    assert not findings
    vals = [v for v in env.values() if v is not tverifier._UNKNOWN]
    assert vals and all(v.device.type == "meta" for v in vals)


def test_an_emitter_that_reads_the_host_poisons_its_outputs(monkeypatch):
    """An emitter that reads a value on the host (here ``.item()``)
    raises on meta tensors: its outputs, and those of every op reading
    them, are unknown, and no finding is guessed for them."""
    from paddle_tpu_torch.ops import registry

    info = registry.get_op_info("scale")
    emit = info.emit

    def host_read(ctx, ins, attrs):
        if float(ins["X"][0].sum().item()) > 1e30:
            raise AssertionError("unreachable")
        return emit(ctx, ins, attrs)

    monkeypatch.setattr(info, "emit", host_read)
    x = tfluid.layers.data(name="x", shape=[4])
    s = tfluid.layers.scale(x, scale=2.0)
    r = tfluid.layers.relu(s)
    block = tfluid.default_main_program().global_block()
    block.var(r.name).shape = (3, 3)  # a mismatch nothing can see now
    env, findings = tverifier.abstract_walk(tfluid.default_main_program())
    assert env[s.name] is tverifier._UNKNOWN
    assert env[r.name] is tverifier._UNKNOWN
    assert env["x"].device.type == "meta"
    assert findings == []


def test_plan_raises_naming_the_queue_item():
    """A plan (once refused) arms PTV016 and PTV018-PTV021: the findings
    equal the JAX package's; with those rules off a plan is harmless."""
    (_, jp), (_, tp) = _pair("mlp_train")

    def rules(rep):
        return sorted((f.rule, f.var, f.message) for f in rep.findings)

    for plan in ({"fc_0.w_0": ("dp",)}, {"fc_0.w_0": ("dp", "dp")}):
        assert rules(tverifier.verify_program(tp, plan=plan)) == \
            rules(jverifier.verify_program(jp, plan=plan))
    assert any(f.rule == "PTV018" for f in tverifier.verify_program(
        tp, plan={"fc_0.w_0": ("dp", "dp")}).findings)
    rep = tverifier.verify_program(
        tp, plan={"fc_0.w_0": ("dp",)},
        suppress={"PTV016", "PTV018", "PTV019", "PTV020", "PTV021"})
    assert not rep.errors


def test_env_verify_enabled(monkeypatch):
    for value, want in (("", False), ("0", False), ("1", True)):
        monkeypatch.setenv("PADDLE_TPU_VERIFY", value)
        assert tverifier.env_verify_enabled() == \
            jverifier.env_verify_enabled() == want


# -- Executor.run(verify=) ---------------------------------------------------


def _feed():
    rng = np.random.RandomState(0)
    return {"x": rng.rand(4, 4).astype(np.float32),
            "y": rng.rand(4, 1).astype(np.float32)}


def test_executor_run_verify_kwarg():
    cost, prog = _mlp(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program(), verify=True)
    (loss,) = exe.run(feed=_feed(), fetch_list=[cost], verify=True)
    assert np.isfinite(float(np.asarray(loss).ravel()[0]))
    prog.global_block().append_op("bogus_xyz", outputs={"Out": ["zz"]})
    with pytest.raises(tverifier.VerificationError, match="PTV002"):
        exe.run(feed=_feed(), fetch_list=[cost], verify=True)
    with pytest.raises(tverifier.VerificationError):
        exe.run(feed={k: np.stack([v, v]) for k, v in _feed().items()},
                fetch_list=[cost], verify=True, steps_per_dispatch=2)


def test_executor_env_gate(monkeypatch):
    cost, prog = _mlp(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    prog.global_block().append_op("bogus_xyz", outputs={"Out": ["zz"]})
    monkeypatch.setenv("PADDLE_TPU_VERIFY", "1")
    with pytest.raises(tverifier.VerificationError):
        exe.run(feed=_feed(), fetch_list=[cost])


# -- equivalence --------------------------------------------------------------


@pytest.mark.parametrize("prog", list(PROGRAMS))
def test_canonical_forms_equal_jax_as_json(prog):
    (jc, jp), (tc, tp) = _pair(prog)
    jc = jc[0] if isinstance(jc, tuple) else jc
    for fetch in (None, [jc.name]):
        ca, ia = jeq.canonicalize(jp, fetch, None)
        cb, ib = teq.canonicalize(tp, fetch, None)
        assert cb.to_json() == ca.to_json()
        assert (ib.dead_removed, ib.renamed, ib.duplicates,
                ib.op_hashes) == (ia.dead_removed, ia.renamed,
                                  ia.duplicates, ia.op_hashes)
    assert [f.format() for f in teq.duplicate_findings(tp)] == \
        [f.format() for f in jeq.duplicate_findings(jp)]


def _drop_mean(f, prog):
    mut = type(prog).from_json(prog.to_json())
    blk = mut.global_block()
    blk.ops.pop(next(i for i, op in enumerate(blk.ops) if op.type == "mean"))
    return mut


def _swap_sub(f, prog):
    mut = type(prog).from_json(prog.to_json())
    sub = next(op for op in mut.global_block().ops
               if op.type == "elementwise_sub")
    sub.inputs["X"], sub.inputs["Y"] = sub.inputs["Y"], sub.inputs["X"]
    return mut


def _swap_add(f, prog):
    mut = type(prog).from_json(prog.to_json())
    add = next(op for op in mut.global_block().ops
               if op.type == "elementwise_add"
               and op.inputs["X"] and op.inputs["Y"])
    add.inputs["X"], add.inputs["Y"] = add.inputs["Y"], add.inputs["X"]
    return mut


REWRITES = {"identity": lambda f, p: type(p).from_json(p.to_json()),
            "dropped_op": _drop_mean, "swapped_sub": _swap_sub,
            "swapped_add": _swap_add}


@pytest.mark.parametrize("rewrite", list(REWRITES))
def test_equivalence_verdicts_equal_jax(rewrite):
    jfluid.reset()
    jc, jp = _mlp(jfluid)
    tc, tp = _mlp(tfluid)
    want = jeq.prove_equivalent(jp, REWRITES[rewrite](jfluid, jp),
                                feed_names=["x", "y"],
                                fetch_names=[jc.name])
    got = teq.prove_equivalent(tp, REWRITES[rewrite](tfluid, tp),
                               feed_names=["x", "y"], fetch_names=[tc.name])
    assert (got.equivalent, got.tier) == (want.equivalent, want.tier)
    assert sorted(f.rule for f in got.findings) == \
        sorted(f.rule for f in want.findings)
    assert (got.diff.render() if got.diff else None) == \
        (want.diff.render() if want.diff else None)


def test_perturbed_weight_is_a_differential_counterexample():
    cost, prog = _mlp(tfluid)
    sa, sb = tfluid.Scope(), tfluid.Scope()
    w = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    sa.set("fc_0.w_0", w)
    w2 = np.array(w)
    w2[0, 0] += 0.5
    sb.set("fc_0.w_0", w2)
    proof = teq.prove_equivalent(prog, prog, feed_names=["x", "y"],
                                 fetch_names=[cost.name], scope_before=sa,
                                 scope_after=sb, execute="always")
    assert not proof.equivalent and proof.tier == "differential"
    assert any(f.rule == "PTV024" for f in proof.findings), proof.render()
    proof2 = teq.prove_equivalent(prog, prog, feed_names=["x", "y"],
                                  fetch_names=[cost.name], scope_before=sa,
                                  scope_after=sa, execute="always")
    assert proof2.equivalent


def test_differential_run_feeds_equal_jax():
    jfluid.reset()
    _, jp = _mlp(jfluid)
    _, tp = _mlp(tfluid)
    a = jeq.build_feeds(jp, ["x", "y"], batch_size=3, seed=5)
    b = teq.build_feeds(tp, ["x", "y"], batch_size=3, seed=5)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_loop_parity_report_is_proven():
    """On the CPU a fused dispatch walks its steps in sequence (no graph
    to replay), so this holds the stacking, the stacked fetches and the
    rng_step offsets, and the report's cases to the JAX package's."""
    rep = teq.loop_parity_report(ks=(1, 2), batch_size=2,
                                 place=tfluid.CPUPlace())
    assert rep["verdict"] == "PROVEN", rep["findings"]
    assert rep["models"] == ["mlp", "small_lm"]
    assert rep["device"] == "cpu"
    assert not any(c["replayed"] for c in rep["cases"])
    assert {c["dispatches"] for c in rep["cases"]} == {3}
    jfluid.reset()
    want = jeq.loop_parity_report(ks=(1, 2), batch_size=2)
    assert want["verdict"] == rep["verdict"]
    assert [(c["model"], c["k"], c["fetches"], c["written_state"])
            for c in rep["cases"]] == \
        [(c["model"], c["k"], c["fetches"], c["written_state"])
         for c in want["cases"]]


def test_loop_parity_report_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CPUPlace"):
        teq.loop_parity_report(ks=(1,))


# -- contracts ----------------------------------------------------------------


def _conv_bn(f):
    img = f.layers.data(name="img", shape=[1, 8, 8])
    c = f.layers.conv2d(img, num_filters=4, filter_size=3, bias_attr=False)
    b = f.layers.batch_norm(c, act="relu")
    return f.layers.fc(f.layers.reshape(b, [-1, 4 * 6 * 6]), size=3,
                       act="softmax")


def test_fuse_batch_norm_contract_clean():
    pred = _conv_bn(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    inf = tfluid.default_main_program().clone(for_test=True)
    n = tcontracts.checked_fuse_batch_norm(inf, tfluid.global_scope(),
                                           fetch_names=[pred.name])
    assert n == 1
    rep = tverifier.verify_program(inf, feed_names=["img"],
                                   fetch_names=[pred.name],
                                   check_shapes=False)
    assert not rep.findings, rep.render()


def test_fuse_batch_norm_runs_its_contract_under_the_gate(monkeypatch):
    pred = _conv_bn(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    inf = tfluid.default_main_program().clone(for_test=True)
    calls = []
    real = tcontracts.checked_fuse_batch_norm

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tcontracts, "checked_fuse_batch_norm", spy)
    monkeypatch.setenv("PADDLE_TPU_VERIFY", "1")
    assert tfluid.fuse_batch_norm(inf, tfluid.global_scope(),
                                  fetch_names=[pred.name]) == 1
    assert calls == [1]


def test_a_corrupted_fold_is_refuted(monkeypatch):
    """A fold that writes a wrong filter is a PTV024 counterexample."""
    from paddle_tpu_torch import inference_transpiler as tit

    pred = _conv_bn(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    inf = tfluid.default_main_program().clone(for_test=True)
    real = tit.InferenceTranspiler.transpile

    def corrupt(self, program, scope, block_id=0, fetch_names=()):
        n = real(self, program, scope, block_id, fetch_names=fetch_names)
        conv = next(op for op in program.global_block().ops
                    if op.type == "conv2d")
        w = conv.input("Filter")[0]
        scope.set(w, scope.find(w) * 2.0)
        return n

    monkeypatch.setattr(tit.InferenceTranspiler, "transpile", corrupt)
    with pytest.raises(tverifier.VerificationError, match="PTV024"):
        tcontracts.checked_fuse_batch_norm(inf, tfluid.global_scope(),
                                           fetch_names=[pred.name])


@pytest.mark.parametrize("fn,item", [
    ("checked_distribute_transpile", 11), ("checked_sharding_plan", 11)])
def test_unported_contracts_raise_naming_the_queue_item(fn, item):
    """Both contracts of Queue A item {item} are ported now.
    `checked_distribute_transpile` splits the program as the JAX
    package's does (the same trainer ops, rules and endpoints) and
    refuses an optimizer op that survives the split (PTV014);
    `checked_sharding_plan` returns the transpiler's plan, as the JAX
    package's, spec for spec."""
    (jp, tp) = (p for _, p in _pair("mlp_train"))
    assert hasattr(jcontracts, fn)
    if fn == "checked_distribute_transpile":
        from paddle_tpu.distributed.distribute_transpiler import \
            DistributeTranspiler as JDT
        from paddle_tpu_torch.distributed.distribute_transpiler import \
            DistributeTranspiler as TDT

        eps = "127.0.0.1:1,127.0.0.1:2"
        tt = getattr(tcontracts, fn)(TDT(), 0, program=tp, pservers=eps)
        jt = getattr(jcontracts, fn)(JDT(), 0, program=jp, pservers=eps)
        assert [op.type for op in tp.global_block().ops] == \
            [op.type for op in jp.global_block().ops]
        assert tt.param_endpoint == jt.param_endpoint
        assert {p: {k: v for k, v in c.items() if k != "_lr_var"}
                for p, c in tt.param_cfg.items()} == \
            {p: {k: v for k, v in c.items() if k != "_lr_var"}
             for p, c in jt.param_cfg.items()}
        tt.program.global_block().append_op(
            type="sgd", inputs={"Param": [next(iter(tt.param_cfg))]},
            outputs={}, attrs={})
        with pytest.raises(tverifier.VerificationError, match="PTV014"):
            tcontracts.verify_distribute_result(tt)
        return
    from paddle_tpu.parallel import DistributeTranspiler as JDT
    from paddle_tpu.parallel import make_mesh as jmake
    from paddle_tpu_torch.analysis.sharding import spec_of
    from paddle_tpu_torch.parallel import DistributeTranspiler as TDT
    from paddle_tpu_torch.parallel.mesh import make_mesh

    tmesh = make_mesh({"dp": 8}, devices=[torch.device("cpu")] * 8)
    tplan = getattr(tcontracts, fn)(TDT(), tp, tmesh)
    jplan = getattr(jcontracts, fn)(JDT(), jp, jmake({"dp": 8}))
    assert {n: spec_of(v) for n, v in tplan.items()} == \
        {n: spec_of(v) for n, v in jplan.items()}


# -- tracing ------------------------------------------------------------------


def test_tracer_records_spans_and_resets():
    TRACER.enable()
    try:
        with TRACER.span("outer", a=1):
            with TRACER.span("inner"):
                pass
        TRACER.instant("mark", k=2)
        evs = TRACER.events()
        assert [e["name"] for e in evs] == ["inner", "outer", "mark"]
        assert evs[0]["args"]["depth"] == 1
        from paddle_tpu_torch.observability import tracing

        assert tracing.validate_chrome_trace(TRACER.to_chrome()) == []
        tfluid.reset()
        assert TRACER.events() == []
    finally:
        TRACER.disable()
    assert TRACER.span("off") is tracing.NOOP_SPAN


# -- the CLI ------------------------------------------------------------------


def _jax_saved_model(d):
    """fit_a_line saved by the JAX package (program.json, __model__ when
    the toolchain is there, persistables)."""
    jfluid.reset()
    x = jfluid.layers.data(name="x", shape=[13])
    h = jfluid.layers.fc(input=x, size=8, act="relu")
    pred = jfluid.layers.fc(input=h, size=1)
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(jfluid.default_startup_program())
    jfluid.io.save_inference_model(d, ["x"], [pred], exe)
    return pred.name


def _out(cli, argv, capsys):
    rc = cli.main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["lint", "{d}"], ["lint", "{d}/program.json"],
    ["lint", "{d}", "--no-shapes", "--strict"],
    ["analyze", "{d}", "--chip", "cpu-host"],
    ["analyze", "{d}", "--chip", "cpu-host", "--json", "--batch-size", "8"],
    ["analyze", "{d}", "--chip", "cpu-host", "--no-shapes"],
    ["diff", "{d}"], ["diff", "{d}", "--json"],
    ["diff", "{d}", "{d}/program.json", "--no-exec"],
    ["diff", "{d}", "{d}", "--place", "cpu"]],
    ids=lambda a: "_".join(a).replace("{d}", "m").replace("/", "_"))
def test_cli_output_equals_jax_on_a_jax_saved_model(argv, tmp_path, capsys):
    d = str(tmp_path / "model")
    _jax_saved_model(d)
    argv = [a.format(d=d) for a in argv]
    jargv = [a for a in argv if a not in ("--place", "cpu")]
    want = _out(jcli, jargv, capsys)
    got = _out(tcli, argv, capsys)
    assert got == want
    assert got[0] == 0


def test_cli_lint_catches_a_dropped_fetch_producer(tmp_path, capsys):
    d = str(tmp_path / "model")
    fetch = _jax_saved_model(d)
    with open(os.path.join(d, "program.json")) as f:
        desc = json.load(f)
    desc["blocks"][0]["ops"] = [
        op for op in desc["blocks"][0]["ops"]
        if fetch not in [n for ns in op["outputs"].values() for n in ns]]
    with open(os.path.join(d, "program.json"), "w") as f:
        json.dump(desc, f)
    model = os.path.join(d, "__model__")
    if os.path.exists(model):
        os.remove(model)
    assert _out(tcli, ["lint", d], capsys) == _out(jcli, ["lint", d], capsys)
    assert tcli.main(["lint", d]) == 1
    with open(model, "wb"):
        pass
    with pytest.raises((ValueError, OSError)):
        tcli.main(["lint", d])


def test_cli_lint_suppress_and_strict(tmp_path, capsys):
    cost, prog = _mlp(tfluid)
    block = prog.global_block()
    block.append_op("fill_constant", outputs={"Out": [_first_mul_out(block)]},
                    attrs={"shape": [1], "value": 0.0, "dtype": "float32"})
    p = str(tmp_path / "prog.json")
    with open(p, "w") as f:
        f.write(prog.to_json())
    assert tcli.main(["lint", p, "--no-shapes"]) == 0
    assert tcli.main(["lint", p, "--no-shapes", "--strict"]) == 1
    assert tcli.main(["lint", p, "--no-shapes", "--strict",
                      "--suppress", "PTV007,PTV008"]) == 0
    out = capsys.readouterr().out
    assert "PTV007" in out and "OK" in out


def test_cli_diff_of_two_models_with_other_weights(tmp_path, capsys):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _jax_saved_model(a)
    _jax_saved_model(b)
    w = np.load(os.path.join(b, "fc_0.w_0.npy"))
    np.save(os.path.join(b, "fc_0.w_0.npy"), w + 0.5)
    got = _out(tcli, ["diff", a, b, "--place", "cpu"], capsys)
    want = _out(jcli, ["diff", a, b], capsys)
    assert got[0] == want[0] == 1
    assert "PTV024" in got[1] and "PTV024" in want[1]


def test_cli_analyze_sharding_exits_naming_the_queue_item(tmp_path, capsys):
    """`analyze --sharding` (once refused): on a JAX-saved model over
    --axes, and on one mode of the catalog, the port prints what the JAX
    package prints; a malformed --axes exits 2."""
    d = str(tmp_path / "model")
    _jax_saved_model(d)
    for argv in (["analyze", d, "--sharding", "--axes", "dp=8", "--chip",
                  "cpu-host", "--batch-size", "8"],
                 ["analyze", "--sharding", "--mode", "dp", "--chip",
                  "cpu-host"]):
        assert _out(tcli, argv, capsys) == _out(jcli, argv, capsys)
    assert tcli.main(["analyze", d, "--sharding", "--axes", "dp"]) == 2
