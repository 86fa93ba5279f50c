"""The port's sharding analyzer (``analysis/sharding.py``), transpiler and
plan tools against the JAX package's on the same descs: logical-axis
resolution, every mode's plan and propagated specs, ``comm_report``
(priced with the JAX package's v5e link rates, ``chip="tpu-v5e"``, so the
two reports compare field for field), the exact collective bytes (dp, mp
vocab, fsdp, pp, hybrid), PTV016 and PTV018-PTV021 findings,
``scaling_curve``, ``mode_plan_equivalence`` 11/11 PROVEN, the per-shard
peak, the checked plan contract, and ``analyze --sharding``'s output.
Everything here is desc-only: equal means equal (no tolerance), except
the float times, held to 1e-12 relative."""

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import cli as jcli
from paddle_tpu.analysis import equivalence as jeq
from paddle_tpu.analysis import memory as jmemory
from paddle_tpu.analysis import sharding as jsh
from paddle_tpu.analysis import verify_program as jverify
from paddle_tpu.parallel import ParallelExecutor as JPE
from paddle_tpu.parallel import ShardingRules as JRules
from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu.parallel import modes as jmodes
from paddle_tpu_torch import cli as tcli
from paddle_tpu_torch.analysis import equivalence as teq
from paddle_tpu_torch.analysis import memory as tmemory
from paddle_tpu_torch.analysis import sharding as tsh
from paddle_tpu_torch.analysis import verify_program as tverify
from paddle_tpu_torch.parallel import ParallelExecutor as TPE
from paddle_tpu_torch.parallel import ShardingRules as TRules
from paddle_tpu_torch.parallel import mesh as tmesh
from paddle_tpu_torch.parallel import modes as tmodes
from paddle_tpu_torch.parallel.transpiler import DistributeTranspiler

CPU = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    yield


def _tmesh(axes):
    return tmesh.make_mesh(axes, devices=CPU[:int(np.prod(list(
        axes.values())))])


def _jpe(**kw):
    return JPE(**kw)


def _tpe(axes, **kw):
    return TPE(mesh=_tmesh(axes), **kw)


def _both(build):
    """build(fluid) in each package (each reset first): ((jout, jprog),
    (tout, tprog))."""
    out = []
    for f in (jfluid, tfluid):
        f.reset()
        got = build(f)
        out.append((got, f.default_main_program()))
    return out


def _spec_map(plan, prog):
    block = prog.global_block()
    out = {}
    for n, sh in plan.items():
        v = block._find_var_recursive(n)
        nd = len(v.shape) if v is not None and v.shape else None
        out[n] = tsh.spec_of(sh, nd)
    return out


def _same_report(t, j):
    """Two comm reports equal but for the chip's name and float noise."""
    t, j = dict(t), dict(j)
    assert t.pop("chip") == "tpu-v5e" and j.pop("chip") == "v5e"
    for k in ("comm_time_s", "ici_time_s", "dcn_time_s"):
        np.testing.assert_allclose(t.pop(k), j.pop(k), rtol=1e-12)
    assert json.loads(json.dumps(t)) == json.loads(json.dumps(j))


def _train_mlp(f, width=8):
    x = f.layers.data(name="x", shape=[4])
    y = f.layers.data(name="y", shape=[1])
    h = f.layers.fc(input=x, size=width, act="relu")
    pred = f.layers.fc(input=h, size=1)
    cost = f.layers.mean(f.layers.square_error_cost(pred, y))
    f.optimizer.SGD(learning_rate=0.01).minimize(cost)
    return cost


# -- logical-axis rules --------------------------------------------------------

def test_logical_to_mesh_axes_resolution_and_fallback():
    rules = [("batch", "dp"), ("vocab", "mp"), ("vocab", "dp"),
             ("embed", None), ("mlp", "mp", 128)]
    cases = [
        (("batch", "embed"), {"dp": 4, "mp": 2}, (8, 16)),
        (("vocab", "embed"), {"dp": 4}, (128, 16)),
        (("vocab", "embed"), {"dp": 4, "mp": 2}, (129, 16)),
        (("embed", "mlp"), {"mp": 2}, (16, 64)),
        (("embed", "mlp"), {"mp": 2}, (16, 256)),
        (("vocab", "vocab"), {"mp": 2, "dp": 2}, (8, 8)),
    ]
    for names, sizes, dims in cases:
        jc, tc = [], []
        assert tsh.logical_to_mesh_axes(
            tsh.AxisNames(*names), rules, sizes, dims, conflicts=tc) == \
            jsh.logical_to_mesh_axes(jsh.AxisNames(*names), rules, sizes,
                                     dims, conflicts=jc)
        assert tc == jc
    assert tsh.standard_logical_axis_rules(zero_dp_states=True) == \
        jsh.standard_logical_axis_rules(zero_dp_states=True)
    assert TRules(fsdp_params=True).logical_rules(
        _tmesh({"dcn_dp": 2, "dp": 4})) == JRules(
        fsdp_params=True).logical_rules(jmesh.make_hybrid_mesh(
            {"dp": 4}, {"dcn_dp": 2}))


# -- every mode: plan, propagated specs, collectives, price -------------------

@pytest.mark.parametrize("name", jmodes.MODE_NAMES)
def test_mode_plan_propagation_and_comm_report_match_jax(name):
    jm, jprog, _ = jmodes.build_mode(name)
    jmesh_, jplan, jprov = jmodes.mode_plan(jm, jprog)
    tm, tprog, _ = tmodes.build_mode(name)
    tmesh_, tplan, tprov = tmodes.mode_plan(tm, tprog)
    assert _spec_map(tplan, tprog) == _spec_map(jplan, jprog)
    assert tprov == jprov
    ja = jsh.propagate(jprog, mesh=jmesh_, plan=jplan, batch_size=8,
                       provenance=jprov)
    ta = tsh.propagate(tprog, mesh=tmesh_, plan=tplan, batch_size=8,
                       provenance=tprov)
    assert ta.specs == ja.specs
    assert [(c.kind, c.axes, c.bytes, c.var, c.phase)
            for c in ta.collectives] == \
        [(c.kind, c.axes, c.bytes, c.var, c.phase) for c in ja.collectives]
    assert ta.per_kind() == ja.per_kind()
    _same_report(tsh.comm_report(ta, chip="tpu-v5e"),
                 jsh.comm_report(ja, chip="v5e"))
    assert tsh.render_comm(tsh.comm_report(ta, chip="cpu-host")) == \
        jsh.render_comm(jsh.comm_report(ja, chip="cpu-host"))


def test_plan_equivalence_proves_all_eleven_modes():
    """The port's rule-driven plans against its own copy of the golden
    archive (never the JAX package's file), and against JAX's sweep."""
    tr = teq.plan_equivalence_report()
    assert [r["verdict"] for r in tr] == ["PROVEN"] * 11
    assert all(r["golden"] for r in tr)
    jr = jeq.plan_equivalence_report()
    assert json.loads(json.dumps(tr)) == json.loads(json.dumps(jr))
    here = os.path.dirname(tmodes.__file__)
    assert os.path.exists(os.path.join(here, "mode_plans_golden.json"))


def test_removed_zero_rule_reopens_the_diff(monkeypatch):
    """Mutation: drop the ZeRO-1 state0 rule from the table and dp_mp's
    velocities fall back to replicated — the golden diff reappears."""
    orig = tsh.standard_logical_axis_rules

    def no_state0(**kw):
        return [r for r in orig(**kw)
                if not (r[0] == "state0" and r[1] is not None)]

    monkeypatch.setattr(tsh, "standard_logical_axis_rules", no_state0)
    rep = teq.mode_plan_equivalence("dp_mp")
    assert rep["verdict"] == "DIVERGED"
    assert any("velocity" in d["var"] for d in rep["spec_diffs"])


# -- exact bytes ---------------------------------------------------------------

def _param_bytes(prog):
    total = 0
    for v in prog.global_block().vars.values():
        if v.persistable and getattr(v, "trainable", False):
            total += int(np.prod(v.shape)) * 4
    return total


def test_dp_grad_allreduce_bytes_exact():
    (jc, jp), (tc, tp) = _both(_train_mlp)
    ta = tsh.propagate(tp, plan=_tpe({"dp": 8}).static_plan(tp),
                       batch_size=64)
    ja = jsh.propagate(jp, plan=_jpe(axes={"dp": 8}).static_plan(jp),
                       batch_size=64)
    assert ta.per_kind() == ja.per_kind()
    assert ta.per_kind()["all-reduce"]["bytes"] == _param_bytes(tp) + 4


def test_mp_vocab_lookup_allreduce_bytes_exact():
    def build(f):
        ids = f.layers.data(name="ids", shape=[1], dtype="int64")
        emb = f.layers.embedding(ids, size=[128, 32])
        return f.layers.mean(emb)

    (_, jp), (_, tp) = _both(build)
    ta = tsh.propagate(tp, plan=_tpe({"dp": 4, "mp": 2}).static_plan(tp),
                       batch_size=8)
    ja = jsh.propagate(jp, plan=_jpe(axes={"dp": 4, "mp": 2})
                       .static_plan(jp), batch_size=8)
    got = [c.bytes for c in ta.collectives
           if c.kind == "all-reduce" and c.axes == ("mp",)]
    assert got == [c.bytes for c in ja.collectives
                   if c.kind == "all-reduce" and c.axes == ("mp",)]
    assert got == [(8 // 4) * 32 * 4]


def test_fsdp_gather_and_allreduce_bytes_exact():
    (_, jp), (_, tp) = _both(_train_mlp)
    ta = tsh.propagate(tp, plan=_tpe({"dp": 8}, fsdp_params=True)
                       .static_plan(tp), batch_size=64)
    ja = jsh.propagate(jp, plan=_jpe(axes={"dp": 8}, fsdp_params=True)
                       .static_plan(jp), batch_size=64)
    assert ta.per_kind() == ja.per_kind()
    assert set(ta.per_kind()) == {"all-gather", "all-reduce"}


def test_pp_point_to_point_bytes_exact():
    def build(f):
        x = f.layers.data(name="x", shape=[16], dtype="float32")
        y = f.layers.data(name="y", shape=[1], dtype="int64")
        h = f.layers.fc(input=x, size=32, act="tanh")
        f.layers.pipeline_stage()
        logits = f.layers.fc(input=h, size=4)
        return f.layers.mean(f.layers.softmax_with_cross_entropy(logits, y))

    (_, jp), (_, tp) = _both(build)
    ta = tsh.propagate(tp, mesh=_tmesh({"pp": 4}), plan={}, batch_size=16)
    ja = jsh.propagate(jp, mesh=jmake_mesh({"pp": 4}), plan={},
                       batch_size=16)
    p2p = [c.bytes for c in ta.collectives
           if c.kind == "collective-permute"]
    assert p2p == [c.bytes for c in ja.collectives
                   if c.kind == "collective-permute"] == [16 * 32 * 4] * 2


def test_hybrid_decomposition_bytes_exact():
    """A hybrid {dcn_dp: 2} x {dp: 4} dp step: each gradient all-reduce
    decomposes into ICI reduce-scatter, DCN all-reduce, ICI all-gather,
    byte for byte as the JAX package prices it."""
    (_, jp), (_, tp) = _both(_train_mlp)
    tpe = TPE(mesh=tmesh.make_hybrid_mesh({"dp": 4}, {"dcn_dp": 2},
                                          devices=CPU), zero_dp_states=True)
    jpe = JPE(mesh=jmesh.make_hybrid_mesh({"dp": 4}, {"dcn_dp": 2}),
              zero_dp_states=True)
    ta = tsh.propagate(tp, mesh=tpe.mesh, plan=tpe.static_plan(tp),
                       batch_size=64)
    ja = jsh.propagate(jp, mesh=jpe.mesh, plan=jpe.static_plan(jp),
                       batch_size=64)
    tr, jr = tsh.comm_report(ta, chip="tpu-v5e"), jsh.comm_report(
        ja, chip="v5e")
    _same_report(tr, jr)
    assert tr["link_bytes"]["dcn"] > 0 and tr["link_bytes"]["ici"] > 0
    assert any("decomposed" in e for e in tr["breakdown"])


# -- PTV016, PTV018-PTV021 -----------------------------------------------------

def _findings(rep):
    return sorted((f.rule, f.severity, f.var, f.message)
                  for f in rep.findings)


def test_ptv018_conflict_and_ptv019_reshard_match_jax():
    (jc, jp), (tc, tp) = _both(_train_mlp)
    kw = dict(feed_names=["x", "y"], check_shapes=False)
    bad = {"fc_0.w_0": ("dp", "dp")}
    jr = jverify(jp, plan=bad, fetch_names=[jc.name], **kw)
    tr = tverify(tp, plan=bad, fetch_names=[tc.name], **kw)
    assert _findings(tr) == _findings(jr)
    assert any(f.rule == "PTV018" for f in tr.findings)

    def two(f):
        a = f.layers.data(name="a", shape=[16])
        b = f.layers.data(name="b", shape=[16])
        s = f.layers.elementwise_add(f.layers.relu(a), f.layers.relu(b))
        return f.layers.mean(s)

    (jl, jp), (tl, tp) = _both(two)
    jplan = {"a": jmesh.named(jmake_mesh({"dp": 4, "mp": 2}), "dp", None),
             "b": jmesh.named(jmake_mesh({"dp": 4, "mp": 2}), "mp", None)}
    m = _tmesh({"dp": 4, "mp": 2})
    tplan = {"a": tmesh.named(m, "dp", None), "b": tmesh.named(m, "mp", None)}
    jr = jverify(jp, feed_names=["a", "b"], fetch_names=[jl.name],
                 plan=jplan, check_shapes=False)
    tr = tverify(tp, feed_names=["a", "b"], fetch_names=[tl.name],
                 plan=tplan, check_shapes=False)
    assert _findings(tr) == _findings(jr)
    assert any(f.rule == "PTV019" for f in tr.findings)


def test_ptv020_and_ptv021_match_jax():
    def big(f):
        x = f.layers.data(name="x", shape=[512])
        y = f.layers.data(name="y", shape=[1])
        h = f.layers.fc(input=x, size=1024)
        pred = f.layers.fc(input=h, size=1)
        cost = f.layers.mean(f.layers.square_error_cost(pred, y))
        f.optimizer.SGD(learning_rate=0.1).minimize(cost)
        return cost

    (jc, jp), (tc, tp) = _both(big)
    kw = dict(feed_names=["x", "y"], check_shapes=False)
    jr = jverify(jp, plan=_jpe(axes={"dp": 8}).static_plan(jp),
                 fetch_names=[jc.name], **kw)
    tr = tverify(tp, plan=_tpe({"dp": 8}).static_plan(tp),
                 fetch_names=[tc.name], **kw)
    assert _findings(tr) == _findings(jr)
    assert any(f.rule == "PTV020" for f in tr.findings)
    (jc, jp), (tc, tp) = _both(_train_mlp)
    jr = jverify(jp, plan=_jpe(axes={"dcn_dp": 8}, rules=JRules(
        dp_axis="dcn_dp")).static_plan(jp), fetch_names=[jc.name], **kw)
    tr = tverify(tp, plan=_tpe({"dcn_dp": 8}, rules=TRules(
        dp_axis="dcn_dp")).static_plan(tp), fetch_names=[tc.name], **kw)
    assert _findings(tr) == _findings(jr)
    assert any(f.rule == "PTV021" for f in tr.findings)


@pytest.mark.parametrize("cfg", [dict(zero_dp_states=True),
                                 dict(fsdp_params=True)])
def test_ptv016_findings_name_the_axis_rule(cfg):
    def mlp(f):
        x = f.layers.data(name="x", shape=[32])
        y = f.layers.data(name="y", shape=[1], dtype="int64")
        h = f.layers.fc(input=x, size=64, act="relu")
        logits = f.layers.fc(input=h, size=10)
        loss = f.layers.mean(f.layers.softmax_with_cross_entropy(logits, y))
        f.optimizer.Momentum(learning_rate=0.05, momentum=0.9).minimize(loss)
        return loss

    (jl, jp), (tl, tp) = _both(mlp)
    out = []
    for pe, prog, loss, verify in (
            (_jpe(axes={"dp": 8}, **cfg), jp, jl, jverify),
            (_tpe({"dp": 8}, **cfg), tp, tl, tverify)):
        prov = {}
        plan = pe.static_plan(prog, provenance=prov)
        out.append(_findings(verify(
            prog, feed_names=["x", "y"], fetch_names=[loss.name], plan=plan,
            plan_provenance=prov, check_shapes=False)))
    assert out[1] == out[0]
    assert any(r == "PTV016" for r, *_ in out[1])


# -- scaling, per-shard peak, the checked plan ---------------------------------

def test_scaling_curve_matches_jax():
    from paddle_tpu.analysis import cost as jcost
    from paddle_tpu_torch.analysis import cost as tcost

    for name in ("dp", "lm_dp_sp"):
        jm, jprog, _ = jmodes.build_mode(name)
        jmesh_, jplan, _ = jmodes.mode_plan(jm, jprog)
        tm, tprog, _ = tmodes.build_mode(name)
        tmesh_, tplan, _ = tmodes.mode_plan(tm, tprog)
        ja = jsh.propagate(jprog, mesh=jmesh_, plan=jplan, batch_size=8)
        ta = tsh.propagate(tprog, mesh=tmesh_, plan=tplan, batch_size=8)
        jc = jcost.program_cost(jprog, batch_size=8, chip="cpu-host")
        tc = tcost.program_cost(tprog, batch_size=8, chip="cpu-host")
        axis = max(jm.mesh_axes, key=jm.mesh_axes.get)
        jcur = jsh.scaling_curve(ja, jc, axis=axis, chip="cpu-host")
        tcur = tsh.scaling_curve(ta, tc, axis=axis, chip="cpu-host")
        for a, b in zip(tcur, jcur):
            assert a["n"] == b["n"]
            np.testing.assert_allclose(
                [a["step_time_s"], a["comm_time_s"], a["efficiency"]],
                [b["step_time_s"], b["comm_time_s"], b["efficiency"]],
                rtol=1e-9)


@pytest.mark.parametrize("name", ["dp", "dp_mp", "lm_dp_sp"])
def test_per_shard_peak_matches_jax(name):
    jm, jprog, _ = jmodes.build_mode(name)
    _, jplan, _ = jmodes.mode_plan(jm, jprog)
    tm, tprog, _ = tmodes.build_mode(name)
    _, tplan, _ = tmodes.mode_plan(tm, tprog)
    got = tmemory.peak_estimate(tprog, 8, plan=tplan)
    want = jmemory.peak_estimate(jprog, 8, plan=jplan)
    assert got == want and got["per_shard"]
    assert tmemory.render(got) == jmemory.render(want)
    for n in ("fc_0.w_0", "x"):
        if n in tplan:
            assert tmemory.shard_divisor(tplan[n]) == \
                jmemory.shard_divisor(jplan[n])


def test_checked_sharding_plan_equals_the_plan(monkeypatch):
    """Under PADDLE_TPU_VERIFY=1 the transpiler runs in its contract:
    the same plan, the program unmutated; a plan key naming no variable
    is PTV013."""
    tm, tprog, _ = tmodes.build_mode("lm_dp_sp")
    mesh = _tmesh(dict(tm.mesh_axes))
    plain = DistributeTranspiler().transpile(tprog, mesh)
    monkeypatch.setenv("PADDLE_TPU_VERIFY", "1")
    version = tprog._version
    checked = DistributeTranspiler().transpile(tprog, mesh)
    assert tprog._version == version
    assert _spec_map(checked, tprog) == _spec_map(plain, tprog)

    class Bad(DistributeTranspiler):
        def transpile(self, program, mesh):
            from paddle_tpu_torch.analysis import contracts

            if contracts.should_wrap():
                return contracts.checked_sharding_plan(self, program, mesh)
            return {"nope": None}

    with pytest.raises(Exception, match="PTV013"):
        Bad().transpile(tprog, mesh)


# -- the CLI ------------------------------------------------------------------

def _out(cli, argv, capsys):
    rc = cli.main(argv)
    return rc, capsys.readouterr().out


def test_analyze_cli_sharding_catalog_matches_jax(capsys):
    argv = ["analyze", "--sharding", "--chip", "cpu-host", "--json",
            "--batch-size", "8"]
    trc, tout = _out(tcli, argv, capsys)
    jrc, jout = _out(jcli, argv, capsys)
    assert trc == jrc == 0
    assert [json.loads(ln) for ln in tout.splitlines()] == \
        [json.loads(ln) for ln in jout.splitlines()]
    argv = ["analyze", "--sharding", "--mode", "lm_dp_sp", "--chip",
            "cpu-host"]
    assert _out(tcli, argv, capsys) == _out(jcli, argv, capsys)


def test_analyze_cli_sharding_on_saved_model(tmp_path, capsys):
    d = str(tmp_path / "m")
    x = jfluid.layers.data(name="x", shape=[16])
    h = jfluid.layers.fc(input=x, size=256, act="relu")
    y = jfluid.layers.fc(input=h, size=4)
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(jfluid.default_startup_program())
    jfluid.io.save_inference_model(d, ["x"], [y], exe)
    argv = ["analyze", d, "--sharding", "--axes", "dp=4,mp=2",
            "--chip", "cpu-host", "--json", "--batch-size", "8"]
    trc, tout = _out(tcli, argv, capsys)
    jrc, jout = _out(jcli, argv, capsys)
    assert trc == jrc == 0
    t, j = json.loads(tout), json.loads(jout)
    assert t["sharding"] == j["sharding"]
    assert t["memory"] == j["memory"]
    assert _out(tcli, ["analyze", d, "--sharding", "--axes", "dp"],
                capsys)[0] == 2
