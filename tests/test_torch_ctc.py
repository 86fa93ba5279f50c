"""The CTC slice of the port against the JAX package on the CPU.

- ``warpctc``, ``ctc_align``, ``edit_distance`` and ``nce`` (``new_op_cases``
  of ``chip_smoke.py``, which phase 37 runs on the card): the port's
  emitter and the JAX emitter on the same f32 inputs, outputs within 1e-5
  of their max |value|, integer outputs equal; ``warpctc`` at its edges
  (an infeasible alignment costs JAX's 1e30, a label of length 0, a logit
  length of 0 and below T, [B, L, 1] labels, a blank last, bf16 logits
  computed in f32); ``edit_distance`` also against a numpy Levenshtein.
- The gradients of ``warpctc`` (feasible rows) and ``nce`` in float64
  against ``jax.grad`` of the JAX emitter, within 1e-6 of max |g|; ``nce``
  takes the port's negatives into the JAX emitter, and is held by its
  properties (negatives in [0, C), Cost equal to the numpy formula, the
  same draws in the grad op's re-run).
- ``WarpCTCGrad``: declared by both packages' layers, written by neither
  emitter; the port binds nothing to it and trains, the JAX package's
  backward fails on it (ROADMAP Queue C).
- Path (b), the bidirectional-GRU CTC program (``ctc_train_program``) at a
  small size: 3 Momentum steps from JAX's startup state against the JAX
  program with ``WarpCTCGrad`` dropped from its desc, losses within 1e-5
  relative and step-1 gradients within 1e-5 of max |g|; its greedy decode
  (``top_k`` → ``ctc_align`` → ``edit_distance``) equal to JAX's."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import lod as jlod
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch import lod as tlod
from paddle_tpu_torch.ops import registry as treg

TOL = 1e-5
GRAD_TOL = 1e-6
CTC_CASES = ("warpctc", "warpctc_edges", "warpctc_last_blank", "ctc_align",
             "edit_distance", "edit_distance_raw")
NEW_OPS = ("warpctc ctc_align edit_distance nce im2sequence lrn row_conv "
           "auc precision_recall positive_negative_pair iou_similarity "
           "box_coder prior_box roi_pool multibox_loss "
           "detection_output").split()


@pytest.fixture(autouse=True)
def _fresh():
    tfluid.reset()
    jfluid.reset()
    yield


def max_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if not want.size:
        return 0.0
    return float(np.abs(got.astype(np.float64) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def jax_emit(op, ins, attrs, subst=None):
    ctx = jreg.EmitContext(jax.random.PRNGKey(0), is_test=False)
    full = {s: [jnp.asarray(a)] for s, a in ins.items()}
    for s, x in (subst or {}).items():
        full[s] = [x]
    return jreg.get_op_info(op).emit(ctx, full, dict(attrs))


def port_emit(op, ins, attrs, step=0, uid=None):
    ctx = treg.EmitContext(torch.device("cpu"), is_test=False, step=step)
    attrs = dict(attrs)
    if uid is not None:
        attrs["__uid__"] = uid
    return treg.get_op_info(op).emit(
        ctx, {s: [torch.as_tensor(a)] for s, a in ins.items()}, attrs)


def hold_outputs(case, outs):
    """The port's and the JAX emitter's outputs of `case` on its f32
    inputs: floats within TOL of max |value|, integers equal (dtype
    included)."""
    op, ins, attrs, _, _ = cs.new_op_cases()[case]
    t = port_emit(op, ins, attrs)
    j = jax_emit(op, ins, attrs)
    for s in outs:
        tv, jv = t[s][0].numpy(), np.asarray(j[s][0])
        if np.issubdtype(jv.dtype, np.floating):
            assert max_rel(tv, jv) <= TOL, (case, s, max_rel(tv, jv))
        else:
            assert tv.dtype == jv.dtype, (case, s, tv.dtype, jv.dtype)
            np.testing.assert_array_equal(tv, jv, err_msg=f"{case} {s}")
    return t, j


def grads_f64(op, ins, attrs, diff, outs, subst=None):
    """d sum_k sum(out_k * ct_k) / d `diff` in float64: (port by
    ``torch.autograd`` through the emitter, JAX by ``jax.grad``)."""
    ins64 = {s: (a.astype(np.float64) if a.dtype == np.float32 else a)
             for s, a in ins.items()}
    j0 = jax_emit(op, ins64, attrs, subst)
    cts = {s: np.random.RandomState(90 + k).uniform(
        0.5, 1.5, np.asarray(j0[s][0]).shape)
        for k, s in enumerate(outs)
        if np.issubdtype(np.asarray(j0[s][0]).dtype, np.floating)}

    def jloss(xs):
        o = jax_emit(op, ins64, attrs, {**(subst or {}), **dict(zip(diff,
                                                                    xs))})
        return sum(jnp.sum(o[s][0] * c) for s, c in cts.items())

    jg = jax.grad(jloss)([jnp.asarray(ins64[s]) for s in diff])
    ctx = treg.EmitContext(torch.device("cpu"), is_test=False)
    t_in = {s: [torch.as_tensor(a)] for s, a in ins64.items()}
    leaves = [torch.as_tensor(ins64[s]).requires_grad_(True) for s in diff]
    for s, leaf in zip(diff, leaves):
        t_in[s] = [leaf]
    with torch.enable_grad():
        o = treg.get_op_info(op).emit(ctx, t_in, dict(attrs))
        total = sum((o[s][0] * torch.as_tensor(c)).sum()
                    for s, c in cts.items())
        tg = torch.autograd.grad(total, leaves)
    return [g.numpy() for g in tg], [np.asarray(g) for g in jg]


# -- the ops against the JAX emitters -----------------------------------------

@pytest.mark.parametrize("case", CTC_CASES)
def test_ctc_ops_match_jax(case):
    hold_outputs(case, cs.new_op_cases()[case][4])


def test_warpctc_infeasible_row_costs_jax_floor():
    """Row 0 of ``warpctc_edges`` needs 5 frames for "1 1 1" and has 4:
    JAX's -NEG_INF, where ATen's ctc_loss gives inf."""
    t, j = hold_outputs("warpctc_edges", ("Loss",))
    assert float(t["Loss"][0][0, 0]) == pytest.approx(1e30, rel=1e-6)
    assert float(np.asarray(j["Loss"][0])[0, 0]) == pytest.approx(
        1e30, rel=1e-6)
    assert np.isfinite(t["Loss"][0].numpy()[1:]).all()
    assert float(np.asarray(j["Loss"][0])[1:].max()) < 1e3


def test_warpctc_bf16_logits_are_computed_in_f32():
    op, ins, attrs, _, _ = cs.new_op_cases()["warpctc"]
    x16 = torch.as_tensor(ins["Logits"]).to(torch.bfloat16)
    t = port_emit(op, {**ins, "Logits": x16}, attrs)["Loss"][0]
    assert t.dtype == torch.float32
    j = jax_emit(op, ins, attrs, {"Logits": jnp.asarray(
        x16.float().numpy()).astype(jnp.bfloat16)})["Loss"][0]
    assert max_rel(t.numpy(), np.asarray(j)) <= TOL


def _levenshtein(a, b):
    d = np.arange(len(b) + 1, dtype=np.float64)
    for i, x in enumerate(a):
        prev, d[0] = d.copy(), i + 1
        for k, y in enumerate(b):
            d[k + 1] = min(prev[k] + (x != y), prev[k + 1] + 1, d[k] + 1)
    return d[-1]


@pytest.mark.parametrize("seed", range(3))
def test_edit_distance_matches_numpy_levenshtein(seed):
    rng = np.random.RandomState(seed)
    hyp = rng.randint(0, 3, (6, 9))
    ref = rng.randint(0, 3, (6, 7))
    hl = rng.randint(0, 10, 6).astype(np.int32)
    rl = rng.randint(0, 8, 6).astype(np.int32)
    out = port_emit("edit_distance", {"Hyps": hyp, "Refs": ref,
                                      "HypsLength": hl, "RefsLength": rl},
                    {"normalized": False})
    want = [_levenshtein(hyp[i, :hl[i]], ref[i, :rl[i]]) for i in range(6)]
    np.testing.assert_array_equal(out["Out"][0].numpy()[:, 0], want)
    assert out["SequenceNum"][0].tolist() == [6]


@pytest.mark.parametrize("case", ("warpctc", "warpctc_edges",
                                  "warpctc_last_blank"))
def test_warpctc_gradient_matches_jax_grad_in_float64(case):
    op, ins, attrs, diff, outs = cs.new_op_cases()[case]
    tg, jg = grads_f64(op, ins, attrs, diff, outs)
    # the infeasible row's gradient is zero in the port (zero_infinity);
    # JAX's is whatever its rounded -1e30 terms give
    rows = slice(1, None) if case == "warpctc_edges" else slice(None)
    if case == "warpctc_edges":
        assert not tg[0][0].any()
    assert max_rel(tg[0][rows], jg[0][rows]) <= GRAD_TOL


def _nce_case():
    op, ins, attrs, diff, outs = cs.new_op_cases()["nce"]
    t = port_emit(op, ins, attrs, uid=7)
    neg = t["SampleLabels"][0].numpy()
    return op, ins, attrs, diff, outs, t, neg


def test_nce_holds_its_properties_and_jax_on_its_draws(monkeypatch):
    op, ins, attrs, diff, outs, t, neg = _nce_case()
    c = ins["Weight"].shape[0]
    assert neg.shape == (4, attrs["num_neg_samples"]) and neg.dtype == np.int32
    assert (neg >= 0).all() and (neg < c).all()
    np.testing.assert_allclose(t["Cost"][0].numpy()[:, 0],
                               cs.nce_formula(ins, {"SampleLabels": [neg]}),
                               rtol=TOL, atol=TOL)
    # the same (step, uid) draws the same negatives, as the grad op's
    # re-run must; another step draws others
    again = port_emit(op, ins, attrs, uid=7)["SampleLabels"][0].numpy()
    other = port_emit(op, ins, attrs, step=1, uid=7)["SampleLabels"][0]
    np.testing.assert_array_equal(again, neg)
    assert not np.array_equal(other.numpy(), neg)
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(neg))
    j = jax_emit(op, ins, attrs)
    for s in ("Cost", "SampleLogits"):
        assert max_rel(t[s][0].numpy(), np.asarray(j[s][0])) <= TOL
    np.testing.assert_array_equal(np.asarray(j["SampleLabels"][0]), neg)


def test_nce_gradient_matches_jax_grad_in_float64(monkeypatch):
    op, ins, attrs, diff, outs, _, neg = _nce_case()
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(neg))
    monkeypatch.setattr(torch, "randint",
                        lambda lo, hi, shape, **kw: torch.as_tensor(
                            neg.astype(np.int64)))
    tg, jg = grads_f64(op, ins, attrs, diff, ("Cost",))
    for s, t, j in zip(diff, tg, jg):
        assert max_rel(t, j) <= GRAD_TOL, s


def test_registry_holds_the_new_ops_as_jax_does():
    assert set(NEW_OPS) <= set(treg.registered_ops())
    for op in jreg.registered_ops():
        ti, ji = treg.get_op_info(op), jreg.get_op_info(op)
        assert (ti.grad is None) == (ji.grad is None), op
        assert ti.non_diff_inputs == ji.non_diff_inputs, op
        assert ti.non_diff_outputs == ji.non_diff_outputs, op
        # an op draws from the generator where JAX's draws from ctx.rng
        assert ti.draws_rng == ("ctx.rng(" in inspect.getsource(ji.emit)), op
    assert treg.get_op_info("nce").draws_rng
    assert treg.get_op_info("warpctc").unwritten_outputs == ("WarpCTCGrad",)
    assert treg.get_op_info("roi_pool").unwritten_outputs == ("Argmax",)
    assert [op for op in treg.registered_ops()
            if treg.get_op_info(op).unwritten_outputs] == ["roi_pool",
                                                           "warpctc"]
    # 173 after the CTC slice, 175 with moe and pipeline_stage; every op
    # type of the JAX package since the last 48
    assert len(treg.registered_ops()) == 223
    assert treg.registered_ops() == jreg.registered_ops()


# -- WarpCTCGrad and path (b) -------------------------------------------------

def _drop_warpctc_grad(main):
    """The JAX program's warpctc op without its WarpCTCGrad output (a
    test-side edit of a built desc: JAX's emitter never writes it)."""
    for op in main.global_block().ops:
        if op.type == "warpctc":
            op.outputs.pop("WarpCTCGrad")


def _ctc_grads(main):
    return sorted(p.name + "@GRAD" for p in
                  main.global_block().all_parameters())


def test_warpctc_grad_output_is_bound_to_nothing():
    loss, _, _, main, startup = cs.ctc_train_program(tfluid, **cs.CTC_SMALL)
    fwd = next(op for op in main.global_block().ops if op.type == "warpctc")
    grad_name = fwd.outputs["WarpCTCGrad"][0]
    grad_op = next(op for op in main.global_block().ops
                   if op.type == "generic_grad"
                   and op.attrs["__fwd_type__"] == "warpctc")
    assert grad_op.inputs["WarpCTCGrad"] == [grad_name]
    assert treg.unbound_slots(grad_op) == ("WarpCTCGrad", "WarpCTCGrad@GRAD")
    assert treg.unbound_slots(fwd) == ()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    feed, _, _ = cs.ctc_feed(tlod, **cs.CTC_SMALL)
    (val,) = exe.run(main, feed=feed, fetch_list=[loss])
    assert np.isfinite(val).all()
    with pytest.raises(KeyError, match="not computed"):
        exe.run(main, feed=feed, fetch_list=[grad_name])
    # any other name that nothing writes still raises
    block = main.global_block()
    block.create_var(name="never_written", shape=(1,), dtype="float32")
    block.append_op("scale", inputs={"X": ["never_written"]},
                    outputs={"Out": ["scaled"]}, attrs={"scale": 2.0})
    block.create_var(name="scaled", shape=(1,), dtype="float32")
    with pytest.raises(RuntimeError, match="never_written"):
        exe.run(main, feed=feed, fetch_list=["scaled"])


def test_jax_warpctc_layer_cannot_train():
    """ROADMAP Queue C: the JAX package's backward of the layer's
    undeclared WarpCTCGrad output fails."""
    loss, _, _, main, startup = cs.ctc_train_program(jfluid, **cs.CTC_SMALL)
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup)
    feed, _, _ = cs.ctc_feed(jlod, **cs.CTC_SMALL)
    grad_name = next(op for op in main.global_block().ops
                     if op.type == "warpctc").outputs["WarpCTCGrad"][0]
    with pytest.raises(Exception, match=grad_name.replace(".", r"\.")):
        exe.run(main, feed=feed, fetch_list=[loss])


def test_ctc_program_trains_as_jax_with_its_grad_output_dropped():
    j_loss, _, _, j_main, j_start = cs.ctc_train_program(
        jfluid, before_minimize=_drop_warpctc_grad, **cs.CTC_SMALL)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(j_start)
    state = {n: np.array(jfluid.global_scope().find_np(n))
             for n, v in j_main.global_block().vars.items() if v.persistable}
    grads = _ctc_grads(j_main)
    feeds = [cs.ctc_feed(jlod, seed=s, **cs.CTC_SMALL)[0] for s in range(3)]
    j_rows = [jexe.run(j_main, feed=f, fetch_list=[j_loss] + grads)
              for f in feeds]
    t_loss, _, _, t_main, _ = cs.ctc_train_program(tfluid, **cs.CTC_SMALL)
    assert [op.type for op in t_main.global_block().ops] == \
        [op.type for op in j_main.global_block().ops]
    tfluid.load_persistables(t_main, state)
    texe = tfluid.Executor(tfluid.CPUPlace())
    t_feeds = [cs.ctc_feed(tlod, seed=s, **cs.CTC_SMALL)[0]
               for s in range(3)]
    t_rows = [texe.run(t_main, feed=f, fetch_list=[t_loss] + grads)
              for f in t_feeds]
    for k, (t, j) in enumerate(zip(t_rows, j_rows)):
        assert max_rel(t[0], j[0]) <= TOL, (k, t[0], j[0])
        if k == 0:
            for n, tg, jg in zip(grads, t[1:], j[1:]):
                assert max_rel(tg, jg) <= TOL, (n, max_rel(tg, jg))


def test_greedy_decode_and_edit_distance_match_jax():
    """The test-mode clone's logits of path (b), decoded by
    ``ctc_decode_program`` in both packages: ids, lengths, distances and
    the sequence count equal."""
    loss, logits, test, main, startup = cs.ctc_train_program(
        tfluid, **cs.CTC_SMALL)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    feed, ts, ls = cs.ctc_feed(tlod, seed=4, **cs.CTC_SMALL)
    (lg,) = exe.run(test, feed=feed, fetch_list=[logits])
    dfeed = cs.ctc_decode_feed(lg, ts, cs.padded_labels(feed["labels"]), ls)
    got = {}
    for name, fl in (("port", tfluid), ("jax", jfluid)):
        fetch = cs.ctc_decode_program(fl, cs.CTC_SMALL["classes"])
        got[name] = [np.asarray(v) for v in fl.Executor(fl.CPUPlace()).run(
            fl.default_main_program(), feed=dfeed, fetch_list=fetch)]
    for t, j in zip(got["port"], got["jax"]):
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t, j)
    assert got["port"][3].tolist() == [cs.CTC_SMALL["bs"]]
