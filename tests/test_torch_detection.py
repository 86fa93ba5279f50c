"""The detection ops, ``DetectionMAP`` and the other op types this slice
adds (``lrn``, ``im2sequence``, ``row_conv``, ``auc``,
``precision_recall``, ``positive_negative_pair``) against the JAX package
on the CPU.

- Each op on ``chip_smoke.new_op_cases``' f32 inputs (the shapes phase 37
  runs on the card) and on cases of ties: the port's emitter and the JAX
  emitter's outputs within 1e-5 of their max |value|, integers equal.
  Ties break at the lowest index in both: ``auc``'s ranks, the hard
  negatives of ``multibox_loss``, ``detection_output``'s ``top_k``.
- The gradient of every differentiable one (``im2sequence``, ``lrn``,
  ``row_conv``, ``roi_pool`` with a tied maximum in a bin,
  ``multibox_loss``) in float64 against ``jax.grad``, within 1e-6 of max
  |g|.
- ``DetectionMAP``: the JAX tests' cases (a false positive above and
  below the true one, a duplicate, a difficult ground truth) and a
  slate from ``detection_output``, both AP versions, equal to JAX's.
- ``row_conv`` reads a sequence's padded steps as the JAX emitter does
  (ROADMAP Queue C): on an fc output whose padded steps hold its bias,
  the port equals JAX and both differ from the reference's per-sequence
  sum at the steps before a sequence's end.
- v1 ``roi_pool_layer`` declares ``Argmax``, which neither emitter
  writes: the port trains it (``unwritten_outputs``), the JAX package's
  backward fails on it (ROADMAP Queue C) and, with ``Argmax`` dropped
  from its desc, trains to the port's losses and gradients."""

import numpy as np
import pytest

import chip_smoke as cs
import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import evaluator as jevaluator
from paddle_tpu_torch import evaluator as tevaluator
from test_torch_ctc import GRAD_TOL, TOL, grads_f64, hold_outputs, \
    jax_emit, max_rel, port_emit

CASES = ("im2sequence", "im2sequence_two_pads", "lrn", "row_conv", "auc",
         "precision_recall", "positive_negative_pair", "iou_similarity",
         "box_coder_encode", "box_coder_decode", "prior_box", "roi_pool",
         "multibox_loss", "detection_output")
GRAD_CASES = ("im2sequence", "im2sequence_two_pads", "lrn", "row_conv",
              "roi_pool", "multibox_loss")


@pytest.fixture(autouse=True)
def _fresh():
    tfluid.reset()
    jfluid.reset()
    yield


@pytest.mark.parametrize("case", CASES)
def test_op_matches_jax(case):
    hold_outputs(case, cs.new_op_cases()[case][4])


@pytest.mark.parametrize("case", GRAD_CASES)
def test_gradient_matches_jax_grad_in_float64(case):
    op, ins, attrs, diff, outs = cs.new_op_cases()[case]
    tg, jg = grads_f64(op, ins, attrs, diff, outs)
    for s, t, j in zip(diff, tg, jg):
        assert max_rel(t, j) <= GRAD_TOL, (case, s, max_rel(t, j))


def _case(name, **over):
    op, ins, attrs, diff, outs = cs.new_op_cases()[name]
    return op, {**ins, **over}, attrs, diff, outs


def _hold(op, ins, attrs, outs):
    t = port_emit(op, ins, attrs)
    j = jax_emit(op, ins, attrs)
    for s in outs:
        tv, jv = t[s][0].numpy(), np.asarray(j[s][0])
        if np.issubdtype(jv.dtype, np.floating):
            assert max_rel(tv, jv) <= TOL, (op, s, max_rel(tv, jv))
        else:
            np.testing.assert_array_equal(tv, jv)
    return t


def test_ties_break_at_the_lowest_index_as_in_xla():
    # auc: every score tied
    op, ins, attrs, _, outs = _case("auc")
    pred = np.full_like(ins["Predict"], 0.5)
    _hold(op, {**ins, "Predict": pred}, attrs, outs)
    # multibox_loss: identical class scores on every prior, so the hard
    # negatives' losses tie and their ranks come from the stable sort
    op, ins, attrs, diff, outs = _case("multibox_loss")
    conf = np.repeat(ins["Conf"][:, :1], ins["Conf"].shape[1], axis=1)
    _hold(op, {**ins, "Conf": conf}, attrs, outs)
    tg, jg = grads_f64(op, {**ins, "Conf": conf}, attrs, diff, outs)
    for t, j in zip(tg, jg):
        assert max_rel(t, j) <= GRAD_TOL
    # detection_output: tied scores across priors and classes
    op, ins, attrs, _, outs = _case("detection_output")
    conf = np.zeros_like(ins["Conf"])
    conf[:, ::2, 1] = 2.0
    t = _hold(op, {**ins, "Conf": conf}, attrs, outs)
    assert (t["Out"][0].numpy()[..., 0] >= 0).any()


def _map(mod, dets, gtb, gtl, cnt, diff=None, **kw):
    ev = mod.DetectionMAP(**kw)
    ev.add_batch(dets, gtb, gtl, cnt, gt_difficult=diff)
    return ev.eval()


def _map_cases():
    dets = np.array([[[1, 0.9, 0.0, 0.0, 0.4, 0.4],
                      [1, 0.8, 0.6, 0.6, 0.9, 0.9],
                      [-1, 0, 0, 0, 0, 0]]])
    swapped = dets.copy()
    swapped[0, 0, 1], swapped[0, 1, 1] = 0.8, 0.9
    one = (np.array([[[0.0, 0.0, 0.4, 0.4]]]), np.array([[1]]),
           np.array([1]))
    dup = np.array([[[1, 0.9, 0.0, 0.0, 0.4, 0.4],
                     [1, 0.8, 0.02, 0.02, 0.44, 0.44],
                     [-1, 0, 0, 0, 0, 0]]])
    two = (np.array([[[0.0, 0.0, 0.4, 0.4], [0.3, 0.3, 0.7, 0.7]]]),
           np.array([[1, 1]]), np.array([2]))
    easy_hard = (np.array([[[0.0, 0.0, 0.4, 0.4], [0.6, 0.6, 0.9, 0.9]]]),
                 np.array([[1, 1]]), np.array([2]))
    hard = np.array([[False, True]])
    return {
        "tp_then_fp": (dets, *one, None, {"overlap_threshold": 0.5}),
        "fp_then_tp": (swapped, *one, None, {"overlap_threshold": 0.5}),
        "duplicate_is_fp": (dup, *two, None, {"overlap_threshold": 0.3}),
        "difficult_ignored": (dets, *easy_hard, hard,
                              {"overlap_threshold": 0.5}),
        "difficult_counted": (dets, *easy_hard, hard,
                              {"overlap_threshold": 0.5,
                               "evaluate_difficult": True}),
        "eleven_point": (swapped, *one, None,
                         {"overlap_threshold": 0.5,
                          "ap_version": "11point"}),
    }


@pytest.mark.parametrize("case", sorted(_map_cases()))
def test_detection_map_matches_jax(case):
    dets, gtb, gtl, cnt, diff, kw = _map_cases()[case]
    t = _map(tevaluator, dets, gtb, gtl, cnt, diff, **kw)
    j = _map(jevaluator, dets, gtb, gtl, cnt, diff, **kw)
    assert t == j


@pytest.mark.parametrize("ap", ("integral", "11point"))
def test_detection_map_of_a_detection_output_slate_matches_jax(ap):
    op, ins, attrs, _, _ = cs.new_op_cases()["detection_output"]
    det = cs._detection_inputs(np.random.RandomState(2))
    slate = port_emit(op, ins, attrs)["Out"][0].numpy()
    j_slate = np.asarray(jax_emit(op, ins, attrs)["Out"][0])
    kw = {"overlap_threshold": 0.3, "ap_version": ap, "background_label": 0}
    t = _map(tevaluator, slate, det["GtBox"], det["GtLabel"], det["GtCount"],
             **kw)
    j = _map(jevaluator, j_slate, det["GtBox"], det["GtLabel"],
             det["GtCount"], **kw)
    assert t == pytest.approx(j, abs=1e-12)
    assert 0.0 < t <= 1.0


def test_row_conv_reads_padded_steps_as_jax_does():
    """An fc output's padded steps hold its bias; row_conv sums them into
    the last steps of a short sequence, in both packages, where the
    reference sums within the sequence only."""
    lengths = np.array([2, 4], np.int32)
    x = np.random.RandomState(0).randn(2, 4, 3).astype(np.float32)
    bias = np.float32([0.5, -1.0, 2.0])
    fc_out = x + bias  # what fc writes at every step, padded ones too
    filt = np.random.RandomState(1).randn(3, 3).astype(np.float32)
    ins = {"X": fc_out, "Filter": filt}
    t = _hold("row_conv", ins, {}, ("Out",))["Out"][0].numpy()
    ref = np.zeros_like(fc_out)
    for b, n in enumerate(lengths):
        for s in range(n):
            for i in range(filt.shape[0]):
                if s + i < n:
                    ref[b, s] += fc_out[b, s + i] * filt[i]
    # the full-length row agrees; the short row's last valid step does not
    np.testing.assert_allclose(t[1], ref[1], rtol=1e-5, atol=1e-5)
    assert np.abs(t[0, 1] - ref[0, 1]).max() > 1e-2


def _roi_program(v1, fluid, before_minimize=None):
    feat = v1.data_layer("rfeat", size=4 * 5 * 5, height=5, width=5)
    rois = v1.data_layer("rrois", size=5)
    conv = v1.img_conv_layer(feat, filter_size=3, num_filters=2, padding=1)
    rp = v1.roi_pool_layer(conv, rois, pooled_width=2, pooled_height=2,
                           spatial_scale=1.0)
    cost = v1.sum_cost(rp)
    if before_minimize is not None:
        before_minimize(fluid.default_main_program())
    fluid.optimizer.SGD(learning_rate=0.1).minimize(cost.var)
    return cost


def _drop_argmax(main):
    for op in main.global_block().ops:
        if op.type == "roi_pool":
            op.outputs.pop("Argmax")


def test_v1_roi_pool_layer_trains_as_jax_with_argmax_dropped():
    """The v1 layer declares roi_pool's ``Argmax``, which neither emitter
    writes: the port binds nothing to it and trains; the JAX package's
    backward fails on it (ROADMAP Queue C) and trains once the desc drops
    it, to the port's values."""
    from paddle_tpu.v1 import layers as jv1
    from paddle_tpu_torch.v1 import layers as tv1

    feed = {"rfeat": np.random.RandomState(0).rand(2, 4, 5, 5).astype(
        np.float32),
        "rrois": np.array([[0, 0, 0, 4, 4], [1, 1, 2, 3, 4]], np.float32)}
    cost = _roi_program(jv1, jfluid)
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(jfluid.default_startup_program())
    with pytest.raises(Exception, match="roi_pool_0.tmp_1"):
        exe.run(feed=feed, fetch_list=[cost.var])
    jfluid.reset()
    cost = _roi_program(jv1, jfluid, _drop_argmax)
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(jfluid.default_startup_program())
    state = {n: np.array(jfluid.global_scope().find_np(n))
             for n, v in jfluid.default_main_program().global_block()
             .vars.items() if v.persistable}
    grads = ["conv2d_0.w_0@GRAD", "conv2d_0.b_0@GRAD"]
    j_rows = [exe.run(feed=feed, fetch_list=[cost.var] + grads)
              for _ in range(2)]
    t_cost = _roi_program(tv1, tfluid)
    tfluid.load_persistables(tfluid.default_main_program(), state)
    texe = tfluid.Executor(tfluid.CPUPlace())
    t_rows = [texe.run(feed=feed, fetch_list=[t_cost.var] + grads)
              for _ in range(2)]
    for t, j in zip(t_rows, j_rows):
        for tv, jv in zip(t, j):
            assert max_rel(tv, jv) <= TOL
