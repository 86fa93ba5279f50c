"""The sequence op types the sequence-labelling slice adds to the port,
held to the JAX package on the CPU the way ``tests/test_torch_op_grad.py``
holds the training options: a one-op program from numpy inputs (made
from a seed), run by the port's Executor.

- ``sequence_expand``, ``sequence_concat``, ``sequence_erase``,
  ``lstm_unit``, ``gru_unit``, ``sequence_slice``, ``sequence_reshape``,
  ``kmax_seq_score``, ``sequence_concat_time``, ``sub_nested_seq``,
  ``lod_reset`` and the sequence API's helpers ``shape``, ``gather``,
  ``arg_sort`` and ``cos_sim``: every output, with its dtype, equal to
  the JAX emitter's (f32 within 1e-5 of the output's largest |value|,
  integers exactly), at ragged lengths that include 1 and T;
  ``kmax_seq_score`` and ``arg_sort`` on ties keep the lowest index, as
  ``lax.top_k`` and ``jnp.argsort`` do.
- Each differentiable op in float64: the desc-level gradient of
  ``mean(out * ct)`` (``generic_grad``) equal to ``jax.grad`` of the JAX
  emitter (1e-12) and to central differences of the port's own forward
  (1e-6 of the largest |numeric gradient|), for every output slot that
  takes a cotangent.
- The registry: each new type carries JAX's grad and non-differentiable
  slots, and every port op type is a JAX one."""

import numpy as np
import pytest

import paddle_tpu as jfluid  # noqa: F401  (registers the JAX emitters)
import paddle_tpu_torch as tfluid
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.ops import registry as treg
from test_torch_op_grad import (_check_outputs, _grad_program, _jax_grads,
                                _numeric, _set)

NEW_OPS = ("sequence_expand sequence_concat sequence_erase lstm_unit "
           "gru_unit sequence_slice sequence_reshape kmax_seq_score "
           "sequence_concat_time sub_nested_seq lod_reset shape gather "
           "arg_sort cos_sim").split()
FWD_TOL = 1e-5
NUMERIC_TOL = 1e-6
JAX_TOL = 1e-12


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    yield


def _a(seed, *shape, lo=-2.0, hi=2.0, dtype=np.float32):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(dtype)


def _len(*v):
    return np.array(v, np.int32)


# -- the cases: name -> dtype -> (op, inputs, attrs, differentiable slots,
#    output slots that take a cotangent) --------------------------------------

def _expand(dt, lengths=(4, 1, 3), max_len=4, ref=False):
    ins = {"X": [_a(1, len(lengths), 3, dtype=dt)],
           "Length": [_len(*lengths)]}
    if ref:
        ins["Ref"] = [_a(2, len(lengths), max_len, 2, dtype=dt)]
    return ("sequence_expand", ins, {"max_len": -1 if ref else max_len},
            ("X",), ("Out",))


def _lstm_unit(dt, fb=0.0):
    return ("lstm_unit", {"X": [_a(3, 3, 8, dtype=dt)],
                          "C_prev": [_a(4, 3, 2, dtype=dt)]},
            {"forget_bias": fb}, ("X", "C_prev"), ("C", "H"))


def _gru_unit(dt, bias=True):
    ins = {"Input": [_a(5, 2, 9, dtype=dt)],
           "HiddenPrev": [_a(6, 2, 3, dtype=dt)],
           "Weight": [_a(7, 3, 9, lo=-1, hi=1, dtype=dt)]}
    if bias:
        ins["Bias"] = [_a(8, 9, lo=-0.5, hi=0.5, dtype=dt)]
    return ("gru_unit", ins, {}, tuple(ins),
            ("Hidden", "Gate", "ResetHiddenPrev"))


def _slice(dt):
    return ("sequence_slice",
            {"X": [_a(9, 3, 5, 2, dtype=dt)], "Offset": [_len(0, 2, 4)],
             "SliceLength": [_len(5, 2, 1)], "Length": [_len(5, 4, 5)]},
            {}, ("X",), ("Out",))


def _reshape(dt, lengths=(4, 1, 3), new_dim=4):
    return ("sequence_reshape",
            {"X": [_a(10, len(lengths), 4, 2, dtype=dt)],
             "Length": [_len(*lengths)]},
            {"new_dim": new_dim}, ("X",), ("Out",))


def _concat_time(dt):
    return ("sequence_concat_time",
            {"X": [_a(11, 3, 4, 2, dtype=dt), _a(12, 3, 3, 2, dtype=dt)],
             "Length": [_len(4, 1, 2), _len(1, 3, 0)]},
            {}, ("X",), ("Out",))


def _cos(dt, y_rows=3):
    return ("cos_sim", {"X": [_a(13, 3, 4, dtype=dt)],
                        "Y": [_a(14, y_rows, 4, dtype=dt)]},
            {}, ("X", "Y"), ("Out", "XNorm", "YNorm"))


DIFF = {
    "sequence_expand": _expand,
    "sequence_expand_ref": lambda dt: _expand(dt, (2, 4, 1), ref=True),
    "sequence_concat": lambda dt: (
        "sequence_concat", {"X": [_a(15, 2, 3, 2, dtype=dt),
                                  _a(16, 2, 3, 4, dtype=dt)]},
        {}, ("X",), ("Out",)),
    "lstm_unit": _lstm_unit,
    "lstm_unit_forget_bias": lambda dt: _lstm_unit(dt, 1.0),
    "gru_unit": _gru_unit,
    "gru_unit_no_bias": lambda dt: _gru_unit(dt, bias=False),
    "sequence_slice": _slice,
    "sequence_reshape": _reshape,
    # 3·2 values over new_dim 4: the row keeps its tail in a padded step
    "sequence_reshape_partial": lambda dt: _reshape(dt, (3, 4, 1), 4),
    "sequence_reshape_down": lambda dt: _reshape(dt, (4, 2, 1), 1),
    "sequence_concat_time": _concat_time,
    "gather": lambda dt: ("gather", {"X": [_a(17, 5, 3, dtype=dt)],
                                     "Index": [np.array([4, 0, 4, 2],
                                                        np.int64)]},
                          {}, ("X",), ("Out",)),
    "gather_2d_index": lambda dt: (
        "gather", {"X": [_a(18, 4, 2, 3, dtype=dt)],
                   "Index": [np.array([[3, 1], [0, 3]], np.int32)]},
        {}, ("X",), ("Out",)),
    "cos_sim": _cos,
    "cos_sim_one_row": lambda dt: _cos(dt, 1),
}


def _kmax_ties():
    x = _a(20, 3, 6)
    x[0, [1, 3, 4]] = 1.5  # a three-way tie at the top
    x[2, :] = 0.25         # every step equal
    return x


NONDIFF = {
    "sequence_erase": ("sequence_erase",
                       {"X": [np.array([[2, 5, 3, 5, 1], [5, 5, 4, 0, 0],
                                        [7, 2, 0, 0, 0]], np.int64)],
                        "Length": [_len(5, 3, 1)]},
                       {"tokens": [5, 2]}),
    "sequence_erase_none": ("sequence_erase",
                            {"X": [np.array([[2, 5], [1, 3]], np.int32)],
                             "Length": [_len(2, 1)]}, {"tokens": []}),
    "kmax_seq_score": ("kmax_seq_score",
                       {"X": [_a(21, 4, 6)], "Length": [_len(6, 1, 3, 4)]},
                       {"beam_size": 3}),
    "kmax_seq_score_ties": ("kmax_seq_score",
                            {"X": [_kmax_ties()[..., None]],
                             "Length": [_len(6, 2, 6)]},
                            {"beam_size": 4}),
    "kmax_seq_score_k_over_t": ("kmax_seq_score",
                                {"X": [_a(22, 2, 3)],
                                 "Length": [_len(3, 1)]},
                                {"beam_size": 5}),
    "sub_nested_seq": ("sub_nested_seq",
                       {"X": [_a(23, 2, 3, 4, 2)],
                        "Length": [np.array([[4, 1, 2], [3, 0, 4]],
                                            np.int32)],
                        "SelectedIndices": [np.array([[2, 0], [-1, 2]],
                                                     np.int64)]}, {}),
    "lod_reset_y": ("lod_reset", {"X": [_a(24, 3, 4)],
                                  "Y": [np.array([[2], [4], [1]], np.int64)]},
                    {}),
    "lod_reset_attr": ("lod_reset", {"X": [_a(25, 2, 5, 3)]},
                       {"target_lengths": [5, 2]}),
    "shape": ("shape", {"Input": [_a(26, 2, 5, 3)]}, {}),
    "arg_sort": ("arg_sort", {"X": [np.array([3.0, 1.0, 3.0, 0.5, 1.0],
                                             np.float32)]}, {"axis": 0}),
    "arg_sort_column": ("arg_sort",
                        {"X": [np.array([[-2.0], [-5.0], [-2.0], [-5.0]],
                                        np.float32)]}, {"axis": 0}),
    "arg_sort_rows": ("arg_sort",
                      {"X": [np.array([[2, 1, 2], [0, 0, -1]], np.int32)]},
                      {"axis": 1}),
}


def test_registry_holds_the_new_ops_as_jax_does():
    for op in NEW_OPS:
        ti, ji = treg.get_op_info(op), jreg.get_op_info(op)
        assert (ti.grad is None) == (ji.grad is None), op
        assert ti.non_diff_inputs == ji.non_diff_inputs, op
        assert ti.non_diff_outputs == ji.non_diff_outputs, op
    assert set(treg.registered_ops()) <= set(jreg.registered_ops())
    covered = {c(np.float32)[0] for c in DIFF.values()} \
        | {c[0] for c in NONDIFF.values()}
    assert covered == set(NEW_OPS)


@pytest.mark.parametrize("case", sorted(DIFF))
def test_differentiable_op_output_matches_jax(case):
    op_type, ins, attrs, _, _ = DIFF[case](np.float32)
    _check_outputs(op_type, ins, attrs, tol=FWD_TOL)


@pytest.mark.parametrize("case", sorted(NONDIFF))
def test_nondifferentiable_op_output_matches_jax(case):
    op_type, ins, attrs = NONDIFF[case]
    _check_outputs(op_type, ins, attrs, tol=FWD_TOL)


def desc_grads_hold(op_type, ins, attrs, diff, out_slot, tag):
    """The desc-level gradients of mean(out_slot * ct) against jax.grad
    (JAX_TOL) and central differences of the port's forward
    (NUMERIC_TOL of the largest |numeric gradient|)."""
    prog, grads, values, ct = _grad_program(op_type, ins, attrs, diff,
                                            out_slot)
    _set(tfluid.global_scope(), values)
    exe = tfluid.Executor(tfluid.CPUPlace())
    names = sorted(grads)
    got = dict(zip(names, exe.run(prog, fetch_list=[grads[n]
                                                    for n in names])))
    want = _jax_grads(op_type, ins, attrs, diff, out_slot, ct)
    assert sorted(got) == sorted(want), tag
    for name, g in got.items():
        assert g.dtype == np.float64, (tag, name)
        np.testing.assert_allclose(g, want[name], rtol=JAX_TOL, atol=JAX_TOL,
                                   err_msg=f"{tag} {name}")
        num = _numeric(prog, values, name, exe)
        scale = max(float(np.abs(num).max()), 1e-3)
        err = float(np.abs(g - num).max()) / scale
        assert err < NUMERIC_TOL, (tag, name, err)


@pytest.mark.parametrize("case,out_slot", [
    (c, s) for c in sorted(DIFF) for s in DIFF[c](np.float32)[4]])
def test_desc_grad_matches_central_differences_and_jax(case, out_slot):
    op_type, ins, attrs, diff, _ = DIFF[case](np.float64)
    desc_grads_hold(op_type, ins, attrs, diff, out_slot, case)
