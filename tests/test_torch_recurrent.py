"""The port's recurrent slice against the JAX package on the CPU.

- (a) ``lstm_forward_ref`` / ``gru_forward_ref``, the plain versions of the
  CUDA kernels K7 and K9, against the Pallas kernels in interpret mode;
- (b) ``lstm_backward_ref`` / ``gru_backward_ref`` and ``LSTMTrain`` /
  ``GRUTrain`` against ``make_lstm_train`` / ``make_gru_train`` in
  interpret mode, with a non-zero cotangent for the cell states;
- (c) every op the two programs add, forward and ``generic_grad``, against
  the JAX emitters;
- (d) the stacked-LSTM classifier and the attention-NMT training program:
  the descs op for op, and three Adam steps from the JAX startup's state
  carried across by name, ragged feeds included;
- (e) the port's ``lod.py`` against the JAX package's.

Inputs come from numpy seeds and go through both packages.  On the CPU the
JAX ``lstm`` and ``gru`` emitters take their ``lax.scan`` path (the Pallas
dispatch is TPU-only) and the port's wrappers take the kernels' plain
versions.  The CUDA kernels themselves are held to their plain versions on
a card by ``tests/test_torch_kernels.py`` (``-k on_card``) and
``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import lod as jlod
from paddle_tpu.models import image_models as jimage_models
from paddle_tpu.models import seq2seq as jseq2seq
from paddle_tpu.ops import registry as jreg
from paddle_tpu.ops.pallas_kernels import _common as jcommon
from paddle_tpu.ops.pallas_kernels import gru as jgru
from paddle_tpu.ops.pallas_kernels import lstm as jlstm
from paddle_tpu_torch import lod as tlod
from paddle_tpu_torch.models import rnn_bench
from paddle_tpu_torch.ops import registry as treg
from paddle_tpu_torch.ops.cuda_kernels import _recurrent as t_rec
from paddle_tpu_torch.ops.cuda_kernels import gru as t_gru
from paddle_tpu_torch.ops.cuda_kernels import lstm as t_lstm

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# f32: two frameworks' reduction orders over H <= 128; bf16: one rounding of
# values of order 1 is 2^-9, a few of them compound over T steps
FWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# (B, T, H, lengths): the JAX tests' lane-friendly shape and an awkward one
# with a row of length 0
SHAPES = {
    "b8_h128": (8, 6, 128, [6, 6, 4, 6, 2, 6, 6, 5]),
    "b3_h20": (3, 5, 20, [5, 0, 3]),
}


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    yield


def _t(a, dtype="float32"):
    t = torch.from_numpy(np.asarray(a))
    return t.to(TORCH_DT[dtype]) if t.is_floating_point() else t


def _j(a, dtype="float32"):
    a = np.asarray(a)
    return jnp.asarray(a, JAX_DT[dtype]) if a.dtype.kind == "f" \
        else jnp.asarray(a)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() \
            else x.detach().numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind not in "iub" else x


def _rnn_inputs(shape, gates, seed=0):
    B, T, H, lengths = SHAPES[shape]
    rng = np.random.RandomState(seed)
    return {
        "x": (rng.randn(B, T, gates * H) * 0.3).astype(np.float32),
        "h0": (rng.randn(B, H) * 0.2).astype(np.float32),
        "c0": (rng.randn(B, H) * 0.2).astype(np.float32),
        "w": (rng.randn(H, gates * H) * 0.1).astype(np.float32),
        "lengths": np.asarray(lengths, np.int32),
        "dhs": rng.randn(B, T, H).astype(np.float32),
        "dcs": rng.randn(B, T, H).astype(np.float32),
    }


# -- (a) the forward plain versions against the Pallas kernels ----------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_lstm_forward_ref_matches_pallas_interpret(shape, dtype):
    a = _rnn_inputs(shape, 4)
    want = jlstm.lstm_forward(_j(a["x"], dtype), _j(a["h0"], dtype),
                              _j(a["c0"], dtype), _j(a["w"], dtype),
                              _j(a["lengths"]), interpret=True)
    got = t_lstm.lstm_forward_ref(_t(a["x"], dtype), _t(a["h0"], dtype),
                                  _t(a["c0"], dtype), _t(a["w"], dtype),
                                  _t(a["lengths"]))
    for name, g, w in zip(("hs", "cs", "hT", "cT"), got, want):
        assert g.dtype == TORCH_DT[dtype], name
        np.testing.assert_allclose(_np(g), _np(w), rtol=0,
                                   atol=FWD_TOL[dtype], err_msg=name)
    # the public wrapper takes the plain version for CPU tensors
    pub = t_lstm.lstm_forward(_t(a["x"], dtype), _t(a["h0"], dtype),
                              _t(a["c0"], dtype), _t(a["w"], dtype),
                              _t(a["lengths"]))
    for g, p in zip(got, pub):
        assert torch.equal(g, p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_gru_forward_ref_matches_pallas_interpret(shape, dtype):
    a = _rnn_inputs(shape, 3)
    want = jgru.gru_forward(_j(a["x"], dtype), _j(a["h0"], dtype),
                            _j(a["w"], dtype), _j(a["lengths"]),
                            interpret=True)
    got = t_gru.gru_forward_ref(_t(a["x"], dtype), _t(a["h0"], dtype),
                                _t(a["w"], dtype), _t(a["lengths"]))
    for name, g, w in zip(("hs", "hT"), got, want):
        assert g.dtype == TORCH_DT[dtype], name
        np.testing.assert_allclose(_np(g), _np(w), rtol=0,
                                   atol=FWD_TOL[dtype], err_msg=name)
    pub = t_gru.gru_forward(_t(a["x"], dtype), _t(a["h0"], dtype),
                            _t(a["w"], dtype), _t(a["lengths"]))
    for g, p in zip(got, pub):
        assert torch.equal(g, p)


# -- (b) the backward plain versions and the autograd functions ---------------

# the JAX kernel tests' own tolerance for these gradients (f32 sums over
# T*B rows in another order)
BWD_ATOL = 3e-4


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_lstm_backward_ref_and_train_match_pallas_interpret(shape):
    a = _rnn_inputs(shape, 4)
    x, h0, c0, w = (_j(a[k]) for k in ("x", "h0", "c0", "w"))
    lengths = _j(a["lengths"])
    fused = jlstm.make_lstm_train(interpret=True)
    (jhs, jcs), vjp = jax.vjp(lambda *p: fused(*p, lengths), x, h0, c0, w)
    want = vjp((_j(a["dhs"]), _j(a["dcs"])))

    tx, th0, tc0, tw = (_t(a[k]) for k in ("x", "h0", "c0", "w"))
    tl = _t(a["lengths"])
    hs, cs, _, _ = t_lstm.lstm_forward_ref(tx, th0, tc0, tw, tl)
    got = t_lstm.lstm_backward_ref(tx, th0, tc0, tw, tl, hs, cs,
                                   _t(a["dhs"]), _t(a["dcs"]))
    leaves = [t.clone().requires_grad_(True) for t in (tx, th0, tc0, tw)]
    ths, tcs = t_lstm.LSTMTrain.apply(*leaves, tl)
    np.testing.assert_allclose(_np(ths), _np(jhs), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(tcs), _np(jcs), rtol=0, atol=1e-5)
    auto = torch.autograd.grad([ths, tcs], leaves,
                               [_t(a["dhs"]), _t(a["dcs"])])
    for name, g, au, wnt in zip(("dx", "dh0", "dc0", "dw"), got, auto, want):
        np.testing.assert_allclose(_np(g), _np(wnt), rtol=0, atol=BWD_ATOL,
                                   err_msg=name)
        assert torch.equal(g, au), name


def test_lstm_train_takes_a_missing_cell_cotangent_as_zeros():
    """``generic_grad`` leaves the Cell cotangent out: the backward then
    sees zeros for dcs, and must equal an explicit zero cotangent."""
    a = _rnn_inputs("b3_h20", 4)
    args = [_t(a[k]) for k in ("x", "h0", "c0", "w")]
    tl = _t(a["lengths"])
    leaves = [t.clone().requires_grad_(True) for t in args]
    hs, cs = t_lstm.LSTMTrain.apply(*leaves, tl)
    only_h = torch.autograd.grad([hs], leaves, [_t(a["dhs"])],
                                 retain_graph=True)
    both = torch.autograd.grad([hs, cs], leaves,
                               [_t(a["dhs"]), torch.zeros_like(cs)])
    for g, b in zip(only_h, both):
        assert torch.equal(g, b)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_gru_backward_ref_and_train_match_pallas_interpret(shape):
    a = _rnn_inputs(shape, 3)
    x, h0, w = (_j(a[k]) for k in ("x", "h0", "w"))
    lengths = _j(a["lengths"])
    fused = jgru.make_gru_train(interpret=True)
    jhs, vjp = jax.vjp(lambda *p: fused(*p, lengths), x, h0, w)
    want = vjp(_j(a["dhs"]))

    tx, th0, tw = (_t(a[k]) for k in ("x", "h0", "w"))
    tl = _t(a["lengths"])
    hs, _ = t_gru.gru_forward_ref(tx, th0, tw, tl)
    got = t_gru.gru_backward_ref(tx, th0, tw, tl, hs, _t(a["dhs"]))
    leaves = [t.clone().requires_grad_(True) for t in (tx, th0, tw)]
    ths = t_gru.GRUTrain.apply(*leaves, tl)
    np.testing.assert_allclose(_np(ths), _np(jhs), rtol=0, atol=1e-5)
    auto = torch.autograd.grad([ths], leaves, [_t(a["dhs"])])
    for name, g, au, wnt in zip(("dx", "dh0", "dw"), got, auto, want):
        np.testing.assert_allclose(_np(g), _np(wnt), rtol=0, atol=BWD_ATOL,
                                   err_msg=name)
        assert torch.equal(g, au), name


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_backward_ref_in_bf16_keeps_the_pallas_rounding_points(kind):
    """bf16: dx in bf16, dW summed in f32 from unrounded gate gradients and
    cast once — within 2e-2 of each gradient's max |g|, the bf16 kernel
    tolerance."""
    gates = 4 if kind == "lstm" else 3
    a = _rnn_inputs("b8_h128", gates)
    dt = "bfloat16"
    lengths = _j(a["lengths"])
    if kind == "lstm":
        jin = [_j(a[k], dt) for k in ("x", "h0", "c0", "w")]
        hs, cs, _, _ = jlstm.lstm_forward(*jin, lengths, interpret=True)
        want = jlstm.lstm_backward(*jin, lengths, hs, cs, _j(a["dhs"], dt),
                                   _j(a["dcs"], dt), interpret=True)
        tin = [_t(a[k], dt) for k in ("x", "h0", "c0", "w")]
        got = t_lstm.lstm_backward_ref(
            *tin, _t(a["lengths"]), _t(_np(hs), dt), _t(_np(cs), dt),
            _t(a["dhs"], dt), _t(a["dcs"], dt))
    else:
        jin = [_j(a[k], dt) for k in ("x", "h0", "w")]
        hs, _ = jgru.gru_forward(*jin, lengths, interpret=True)
        want = jgru.gru_backward(*jin, lengths, hs, _j(a["dhs"], dt),
                                 interpret=True)
        tin = [_t(a[k], dt) for k in ("x", "h0", "w")]
        got = t_gru.gru_backward_ref(*tin, _t(a["lengths"]),
                                     _t(_np(hs), dt), _t(a["dhs"], dt))
    for g, wnt in zip(got, want):
        assert g.dtype == torch.bfloat16
        scale = float(np.abs(_np(wnt)).max())
        np.testing.assert_allclose(_np(g), _np(wnt), rtol=0,
                                   atol=2e-2 * scale)


def test_empty_batch_and_empty_time_launch_nothing():
    for B, T in ((0, 4), (3, 0)):
        H = 8
        x4, x3 = torch.zeros(B, T, 4 * H), torch.zeros(B, T, 3 * H)
        h0 = torch.ones(B, H)
        w4, w3 = torch.zeros(H, 4 * H), torch.zeros(H, 3 * H)
        ln = torch.zeros(B, dtype=torch.int32)
        hs, cs, hT, cT = t_lstm.lstm_forward(x4, h0, h0, w4, ln)
        assert hs.shape == cs.shape == (B, T, H)
        assert torch.equal(hT, h0) and torch.equal(cT, h0)
        dx, dh0, dc0, dw = t_lstm.lstm_backward(x4, h0, h0, w4, ln, hs, cs,
                                                hs, cs)
        assert dx.shape == x4.shape and not dw.any() and not dh0.any()
        ghs, ghT = t_gru.gru_forward(x3, h0, w3, ln)
        assert ghs.shape == (B, T, H) and torch.equal(ghT, h0)
        dx, dh0, dw = t_gru.gru_backward(x3, h0, w3, ln, ghs, ghs)
        assert dx.shape == x3.shape and not dw.any()


def test_wrappers_reject_what_the_kernels_do_not_take():
    H = 8
    x, h0, w = torch.zeros(2, 3, 4 * H), torch.zeros(2, H), \
        torch.zeros(H, 4 * H)
    ln = torch.tensor([3, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="agree on H"):
        t_lstm.lstm_forward(x[..., :3 * H], h0, h0, w, ln)
    with pytest.raises(ValueError, match=r"\[B,H\]"):
        t_lstm.lstm_forward(x, h0[:1], h0, w, ln)
    with pytest.raises(ValueError, match="lengths"):
        t_lstm.lstm_forward(x, h0, h0, w, ln.float())
    with pytest.raises(TypeError, match="one dtype"):
        t_lstm.lstm_forward(x, h0, h0, w.bfloat16(), ln)
    with pytest.raises(ValueError, match="agree on H"):
        t_gru.gru_forward(x, h0, w, ln)
    with pytest.raises(ValueError, match=r"\[B,T,H\]"):
        t_gru.gru_backward(x[..., :3 * H], h0, w[:, :3 * H], ln,
                           torch.zeros(2, 3, H), torch.zeros(2, 2, H))


def test_step_mask_and_reverse_within_length_match_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(4, 6, 5).astype(np.float32)
    fill = rng.randn(4, 5).astype(np.float32)
    lengths = np.array([6, 0, 3, 1], np.int32)
    np.testing.assert_array_equal(
        _np(t_rec.step_mask(_t(lengths), 6, torch.float32)),
        _np(jcommon.step_mask(_j(lengths), 6, jnp.float32)))
    np.testing.assert_array_equal(
        _np(t_rec.reverse_within_length(_t(x), _t(lengths))),
        _np(jcommon.reverse_within_length(_j(x), _j(lengths))))
    np.testing.assert_array_equal(
        _np(t_rec.reverse_within_length(_t(x), _t(lengths),
                                        pad_fill=_t(fill))),
        _np(jcommon.reverse_within_length(_j(x), _j(lengths),
                                          pad_fill=_j(fill))))
    # a row of length 0 maps every step to itself
    assert torch.equal(
        t_rec.reverse_within_length(_t(x), _t(lengths))[1], _t(x)[1])


# -- (c) each new op, forward and grad ----------------------------------------

def _f(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _op_cases():
    r = np.random.RandomState(0)
    B, T, H = 3, 5, 4
    ln = np.array([5, 2, 0], np.int32)

    def lstm_ins(bias_mult=4, init=False):
        ins = {"Input": [_f(r, B, T, 4 * H) * 0.5], "Weight": [_f(r, H, 4 * H)
                                                               * 0.3],
               "Bias": [_f(r, bias_mult * H) * 0.2], "Length": [ln]}
        if init:
            ins["H0"] = [_f(r, B, H) * 0.3]
            ins["C0"] = [_f(r, B, H) * 0.3]
        return ins

    def gru_ins(init=False):
        ins = {"Input": [_f(r, B, T, 3 * H) * 0.5],
               "Weight": [_f(r, H, 3 * H) * 0.3],
               "Bias": [_f(r, 3 * H) * 0.2], "Length": [ln]}
        if init:
            ins["H0"] = [_f(r, B, H) * 0.3]
        return ins

    lstm_attrs = {"is_reverse": False, "use_peepholes": False,
                  "gate_activation": "sigmoid", "cell_activation": "tanh",
                  "candidate_activation": "tanh"}
    gru_attrs = {"is_reverse": False, "gate_activation": "sigmoid",
                 "activation": "tanh"}
    pool_x = _f(r, B, T, 6)
    E, D, A, Ts, Tt = 2 * H, 3, 5, T, 4
    cases = {
        "lstm": ("lstm", lstm_ins(), lstm_attrs),
        "lstm_reverse_init": ("lstm", lstm_ins(init=True),
                              {**lstm_attrs, "is_reverse": True}),
        "lstm_peepholes": ("lstm", lstm_ins(bias_mult=7),
                           {**lstm_attrs, "use_peepholes": True}),
        "lstm_peepholes_reverse": (
            "lstm", lstm_ins(bias_mult=7, init=True),
            {**lstm_attrs, "use_peepholes": True, "is_reverse": True}),
        "lstm_other_activations": (
            "lstm", lstm_ins(),
            {**lstm_attrs, "gate_activation": "tanh",
             "cell_activation": "relu", "candidate_activation": "sigmoid"}),
        "gru": ("gru", gru_ins(), gru_attrs),
        "gru_reverse_init": ("gru", gru_ins(init=True),
                             {**gru_attrs, "is_reverse": True}),
        "gru_other_activations": (
            "gru", gru_ins(init=True),
            {**gru_attrs, "gate_activation": "tanh", "activation": "relu",
             "is_reverse": True}),
        "sequence_reverse": ("sequence_reverse",
                             {"X": [_f(r, B, T, 6)], "Length": [ln]}, {}),
        "masked_seq_mean": ("masked_seq_mean",
                            {"X": [_f(r, B, T, 1)], "Length": [ln]}, {}),
        "concat": ("concat", {"X": [_f(r, B, T, 2), _f(r, B, T, 3)]},
                   {"axis": 2}),
        "tanh": ("tanh", {"X": [_f(r, 3, 4)]}, {}),
        "attention_gru_decoder": (
            "attention_gru_decoder",
            {"EncOut": [_f(r, B, Ts, E)],
             "EncLength": [np.array([5, 2, 1], np.int32)],
             "TgtEmb": [_f(r, B, Tt, D)],
             "TgtLength": [np.array([4, 1, 3], np.int32)],
             "H0": [_f(r, B, H) * 0.3], "WIn": [_f(r, D + E, 3 * H) * 0.3],
             "BIn": [_f(r, 3 * H) * 0.1], "WH": [_f(r, H, 3 * H) * 0.3],
             "WQuery": [_f(r, H, A) * 0.3], "WMem": [_f(r, E, A) * 0.3],
             "V": [_f(r, A)]}, {}),
        # the shapes the two programs give the ops they reuse
        "mul_3d": ("mul", {"X": [_f(r, B, T, 6)], "Y": [_f(r, 6, 4)]},
                   {"x_num_col_dims": 2, "y_num_col_dims": 1}),
        "elementwise_add_axis2": ("elementwise_add",
                                  {"X": [_f(r, B, T, 6)], "Y": [_f(r, 6)]},
                                  {"axis": 2}),
        "lookup_table_3d_ids": (
            "lookup_table",
            {"W": [_f(r, 10, 4)],
             "Ids": [r.randint(0, 10, (B, T, 1)).astype(np.int64)]},
            {"is_sparse": False, "padding_idx": -1}),
        "softmax_with_cross_entropy_3d": (
            "softmax_with_cross_entropy",
            {"Logits": [_f(r, B, T, 7)],
             "Label": [r.randint(0, 7, (B, T, 1)).astype(np.int64)]},
            {"soft_label": False}),
    }
    for ptype in ("sum", "average", "sqrt", "max", "last", "first"):
        cases[f"sequence_pool_{ptype}"] = (
            "sequence_pool", {"X": [pool_x], "Length": [ln]},
            {"pooltype": ptype})
    return cases


_OP_CASES = _op_cases()


def _jax_ctx(is_test=False):
    return jreg.EmitContext(jax.random.PRNGKey(0), is_test=is_test)


def _torch_ctx(is_test=False):
    return treg.EmitContext(torch.device("cpu"), is_test=is_test)


def _emit_both(op_type, ins, attrs, is_test=False):
    jouts = jreg.get_op_info(op_type).emit(
        _jax_ctx(is_test), {s: [jnp.asarray(a) for a in v]
                            for s, v in ins.items()}, attrs)
    touts = treg.get_op_info(op_type).emit(
        _torch_ctx(is_test), {s: [torch.from_numpy(a) for a in v]
                              for s, v in ins.items()}, attrs)
    return jouts, touts


# f32 on the CPU in two frameworks: 1e-5 covers reduction-order and
# transcendental differences at these sizes (T <= 5, widths <= 16)
@pytest.mark.parametrize("case", sorted(_OP_CASES))
def test_op_and_grad_match_jax(case):
    op_type, ins, attrs = _OP_CASES[case]
    jinfo, tinfo = jreg.get_op_info(op_type), treg.get_op_info(op_type)
    jouts, touts = _emit_both(op_type, ins, attrs)
    assert sorted(touts) == sorted(jouts)
    for slot in jouts:
        for j, t in zip(jouts[slot], touts[slot]):
            assert _np(t).shape == _np(j).shape, slot
            np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{case} {slot}")
    assert tinfo.non_diff_outputs == jinfo.non_diff_outputs
    assert tinfo.non_diff_inputs == jinfo.non_diff_inputs

    rng = np.random.RandomState(1)
    cts = {s: [rng.randn(*_np(o).shape).astype(np.float32)
               for o in jouts[s]]
           for s in jouts if s not in tinfo.non_diff_outputs}
    wanted = {(s, i) for s, v in ins.items()
              if s not in tinfo.non_diff_inputs
              for i, a in enumerate(v) if a.dtype.kind == "f"}
    gattrs = {"__fwd_type__": op_type, "__fwd_attrs__": dict(attrs),
              "__fwd_input_slots__": sorted(ins),
              "__fwd_output_slots__": sorted(jouts), "__uid__": 0,
              "__wanted__": wanted}

    def grad_ins(conv, outs):
        g = {s: [conv(a) for a in v] for s, v in ins.items()}
        g.update({s: list(v) for s, v in outs.items()})
        g.update({s + "@GRAD": [conv(a) for a in v] for s, v in cts.items()})
        return g

    jg = jreg.get_op_info("generic_grad").emit(
        _jax_ctx(), grad_ins(jnp.asarray, jouts), gattrs)
    tg = treg.get_op_info("generic_grad").emit(
        _torch_ctx(), grad_ins(torch.from_numpy, touts), gattrs)
    assert sorted(tg) == sorted(jg) == sorted(
        {s + "@GRAD" for s, _ in wanted})
    for slot in jg:
        for j, t in zip(jg[slot], tg[slot]):
            np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{case} {slot}")


@pytest.mark.parametrize("case", ["lstm", "lstm_reverse_init", "gru",
                                  "gru_reverse_init"])
def test_recurrent_op_in_test_mode_matches_jax(case):
    """``ctx.is_test``: the emitters call the forward function alone."""
    op_type, ins, attrs = _OP_CASES[case]
    jouts, touts = _emit_both(op_type, ins, attrs, is_test=True)
    for slot in jouts:
        np.testing.assert_allclose(_np(touts[slot][0]), _np(jouts[slot][0]),
                                   rtol=1e-5, atol=1e-5, err_msg=slot)
        assert not touts[slot][0].requires_grad


def test_lstm_peepholes_need_a_7h_bias():
    op_type, ins, attrs = _OP_CASES["lstm"]
    with pytest.raises(ValueError, match="use_peepholes needs"):
        treg.get_op_info("lstm").emit(
            _torch_ctx(), {s: [torch.from_numpy(a) for a in v]
                           for s, v in ins.items()},
            {**attrs, "use_peepholes": True})


def test_sequence_pool_rejects_an_unknown_pooltype():
    _, ins, _ = _OP_CASES["sequence_pool_sum"]
    with pytest.raises(ValueError, match="unknown pooltype"):
        treg.get_op_info("sequence_pool").emit(
            _torch_ctx(), {s: [torch.from_numpy(a) for a in v]
                           for s, v in ins.items()}, {"pooltype": "median"})


# -- (d) the two programs ------------------------------------------------------

LV, LH, LT, LB = 50, 16, 8, 4   # the classifier, tiny
NV, ND, NT, NB = 40, 16, 8, 4   # the NMT program, tiny


def _jax_lstm_program(dtype="float32", train=True):
    """``bench.py``'s ``bench_lstm_train`` program, in the JAX package."""
    words = jfluid.layers.sequence_data(name="words", shape=[1],
                                        dtype="int64", max_len=LT)
    label = jfluid.layers.data(name="label", shape=[1], dtype="int64")
    emb = jfluid.layers.sequence_embedding(words, size=[LV, LH], dtype=dtype)
    logits = jimage_models.stacked_lstm_net(emb, hidden_dim=LH,
                                            stacked_num=2, class_dim=2)
    logits32 = jfluid.layers.cast(logits, "float32") \
        if dtype != "float32" else logits
    loss = jfluid.layers.mean(
        jfluid.layers.softmax_with_cross_entropy(logits32, label))
    if train:
        jfluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return loss


def _jax_nmt_program():
    model = jseq2seq.Seq2SeqAttention(NV, NV, emb_dim=ND, hidden=ND, attn=ND)
    src = jfluid.layers.sequence_data("src", shape=[1], dtype="int64",
                                      max_len=NT)
    tgt = jfluid.layers.sequence_data("tgt", shape=[1], dtype="int64",
                                      max_len=NT)
    nxt = jfluid.layers.sequence_data("tgt_next", shape=[1], dtype="int64",
                                      max_len=NT)
    loss = model.train_cost(src, tgt, nxt)
    jfluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return loss


def _build_both(which, dtype="float32"):
    jfluid.reset()
    if which == "lstm":
        jloss = _jax_lstm_program(dtype)
        tloss = rnn_bench.lstm_train_program(vocab=LV, hidden=LH, seq_len=LT,
                                             dtype=dtype, learning_rate=0.01)
    else:
        jloss = _jax_nmt_program()
        tloss = rnn_bench.nmt_train_program(vocab=NV, dim=ND, seq_len=NT,
                                            learning_rate=0.01)
    return jloss, tloss


def _desc(program):
    return [(op.type, op.inputs, op.outputs, op.attrs)
            for op in program.global_block().ops]


@pytest.mark.parametrize("which,dtype", [("lstm", "float32"),
                                         ("lstm", "bfloat16"),
                                         ("nmt", "float32")])
def test_program_desc_matches_jax_op_for_op(which, dtype):
    _build_both(which, dtype)
    jops = _desc(jfluid.default_main_program())
    tops = _desc(tfluid.default_main_program())
    assert len(tops) == len(jops)
    for i, (t, j) in enumerate(zip(tops, jops)):
        assert t == j, f"op {i}: port {t[0]} != JAX {j[0]}"
    assert _desc(tfluid.default_startup_program()) == \
        _desc(jfluid.default_startup_program())

    def persistables(program):
        return sorted((v.name, v.shape, v.dtype)
                      for v in program.global_block().vars.values()
                      if v.persistable)

    assert persistables(tfluid.default_main_program()) == \
        persistables(jfluid.default_main_program())
    kinds = {t[0] for t in tops}
    assert ("lstm" if which == "lstm" else "gru") in kinds


def _ragged_lstm_feed():
    """The classifier's feed as ragged sequences (a list of [n, 1] arrays):
    both executors pad it to the bucket and add ``words@LENGTH``."""
    rng = np.random.RandomState(5)
    seqs = [rng.randint(0, LV, (n, 1)).astype(np.int64)
            for n in (3, 8, 5, 1)]
    return {"words": seqs,
            "label": rng.randint(0, 2, (LB, 1)).astype(np.int64)}


_FEEDS = {
    "lstm_full": ("lstm", lambda: rnn_bench.lstm_feed(LB, LT, LV)),
    "lstm_padded_ragged": ("lstm", lambda: rnn_bench.lstm_feed(
        LB, LT, LV, ragged=True, seed=1)),
    "lstm_lod_feed": ("lstm", _ragged_lstm_feed),
    "nmt_ragged": ("nmt", lambda: rnn_bench.nmt_feed(NB, NT, NV)),
}


@pytest.mark.parametrize("case", sorted(_FEEDS))
def test_three_adam_steps_match_jax(case):
    """From the JAX startup's values carried across by name: per-step
    losses (1e-4 relative) and every parameter and moment after step 3
    (1e-4: three Adam steps at lr 1e-2 amplify f32 gradient noise where
    |g| ~ sqrt(v))."""
    which, make_feed = _FEEDS[case]
    jloss, tloss = _build_both(which)
    jmain, tmain = jfluid.default_main_program(), \
        tfluid.default_main_program()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    persist = [n for n, v in jmain.global_block().vars.items()
               if v.persistable]
    tfluid.load_persistables(
        tmain, {n: jfluid.global_scope().find_np(n) for n in persist})
    texe = tfluid.Executor(tfluid.CPUPlace())
    feed = make_feed()
    jl, tl = [], []
    for _ in range(3):
        jl.append(float(np.asarray(
            jexe.run(jmain, feed=feed, fetch_list=[jloss])[0])[0]))
        tl.append(float(texe.run(tmain, feed=feed, fetch_list=[tloss])[0][0]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[2] < tl[0]
    for n in persist:
        np.testing.assert_allclose(
            tfluid.global_scope().find_np(n),
            jfluid.global_scope().find_np(n), rtol=1e-4, atol=1e-4,
            err_msg=n)


def test_lstm_program_in_test_mode_matches_jax_and_the_training_forward():
    """The forward program without grad ops runs with ``is_test``: the
    ``lstm`` op calls ``lstm_forward`` alone; the loss equals JAX's and the
    training program's first loss from the same weights."""
    jfluid.reset()
    jloss = _jax_lstm_program(train=False)
    tloss = rnn_bench.lstm_train_program(vocab=LV, hidden=LH, seq_len=LT,
                                         dtype="float32", train=False)
    tmain = tfluid.default_main_program()
    assert not any(op.type.endswith("_grad")
                   for op in tmain.global_block().ops)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    tfluid.load_persistables(tmain, {
        n: jfluid.global_scope().find_np(n)
        for n, v in tmain.global_block().vars.items() if v.persistable})
    feed = rnn_bench.lstm_feed(LB, LT, LV, ragged=True, seed=2)
    (j,) = jexe.run(feed=feed, fetch_list=[jloss])
    (t,) = tfluid.Executor(tfluid.CPUPlace()).run(feed=feed,
                                                   fetch_list=[tloss])
    np.testing.assert_allclose(t, np.asarray(j), rtol=1e-5)


def test_bf16_lstm_steps_are_finite_and_fall():
    loss = rnn_bench.lstm_train_program(vocab=LV, hidden=LH, seq_len=LT,
                                        dtype="bfloat16", learning_rate=0.01)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    feed = rnn_bench.lstm_feed(LB, LT, LV, ragged=True)
    losses = [float(exe.run(feed=feed, fetch_list=[loss])[0][0])
              for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    w = tfluid.global_scope().find("dynamic_lstm_0.w_0")
    assert w is not None and w.dtype == torch.bfloat16


def test_recurrent_steps_launch_no_kernel_on_cpu():
    fns = (t_lstm.lstm_forward, t_lstm.lstm_backward, t_gru.gru_forward,
           t_gru.gru_backward)
    before = [f.launches for f in fns]
    for which in ("lstm", "nmt"):
        tfluid.reset()
        if which == "lstm":
            loss = rnn_bench.lstm_train_program(vocab=LV, hidden=LH,
                                                seq_len=LT, dtype="float32")
            feed = rnn_bench.lstm_feed(LB, LT, LV)
        else:
            loss = rnn_bench.nmt_train_program(vocab=NV, dim=ND, seq_len=NT)
            feed = rnn_bench.nmt_feed(NB, NT, NV)
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(tfluid.default_startup_program())
        exe.run(feed=feed, fetch_list=[loss])
    assert [f.launches for f in fns] == before


def test_get_length_var_needs_a_sequence_input():
    x = tfluid.layers.data("x", shape=[4, 8], dtype="float32")
    with pytest.raises(ValueError, match="no sequence-length companion"):
        tfluid.layers.sequence_pool(x)


def test_rnn_bench_feeds_keep_the_bench_draws():
    """The full-length feed is ``bench.py``'s: words then labels from
    ``RandomState(0)``; a ragged feed keeps one full row and zero pads."""
    feed = rnn_bench.lstm_feed(4, 6, 100)
    rng = np.random.RandomState(0)
    np.testing.assert_array_equal(feed["words"],
                                  rng.randint(0, 100, (4, 6, 1)))
    np.testing.assert_array_equal(feed["label"], rng.randint(0, 2, (4, 1)))
    assert feed["words@LENGTH"].tolist() == [6] * 4
    rag = rnn_bench.lstm_feed(16, 6, 100, ragged=True)
    ln = rag["words@LENGTH"]
    assert ln.dtype == np.int32 and ln[0] == 6 and ln.min() >= 1
    assert len(set(ln.tolist())) > 1
    for b, n in enumerate(ln):
        assert not rag["words"][b, n:].any()
    nmt = rnn_bench.nmt_feed(8, 6, 50)
    for b, n in enumerate(nmt["tgt@LENGTH"]):
        assert nmt["tgt_next"][b, n - 1, 0] == 1      # <eos>
        assert nmt["tgt"][b, 0, 0] == 0               # <bos>
        assert not nmt["tgt_next"][b, n:].any()


# -- (e) lod.py ----------------------------------------------------------------

def test_lod_matches_the_jax_package():
    rng = np.random.RandomState(4)
    seqs = [rng.randn(n, 3).astype(np.float32) for n in (2, 9, 5, 1)]
    j, t = jlod.LoDTensor.from_sequences(seqs), \
        tlod.LoDTensor.from_sequences(seqs)
    assert t.lod == j.lod and t.num_sequences == j.num_sequences
    np.testing.assert_array_equal(t.data, j.data)
    np.testing.assert_array_equal(t.sequence_lengths(),
                                  j.sequence_lengths())
    for kw in ({}, {"bucket": False}, {"max_len": 4}):
        (tp, tl), (jp, jl) = t.to_padded(**kw), j.to_padded(**kw)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tl, jl)
        assert tl.dtype == np.int32
    back = tlod.LoDTensor.from_padded(*t.to_padded())
    assert back.lod == t.lod
    np.testing.assert_array_equal(back.data, t.data)
    assert tlod.LENGTH_SUFFIX == jlod.LENGTH_SUFFIX
    for n in (1, 8, 9, 96, 97, 1024, 1025, 3000):
        assert tlod.bucket_len(n) == jlod.bucket_len(n)
    for v in (seqs, t, [1, 2, 3], np.zeros((2, 3)), [], [[1, 2], [3]]):
        jv = j if v is t else v
        assert tlod.is_lod_feed(v) == jlod.is_lod_feed(jv)
    assert tlod.as_lod_tensor(t) is t
    assert tlod.as_lod_tensor(seqs).lod == j.lod
    with pytest.raises(ValueError, match="inconsistent"):
        tlod.LoDTensor(np.zeros((4, 2)), [[0, 2, 5]])


def test_executor_pads_ragged_feeds_and_adds_lengths():
    words = tfluid.layers.sequence_data("words", shape=[1], dtype="int64")
    as_float = tfluid.layers.propagate_length(
        words, tfluid.layers.cast(words, "float32"))
    out = tfluid.layers.sequence_pool(as_float, pool_type="sum")
    seqs = [np.full((n, 1), n, np.int64) for n in (3, 9, 1)]
    exe = tfluid.Executor(tfluid.CPUPlace())
    for feed in (seqs, tlod.LoDTensor.from_sequences(seqs)):
        padded, ln, pooled = exe.run(
            feed={"words": feed},
            fetch_list=["words", "words@LENGTH", out], return_numpy=False)
        assert tuple(padded.shape) == (3, 16, 1)       # bucket of 9
        assert padded.dtype == torch.int64 and ln.dtype == torch.int32
        assert ln.tolist() == [3, 9, 1]
        assert pooled[:, 0].tolist() == [9.0, 81.0, 1.0]
