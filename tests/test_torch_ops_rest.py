"""The last 48 op types of the port, held to the JAX package on the CPU:

- each op run as a one-op program by the port's Executor on seeded numpy
  inputs: every output equal to the JAX emitter's (f32 within 1e-5 of its
  largest |value|, integer outputs exact, the same dtype), and its
  desc-level gradient (``append_backward``, ``generic_grad``) of ``sum_k
  mean(out_k * ct_k)`` equal to ``jax.grad`` of the JAX emitter within
  1e-5 of the largest |gradient|, at the kinks too (ties of ``maxout``,
  ``arg_max`` and the indexed max pools, zeros in ``l1_norm``, a gold
  outside the beam, padded candidates);
- the same emitter on meta tensors (the verifier's shape oracle) gives
  the real run's shapes and dtypes;
- the two ops that draw from the generator by their properties (bounds,
  moments, frequencies against the JAX draws), deterministic per seed;
- ``save`` and ``load``: a file written by either package is read by the
  other;
- the registry: each op's grad, non-differentiable slots and
  ``draws_rng`` as the JAX registration implies."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.framework.backward import append_backward
from paddle_tpu_torch.ops import registry as treg

TOL = 1e-5

NEW_OPS = """pad crop reverse expand squeeze prelu maxout norm squared_l2_distance
smooth_l1_loss huber_loss rank_loss arg_max multiplex hsigmoid selective_fc
factorization_machine bilinear_interp bilinear_tensor_product conv3d
conv3d_transpose pool3d spp conv_shift cross_entropy_over_beam
cross_entropy_selfnorm huber_classification lambda_rank sampling_id
scale_sub_region depthwise_conv2d fill_zeros_like hinge_loss l1_norm load
log_loss log_softmax margin_rank_loss max_pool2d_with_index
max_pool3d_with_index minus modified_huber_loss one_hot save scatter
sequence_mask truncated_gaussian_random unpool""".split()
RNG_OPS = ("sampling_id", "truncated_gaussian_random")
IO_OPS = ("save", "load")


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    jfluid.reset()
    yield


def _a(seed, *shape, lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _i(*v, dt=np.int64):
    return np.array(v, dt)


def _labels01(seed, n):
    return (np.random.RandomState(seed).rand(n, 1) > 0.5).astype(np.float32)


def _ties_maxout():
    x = _a(3, 2, 6, 3, 3)
    x[0, 1] = x[0, 0]          # a tie within a group of 2
    return x


def _ties_argmax():
    x = _a(4, 3, 5)
    x[0, 1] = x[0, 3] = 3.0    # the lowest index wins
    x[2, :] = 1.0
    return x


def _ties_pool():
    x = _a(5, 2, 2, 5, 5)
    x[0, 0, 0:2, 0:2] = 2.5    # a window of four equal maxima
    return x


def _zeros_l1():
    x = _a(6, 3, 4)
    x[0, :2] = 0.0             # the kink of |x|
    return x


def _beam(length=True, gold_out=False, three_d=False):
    x = _a(20, 3, 6, 1) if three_d else _a(20, 3, 6)
    ids = _i([0, 2, 4], [1, 3, 5], [2, 0, 5])
    gold = _i([2], [4] if gold_out else [3], [5])
    ins = {"X": [x], "Ids": [ids], "Label": [gold]}
    if length:
        ins["Length"] = [_i(6, 6, 3)]   # the third row's id 5 is padding
    return ("cross_entropy_over_beam", ins, {}, ("X",))


def _lambda(ndcg):
    s = _a(21, 3, 6, 1)
    s[1, 0, 0] = s[1, 2, 0]    # tied scores keep index order
    rel = np.random.RandomState(22).randint(0, 3, (3, 6, 1)).astype(
        np.float32)
    return ("lambda_rank", {"X": [s], "Score": [rel],
                            "Length": [_i(6, 4, 2)]},
            {"NDCG_num": ndcg}, ("X",))


def _hsig(num_classes, bias):
    ins = {"X": [_a(23, 4, 5)], "W": [_a(24, num_classes - 1, 5)],
           "Label": [_i([0], [num_classes - 1], [2], [num_classes // 2])]}
    if bias:
        ins["Bias"] = [_a(25, 1, num_classes - 1)]
    return ("hsigmoid", ins, {"num_classes": num_classes},
            ("X", "W") + (("Bias",) if bias else ()))


def _unpool_ins():
    # the indices of a 2x2 stride-2 max pool of a 4x4 map: one position
    # in each window, unique
    rng = np.random.RandomState(26)
    dy, dx = rng.randint(0, 2, (2, 2, 2, 2)), rng.randint(0, 2, (2, 2, 2, 2))
    rows = np.arange(2)[:, None] * 2 + dy
    cols = np.arange(2)[None, :] * 2 + dx
    return {"X": [_a(27, 2, 2, 2, 2)], "Indices": [(rows * 4 + cols).astype(
        np.int32)]}


# (op type, inputs, attrs, differentiable slots)
CASES = {
    "pad": ("pad", {"X": [_a(1, 2, 3, 4)]},
            {"paddings": [0, 1, 2, 0, 1, 1], "pad_value": 0.5}, ("X",)),
    "crop": ("crop", {"X": [_a(2, 3, 5, 6)]},
             {"offsets": [0, 1, 2], "shape": [-1, 3, 3]}, ("X",)),
    "reverse": ("reverse", {"X": [_a(3, 2, 3, 4)]}, {"axis": [0, 2]}, ("X",)),
    "reverse_int_axis": ("reverse", {"X": [_a(3, 2, 3)]}, {"axis": 1},
                         ("X",)),
    "expand": ("expand", {"X": [_a(4, 2, 3)]}, {"expand_times": [2, 3]},
               ("X",)),
    "squeeze": ("squeeze", {"X": [_a(5, 2, 1, 3, 1)]}, {"axes": [1]},
                ("X",)),
    "squeeze_all": ("squeeze", {"X": [_a(5, 2, 1, 3, 1)]}, {}, ("X",)),
    "prelu_shared": ("prelu", {"X": [_a(6, 2, 3, 4, 4)],
                               "Alpha": [_a(7, 1, lo=0.1, hi=0.5)]},
                     {}, ("X", "Alpha")),
    "prelu_channel": ("prelu", {"X": [_a(8, 2, 3, 4, 4)],
                                "Alpha": [_a(9, 3, lo=0.1, hi=0.5)]},
                      {}, ("X", "Alpha")),
    "prelu_element": ("prelu", {"X": [_a(10, 2, 3, 2, 2)],
                                "Alpha": [_a(11, 12, lo=0.1, hi=0.5)]},
                      {}, ("X", "Alpha")),
    "maxout": ("maxout", {"X": [_a(12, 2, 6, 3, 3)]}, {"groups": 3},
               ("X",)),
    "maxout_ties": ("maxout", {"X": [_ties_maxout()]}, {"groups": 2},
                    ("X",)),
    "norm": ("norm", {"X": [_a(13, 2, 3, 4)]}, {"axis": 1}, ("X",)),
    "norm_scale": ("norm", {"X": [_a(14, 2, 3, 4)],
                            "Scale": [_a(15, 3)]},
                   {"axis": 1, "epsilon": 1e-6}, ("X", "Scale")),
    "squared_l2_distance": ("squared_l2_distance",
                            {"X": [_a(16, 4, 3)], "Y": [_a(17, 4, 3)]},
                            {}, ("X", "Y")),
    "squared_l2_distance_row": ("squared_l2_distance",
                                {"X": [_a(18, 4, 3)],
                                 "Y": [_a(19, 1, 3)]}, {}, ("X", "Y")),
    "smooth_l1_loss": ("smooth_l1_loss",
                       {"X": [_a(30, 4, 3)], "Y": [_a(31, 4, 3)]},
                       {"sigma": 1.5}, ("X", "Y")),
    "smooth_l1_loss_weights": ("smooth_l1_loss",
                               {"X": [_a(32, 4, 3)], "Y": [_a(33, 4, 3)],
                                "InsideWeight": [_a(34, 4, 3, lo=0, hi=1)],
                                "OutsideWeight": [_a(35, 4, 3, lo=0,
                                                     hi=1)]},
                               {}, ("X", "Y")),
    "huber_loss": ("huber_loss", {"X": [_a(36, 6, 1)], "Y": [_a(37, 6, 1)]},
                   {"delta": 0.8}, ("X", "Y")),
    "rank_loss": ("rank_loss", {"Label": [_labels01(38, 4)],
                                "Left": [_a(39, 4, 1)],
                                "Right": [_a(40, 4, 1)]},
                  {}, ("Left", "Right")),
    "arg_max": ("arg_max", {"X": [_ties_argmax()]}, {"axis": -1}, ()),
    "arg_max_axis0": ("arg_max", {"X": [_ties_argmax()]}, {"axis": 0}, ()),
    "multiplex": ("multiplex", {"Ids": [_i([2], [0], [1], [2])],
                                "X": [_a(41, 4, 5), _a(42, 4, 5),
                                      _a(43, 4, 5)]}, {}, ("X",)),
    "hsigmoid": _hsig(6, bias=True),
    "hsigmoid_pow2_no_bias": _hsig(8, bias=False),
    "selective_fc": ("selective_fc",
                     {"X": [_a(44, 3, 4)], "W": [_a(45, 4, 6)],
                      "Bias": [_a(46, 6)],
                      "Mask": [(np.random.RandomState(47).rand(3, 6) > 0.5)
                               .astype(np.float32)]},
                     {}, ("X", "W", "Bias")),
    "factorization_machine": ("factorization_machine",
                              {"Input": [_a(48, 3, 5)],
                               "Factors": [_a(49, 5, 4)]},
                              {}, ("Input", "Factors")),
    "bilinear_interp_up": ("bilinear_interp", {"X": [_a(50, 2, 2, 3, 4)]},
                           {"out_h": 5, "out_w": 7}, ("X",)),
    "bilinear_interp_down": ("bilinear_interp", {"X": [_a(51, 2, 2, 6, 5)]},
                             {"out_h": 2, "out_w": 1}, ("X",)),
    "bilinear_tensor_product": ("bilinear_tensor_product",
                                {"X": [_a(52, 3, 4)], "Y": [_a(53, 3, 5)],
                                 "Weight": [_a(54, 2, 4, 5)],
                                 "Bias": [_a(55, 1, 2)]},
                                {}, ("X", "Y", "Weight", "Bias")),
    "conv3d": ("conv3d", {"Input": [_a(56, 2, 2, 4, 5, 5)],
                          "Filter": [_a(57, 3, 2, 3, 3, 3)]},
               {"strides": [1, 2, 1], "paddings": [1, 0, 1],
                "dilations": [1, 1, 2]}, ("Input", "Filter")),
    "conv3d_groups": ("conv3d", {"Input": [_a(58, 1, 4, 3, 3, 3)],
                                 "Filter": [_a(59, 2, 2, 2, 2, 2)]},
                      {"groups": 2}, ("Input", "Filter")),
    "conv3d_transpose": ("conv3d_transpose",
                         {"Input": [_a(60, 2, 3, 3, 3, 3)],
                          "Filter": [_a(61, 3, 2, 2, 3, 2)]},
                         {"strides": [2, 2, 2], "paddings": [0, 1, 0],
                          "dilations": [1, 1, 2]}, ("Input", "Filter")),
    "conv3d_transpose_wide_pad": ("conv3d_transpose",
                                  {"Input": [_a(62, 1, 2, 7, 7, 4)],
                                   "Filter": [_a(63, 2, 2, 3, 3, 3)]},
                                  {"strides": [1, 1, 1],
                                   "paddings": [3, 3, 1]},
                                  ("Input", "Filter")),
    "pool3d_max": ("pool3d", {"X": [_a(64, 2, 2, 4, 4, 4)]},
                   {"pooling_type": "max", "ksize": [2, 2, 2]}, ("X",)),
    "pool3d_avg_pad": ("pool3d", {"X": [_a(65, 1, 2, 4, 5, 4)]},
                       {"pooling_type": "avg", "ksize": [3, 3, 3],
                        "strides": [2, 2, 2], "paddings": [1, 1, 1]},
                       ("X",)),
    "pool3d_global": ("pool3d", {"X": [_a(66, 2, 2, 3, 3, 3)]},
                      {"pooling_type": "avg", "global_pooling": True},
                      ("X",)),
    "spp_max": ("spp", {"X": [_a(67, 2, 2, 5, 6)]},
                {"pyramid_height": 3, "pooling_type": "max"}, ("X",)),
    "spp_avg": ("spp", {"X": [_a(68, 2, 2, 4, 3)]},
                {"pyramid_height": 2, "pooling_type": "avg"}, ("X",)),
    "conv_shift": ("conv_shift", {"X": [_a(69, 3, 7)], "Y": [_a(70, 3, 3)]},
                   {}, ("X", "Y")),
    "cross_entropy_over_beam": _beam(),
    "cross_entropy_over_beam_no_length_3d": _beam(length=False,
                                                  three_d=True),
    "cross_entropy_over_beam_gold_out": _beam(gold_out=True),
    "cross_entropy_selfnorm": ("cross_entropy_selfnorm",
                               {"X": [_a(71, 4, 5, lo=0.1, hi=1.0)],
                                "Label": [_i([0], [4], [2], [1])]},
                               {"softmax_selfnorm_alpha": 0.2}, ("X",)),
    "huber_classification": ("huber_classification",
                             {"X": [np.array([[-2.0], [-0.5], [0.3], [1.5],
                                              [0.9], [-1.2]], np.float32)],
                              "Label": [_i([1], [0], [1], [1], [0], [0])]},
                             {}, ("X",)),
    "lambda_rank": _lambda(3),
    "lambda_rank_wide_ndcg": _lambda(10),
    "scale_sub_region": ("scale_sub_region",
                         {"X": [_a(72, 2, 3, 4, 5)],
                          "Indices": [_i([1, 2, 2, 3, 1, 5],
                                         [3, 3, 1, 4, 2, 2])]},
                         {"value": 2.5}, ("X",)),
    "depthwise_conv2d": ("depthwise_conv2d",
                         {"Input": [_a(73, 2, 3, 5, 5)],
                          "Filter": [_a(74, 3, 1, 3, 3)]},
                         {"paddings": [1, 1], "strides": [2, 1]},
                         ("Input", "Filter")),
    "fill_zeros_like": ("fill_zeros_like", {"X": [_a(75, 3, 2)]}, {}, ()),
    "hinge_loss": ("hinge_loss", {"Logits": [np.array(
        [[0.5], [-2.0], [1.0], [0.2]], np.float32)],
        "Labels": [np.array([[1], [0], [1], [0]], np.float32)]},
        {}, ("Logits",)),
    "l1_norm": ("l1_norm", {"X": [_zeros_l1()]}, {}, ("X",)),
    "log_loss": ("log_loss", {"Predicted": [_a(76, 5, 1, lo=0.05, hi=0.95)],
                              "Labels": [_labels01(77, 5)]},
                 {"epsilon": 1e-6}, ("Predicted",)),
    "log_softmax": ("log_softmax", {"X": [_a(78, 3, 5)]}, {}, ("X",)),
    "margin_rank_loss": ("margin_rank_loss",
                         {"Label": [np.array([[1], [-1], [1], [-1]],
                                             np.float32)],
                          "X1": [_a(79, 4, 1)], "X2": [_a(80, 4, 1)]},
                         {"margin": 0.1}, ("X1", "X2")),
    "max_pool2d_with_index": ("max_pool2d_with_index", {"X": [_ties_pool()]},
                              {"ksize": [2, 2], "strides": [2, 2],
                               "paddings": [1, 1]}, ("X",)),
    "max_pool2d_with_index_overlap": ("max_pool2d_with_index",
                                      {"X": [_a(81, 2, 2, 5, 5)]},
                                      {"ksize": [3, 3], "strides": [2, 2]},
                                      ("X",)),
    "max_pool3d_with_index": ("max_pool3d_with_index",
                              {"X": [_a(82, 1, 2, 4, 4, 5)]},
                              {"ksize": [2, 2, 2], "strides": [2, 2, 2],
                               "paddings": [0, 1, 1]}, ("X",)),
    "minus": ("minus", {"X": [_a(83, 3, 4)], "Y": [_a(84, 3, 4)]}, {},
              ("X", "Y")),
    "modified_huber_loss": ("modified_huber_loss",
                            {"X": [np.array([[-2.0], [-0.5], [0.3], [1.5],
                                             [0.9], [-1.2]], np.float32)],
                             "Y": [np.array([[1], [0], [1], [1], [0], [0]],
                                            np.float32)]},
                            {}, ("X",)),
    "one_hot": ("one_hot", {"X": [_i([0], [3], [7], [4])]}, {"depth": 5},
                ()),
    "scatter": ("scatter", {"X": [_a(85, 5, 3)], "Ids": [_i(3, 0)],
                            "Updates": [_a(86, 2, 3)]}, {},
                ("X", "Updates")),
    "sequence_mask": ("sequence_mask", {"X": [_i(3, 0, 5, 1)]},
                      {"maxlen": 5}, ()),
    "sequence_mask_int": ("sequence_mask", {"X": [_i(2, 4)]},
                          {"maxlen": 4, "out_dtype": "int64"}, ()),
    "unpool": ("unpool", _unpool_ins(), {"ksize": [2, 2], "strides": [2, 2]},
               ("X",)),
    "unpool_dropped": ("unpool", {"X": [_a(87, 1, 1, 2, 2)],
                                  "Indices": [np.array([[[[-1, 3], [9, 15]]]],
                                                       np.int32)]},
                       {"ksize": [2, 2], "strides": [2, 2]}, ("X",)),
}


# -- the JAX side -------------------------------------------------------------

def _jax_emit(op_type, ins, attrs, subst=None):
    ctx = jreg.EmitContext(jax.random.PRNGKey(0), is_test=False)
    full = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
    for (s, i), x in (subst or {}).items():
        full[s][i] = x
    return jreg.get_op_info(op_type).emit(ctx, full, attrs)


def _loss_slots(op_type, outs):
    info = jreg.get_op_info(op_type)
    return [s for s in sorted(outs) if s not in info.non_diff_outputs
            and all(jnp.issubdtype(o.dtype, jnp.floating) for o in outs[s])]


def _jax_run(op_type, ins, attrs, slots, cts):
    """The JAX emitter's outputs and ``jax.grad`` of sum_k mean(out_k *
    ct_k) over its differentiable outputs in `slots`' inputs, in one
    jitted call."""

    def loss(xs):
        outs = _jax_emit(op_type, ins, attrs, dict(zip(slots, xs)))
        total = sum(jnp.mean(o * cts[s][k]) for s in _loss_slots(op_type,
                                                                 outs)
                    for k, o in enumerate(outs[s]))
        return total, outs

    xs = [jnp.asarray(ins[s][i]) for s, i in slots]
    if not slots:
        outs = jax.jit(lambda: _jax_emit(op_type, ins, attrs))()
        return {s: [np.asarray(o) for o in v] for s, v in outs.items()}, []
    (_, outs), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(xs)
    return ({s: [np.asarray(o) for o in v] for s, v in outs.items()},
            [np.asarray(g) for g in grads])


# -- the port side -------------------------------------------------------------

def _port_run(op_type, ins, attrs, diff, out_shapes, loss_slots, cts):
    """A one-op program, its outputs named ``<slot>_<k>``, and loss =
    sum mean(out * ct) over `loss_slots`, differentiated by
    ``append_backward``; returns ({slot: [array]}, {input name: grad})."""
    prog = tfluid.default_main_program()
    block = prog.global_block()
    in_desc, values = {}, {}
    for slot, arrs in ins.items():
        in_desc[slot] = []
        for i, a in enumerate(arrs):
            name = f"{slot}_{i}"
            if slot in diff:
                block.create_parameter(name=name, shape=a.shape,
                                       dtype=str(a.dtype))
            else:
                block.create_var(name=name, shape=a.shape,
                                 dtype=str(a.dtype), stop_gradient=True)
            in_desc[slot].append(name)
            values[name] = a
    out_desc = {s: [f"out_{s}_{k}" for k in range(len(v))]
                for s, v in out_shapes.items()}
    for names in out_desc.values():
        for n in names:
            block.create_var(name=n, shape=None, dtype=None)
    block.append_op(op_type, inputs=in_desc, outputs=out_desc,
                    attrs=dict(attrs))
    grads = {}
    if diff:
        means = []
        for s in loss_slots:
            for k, n in enumerate(out_desc[s]):
                ct = f"ct_{s}_{k}"
                block.create_var(name=ct, shape=cts[s][k].shape,
                                 dtype="float32", stop_gradient=True)
                values[ct] = cts[s][k]
                for v in (f"w_{ct}", f"m_{ct}"):
                    block.create_var(name=v, shape=None, dtype="float32")
                block.append_op("elementwise_mul",
                                inputs={"X": [n], "Y": [ct]},
                                outputs={"Out": [f"w_{ct}"]},
                                attrs={"axis": -1})
                block.append_op("mean", inputs={"X": [f"w_{ct}"]},
                                outputs={"Out": [f"m_{ct}"]})
                means.append(f"m_{ct}")
        block.create_var(name="loss", shape=(1,), dtype="float32")
        block.append_op("sum", inputs={"X": means}, outputs={"Out": ["loss"]})
        grads = {p.name: g.name
                 for p, g in append_backward(block.var("loss"))}
    scope = tfluid.global_scope()
    for n, v in values.items():
        scope.set(n, v)
    fetch = [n for s in sorted(out_desc) for n in out_desc[s]]
    names = sorted(grads)
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        prog, fetch_list=fetch + [grads[n] for n in names])
    by = dict(zip(fetch, got))
    outs = {s: [by[n] for n in out_desc[s]] for s in out_desc}
    return outs, dict(zip(names, got[len(fetch):]))


def _max_rel(got, want):
    want = np.asarray(want, np.float64)
    if want.size == 0:
        return 0.0
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


# the op types whose JAX emitter promotes an f32 result to f64 when x64
# is enabled, as these tests run it (``lambda_rank``'s discounts come
# from ``jnp.arange(k) + 2.0``); without x64, as the JAX package runs,
# they stay f32, as the port's do
X64_PROMOTED = ("lambda_rank",)


def _hold(got, want, tag, op_type):
    assert got.shape == want.shape, (tag, got.shape, want.shape)
    if op_type in X64_PROMOTED and want.dtype == np.float64:
        want = want.astype(np.float32)
    assert got.dtype == want.dtype, (tag, got.dtype, want.dtype)
    if np.issubdtype(want.dtype, np.floating):
        assert _max_rel(got, want) <= TOL, (tag, _max_rel(got, want))
    else:
        np.testing.assert_array_equal(got, want, err_msg=tag)


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_forward_and_gradient_match_jax(case):
    op_type, ins, attrs, diff = CASES[case]
    slots = [(s, i) for s in diff for i in range(len(ins[s]))]
    shapes = jax.eval_shape(lambda: _jax_emit(op_type, ins, attrs))
    loss_slots = _loss_slots(op_type, shapes) if diff else []
    cts = {s: [np.random.RandomState(90 + k).uniform(0.5, 1.5, o.shape)
               .astype(np.float32) for k, o in enumerate(shapes[s])]
           for s in loss_slots}
    jouts, jgrads = _jax_run(op_type, ins, attrs, slots, cts)
    touts, tgrads = _port_run(op_type, ins, attrs, diff, shapes, loss_slots,
                              cts)
    assert sorted(touts) == sorted(jouts)
    for s in jouts:
        for k, (t, j) in enumerate(zip(touts[s], jouts[s])):
            _hold(t, j, f"{case} {s}[{k}]", op_type)
    assert sorted(tgrads) == sorted(f"{s}_{i}" for s, i in slots)
    for (s, i), w in zip(slots, jgrads):
        g = tgrads[f"{s}_{i}"]
        assert g.shape == w.shape, (case, s)
        assert _max_rel(g, w) <= TOL, (case, s, _max_rel(g, w))
    # the shape oracle: the emitter on meta tensors
    meta = treg.get_op_info(op_type).emit(
        treg.EmitContext(torch.device("meta"), is_test=False),
        {s: [torch.from_numpy(np.asarray(a)).to("meta") for a in v]
         for s, v in ins.items()}, dict(attrs))
    for s in jouts:
        for k, (m, t) in enumerate(zip(meta[s], touts[s])):
            assert tuple(m.shape) == t.shape, (case, s, k)
            assert str(m.dtype).replace("torch.", "") == str(t.dtype), \
                (case, s, k)


def test_a_shape_only_walk_writes_nothing(tmp_path):
    path = tmp_path / "never.npy"
    out = treg.get_op_info("save").emit(
        treg.EmitContext(torch.device("meta"), is_test=False),
        {"X": [torch.empty(2, 3, device="meta")]}, {"file_path": str(path)})
    assert out == {} and not path.exists()


# -- the two ops that draw ----------------------------------------------------

def _port_draw(op_type, ins, attrs, seed=0, uid=7, step=0):
    prog = tfluid.Program()
    prog.random_seed = seed
    ctx = treg.EmitContext(torch.device("cpu"), is_test=False, program=prog,
                           step=step)
    out = treg.get_op_info(op_type).emit(
        ctx, {s: [torch.from_numpy(a) for a in v] for s, v in ins.items()},
        dict(attrs, __uid__=uid))
    return next(iter(out.values()))[0].numpy()


def _jax_draw(op_type, ins, attrs, seed=0):
    ctx = jreg.EmitContext(jax.random.PRNGKey(seed), is_test=False)
    out = jreg.get_op_info(op_type).emit(
        ctx, {s: [jnp.asarray(a) for a in v] for s, v in ins.items()},
        dict(attrs, __uid__=7))
    return np.asarray(next(iter(out.values()))[0])


def test_truncated_gaussian_random_by_its_properties():
    attrs = {"shape": [20000], "mean": 1.0, "std": 2.0, "dtype": "float32"}
    t = _port_draw("truncated_gaussian_random", {}, attrs)
    j = _jax_draw("truncated_gaussian_random", {}, attrs)
    assert t.dtype == j.dtype == np.float32 and t.shape == j.shape
    # truncated to two std: [mean - 2 std, mean + 2 std]
    assert t.min() >= -3.0 and t.max() <= 5.0
    # the truncated normal's std is 0.8796 of the untruncated one's
    for draws in (t, j):
        assert abs(draws.mean() - 1.0) < 0.05
        assert abs(draws.std() - 2.0 * 0.8796) < 0.05
    # the share in the outer quarter of the range, as JAX's
    assert abs(np.mean(np.abs(t - 1.0) > 3.0)
               - np.mean(np.abs(j - 1.0) > 3.0)) < 0.01
    np.testing.assert_array_equal(
        t, _port_draw("truncated_gaussian_random", {}, attrs))
    assert not np.array_equal(
        t, _port_draw("truncated_gaussian_random", {}, attrs, uid=8))


def test_sampling_id_by_its_frequencies():
    p = np.array([0.1, 0.0, 0.6, 0.3], np.float32)
    x = np.tile(p, (20000, 1))
    x[0] = [0.0, 0.0, 1.0, 0.0]
    t = _port_draw("sampling_id", {"X": [x]}, {})
    j = _jax_draw("sampling_id", {"X": [x]}, {})
    assert t.dtype == j.dtype == np.int64 and t.shape == j.shape == (20000,)
    assert t[0] == 2 and not (t == 1).any()
    for ids in (t, j):
        freq = np.bincount(ids, minlength=4) / ids.size
        assert np.abs(freq - p).max() < 0.015, freq
    np.testing.assert_array_equal(t, _port_draw("sampling_id", {"X": [x]},
                                                {}))
    assert not np.array_equal(t, _port_draw("sampling_id", {"X": [x]}, {},
                                            step=1))


# -- save and load across the packages ----------------------------------------

def _save_load_program(f, path, x_shape, dtype):
    x = f.layers.data(name="x", shape=list(x_shape[1:]), dtype=dtype)
    block = f.default_main_program().global_block()
    block.append_op("save", inputs={"X": [x.name]}, outputs={},
                    attrs={"file_path": str(path), "overwrite": True})
    return x


def _load(f, path, dtype=None):
    block = f.default_main_program().global_block()
    out = block.create_var(name="loaded", shape=None, dtype=dtype)
    attrs = {"file_path": str(path)}
    if dtype:
        attrs["dtype"] = dtype
    block.append_op("load", inputs={}, outputs={"Out": ["loaded"]},
                    attrs=attrs)
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_and_load_cross_the_packages(tmp_path, writer):
    x = np.arange(12, dtype=np.float32).reshape(3, 4) / 7.0
    path = tmp_path / "tensor"          # no extension: none is appended
    wf, rf = (tfluid, jfluid) if writer == "port" else (jfluid, tfluid)
    _save_load_program(wf, path, x.shape, "float32")
    wf.Executor(wf.CPUPlace()).run(feed={"x": x}, fetch_list=[])
    assert path.exists() and not (tmp_path / "tensor.npy").exists()
    for dtype, want in ((None, x), ("float64", x.astype(np.float64))):
        rf.reset()
        out = _load(rf, path, dtype)
        (got,) = rf.Executor(rf.CPUPlace()).run(fetch_list=[out])
        got = np.asarray(got)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_save_refuses_to_overwrite_when_told(tmp_path):
    path = tmp_path / "kept.npy"
    np.save(path, np.zeros(2, np.float32))
    with pytest.raises(IOError, match="overwrite=False"):
        treg.get_op_info("save").emit(
            treg.EmitContext(torch.device("cpu"), is_test=False),
            {"X": [torch.ones(2)]},
            {"file_path": str(path), "overwrite": False})
    np.testing.assert_array_equal(np.load(path), np.zeros(2, np.float32))


# -- the registry ------------------------------------------------------------

def _draws_in_jax(op_type):
    return "ctx.rng(" in inspect.getsource(jreg.get_op_info(op_type).emit)


def test_registry_holds_the_new_ops_as_jax_does():
    assert len(NEW_OPS) == len(set(NEW_OPS)) == 48
    covered = {c[0] for c in CASES.values()} | set(RNG_OPS) | set(IO_OPS)
    assert covered == set(NEW_OPS)
    for op in NEW_OPS:
        ti, ji = treg.get_op_info(op), jreg.get_op_info(op)
        assert (ti.grad is None) == (ji.grad is None), op
        assert ti.non_diff_inputs == ji.non_diff_inputs, op
        assert ti.non_diff_outputs == ji.non_diff_outputs, op
        assert ti.draws_rng == _draws_in_jax(op), op
    assert {op for op in NEW_OPS if treg.get_op_info(op).draws_rng} == \
        set(RNG_OPS)


def test_squeeze_refuses_an_axis_of_another_size():
    with pytest.raises(ValueError, match="not of size 1"):
        treg.get_op_info("squeeze").emit(
            treg.EmitContext(torch.device("cpu"), is_test=False),
            {"X": [torch.zeros(2, 3)]}, {"axes": [1]})


# -- the convolutions' cost rule -----------------------------------------------

def _conv_program(f):
    """depthwise_conv2d, conv3d and conv3d_transpose with their output
    shapes declared, as the layers declare them."""
    block = f.default_main_program().global_block()
    shapes = {"img": (-1, 3, 8, 8), "dw_w": (3, 1, 3, 3),
              "dw_out": (-1, 3, 8, 8), "vol": (-1, 2, 4, 6, 6),
              "c3_w": (4, 2, 3, 3, 3), "c3_out": (-1, 4, 2, 4, 4),
              "ct_w": (4, 2, 2, 2, 2), "ct_out": (-1, 2, 4, 8, 8)}
    for n, shape in shapes.items():
        block.create_var(name=n, shape=shape, dtype="float32")
    block.append_op("depthwise_conv2d",
                    inputs={"Input": ["img"], "Filter": ["dw_w"]},
                    outputs={"Output": ["dw_out"]},
                    attrs={"paddings": [1, 1]})
    block.append_op("conv3d", inputs={"Input": ["vol"], "Filter": ["c3_w"]},
                    outputs={"Output": ["c3_out"]}, attrs={})
    block.append_op("conv3d_transpose",
                    inputs={"Input": ["c3_out"], "Filter": ["ct_w"]},
                    outputs={"Output": ["ct_out"]},
                    attrs={"strides": [2, 2, 2]})
    return block


def test_convolution_costs_equal_jax():
    from paddle_tpu.analysis import cost as jcost
    from paddle_tpu_torch.analysis import cost as tcost

    jb, tb = _conv_program(jfluid), _conv_program(tfluid)
    for op in ("depthwise_conv2d", "conv3d", "conv3d_transpose"):
        assert treg.get_op_info(op).cost is not None, op
    for jop, top in zip(jb.ops, tb.ops):
        got = tcost.op_cost(tb, top, 8)
        assert got == jcost.op_cost(jb, jop, 8), top.type
        assert got["modeled"] and got["flops"] > 0, top.type
