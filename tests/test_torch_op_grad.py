"""Every op the training options add to the port, held to the JAX package
on the CPU the way ``tests/op_test.py`` holds the JAX ops: a one-op
program is built from numpy inputs (made from a seed) and run by the
port's Executor.

- Its outputs, with their dtypes, equal the JAX emitter's on the same
  inputs (f32 within 1e-6 relative to the output's largest |value|;
  bf16 cases check the dtypes JAX promotes to).
- For each differentiable op, float64 inputs made trainable, the loss
  ``mean(out * ct)`` (a fixed random cotangent), ``append_backward``:
  the desc-level gradients (``generic_grad``, autograd over a re-run of
  the emitter) equal central differences of the port's own forward
  (step 1e-6, within 1e-6 relative to the largest |numeric gradient|)
  and ``jax.grad`` of the JAX emitter (within 1e-12).
- At the kinks (clip bounds, ties of maximum and minimum, 0 for relu,
  abs, leaky_relu, elu, thresholds), the same desc-level gradients equal
  JAX's analytic ones (within 1e-12): ``jnp.clip``, ``maximum`` and
  ``minimum`` split the gradient at a tie, ``jnp.abs`` passes +1 at 0.
  Central differences are held there too where the two one-sided slopes
  average to JAX's value (the splits); elsewhere a kink has no
  derivative to approximate.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid  # noqa: F401  (registers the JAX emitters)
import paddle_tpu_torch as tfluid
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.framework.backward import append_backward
from paddle_tpu_torch.ops import registry as treg

# the op types this slice registers in the port
NEW_OPS = (
    "sgd adamax adagrad decayed_adagrad adadelta rmsprop ftrl proximal_gd "
    "proximal_adagrad average_accumulates "
    "elementwise_pow elementwise_max elementwise_min scale sign clip "
    "clip_by_norm squared_l2_norm "
    "sigmoid logsigmoid exp tanh_shrink softshrink hard_shrink sqrt abs "
    "ceil floor round reciprocal log square softplus softsign brelu "
    "leaky_relu soft_relu elu relu6 pow stanh thresholded_relu hard_sigmoid "
    "swish silu sin cos "
    "less_than less_equal greater_than greater_equal equal not_equal "
    "logical_and logical_or logical_xor logical_not select "
    "print increment pruning_mask cross_entropy").split()

EPS = 1e-6
NUMERIC_TOL = 1e-6
JAX_TOL = 1e-12


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    yield


def _r(seed):
    return np.random.RandomState(seed)


def _a(rng, *shape, lo=-2.0, hi=2.0, dtype=np.float64):
    return rng.uniform(lo, hi, shape).astype(dtype)


def _away(x, kinks, gap=0.05):
    """`x` with every element at least `gap` from each of `kinks`."""
    x = x.copy()
    for k in kinks:
        near = np.abs(x - k) < gap
        x[near] = k + np.where(x[near] >= k, gap, -gap) * 2
    return x


# -- the cases ----------------------------------------------------------------
# (op type, inputs, attrs, differentiable input slots)

def _unary(name, attrs=None, lo=-2.0, hi=2.0, kinks=()):
    def make(dtype):
        x = _away(_a(_r(zlib.crc32(name.encode()) % 1000), 3, 4, lo=lo, hi=hi), kinks)
        return (name, {"X": [x.astype(dtype)]}, dict(attrs or {}), ("X",))
    return make


UNARY = {
    "sigmoid": _unary("sigmoid"),
    "logsigmoid": _unary("logsigmoid"),
    "exp": _unary("exp"),
    "tanh_shrink": _unary("tanh_shrink"),
    "softshrink": _unary("softshrink", {"lambda": 0.5}, kinks=(-0.5, 0.5)),
    "hard_shrink": _unary("hard_shrink", {"threshold": 0.5},
                          kinks=(-0.5, 0.5)),
    "sqrt": _unary("sqrt", lo=0.2, hi=3.0),
    "abs": _unary("abs", kinks=(0.0,)),
    "ceil": _unary("ceil", kinks=(-1.0, 0.0, 1.0)),
    "floor": _unary("floor", kinks=(-1.0, 0.0, 1.0)),
    "round": _unary("round", kinks=(-1.5, -0.5, 0.5, 1.5)),
    "reciprocal": _unary("reciprocal", lo=0.3, hi=3.0),
    "log": _unary("log", lo=0.2, hi=3.0),
    "square": _unary("square"),
    "softplus": _unary("softplus"),
    "softsign": _unary("softsign", kinks=(0.0,)),
    "brelu": _unary("brelu", {"t_min": -1.0, "t_max": 1.0},
                    kinks=(-1.0, 1.0)),
    "leaky_relu": _unary("leaky_relu", {"alpha": 0.1}, kinks=(0.0,)),
    "soft_relu": _unary("soft_relu", {"threshold": 1.5}, kinks=(-1.5, 1.5)),
    "elu": _unary("elu", {"alpha": 1.5}, kinks=(0.0,)),
    "relu6": _unary("relu6", {"threshold": 1.0}, kinks=(0.0, 1.0)),
    "pow": _unary("pow", {"factor": 2.5}, lo=0.2, hi=2.0),
    "stanh": _unary("stanh", {"scale_a": 0.7, "scale_b": 1.5}),
    "thresholded_relu": _unary("thresholded_relu", {"threshold": 0.5},
                               kinks=(0.5,)),
    "hard_sigmoid": _unary("hard_sigmoid", {"slope": 0.25, "offset": 0.5},
                           kinks=(-2.0, 2.0)),
    "swish": _unary("swish", {"beta": 1.5}),
    "silu": _unary("silu"),
    "sin": _unary("sin"),
    "cos": _unary("cos"),
    # the three already ported, held here at their kinks too
    "relu": _unary("relu", kinks=(0.0,)),
    "tanh": _unary("tanh"),
    "gelu": _unary("gelu"),
}


def _binary(name, y_shape=(3, 4), axis=-1, y_lo=-2.0, x_lo=-2.0, tie=False):
    def make(dtype):
        r = _r(zlib.crc32(name.encode()) % 1000 + len(y_shape))
        x = _a(r, 2, 3, 4, lo=x_lo)
        y = _a(r, *y_shape, lo=y_lo)
        if tie:  # keep clear of ties: the kink cases put them back
            x = _away(x, (0.0,)) + 3.0 * np.sign(x)
        return (name, {"X": [x.astype(dtype)], "Y": [y.astype(dtype)]},
                {"axis": axis}, ("X", "Y"))
    return make


OTHER_DIFF = {
    "elementwise_pow": _binary("elementwise_pow", x_lo=0.3),
    "elementwise_pow_axis": _binary("elementwise_pow", (3,), 1, x_lo=0.3),
    "elementwise_max": _binary("elementwise_max", tie=True),
    "elementwise_max_axis": _binary("elementwise_max", (3,), 1, tie=True),
    "elementwise_min": _binary("elementwise_min", tie=True),
    "elementwise_min_axis": _binary("elementwise_min", (4,), -1, tie=True),
    "scale": lambda dt: ("scale", {"X": [_a(_r(5), 3, 4).astype(dt)]},
                         {"scale": 1.5, "bias": 0.25}, ("X",)),
    "scale_bias_first": lambda dt: (
        "scale", {"X": [_a(_r(6), 3, 4).astype(dt)]},
        {"scale": -0.5, "bias": 2.0, "bias_after_scale": False}, ("X",)),
    "sign": lambda dt: ("sign", {"X": [_away(_a(_r(7), 3, 4), (0,))
                                       .astype(dt)]}, {}, ("X",)),
    "clip": lambda dt: ("clip", {"X": [_away(_a(_r(8), 3, 4), (-0.5, 1.0))
                                       .astype(dt)]},
                        {"min": -0.5, "max": 1.0}, ("X",)),
    "clip_by_norm_clipped": lambda dt: (
        "clip_by_norm", {"X": [_a(_r(9), 3, 4).astype(dt)]},
        {"max_norm": 1.0}, ("X",)),
    "clip_by_norm_kept": lambda dt: (
        "clip_by_norm", {"X": [_a(_r(10), 3, 4).astype(dt)]},
        {"max_norm": 100.0}, ("X",)),
    "squared_l2_norm": lambda dt: (
        "squared_l2_norm", {"X": [_a(_r(11), 3, 4).astype(dt)]}, {}, ("X",)),
    "select": lambda dt: (
        "select", {"Mask": [(_r(12).rand(3, 1) > 0.5)],
                   "X": [_a(_r(13), 3, 4).astype(dt)],
                   "Y": [_a(_r(14), 3, 4).astype(dt)]}, {}, ("X", "Y")),
    "select_scalar_side": lambda dt: (
        "select", {"Mask": [np.array([True])],
                   "X": [_a(_r(15), 1).astype(dt)],
                   "Y": [_a(_r(16), 1).astype(dt)]}, {}, ("X", "Y")),
    "increment": lambda dt: ("increment", {"X": [_a(_r(17), 1).astype(dt)]},
                             {"step": 2.0}, ("X",)),
    "print": lambda dt: ("print", {"X": [_a(_r(18), 3, 4).astype(dt)]},
                         {"message": "x: ", "print_phase": "none"}, ("X",)),
    "cross_entropy": lambda dt: (
        "cross_entropy",
        {"X": [_r(19).dirichlet(np.ones(5), 6).astype(dt)],
         "Label": [_r(20).randint(0, 5, (6, 1)).astype(np.int64)]},
        {"soft_label": False}, ("X",)),
    "cross_entropy_soft": lambda dt: (
        "cross_entropy",
        {"X": [_r(21).dirichlet(np.ones(5), 6).astype(dt)],
         "Label": [_r(22).dirichlet(np.ones(5), 6).astype(dt)]},
        {"soft_label": True}, ("X",)),
}

DIFF = {**UNARY, **OTHER_DIFF}


def _opt_ins(r, dtype, *slots, positive=()):
    ins = {}
    for s in slots:
        a = _a(r, 3, 4, dtype=dtype)
        ins[s] = [np.abs(a) + 0.1 if s in positive else a]
    return ins


def _lr(v=0.05):
    return [np.array([v], np.float32)]


def _nondiff_cases(dt=np.float32):
    r = _r(30)
    cmp_x = _a(r, 3, 4, dtype=dt)
    cmp_y = cmp_x.copy()
    cmp_y[0] += 1.0
    cmp_y[1] -= 1.0
    bx, by = r.rand(3, 4) > 0.5, r.rand(3, 4) > 0.5
    cases = {
        "sgd": ("sgd", {**_opt_ins(r, dt, "Param", "Grad"),
                        "LearningRate": _lr()}, {}),
        "adamax": ("adamax", {**_opt_ins(r, dt, "Param", "Grad", "Moment",
                                         "InfNorm", positive=("InfNorm",)),
                              "LearningRate": _lr(),
                              "Beta1Pow": [np.array([0.81], np.float32)]},
                   {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
        "adagrad": ("adagrad", {**_opt_ins(r, dt, "Param", "Grad", "Moment",
                                           positive=("Moment",)),
                                "LearningRate": _lr()}, {"epsilon": 1e-6}),
        "decayed_adagrad": ("decayed_adagrad",
                            {**_opt_ins(r, dt, "Param", "Grad", "Moment",
                                        positive=("Moment",)),
                             "LearningRate": _lr()},
                            {"decay": 0.9, "epsilon": 1e-6}),
        "adadelta": ("adadelta", _opt_ins(
            r, dt, "Param", "Grad", "AvgSquaredGrad", "AvgSquaredUpdate",
            positive=("AvgSquaredGrad", "AvgSquaredUpdate")),
            {"rho": 0.9, "epsilon": 1e-6}),
        "rmsprop": ("rmsprop", {**_opt_ins(r, dt, "Param", "Grad",
                                           "MeanSquare", "Moment",
                                           positive=("MeanSquare",)),
                                "LearningRate": _lr()},
                    {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.5}),
        "ftrl": ("ftrl", {**_opt_ins(r, dt, "Param", "Grad",
                                     "SquaredAccumulator",
                                     "LinearAccumulator",
                                     positive=("SquaredAccumulator",)),
                          "LearningRate": _lr()},
                 {"l1": 0.3, "l2": 0.1, "lr_power": -0.5}),
        "proximal_gd": ("proximal_gd", {**_opt_ins(r, dt, "Param", "Grad"),
                                        "LearningRate": _lr(0.5)},
                        {"l1": 0.2, "l2": 0.1}),
        "proximal_adagrad": ("proximal_adagrad",
                             {**_opt_ins(r, dt, "Param", "Grad", "Moment",
                                         positive=("Moment",)),
                              "LearningRate": _lr(0.5)},
                             {"l1": 0.2, "l2": 0.1}),
        "pruning_mask": ("pruning_mask", {"X": [_a(r, 4, 8, dtype=dt)]},
                         {"sparsity_ratio": 0.6}),
        "pruning_mask_ties": ("pruning_mask",
                              {"X": [np.ones((4, 8), dt)]},
                              {"sparsity_ratio": 0.75}),
        "logical_not": ("logical_not", {"X": [bx]}, {}),
    }
    for w, n in ((3, 0), (4, 2), (3, 4)):  # below, at, past the window
        cases[f"average_accumulates_n{n}"] = (
            "average_accumulates",
            {"Param": [_a(r, 3, 4, dtype=dt)],
             "InSum1": [_a(r, 3, 4, dtype=np.float32)],
             "InSum2": [_a(r, 3, 4, dtype=np.float32)],
             "InNumAccumulates": [np.array([n], np.float32)],
             "InOldNumAccumulates": [np.array([5], np.float32)]},
            {"max_average_window": w})
    for op in ("less_than", "less_equal", "greater_than", "greater_equal",
               "equal", "not_equal"):
        cases[op] = (op, {"X": [cmp_x], "Y": [cmp_y]}, {})
    for op in ("logical_and", "logical_or", "logical_xor"):
        cases[op] = (op, {"X": [bx], "Y": [by]}, {})
    return cases


NONDIFF = _nondiff_cases()


def test_cases_cover_every_new_op():
    seen = {DIFF[c](np.float64)[0] for c in DIFF} | {
        c[0] for c in NONDIFF.values()}
    assert set(NEW_OPS) <= seen, sorted(set(NEW_OPS) - seen)
    for op in NEW_OPS:
        assert treg.has_op(op), op
        ti, ji = treg.get_op_info(op), jreg.get_op_info(op)
        assert (ti.grad is None) == (ji.grad is None), op
        assert ti.non_diff_inputs == ji.non_diff_inputs, op
        assert ti.non_diff_outputs == ji.non_diff_outputs, op


# -- running one op -------------------------------------------------------------

def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _dtype_name(t):
    if isinstance(t, torch.Tensor):
        return str(t.dtype).replace("torch.", "")
    return str(t.dtype)


def _port_program(op_type, ins, attrs, out_slots, diff=()):
    """A one-op program of the port; inputs of `diff` slots are trainable
    parameters, the others plain vars.  Returns (program, input names)."""
    tfluid.reset()
    prog = tfluid.default_main_program()
    block = prog.global_block()
    in_desc, names = {}, {}
    for slot, arrs in ins.items():
        in_desc[slot] = []
        for i, a in enumerate(arrs):
            name = f"{slot}_{i}"
            dt = str(a.dtype) if not isinstance(a, torch.Tensor) \
                else _dtype_name(a)
            if slot in diff:
                block.create_parameter(name=name, shape=a.shape, dtype=dt)
            else:
                block.create_var(name=name, shape=a.shape, dtype=dt,
                                 stop_gradient=True)
            in_desc[slot].append(name)
            names[name] = a
    for slot in out_slots:
        block.create_var(name=f"out_{slot}", shape=None, dtype=None)
    block.append_op(op_type, inputs=in_desc,
                    outputs={s: [f"out_{s}"] for s in out_slots},
                    attrs=dict(attrs))
    return prog, names


def _set(scope, values):
    for n, v in values.items():
        scope.set(n, v if isinstance(v, torch.Tensor) else np.asarray(v))


def _jax_outs(op_type, ins, attrs):
    ctx = jreg.EmitContext(jax.random.PRNGKey(0), is_test=False)
    return jreg.get_op_info(op_type).emit(
        ctx, {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}, attrs)


def _run_port(op_type, ins, attrs, out_slots):
    prog, values = _port_program(op_type, ins, attrs, out_slots)
    _set(tfluid.global_scope(), values)
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        prog, fetch_list=[f"out_{s}" for s in out_slots],
        return_numpy=False)
    return dict(zip(out_slots, got))


def _check_outputs(op_type, ins, attrs, tol=1e-6):
    jouts = _jax_outs(op_type, ins, attrs)
    slots = sorted(s for s in jouts if jouts[s])
    touts = _run_port(op_type, ins, attrs, slots)
    for s in slots:
        j, t = jouts[s][0], touts[s]
        assert _dtype_name(t) == _dtype_name(j), (op_type, s)
        assert tuple(t.shape) == tuple(j.shape), (op_type, s)
        jn, tn = _np(j), _np(t)
        if jn.dtype == bool or jn.dtype.kind in "iu":
            np.testing.assert_array_equal(tn, jn, err_msg=f"{op_type} {s}")
        else:
            scale = max(float(np.abs(jn).max()), 1e-30)
            err = float(np.abs(tn.astype(np.float64) - jn).max()) / scale
            assert err <= tol, (op_type, s, err)
    return touts


@pytest.mark.parametrize("case", sorted(DIFF))
def test_differentiable_op_output_matches_jax(case):
    op_type, ins, attrs, _ = DIFF[case](np.float32)
    _check_outputs(op_type, ins, attrs)


@pytest.mark.parametrize("case", sorted(NONDIFF))
def test_nondifferentiable_op_output_matches_jax(case):
    op_type, ins, attrs = NONDIFF[case]
    _check_outputs(op_type, ins, attrs)


# -- gradients ------------------------------------------------------------------

def _grad_program(op_type, ins, attrs, diff, out_slot):
    """The one-op program with ``loss = mean(out * ct)`` and its backward;
    returns (program, loss name, {input name: grad name}, values)."""
    prog, values = _port_program(op_type, ins, attrs, [out_slot], diff)
    block = prog.global_block()
    ct = np.asarray(_np(_jax_outs(op_type, ins, attrs)[out_slot][0]))
    ct = _r(99).uniform(0.5, 1.5, ct.shape).astype(ct.dtype)
    block.create_var(name="ct", shape=ct.shape, dtype=str(ct.dtype),
                     stop_gradient=True)
    values["ct"] = ct
    for n in ("weighted", "loss"):
        block.create_var(name=n, shape=None, dtype=str(ct.dtype))
    block.append_op("elementwise_mul", inputs={"X": [f"out_{out_slot}"],
                                               "Y": ["ct"]},
                    outputs={"Out": ["weighted"]}, attrs={"axis": -1})
    block.append_op("mean", inputs={"X": ["weighted"]},
                    outputs={"Out": ["loss"]})
    block.var("loss").shape = (1,)
    pg = append_backward(block.var("loss"))
    return prog, {p.name: g.name for p, g in pg}, values, ct


def _jax_grads(op_type, ins, attrs, diff, out_slot, ct):
    ctx = jreg.EmitContext(jax.random.PRNGKey(0), is_test=False)
    emit = jreg.get_op_info(op_type).emit
    names = [(s, i) for s in diff for i in range(len(ins[s]))]

    def loss(*xs):
        full = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
        for (s, i), x in zip(names, xs):
            full[s][i] = x
        return jnp.mean(emit(ctx, full, attrs)[out_slot][0] * ct)

    gs = jax.grad(loss, argnums=tuple(range(len(names))))(
        *[jnp.asarray(ins[s][i]) for s, i in names])
    return {f"{s}_{i}": np.asarray(g) for (s, i), g in zip(names, gs)}


def _out_slot(op_type):
    return "Y" if op_type == "cross_entropy" else "Out"


def _desc_grads(op_type, ins, attrs, diff):
    out_slot = _out_slot(op_type)
    prog, grads, values, ct = _grad_program(op_type, ins, attrs, diff,
                                            out_slot)
    scope = tfluid.global_scope()
    _set(scope, values)
    exe = tfluid.Executor(tfluid.CPUPlace())
    names = sorted(grads)
    got = exe.run(prog, fetch_list=[grads[n] for n in names])
    return dict(zip(names, got)), prog, values, ct, exe


def _numeric(prog, values, name, exe):
    """Central differences of the loss in `name`, by the port's forward."""
    scope = tfluid.global_scope()
    base = np.asarray(values[name], np.float64)
    num = np.zeros_like(base)
    flat, nflat = base.reshape(-1), num.reshape(-1)
    for j in range(flat.size):
        f = []
        for step in (EPS, -EPS):
            x = flat.copy()
            x[j] += step
            scope.set(name, x.reshape(base.shape))
            f.append(float(exe.run(prog, fetch_list=["loss"])[0][0]))
        nflat[j] = (f[0] - f[1]) / (2 * EPS)
    scope.set(name, base)
    return num


@pytest.mark.parametrize("case", sorted(DIFF))
def test_desc_grad_matches_central_differences_and_jax(case):
    op_type, ins, attrs, diff = DIFF[case](np.float64)
    got, prog, values, ct, exe = _desc_grads(op_type, ins, attrs, diff)
    want = _jax_grads(op_type, ins, attrs, diff, _out_slot(op_type), ct)
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        assert g.dtype == np.float64, (case, name)
        np.testing.assert_allclose(g, want[name], rtol=JAX_TOL,
                                   atol=JAX_TOL, err_msg=f"{case} {name}")
        num = _numeric(prog, values, name, exe)
        scale = max(float(np.abs(num).max()), 1e-3)
        err = float(np.abs(g - num).max()) / scale
        assert err < NUMERIC_TOL, (case, name, err)


# -- at the kinks -----------------------------------------------------------------

def _kink_unary(name, points, attrs=None, numeric=False):
    x = np.array(points + [-1.7, 0.3, 1.9][: 12 - len(points)],
                 np.float64).reshape(-1, 1)
    return (name, {"X": [x]}, dict(attrs or {}), ("X",), numeric)


def _tie(name, axis_shape=None):
    r = _r(40)
    x = _a(r, 3, 4)
    y = x.copy() if axis_shape is None else x[0, :].copy()
    y_ties = y.reshape(-1)
    y_ties[1::2] += 0.5  # half the pairs tie, half do not
    return (name, {"X": [x], "Y": [y]}, {"axis": -1}, ("X", "Y"), True)


KINKS = {
    # one-sided slopes average to JAX's split: central differences hold
    "clip": ("clip", {"X": [np.array([[-0.5], [1.0], [0.2], [-2.0],
                                      [3.0]])]},
             {"min": -0.5, "max": 1.0}, ("X",), True),
    "brelu": _kink_unary("brelu", [-1.0, 1.0], {"t_min": -1.0,
                                                "t_max": 1.0}, True),
    "relu6": _kink_unary("relu6", [0.0, 1.0], {"threshold": 1.0}, True),
    "hard_sigmoid": _kink_unary("hard_sigmoid", [-2.0, 2.0],
                                {"slope": 0.25, "offset": 0.5}, True),
    "soft_relu": _kink_unary("soft_relu", [-1.5, 1.5],
                             {"threshold": 1.5}, True),
    "elementwise_max": _tie("elementwise_max"),
    "elementwise_min": _tie("elementwise_min"),
    "elementwise_max_broadcast": _tie("elementwise_max", axis_shape=True),
    # no derivative at the point: JAX's analytic value is the contract
    "relu": _kink_unary("relu", [0.0]),
    "abs": _kink_unary("abs", [0.0, -0.0]),
    "leaky_relu": _kink_unary("leaky_relu", [0.0], {"alpha": 0.1}),
    "elu": _kink_unary("elu", [0.0], {"alpha": 1.5}),
    "softsign": _kink_unary("softsign", [0.0], numeric=True),
    "thresholded_relu": _kink_unary("thresholded_relu", [0.5],
                                    {"threshold": 0.5}),
    "softshrink": _kink_unary("softshrink", [-0.5, 0.5], {"lambda": 0.5}),
    "hard_shrink": _kink_unary("hard_shrink", [-0.5, 0.5],
                               {"threshold": 0.5}),
    "sign": _kink_unary("sign", [0.0]),
    "floor": _kink_unary("floor", [1.0, -1.0]),
    "pow_at_zero": _kink_unary("pow", [0.0], {"factor": 1.0}, True),
    "clip_by_norm_at_norm": ("clip_by_norm",
                             {"X": [np.array([[0.6, 0.8]])]},
                             {"max_norm": 1.0}, ("X",), False),
}


@pytest.mark.parametrize("case", sorted(KINKS))
def test_desc_grad_at_kinks_matches_jax(case):
    op_type, ins, attrs, diff, numeric = KINKS[case]
    got, prog, values, ct, exe = _desc_grads(op_type, ins, attrs, diff)
    want = _jax_grads(op_type, ins, attrs, diff, "Out", ct)
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name], rtol=JAX_TOL,
                                   atol=JAX_TOL, err_msg=f"{case} {name}")
        if numeric:
            num = _numeric(prog, values, name, exe)
            scale = max(float(np.abs(num).max()), 1e-3)
            assert float(np.abs(g - num).max()) / scale < NUMERIC_TOL, case


def test_split_gradient_at_a_clip_bound_is_half():
    """The boundary value itself: half the cotangent passes at a clip
    bound and at a tie of elementwise_max, none of it at relu's 0, all of
    it at abs's 0, as in JAX."""
    cases = [("clip", {"X": [np.array([[-0.5, 1.0, 0.0]])]},
              {"min": -0.5, "max": 1.0}, [0.5, 0.5, 1.0]),
             ("relu", {"X": [np.array([[0.0, 1.0, -1.0]])]}, {},
              [0.0, 1.0, 0.0]),
             ("abs", {"X": [np.array([[0.0, 1.0, -1.0]])]}, {},
              [1.0, 1.0, -1.0])]
    for op_type, ins, attrs, want in cases:
        got, _, _, ct, _ = _desc_grads(op_type, ins, attrs, ("X",))
        np.testing.assert_allclose(got["X_0"] / (ct / ct.size),
                                   np.array([want]), rtol=1e-12,
                                   err_msg=op_type)


# -- dtypes as JAX promotes them ------------------------------------------------

def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _jbf16(a):
    return jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16)


@pytest.mark.parametrize("case", ["squared_l2_norm", "mul_f32_scale", "sgd",
                                  "clip_bf16", "adagrad_bf16_param",
                                  "sum_bf16_f32"])
def test_dtypes_follow_jax(case):
    """bf16 inputs: squared_l2_norm stays bf16; a bf16 grad times an f32
    [1] scale is f32; SGD on a bf16 parameter with an f32 learning rate
    hands back f32 (what the executor writes back); a bf16 clip stays
    bf16; the decay's sum of an f32 grad and a bf16 term is f32."""
    r = _r(50)
    g, p = r.randn(3, 4), r.randn(3, 4)
    lr = np.array([0.1], np.float32)
    m = np.abs(r.randn(3, 4)).astype(np.float32)
    table = {
        "squared_l2_norm": ("squared_l2_norm", {"X": [g]}, {}, {"X"}),
        "mul_f32_scale": ("elementwise_mul", {"X": [g], "Y": [lr]},
                          {"axis": -1}, {"X"}),
        "sgd": ("sgd", {"Param": [p], "Grad": [g], "LearningRate": [lr]},
                {}, {"Param", "Grad"}),
        "clip_bf16": ("clip", {"X": [g]}, {"min": -0.5, "max": 0.5}, {"X"}),
        "adagrad_bf16_param": ("adagrad", {"Param": [p], "Grad": [g],
                                           "Moment": [m],
                                           "LearningRate": [lr]},
                               {"epsilon": 1e-6}, {"Param", "Grad"}),
        "sum_bf16_f32": ("sum", {"X": [g.astype(np.float32), p]}, {},
                         {"X1"}),
    }
    op_type, ins, attrs, bf = table[case]

    def conv(to_bf16, to_plain):
        return {s: [to_bf16(a) if (s in bf or f"{s}{i}" in bf)
                    else to_plain(a) for i, a in enumerate(v)]
                for s, v in ins.items()}

    jouts = jreg.get_op_info(op_type).emit(
        jreg.EmitContext(jax.random.PRNGKey(0), is_test=False),
        conv(_jbf16, lambda a: jnp.asarray(np.asarray(a, np.float32))),
        attrs)
    tins = conv(_bf16, lambda a: torch.from_numpy(np.asarray(a, np.float32)))
    slots = sorted(jouts)
    touts = _run_port(op_type, tins, attrs, slots)
    for s in slots:
        j, t = jouts[s][0], touts[s]
        assert _dtype_name(t) == _dtype_name(j), (case, s, t.dtype, j.dtype)
        np.testing.assert_allclose(_np(t), _np(j), rtol=1e-2, atol=1e-2)


def test_print_prints_message_and_passes_through(capsys):
    x = _a(_r(60), 2, 3, dtype=np.float32)
    out = _run_port("print", {"X": [x]}, {"message": "grad: "}, ["Out"])
    np.testing.assert_array_equal(_np(out["Out"]), x)
    said = capsys.readouterr().out
    assert said.startswith("grad: ") and f"{x[0, 0]:.4f}"[:5] in said
    _run_port("print", {"X": [x]}, {"message": "quiet: ",
                                    "print_phase": "none"}, ["Out"])
    assert "quiet" not in capsys.readouterr().out


def test_pruning_mask_prunes_the_same_ties_as_jax():
    """Count-based with a stable sort: among equal magnitudes the lowest
    indices go first, in both packages, and a constant parameter still
    loses exactly ratio * N (``tests/test_aux.py``'s tie case)."""
    x = np.ones((4, 8), np.float32)
    x[1, ::2] = 0.5
    for ratio in (0.0, 0.25, 0.5, 0.75, 1.0):
        jm = np.asarray(_jax_outs("pruning_mask", {"X": [x]},
                                  {"sparsity_ratio": ratio})["Out"][0])
        tm = _np(_run_port("pruning_mask", {"X": [x]},
                           {"sparsity_ratio": ratio}, ["Out"])["Out"])
        np.testing.assert_array_equal(tm, jm)
        assert tm.sum() == x.size - int(ratio * x.size)
