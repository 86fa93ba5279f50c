"""ParallelExecutor: SPMD execution of a program over a device mesh — the
port of ``paddle_tpu/parallel/parallel_executor.py``.

The JAX package hands its plan to GSPMD, which partitions the jitted step
and inserts the collectives.  The port executes the plan itself, op by op,
over the mesh (``parallel/mesh.py``), single-controller as JAX is:

- **State.**  Feeds and persistables are split or replicated by the plan
  (``DistributeTranspiler.transpile``, the logical-axis rule table).  A
  value is a ``ShardedTensor`` (its spec and one shard for each position)
  or a plain, replicated tensor.  Written state is laid out by its plan at
  the end of every step, so it keeps its planned layout across steps (the
  ZeRO-1 parameter all-gather after the sharded update is that reshard).
- **Local rules** (``LOCAL_RULES``).  An op whose inputs' layouts allow it
  runs once for each group of positions on its shards: elementwise ops,
  ``mul`` over an unsharded contraction dim, ``layer_norm`` and
  ``softmax_with_cross_entropy`` over an unsharded last dim, a reshape
  that keeps its sharded dims whole, ``transpose``, ``lookup_table`` with
  sharded ids, convolutions and pooling over a sharded batch, the
  optimizers' elementwise updates.  Replicated operands are sliced
  locally to match (free).
- **Rules with a collective.**  ``mean`` over a sharded dim is a psum of
  the local sums; ``mul`` contracting over a sharded dim is a psum of
  partial products; a vocab-sharded ``lookup_table`` is the masked lookup
  and a psum; ``batch_norm`` over a sharded batch psums its statistics —
  as ``analysis/sharding.py`` prices them.
- **Mesh-aware ops** (``OpInfo.mesh_emit``) take every position's shards
  at once: sequence-parallel attention (``parallel/ring_attention.py``)
  and the expert-parallel ``moe``.  ``ctx.mesh`` is set for them, as in
  JAX.
- **Everything else** gathers its sharded inputs (each gather counted as
  a reshard), runs whole and slices its outputs by the propagated spec
  (``analysis.sharding.propagate``): always correct.  So do creation ops,
  a reshape that splits or merges a sharded dim, and the ops that draw
  random numbers (a dropout mask is the single-card mask's slice).
- **Gradients.**  A ``generic_grad`` runs its forward op's rule again,
  for each group of positions, on leaves of the inputs' shards, and pulls
  the output cotangents back with autograd (through any collective of the
  rule).  A leaf's gradient belongs to the group that computed it; an
  input replicated over some of those groups (a weight read by every dp
  position) gets the EXPLICIT psum of their gradients through
  ``collectives.psum``, counted, in the positions' flat order whatever the
  mesh's shape.  So a hybrid ``{"dcn_dp": 2, "dp": 4}`` step equals the
  flat ``{"dp": 8}`` step bit for bit.

``run(steps_per_dispatch=K)`` runs as the port's ``Executor`` runs it:
captured as one CUDA graph on the card, in sequence on the CPU, and down
the loud eager route for blocks that ``step_loop.safety_report`` flags.
``save`` ops raise, as in JAX.  ``last_step`` holds the collectives (kind,
axes, bytes, the variable made) and the reshard count of the last
``run``.
"""

from __future__ import annotations

import copy
import logging
from typing import Dict, Optional

import torch

from ..framework.core import GRAD_SUFFIX
from ..framework.executor import Executor, OpLoweringError, live_ops
from ..framework.place import CPUPlace, CUDAPlace
from ..observability.attribution import op_scope
from ..ops.registry import get_op_info, unbound_slots, _generic_grad_emit
from . import collectives, transport
from . import mesh as mesh_lib
from .mesh import make_mesh
from .sharded import (ShardedTensor, from_global, from_groups, layout_groups,
                      local_groups, local_view, norm_spec, reshard,
                      spec_axes)
from .transpiler import DistributeTranspiler, ShardingRules

logger = logging.getLogger(__name__)


def _is_sh(x) -> bool:
    return isinstance(x, ShardedTensor)


def spec_of_value(x) -> tuple:
    """The normalized spec of a value (all None for a plain tensor)."""
    if _is_sh(x):
        return x.spec
    return (None,) * x.ndim if isinstance(x, torch.Tensor) else ()


class MeshPlan:
    """How one op runs over the mesh: `in_specs` {slot: [spec | None]}
    (None keeps the value's layout), the axes `E` of its computation (it
    runs once for each group of positions on E, at the group's first
    position), and `run(view, ctxs) -> outs`, where ``view(slot, i, p)``
    is input (slot, i)'s block at position p and ``ctxs[p]`` the emit
    context of p's device."""

    def __init__(self, in_specs, axes, run, mesh_aware=False):
        self.in_specs = in_specs
        self.axes = tuple(axes)
        self.run = run
        # a mesh-aware op's run reads every position (mesh_emit)
        self.mesh_aware = mesh_aware


def axes_in_order(mesh, axes) -> tuple:
    s = set(axes)
    return tuple(a for a in mesh.axis_names if a in s)


def _groups_on(mesh, axes) -> list:
    return layout_groups(mesh, (tuple(axes),) if axes else ())


def reps_of(mesh, axes) -> list:
    """The first position of each group on `axes` (zero off them) in
    this process: each group computes once a process."""
    key = ("reps", frozenset(axes))
    memo = mesh.memo.get(key)
    if memo is None:
        memo = [g[0] for g in local_groups(mesh, _groups_on(mesh, axes))]
        mesh.memo[key] = memo
    return memo


def rep_map(mesh, axes) -> list:
    """Position → the first position of its group on `axes` in this
    process (None at the positions of other processes)."""
    key = ("repmap", frozenset(axes))
    memo = mesh.memo.get(key)
    if memo is None:
        memo = [None] * mesh.size
        for g in local_groups(mesh, _groups_on(mesh, axes)):
            for q in g:
                memo[q] = g[0]
        mesh.memo[key] = memo
    return memo


def spans_processes(mesh, axes) -> bool:
    """Whether some group on `axes` holds positions of two processes (so
    each of them computes it)."""
    key = ("spans", frozenset(axes))
    memo = mesh.memo.get(key)
    if memo is None:
        memo = mesh.memo[key] = any(
            mesh.process_of(g[0]) != mesh.process_of(g[-1])
            for g in _groups_on(mesh, axes))
    return memo


def local_plan(mesh, emit, attrs, in_specs, out_specs, psum_out=None,
               local_only=()):
    """A MeshPlan that runs `emit` on each group's blocks: outputs are laid
    out by `out_specs` {slot: [spec]}, after a psum over `psum_out`
    {slot: [axes]} where given (partial sums); `local_only` names output
    slots whose blocks have no global order."""
    axes = set()
    for specs in in_specs.values():
        for sp in specs:
            if sp:
                axes.update(spec_axes(sp))
    for specs in out_specs.values():
        for sp in specs:
            if sp:
                axes.update(spec_axes(sp))
    E = axes_in_order(mesh, axes)
    psum_out = psum_out or {}

    def run(view, ctxs):
        reps = reps_of(mesh, E)
        per = {}
        for r in reps:
            ins = {s: [view(s, i, r) for i in range(len(sp))]
                   for s, sp in in_specs.items()}
            per[r] = emit(ctxs[r], ins, attrs)
        outs = {}
        for slot, specs in out_specs.items():
            vals = []
            for i, sp in enumerate(specs):
                if any(slot not in per[r] or len(per[r][slot]) <= i
                       or per[r][slot][i] is None for r in reps):
                    vals.append(None)
                    continue
                by_rep = {r: per[r][slot][i] for r in reps}
                red = psum_out.get(slot, [None] * len(specs))[i]
                if red:
                    rmap = rep_map(mesh, E)
                    full = mesh.local_map(lambda p: by_rep[rmap[p]])
                    full = collectives.psum(full, mesh, tuple(red))
                    by_rep = {r: full[r] for r in reps}
                val = from_groups(mesh, sp, by_rep)
                if slot in local_only and _is_sh(val):
                    val.local_only = True
                vals.append(val)
            outs[slot] = vals
        return outs

    return MeshPlan(in_specs, E, run)


# ---------------------------------------------------------------------------
# local rules: (executor, op type, ins, attrs) -> MeshPlan | None


def _keep(ins):
    return {s: [None] * len(v) for s, v in ins.items()}


_UNARY = {
    "relu", "tanh", "sigmoid", "gelu", "square", "sqrt", "exp", "log",
    "abs", "softsign", "softplus", "leaky_relu", "elu", "relu6", "swish",
    "hard_sigmoid", "brelu", "stanh", "soft_relu", "thresholded_relu",
    "pow", "scale", "cast", "assign", "clip", "logsigmoid", "ceil",
    "floor", "round", "reciprocal", "sin", "cos", "sign",
}
_BINARY = {"elementwise_add", "elementwise_sub", "elementwise_mul",
           "elementwise_div", "elementwise_max", "elementwise_min",
           "elementwise_pow"}
_BATCH_LOCAL = {"conv2d", "pool2d", "conv2d_transpose"}
_OPTIMIZERS = {"sgd", "momentum", "adam", "adamax", "adagrad",
               "decayed_adagrad", "rmsprop", "adadelta", "ftrl",
               "adam_beta_pow_update"}


def _rule_unary(ex, op_type, ins, attrs):
    x = ins.get("X", [None])[0]
    if x is None or not _is_sh(x) or len(ins) != 1:
        return None
    return local_plan(ex.mesh, get_op_info(op_type).emit, attrs,
                      _keep(ins), {"Out": [x.spec]})


def _aligned(x_shape, y_shape, axis):
    """[(x dim, y dim)] of y's dims aligned to x's (the elementwise
    ``axis`` broadcast); None where y is not the smaller operand."""
    if len(y_shape) > len(x_shape):
        return None
    if len(y_shape) == len(x_shape):
        return list(zip(range(len(x_shape)), range(len(y_shape))))
    if axis is None or int(axis) == -1:
        axis = len(x_shape) - len(y_shape)
    return [(int(axis) + j, j) for j in range(len(y_shape))]


def _rule_binary(ex, op_type, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    if not (_is_sh(x) or _is_sh(y)):
        return None
    xs, ys = tuple(x.shape), tuple(y.shape)
    pairs = _aligned(xs, ys, attrs.get("axis", -1))
    if pairs is None:
        return None
    out = list(spec_of_value(x))
    ysp = spec_of_value(y)
    # dims x leaves whole take y's sharding where y's dim is full size
    for d, j in pairs:
        if out[d] is None and ysp[j] and ys[j] == xs[d]:
            used = set(spec_axes(out))
            if not used & set(ysp[j]):
                out[d] = ysp[j]
    out = tuple(out)
    y_in = [None] * len(ys)
    for d, j in pairs:
        if out[d] and ys[j] == xs[d]:
            y_in[j] = out[d]
    return local_plan(ex.mesh, get_op_info(op_type).emit, attrs,
                      {"X": [out], "Y": [tuple(y_in)]}, {"Out": [out]})


def _rule_sum(ex, op_type, ins, attrs):
    xs = [x for x in ins["X"] if x is not None]
    sharded = [x for x in xs if _is_sh(x)]
    if not sharded:
        return None
    target = sharded[0].spec
    return local_plan(ex.mesh, get_op_info(op_type).emit, attrs,
                      {"X": [target if x is not None else None
                             for x in ins["X"]]}, {"Out": [target]})


def _rule_mul(ex, op_type, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    if not (_is_sh(x) or _is_sh(y)):
        return None
    xnc = int(attrs.get("x_num_col_dims", 1))
    ync = int(attrs.get("y_num_col_dims", 1))
    xsp, ysp = list(spec_of_value(x)), list(spec_of_value(y))
    lead = xsp[:xnc]
    contract_x = xsp[xnc:]
    contract_y = ysp[:ync]
    out_y = ysp[ync:]
    used = set(spec_axes(lead))
    # a weight dim sharded over an axis the rows use (the FSDP collision)
    # is gathered; so is any contraction sharding that is not one dim
    # sharded the same way on both sides
    out_y = [e if e and not (set(e) & used) else None for e in out_y]
    used |= set(spec_axes(out_y))
    cx = [e for e in contract_x if e]
    cy = [e for e in contract_y if e]
    red = None
    if len(contract_x) == 1 and len(contract_y) == 1 and (cx or cy):
        e = cx[0] if cx else cy[0]
        if (not cx or not cy or cx[0] == cy[0]) and not (set(e) & used):
            red = e
    if red:
        x_in = tuple(lead) + (red,)
        y_in = (red,) + tuple(out_y)
    else:
        x_in = tuple(lead) + (None,) * len(contract_x)
        y_in = (None,) * len(contract_y) + tuple(out_y)
    out = tuple(lead) + tuple(out_y)
    return local_plan(ex.mesh, get_op_info(op_type).emit, attrs,
                      {"X": [x_in], "Y": [y_in]}, {"Out": [out]},
                      psum_out={"Out": [red]} if red else None)


def _rule_mean(ex, op_type, ins, attrs):
    x = ins["X"][0]
    if not _is_sh(x):
        return None
    mesh = ex.mesh
    axes = axes_in_order(mesh, spec_axes(x.spec))
    n = x.numel()

    def run(view, ctxs):
        full = mesh.local_map(lambda p: view("X", 0, p).sum())
        tot = collectives.psum(full, mesh, axes)[mesh.local[0]]
        return {"Out": [(tot / n).reshape(1).to(x.dtype)]}

    return MeshPlan(_keep(ins), axes, run)


def _rule_swce(ex, op_type, ins, attrs):
    lg, lb = ins["Logits"][0], ins["Label"][0]
    if not (_is_sh(lg) or _is_sh(lb)):
        return None
    sp = list(spec_of_value(lg))
    if not _is_sh(lg):
        sp = list(spec_of_value(lb))
    sp[-1] = None
    sp = tuple(sp)
    lab = sp[:-1] + (None,) if lb.ndim == lg.ndim else sp[:lb.ndim]
    return local_plan(ex.mesh, get_op_info(op_type).emit, attrs,
                      {"Logits": [sp], "Label": [lab]},
                      {"Softmax": [sp], "Loss": [sp]})


def _rule_layer_norm(ex, op_type, ins, attrs):
    x = ins["X"][0]
    if not _is_sh(x):
        return None
    begin = int(attrs.get("begin_norm_axis", 1))
    sp = list(x.spec)
    for d in range(begin, len(sp)):
        sp[d] = None
    sp = tuple(sp)
    lead = [e for e in sp[:begin] if e]
    stat = (tuple(a for e in lead for a in e),) if lead else (None,)
    in_specs = {"X": [sp]}
    for s in ("Scale", "Bias"):
        if s in ins:
            in_specs[s] = [(None,) if v is not None else None
                           for v in ins[s]]
    return local_plan(ex.mesh, get_op_info(op_type).emit, attrs, in_specs,
                      {"Y": [sp], "Mean": [stat], "Variance": [stat]},
                      local_only=("Mean", "Variance") if len(lead) > 1
                      else ())


def _resolve_shape(shape, in_shape):
    shape = [int(s) for s in shape]
    shape = [in_shape[i] if s == 0 else s
             for i, s in enumerate(shape[:len(in_shape)])] \
        + shape[len(in_shape):]
    if -1 in shape:
        known = 1
        for s in shape:
            if s != -1:
                known *= s
        total = 1
        for s in in_shape:
            total *= s
        shape[shape.index(-1)] = total // max(known, 1)
    return shape


def _reshape_blocks(a, b):
    """Pair dims of two shapes of one size into blocks of equal products:
    [((i0, i1), (o0, o1))]; None when the sizes disagree."""
    out, i, o = [], 0, 0
    while i < len(a) or o < len(b):
        i0, o0 = i, o
        pa = a[i] if i < len(a) else 1
        pb = b[o] if o < len(b) else 1
        i, o = i + 1, o + 1
        while pa != pb:
            if pa < pb:
                if i >= len(a):
                    return None
                pa *= a[i]
                i += 1
            else:
                if o >= len(b):
                    return None
                pb *= b[o]
                o += 1
        # size-1 dims trailing a block join it
        out.append(((i0, min(i, len(a))), (o0, min(o, len(b)))))
    return out


def _rule_reshape(ex, op_type, ins, attrs):
    x = ins["X"][0]
    if not _is_sh(x):
        return None
    gin = list(x.shape)
    gout = _resolve_shape(attrs["shape"], gin)
    blocks = _reshape_blocks(gin, gout)
    if blocks is None:
        return None
    out = [None] * len(gout)
    for (i0, i1), (o0, o1) in blocks:
        inner = [x.spec[d] for d in range(i0 + 1, i1)]
        if any(inner):
            return None  # a split or merge of an inner sharded dim
        e = x.spec[i0] if i0 < i1 else None
        if e:
            n = x.split_of(i0)
            if o0 >= o1 or gout[o0] % n:
                return None
            out[o0] = e
    out = tuple(out)
    mesh = ex.mesh
    local_shape = list(gout)
    for d, e in enumerate(out):
        if e:
            n = 1
            for a in e:
                n *= mesh_lib.axis_size(mesh, a)
            local_shape[d] //= n

    def emit(ctx, ins_, attrs_):
        return {"Out": [ins_["X"][0].reshape(local_shape)]}

    return local_plan(mesh, emit, attrs, {"X": [x.spec]}, {"Out": [out]})


def _rule_transpose(ex, op_type, ins, attrs):
    x = ins["X"][0]
    if not _is_sh(x):
        return None
    perm = [int(a) for a in attrs["axis"]]
    out = tuple(x.spec[a] for a in perm)
    return local_plan(ex.mesh, get_op_info(op_type).emit, attrs,
                      {"X": [x.spec]}, {"Out": [out]})


def _rule_slice(ex, op_type, ins, attrs):
    x = ins["Input"][0]
    if not _is_sh(x):
        return None
    if any(x.spec[int(a)] for a in attrs["axes"]):
        return None
    return local_plan(ex.mesh, get_op_info(op_type).emit, attrs,
                      {"Input": [x.spec]}, {"Out": [x.spec]})


def _rule_lookup(ex, op_type, ins, attrs):
    w, ids = ins["W"][0], ins["Ids"][0]
    if not (_is_sh(w) or _is_sh(ids)):
        return None
    mesh = ex.mesh
    isp = spec_of_value(ids)
    wsp = spec_of_value(w)
    lead = isp[:-1] if ids.shape[-1] == 1 else isp
    used = set(spec_axes(lead))
    vocab = wsp[0] if wsp[0] and not (set(wsp[0]) & used) else None
    col = wsp[1] if len(wsp) > 1 and wsp[1] and not (
        set(wsp[1]) & (used | set(vocab or ()))) else None
    out = tuple(lead) + (col,)
    w_in = (vocab, col)
    ids_in = isp
    if not vocab:
        return local_plan(mesh, get_op_info(op_type).emit, attrs,
                          {"W": [w_in], "Ids": [ids_in]}, {"Out": [out]})
    V = w.shape[0]
    n = 1
    for a in vocab:
        n *= mesh_lib.axis_size(mesh, a)
    rows = V // n
    pad = attrs.get("padding_idx")
    from ..ops.tensor_ops import _Gather

    def emit(ctx, ins_, attrs_):
        wl, idl = ins_["W"][0], ins_["Ids"][0]
        p = ctx.position
        lo = mesh_lib.shard_index(mesh, mesh.coords(p), vocab)[0] * rows
        flat = idl.reshape(-1).long()
        keep = (flat >= lo) & (flat < lo + rows)
        loc = torch.where(keep, flat - lo, torch.zeros_like(flat))
        emb = _Gather.apply(wl, loc) * keep[:, None].to(wl.dtype)
        shape = tuple(idl.shape[:-1] if idl.shape[-1] == 1
                      else idl.shape) + (wl.shape[-1],)
        return {"Out": [emb.reshape(shape)]}

    plan = local_plan(mesh, emit, attrs, {"W": [w_in], "Ids": [ids_in]},
                      {"Out": [out]}, psum_out={"Out": [vocab]})
    if pad is None or pad < 0:
        return plan
    inner = plan.run

    def run(view, ctxs):
        outs = inner(view, ctxs)
        o = outs["Out"][0]

        def mask(p, t):
            flat = view("Ids", 0, p).reshape(-1)
            return torch.where((flat == int(pad))[:, None],
                               torch.zeros((), dtype=t.dtype,
                                           device=t.device),
                               t.reshape(flat.shape[0], -1)).reshape(t.shape)

        outs["Out"][0] = from_groups(
            mesh, o.spec if _is_sh(o) else (),
            {r: mask(r, local_view(mesh, o, r))
             for r in reps_of(mesh, plan.axes)})
        return outs

    plan.run = run
    return plan


def _rule_batch_local(ex, op_type, ins, attrs):
    """Ops over a batch-led first input (convolution, pooling): dim 0 may
    be sharded; every other operand is read whole."""
    first = "Input" if "Input" in ins else "X"
    x = ins[first][0]
    if not _is_sh(x):
        return None
    sp = (x.spec[0],) + (None,) * (x.ndim - 1)
    in_specs = {s: [(tuple([None] * v.ndim) if v is not None else None)
                    for v in vals] for s, vals in ins.items()}
    in_specs[first] = [sp]
    outs = {"Output": [sp]} if op_type.startswith("conv") else {"Out": [sp]}
    return local_plan(ex.mesh, get_op_info(op_type).emit, attrs, in_specs,
                      outs)


def _rule_batch_norm(ex, op_type, ins, attrs):
    x = ins["X"][0]
    if not _is_sh(x):
        return None
    mesh = ex.mesh
    fmt = str(attrs.get("data_layout", attrs.get("data_format", "NCHW")))
    ch = x.ndim - 1 if fmt in ("NHWC", "NDHWC", "NLC") else 1
    sp = list(x.spec)
    sp[ch] = None
    sp = tuple(sp)
    axes = axes_in_order(mesh, spec_axes(sp))
    in_specs = {"X": [sp]}
    for s in ("Scale", "Bias", "Mean", "Variance"):
        in_specs[s] = [(None,)]
    eps = float(attrs.get("epsilon", 1e-5))
    momentum = float(attrs.get("momentum", 0.9))
    is_test = bool(attrs.get("is_test", False)) or ex._ctx_is_test
    red = tuple(i for i in range(x.ndim) if i != ch)
    count = 1
    for i in red:
        count *= x.shape[i]
    from ..ops.cuda_kernels import bn_matmul

    def run(view, ctxs):
        reps = reps_of(mesh, axes)
        rmap = rep_map(mesh, axes)
        p0 = mesh.local[0]
        mean_in, var_in = view("Mean", 0, p0), view("Variance", 0, p0)
        xs = {r: view("X", 0, r) for r in reps}
        sdt = bn_matmul.compute_dtype(xs[reps[0]])
        shape = [1] * x.ndim
        shape[ch] = x.shape[ch]
        if is_test:
            use_mean, use_var = mean_in, var_in
            mean_out, var_out = mean_in, var_in
        else:
            s1 = collectives.psum(mesh.local_map(
                lambda p: xs[rmap[p]].to(sdt).sum(red)), mesh, axes)[p0]
            use_mean = s1 / count
            centre = dict(zip(reps, _FanOut.apply(mesh, axes, use_mean)))
            s2 = collectives.psum(mesh.local_map(
                lambda p: ((xs[rmap[p]].to(sdt)
                            - centre[rmap[p]].reshape(shape)) ** 2
                           ).sum(red)), mesh, axes)[p0]
            use_var = s2 / count
            mean_out = momentum * mean_in + (1 - momentum) * use_mean.to(
                mean_in.dtype)
            var_out = momentum * var_in + (1 - momentum) * use_var.to(
                var_in.dtype)
        inv = 1.0 / torch.sqrt(use_var.to(sdt) + eps)
        # each computation reads its own copy of the statistics and of the
        # affine parameters, so their gradients meet in the positions' flat
        # order (a psum) whatever the processes
        means, invs = (dict(zip(reps, _FanOut.apply(mesh, axes, t)))
                       for t in (use_mean, inv))
        ys = {}
        for r in reps:
            xr = xs[r]
            sc, bi = view("Scale", 0, r), view("Bias", 0, r)
            xhat = (xr.to(sdt) - means[r].reshape(shape).to(xr.device)) \
                * invs[r].reshape(shape).to(xr.device)
            ys[r] = (xhat * sc.reshape(shape).to(xr.device)
                     + bi.reshape(shape).to(xr.device)).to(xr.dtype)
        return {"Y": [from_groups(mesh, sp, ys)], "MeanOut": [mean_out],
                "VarianceOut": [var_out], "SavedMean": [use_mean],
                "SavedVariance": [use_var]}

    return MeshPlan(in_specs, axes, run)


class _FanOut(torch.autograd.Function):
    """One copy of a replicated value for each representative of the
    groups on `axes` (``reps_of``).  The backward adds the copies'
    gradients in the positions' flat order (a psum over `axes`,
    uncounted), so the sum does not depend on how the positions split
    over processes.  Where that psum crosses processes, the copies are
    linked through the exchanges and the process that owns position 0
    takes the sum (the others pass zeros on); else every process takes
    its own."""

    @staticmethod
    def forward(ctx, mesh, axes, x):
        ctx.mesh, ctx.axes = mesh, axes
        return tuple(x.clone() for _ in reps_of(mesh, axes))

    @staticmethod
    def backward(ctx, *grads):
        mesh, axes = ctx.mesh, ctx.axes
        by_rep = dict(zip(reps_of(mesh, axes), grads))
        rmap = rep_map(mesh, axes)
        with collectives.uncounted():
            total = collectives.psum(
                mesh.local_map(lambda p: by_rep[rmap[p]]), mesh,
                axes)[mesh.local[0]]
        if mesh.process_of(0) != mesh.process_index and any(
                mesh.process_of(g[0]) != mesh.process_of(g[-1])
                for g in collectives.groups(mesh, axes)):
            total = torch.zeros_like(total)
        return None, None, total


def _rule_optimizer(ex, op_type, ins, attrs):
    """Elementwise updates: every operand shaped like the parameter runs
    at the most sharded such operand's layout; scalars stay whole."""
    param = ins.get("Param", [None])[0]
    if param is None:
        return None
    shape = tuple(param.shape)
    shaped = [(s, i, v) for s, vals in ins.items()
              for i, v in enumerate(vals)
              if v is not None and tuple(v.shape) == shape]
    if not any(_is_sh(v) for _, _, v in shaped):
        return None
    mesh = ex.mesh

    def divisor(v):
        n = 1
        for a in spec_axes(spec_of_value(v)):
            n *= mesh_lib.axis_size(mesh, a)
        return n

    target = max((v for _, _, v in shaped), key=divisor).spec
    in_specs = {s: [None] * len(vals) for s, vals in ins.items()}
    for s, i, _ in shaped:
        in_specs[s][i] = target
    for s, vals in ins.items():
        for i, v in enumerate(vals):
            if v is not None and in_specs[s][i] is None:
                in_specs[s][i] = (None,) * v.ndim

    E = axes_in_order(mesh, spec_axes(target))

    def run(view, ctxs):
        reps = reps_of(mesh, E)
        per = {r: get_op_info(op_type).emit(
            ctxs[r], {s: [view(s, i, r) for i in range(len(vals))]
                      for s, vals in ins.items()}, attrs) for r in reps}
        block = tuple(view("Param", 0, reps[0]).shape)
        outs = {}
        for slot, vals in per[reps[0]].items():
            outs[slot] = [
                None if v is None else
                from_groups(mesh, target, {r: per[r][slot][i] for r in reps})
                if tuple(v.shape) == block else v
                for i, v in enumerate(vals)]
        return outs

    return MeshPlan(in_specs, E, run)


LOCAL_RULES = {
    **{t: _rule_unary for t in _UNARY},
    **{t: _rule_binary for t in _BINARY},
    **{t: _rule_batch_local for t in _BATCH_LOCAL},
    **{t: _rule_optimizer for t in _OPTIMIZERS},
    "sum": _rule_sum,
    "mul": _rule_mul,
    "mean": _rule_mean,
    "softmax_with_cross_entropy": _rule_swce,
    "layer_norm": _rule_layer_norm,
    "reshape": _rule_reshape,
    "transpose": _rule_transpose,
    "slice": _rule_slice,
    "lookup_table": _rule_lookup,
    "batch_norm": _rule_batch_norm,
}


# ---------------------------------------------------------------------------
# the executor


class ParallelExecutor(Executor):
    """``Executor`` over a mesh: ``ParallelExecutor(mesh=None, axes=None,
    rules=None, devices=None, zero_dp_states=False, fsdp_params=False)``,
    JAX's constructor.  Without `mesh`, ``make_mesh(axes, devices)``: the
    visible CUDA devices unless `devices` are given."""

    def __init__(self, mesh=None, axes: Optional[Dict[str, int]] = None,
                 rules: Optional[ShardingRules] = None, devices=None,
                 zero_dp_states: bool = False, fsdp_params: bool = False):
        self.mesh = mesh if mesh is not None else make_mesh(axes, devices)
        dev0 = self.mesh.device(self.mesh.local[0])
        place = CPUPlace() if dev0.type == "cpu" else CUDAPlace(
            dev0.index or 0)
        super().__init__(place)
        self.transpiler = DistributeTranspiler(
            rules, zero_dp_states=zero_dp_states, fsdp_params=fsdp_params)
        self._plans: Dict[tuple, tuple] = {}
        self._propagated: Dict[tuple, dict] = {}
        self.zero_dp_states = self.transpiler.rules.zero_dp_states
        self.fsdp_params = self.transpiler.rules.fsdp_params
        self._ctx_is_test = False
        self._stats = {"reshards": 0}
        # (kind, axes, bytes) of each collective and the reshard count of
        # the last run
        self.last_step: dict = {"collectives": [], "reshards": 0}

    # ------------------------------------------------------------------
    def _plan_for(self, program):
        """(plan, provenance) for `program`, cached per desc version."""
        key = (program._cache_token, program._version)
        entry = self._plans.get(key)
        if entry is None:
            plan = self.transpiler.transpile(program, self.mesh)
            entry = (plan, dict(self.transpiler.last_provenance))
            self._plans[key] = entry
            if (self.zero_dp_states and not self.fsdp_params
                    and not any(
                        getattr(v, "accumulator_for", None)
                        for v in program.global_block().vars.values())
                    and any(op.type.endswith("_grad") or
                            op.type == "generic_grad"
                            for op in program.global_block().ops)):
                logger.warning(
                    "zero_dp_states=True but no variable carries an "
                    "accumulator_for tag (program saved by an older build?) "
                    "— optimizer state will stay replicated")
        return entry

    def _replicated(self):
        return mesh_lib.replicated(self.mesh)

    def _shard_of(self, plan, name):
        s = plan.get(name)
        return s if s is not None else self._replicated()

    def static_plan(self, program, block_id: int = 0, provenance=None):
        """EFFECTIVE per-variable shardings from descs alone: the rule-table
        plan restricted to the persistable/feed vars the block touches —
        the `plan=` input to ``analysis.verify_program`` (PTV016,
        PTV018-021), ``analysis.memory.peak_estimate`` and
        ``analysis.sharding.propagate``.  Pass `provenance={}` to collect
        {var: which rule produced the spec}."""
        block = program.blocks[block_id]
        plan, prov = self._plan_for(program)
        names = set()
        for op in block.ops:
            names.update(n for n in op.input_names() if n)
            names.update(n for n in op.output_names() if n)
        out = {}
        for n in sorted(names):
            v = block._find_var_recursive(n)
            if v is None or not (v.persistable or v.is_data):
                continue
            out[n] = self._shard_of(plan, n)
            if provenance is not None and n in prov:
                provenance.setdefault(n, prov[n])
        return out

    def _propagated_specs(self, program, block_id):
        """{var: spec} from ``analysis.sharding.propagate`` of the plan:
        the layout a gathered op's outputs are sliced to."""
        key = (program._cache_token, program._version, block_id)
        specs = self._propagated.get(key)
        if specs is None:
            from ..analysis.sharding import propagate

            plan, prov = self._plan_for(program)
            try:
                ana = propagate(program, mesh=self.mesh, plan=plan,
                                block_id=block_id, provenance=prov)
                specs = dict(ana.specs)
            except Exception as e:  # the layout is a choice, not a result
                logger.warning("sharding propagation failed (%s); gathered "
                               "ops' outputs stay replicated", e)
                specs = {}
            self._propagated[key] = specs
        return specs

    def _spec_for(self, program, name, ndim):
        plan, _ = self._plan_for(program)
        sh = plan.get(name)
        if sh is None:
            return (None,) * ndim
        from ..analysis.sharding import spec_of

        return norm_spec(spec_of(sh, ndim), ndim)

    # ------------------------------------------------------------------
    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, block_id=0, verify=None, rng_step=None,
            steps_per_dispatch=None, fetch_every="all"):
        from ..framework.core import default_main_program

        program = program if program is not None else default_main_program()
        if any(op.type == "save" for op in program.blocks[block_id].ops):
            raise NotImplementedError(
                "save ops are not supported under ParallelExecutor; "
                "checkpoint sharded state via distributed.checkpoint "
                "(save_checkpoint gathers each sharded value whole)")
        self._stats = {"reshards": 0}
        with collectives.record() as log:
            out = super().run(program, feed, fetch_list, scope,
                              return_numpy, block_id, verify=verify,
                              rng_step=rng_step,
                              steps_per_dispatch=steps_per_dispatch,
                              fetch_every=fetch_every)
        self.last_step = {"collectives": list(log),
                          "reshards": self._stats["reshards"]}
        return out

    def comm_summary(self) -> Dict[str, dict]:
        """{kind: {"count", "bytes"}} of the last run's collectives."""
        out: Dict[str, dict] = {}
        for kind, _axes, nbytes, _tag in self.last_step["collectives"]:
            e = out.setdefault(kind, {"count": 0, "bytes": 0})
            e["count"] += 1
            e["bytes"] += nbytes
        return out

    def _read_state(self, scope, block, name):
        v = scope.find(name)
        if v is None or not _is_sh(v):
            v = super()._read_state(scope, block, name)
        spec = self._spec_for(block.program, name, v.ndim)
        if spec_of_value(v) != spec:
            v = reshard(v, spec, self.mesh)
            scope.set(name, v)
        return v

    def _check_finite(self, values):
        super()._check_finite({n: v.gather() if _is_sh(v) and
                               not v.local_only else v
                               for n, v in values.items()})

    # ------------------------------------------------------------------
    def _contexts(self, ctx):
        """One emit context a position of this process: ctx with the
        position's device and index (the executor's constants are kept
        per device)."""
        by_dev = {}

        def one(p):
            dev = self.mesh.device(p)
            c = copy.copy(ctx)
            c.device = dev
            c.position = p
            if dev != ctx.device:
                c.constants = by_dev.setdefault(str(dev), {})
            return c

        return self.mesh.local_map(one)

    def _loop_transport(self):
        return self.mesh.transport

    def _walk(self, block, env, fetch_names, scope, ctx):
        ctx.mesh = self.mesh
        ctx.position = self.mesh.local[0]
        self._ctx_is_test = ctx.is_test
        ctxs = self._contexts(ctx)
        # a control-flow op's nested block runs whole: its op gathered
        # its inputs (no local rule), as the single-card executor runs it
        ctx.lower_block = lambda idx, sub_env: self._lower_block(
            ctx, idx, sub_env)
        program = block.program
        # feeds laid out by the plan, sliced locally
        for n, v in list(env.items()):
            var = block._find_var_recursive(n)
            if isinstance(v, torch.Tensor) and var is not None \
                    and var.is_data:
                spec = self._spec_for(program, n, v.ndim)
                try:
                    env[n] = from_global(self.mesh, v, spec)
                except ValueError as e:
                    raise ValueError(
                        f"feed {n!r} of shape {tuple(v.shape)} does not "
                        f"split by its plan {spec}: {e}") from e
        live = live_ops(block, fetch_names)
        with torch.no_grad():
            for i, (op, keep) in enumerate(zip(block.ops, live)):
                if not keep:
                    continue
                self._walking = (i, op.type)
                skip = unbound_slots(op)
                for slot, names in op.inputs.items():
                    for n in names:
                        if n and n not in env and slot not in skip:
                            env[n] = self._read_state(scope, block, n)
                self._run_mesh_op(op, env, ctx, ctxs, program, block.idx)
            # written state back to its planned layout
            for n, v in list(env.items()):
                var = block._find_var_recursive(n)
                if var is None or not var.persistable:
                    continue
                if isinstance(v, torch.Tensor) or _is_sh(v):
                    spec = self._spec_for(program, n, v.ndim)
                    if spec_of_value(v) != spec:
                        env[n] = reshard(v, spec, self.mesh, self._stats)
            for n in fetch_names:
                v = env.get(n)
                if _is_sh(v) and not v.local_only and not (
                        block._find_var_recursive(n) is not None
                        and block._find_var_recursive(n).persistable):
                    env[n] = v.gather()

    # ------------------------------------------------------------------
    def _plan_op(self, op_type, ins, attrs, ctx):
        """The MeshPlan of one forward op on these inputs, or None: run
        whole."""
        info = get_op_info(op_type)
        if info.mesh_emit is not None:
            plan = info.mesh_emit(ctx, ins, attrs)
            if plan is not None:
                return plan
        if not any(_is_sh(x) for vals in ins.values() for x in vals):
            return None
        rule = LOCAL_RULES.get(op_type)
        if rule is not None and not info.draws_rng:
            plan = rule(self, op_type, ins, attrs)
            if plan is not None:
                return plan
        return self._gather_plan(op_type, ins, attrs)

    def _gather_plan(self, op_type, ins, attrs):
        """Gather every sharded input and run whole (E = no axes)."""
        info = get_op_info(op_type)
        in_specs = {s: [(None,) * v.ndim if _is_sh(v) else None
                        for v in vals] for s, vals in ins.items()}

        p0 = self.mesh.local[0]

        def run(view, ctxs):
            whole = {s: [view(s, i, p0) for i in range(len(vals))]
                     for s, vals in ins.items()}
            return info.emit(ctxs[p0], whole, attrs)

        return MeshPlan(in_specs, (), run)

    def _prepare(self, plan, ins):
        """Inputs laid out by the plan's in_specs (gathers counted)."""
        out = {}
        for s, vals in ins.items():
            specs = plan.in_specs.get(s, [None] * len(vals))
            row = []
            for i, v in enumerate(vals):
                sp = specs[i] if i < len(specs) else None
                if v is None or sp is None:
                    row.append(v)
                else:
                    row.append(reshard(v, norm_spec(sp, v.ndim), self.mesh,
                                       self._stats))
            out[s] = row
        return out

    def _viewer(self, prepared):
        mesh = self.mesh

        def view(s, i, p):
            vals = prepared.get(s)
            if vals is None or i >= len(vals) or vals[i] is None:
                return None
            return local_view(mesh, vals[i], p)

        return view

    def _slice_whole(self, outs, op, program, block_id):
        """A whole-run op's outputs sliced by their propagated specs (where
        they divide); the slice is local."""
        specs = self._propagated_specs(program, block_id)
        for slot, names in op.outputs.items():
            vals = outs.get(slot) or []
            for i, n in enumerate(names):
                if not n or i >= len(vals) or not isinstance(
                        vals[i], torch.Tensor):
                    continue
                sp = specs.get(n)
                if not sp or not any(sp):
                    continue
                try:
                    vals[i] = from_global(self.mesh, vals[i],
                                          norm_spec(sp, vals[i].ndim))
                except ValueError:
                    pass
        return outs

    def _run_mesh_op(self, op, env, ctx, ctxs, program, block_id):
        info = get_op_info(op.type)
        skip = unbound_slots(op)
        ins = {slot: [env[n] if n and slot not in skip else None
                      for n in names]
               for slot, names in op.inputs.items()}
        attrs = op.attrs
        if op.type == "generic_grad":
            attrs = dict(op.attrs)
            attrs["__wanted__"] = {
                (slot[: -len(GRAD_SUFFIX)], i)
                for slot, names in op.outputs.items()
                for i, n in enumerate(names) if n}
        tag = next((n for ns in op.outputs.values() for n in ns if n), None)
        try:
            with op_scope(op), collectives.tagged(tag):
                if op.type == "generic_grad":
                    outs = self._mesh_grad(ctx, ctxs, ins, attrs, {
                        (slot[: -len(GRAD_SUFFIX)], i): n
                        for slot, names in op.outputs.items()
                        for i, n in enumerate(names) if n})
                else:
                    plan = self._plan_op(op.type, ins, attrs, ctx)
                    if plan is None:
                        outs = info.emit(ctx, ins, attrs)
                    else:
                        prepared = self._prepare(plan, ins)
                        outs = plan.run(self._viewer(prepared), ctxs)
                        if not plan.axes and not plan.mesh_aware:
                            outs = self._slice_whole(outs, op, program,
                                                     block_id)
        except Exception as e:
            in_names = {s: list(ns) for s, ns in op.inputs.items() if ns}
            out_names = {s: list(ns) for s, ns in op.outputs.items() if ns}
            raise OpLoweringError(
                f"error running op {op.type!r} over the mesh "
                f"{self.mesh.shape} (inputs={in_names}, "
                f"outputs={out_names}): {type(e).__name__}: {e}") from e
        for slot, names in op.outputs.items():
            vals = outs.get(slot, []) if outs else []
            for i, n in enumerate(names):
                if n and i < len(vals) and vals[i] is not None:
                    env[n] = vals[i]

    # ------------------------------------------------------------------
    def _mesh_grad(self, ctx, ctxs, ins, attrs, grad_names=None):
        """``generic_grad`` over the mesh: the forward op's plan again, on
        leaves of each computation's blocks, the output cotangents pulled
        back by autograd; a leaf's gradients psummed over the groups that
        share its input block (explicit, counted).

        Over several processes a group that spans two of them is computed
        by each.  Where the re-run exchanged nothing between processes,
        each process's copy is a whole computation of its own and takes
        the whole cotangent.  Where it did, the copies are linked through
        the exchanges' backwards, so each value takes its cotangent once
        (at the process that owns its group's first position; zeros at
        the others, which keeps every process's backward running) and a
        leaf's copies' gradients are summed over the processes."""
        fwd_type = attrs["__fwd_type__"]
        fwd_attrs = attrs["__fwd_attrs__"]
        in_slots = attrs["__fwd_input_slots__"]
        out_slots = attrs["__fwd_output_slots__"]
        info = get_op_info(fwd_type)
        grad_names = grad_names or {}
        fwd_ins = {s: list(ins.get(s, [])) for s in in_slots}
        plan = self._plan_op(fwd_type, fwd_ins, fwd_attrs, ctx)
        if plan is None:
            # a whole-run forward: cotangents gathered, the plain grad
            plain = {s: [v.gather() if _is_sh(v) else v for v in vals]
                     if s not in in_slots else vals
                     for s, vals in ins.items()}
            for s in list(plain):
                if s.endswith(GRAD_SUFFIX):
                    plain[s] = [self._whole(v) for v in plain[s]]
            return _generic_grad_emit(ctx, plain, attrs)
        mesh = self.mesh
        prepared = self._prepare(plan, fwd_ins)
        E = plan.axes if not plan.mesh_aware else mesh.axis_names
        reps = reps_of(mesh, E)
        rmap = rep_map(mesh, E)
        diff = [(s, i) for s in in_slots if s not in info.non_diff_inputs
                for i, v in enumerate(prepared[s])
                if (s, i) in attrs["__wanted__"] and v is not None
                and v.is_floating_point()]
        leaves = {}
        for s, i in diff:
            v = prepared[s][i]
            leaves[(s, i)] = {r: local_view(mesh, v, r).detach()
                              .requires_grad_(True) for r in reps}
        base = self._viewer(prepared)

        def view(s, i, p):
            lv = leaves.get((s, i))
            if lv is None:
                return base(s, i, p)
            return lv[rmap[p]].to(mesh.device(p))

        tr = mesh.transport
        since = transport.mark(tr)
        crossed = tr.crossings if tr is not None else 0
        if plan.mesh_aware:
            leaf_vals = {s: list(prepared[s]) for s in prepared}
            for (s, i), lv in leaves.items():
                leaf_vals[s][i] = ShardedTensor(
                    mesh, spec_of_value(prepared[s][i]),
                    mesh.local_map(lambda p: lv[rmap[p]]))
            with torch.enable_grad(), collectives.uncounted():
                outs = info.mesh_emit(ctx, leaf_vals, fwd_attrs).run(
                    self._viewer(leaf_vals), ctxs)
        else:
            with torch.enable_grad(), collectives.uncounted():
                outs = plan.run(view, ctxs)
        linked = tr is not None and tr.crossings != crossed
        me = mesh.process_index

        def once(g):
            """This process takes group g's cotangent."""
            return not linked or mesh.process_of(g[0]) == me

        primals, cts = [], []
        for s in out_slots:
            grads = ins.get(s + GRAD_SUFFIX, [])
            for i, primal in enumerate((outs.get(s) or [])[: len(
                    ins.get(s, []))]):
                if (s in info.non_diff_outputs or i >= len(grads)
                        or grads[i] is None or primal is None):
                    continue
                g = grads[i]
                if _is_sh(primal):
                    if primal.local_only:
                        continue
                    g = reshard(g, primal.spec, mesh, self._stats)
                    for grp in primal.groups():
                        r = mesh.first_local(grp)
                        t = None if r is None else primal.shards[r]
                        if t is not None and t.requires_grad:
                            primals.append(t)
                            ct = local_view(mesh, g, r).to(t.dtype)
                            cts.append(ct if once(grp)
                                       else torch.zeros_like(ct))
                else:
                    if not primal.requires_grad:
                        continue
                    primals.append(primal)
                    ct = self._whole(g).to(primal.dtype).to(primal.device)
                    cts.append(ct if once(range(mesh.size))
                               else torch.zeros_like(ct))
        flat = [(k, r) for k in diff for r in reps]
        leaf_list = [leaves[k][r] for k, r in flat]
        if (primals and leaf_list) or transport.mark(tr) > since:
            with torch.enable_grad():
                din = transport.grad(tr, primals, leaf_list, cts, since)
        else:
            din = [None] * len(leaf_list)
        got = {}
        for (k, r), leaf, g in zip(flat, leaf_list, din):
            got.setdefault(k, {})[r] = torch.zeros_like(leaf) \
                if g is None else g
        if linked and spans_processes(mesh, E):
            got = self._sum_copies(E, got)
        result = {}
        for (s, i) in diff:
            v = prepared[s][i]
            in_spec = spec_of_value(v)
            red = tuple(a for a in E if a not in spec_axes(in_spec))
            by_rep = got[(s, i)]
            in_groups = local_groups(mesh, layout_groups(mesh, in_spec))
            if red:
                full = mesh.local_map(lambda p: by_rep[rmap[p]])
                with collectives.tagged(grad_names.get((s, i))):
                    full = collectives.psum(full, mesh, red)
                by_rep = {g[0]: full[g[0]] for g in in_groups}
            else:
                by_rep = {g[0]: by_rep[rmap[g[0]]] for g in in_groups}
            result.setdefault(s + GRAD_SUFFIX, {})[i] = from_groups(
                mesh, in_spec, by_rep)
        return {s: [by_idx.get(i) for i in range(max(by_idx) + 1)]
                for s, by_idx in result.items()}

    def _sum_copies(self, E, got):
        """{leaf: {rep: gradient}} with each group on E that spans
        processes given the sum of its processes' copies, added in process
        order."""
        mesh = self.mesh
        me = mesh.process_index
        spanning = [g for g in _groups_on(mesh, E)
                    if mesh.process_of(g[0]) != mesh.process_of(g[-1])]
        wants = []
        for k in got:
            for g in spanning:
                procs = sorted({mesh.process_of(q) for q in g})
                wants += [((k, g[0], src), src, dst) for dst in procs
                          for src in procs if src != dst]
        rep = {g[0]: mesh.first_local(g) for g in spanning}
        mine = lambda key: got[key[0]][rep[key[1]]]  # noqa: E731
        recv = collectives._swap(
            mesh, wants, mine, lambda key: (tuple(mine(key).shape),
                                            mine(key).dtype,
                                            mine(key).device))
        out = {k: dict(v) for k, v in got.items()}
        for k in got:
            for g in spanning:
                r = rep[g[0]]
                if r is None:
                    continue
                procs = sorted({mesh.process_of(q) for q in g})
                parts = [got[k][r] if src == me else recv[(k, g[0], src)]
                         for src in procs]
                acc = parts[0]
                for t in parts[1:]:
                    acc = acc + t
                out[k][r] = acc
        return out

    def _whole(self, v):
        """A value gathered to one tensor (an all-gather when sharded,
        counted as a reshard)."""
        if not _is_sh(v):
            return v
        self._stats["reshards"] = self._stats.get("reshards", 0) + 1
        from .sharded import all_gathered

        return all_gathered(v)
