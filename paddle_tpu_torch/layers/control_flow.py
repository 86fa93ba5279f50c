"""Control-flow layers, the port of
``paddle_tpu/layers/control_flow.py`` (reference fluid
layers/control_flow.py: While :581, StaticRNN :357, DynamicRNN :1231,
IfElse :1130): the comparisons, ``increment``, ``While``, ``StaticRNN``,
``DynamicRNN``, ``ifelse`` and ``recompute``.

A layer appends its ops to a nested sub-block and declares every
external the sub-block reads as an input of the control-flow op, so the
backward pass and the dataflow analysis see the true dataflow.  The ops
(``ops/control_flow_ops.py``) run the sub-block through the executor's
``lower_block``."""

from __future__ import annotations

import contextlib

from ..framework.core import Variable, default_main_program
from ..framework.layer_helper import LayerHelper
from .sequence import get_length_var, propagate_length


def _externals(program, sub_block, exclude):
    """Names read by sub_block ops but produced outside it (and not in
    exclude) that exist in an outer block: the externals a control-flow
    op must declare as inputs."""
    produced = set(exclude)
    ext = []
    for op in sub_block.ops:
        for n in op.input_names():
            if n and n not in produced and n not in ext:
                ext.append(n)
        produced.update(x for x in op.output_names() if x)
    parent = program.blocks[sub_block.parent_idx]
    return [n for n in ext if parent._find_var_recursive(n) is not None]


# --- compare layers --------------------------------------------------------


def _cmp_layer(op_type):
    def fn(x, y, cond=None):
        helper = LayerHelper(op_type)
        if cond is None:
            cond = helper.create_tmp_variable("bool", shape=x.shape,
                                              stop_gradient=True)
        helper.append_op(op_type, inputs={"X": [x.name], "Y": [y.name]},
                         outputs={"Out": [cond.name]})
        return cond

    fn.__name__ = op_type
    return fn


less_than = _cmp_layer("less_than")
less_equal = _cmp_layer("less_equal")
greater_than = _cmp_layer("greater_than")
greater_equal = _cmp_layer("greater_equal")
equal = _cmp_layer("equal")
not_equal = _cmp_layer("not_equal")


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_tmp_variable(x.dtype,
                                                        shape=x.shape)
    helper.append_op("increment", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"step": value})
    return out


# --- While -----------------------------------------------------------------


class While:
    """fluid control_flow.py:581 usage:

        w = While(cond)
        with w.block():
            ... ops updating loop vars ...
            layers.less_than(i, n, cond=cond)   # refresh the condition

    The loop-carried vars are the sub-block's outputs that name vars of
    the enclosing block, and the condition."""

    def __init__(self, cond: Variable, name=None):
        self.helper = LayerHelper("while", name=name)
        self.cond = cond
        self.program = default_main_program()

    @contextlib.contextmanager
    def block(self):
        parent = self.program.current_block()
        sub = self.program.create_block()
        yield
        self.program.rollback()
        carries = []
        for op in sub.ops:
            for n in op.output_names():
                if n and n not in carries and n in parent.vars:
                    carries.append(n)
        if self.cond.name not in carries:
            carries.append(self.cond.name)
        ext = _externals(self.program, sub, exclude=carries)
        self.helper.block.append_op(
            "while",
            inputs={"Carry": list(carries), "X": ext},
            outputs={"Out": list(carries)},
            attrs={"sub_block": sub.idx, "carry_names": list(carries),
                   "cond_name": self.cond.name, "x_names": ext},
        )


# --- StaticRNN / DynamicRNN ------------------------------------------------


class StaticRNN:
    """fluid control_flow.py:357: a step block run once per time step.

        rnn = StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x_seq)          # [B,T,D] -> [B,D]
            h_prev = rnn.memory(shape=[H])
            h = some_layers(x_t, h_prev)
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        out = rnn()                              # [B,T,H]
    """

    def __init__(self, name=None, lengths: Variable = None):
        self.helper = LayerHelper("static_rnn", name=name)
        self.program = default_main_program()
        self.lengths = lengths
        self._step_inputs = []  # (outer seq var, inner step var)
        self._memories = []  # [mem var, update var, init var]
        self._outputs = []  # inner per-step vars
        self._sub = None
        self._result_vars = None

    @contextlib.contextmanager
    def step(self):
        self._parent = self.program.current_block()
        self._sub = self.program.create_block()
        yield
        self.program.rollback()
        self._finalize()

    # -- inside-step API ----------------------------------------------------
    def step_input(self, seq: Variable) -> Variable:
        inner = self._sub.create_var(
            name=seq.name + "@step", dtype=seq.dtype,
            shape=(seq.shape[0],) + tuple(seq.shape[2:]) if seq.shape
            else None)
        self._step_inputs.append((seq, inner))
        return inner

    def memory(self, init: Variable = None, shape=None, batch_ref=None,
               init_value=0.0, dtype="float32") -> Variable:
        if init is None:
            if batch_ref is None and shape is None:
                raise ValueError("memory needs init, or shape (and "
                                 "batch_ref or a step input)")
            init = self.helper.create_tmp_variable(
                dtype, shape=(-1,) + tuple(shape), stop_gradient=True)
            ref = batch_ref if batch_ref is not None \
                else self._step_inputs[0][0]
            self._parent.append_op(
                "fill_constant_batch_size_like",
                inputs={"Input": [ref.name]},
                outputs={"Out": [init.name]},
                attrs={"shape": [-1] + list(shape), "value": init_value,
                       "dtype": dtype, "input_dim_idx": 0,
                       "output_dim_idx": 0})
        mem = self._sub.create_var(name=init.name + "@mem", dtype=init.dtype,
                                   shape=init.shape)
        self._memories.append([mem, None, init])
        return mem

    def update_memory(self, mem: Variable, updated: Variable):
        for m in self._memories:
            if m[0].name == mem.name:
                m[1] = updated
                return
        raise ValueError(f"unknown memory {mem.name}")

    def step_output(self, out: Variable):
        self._outputs.append(out)

    def output(self, *outs):
        for o in outs:
            self.step_output(o)

    # -- finalize -----------------------------------------------------------
    def _finalize(self):
        helper = self.helper
        if not self._outputs:
            raise ValueError("StaticRNN needs at least one step_output")
        for m in self._memories:
            if m[1] is None:
                raise ValueError(f"memory {m[0].name} never updated")
        inner_names = ([i.name for _, i in self._step_inputs]
                       + [m[0].name for m in self._memories])
        ext = _externals(self.program, self._sub, exclude=inner_names)
        # outer output [B, T, ...inner feature dims]: T is dynamic, the
        # feature tail is what later fc/pool layers need
        outs = [helper.create_tmp_variable(
            o.dtype, shape=((o.shape[0], -1) + tuple(o.shape[1:]))
            if o.shape else None) for o in self._outputs]
        mem_finals = [helper.create_tmp_variable(m[2].dtype,
                                                 shape=m[2].shape)
                      for m in self._memories]
        ins = {"StepInputs": [s.name for s, _ in self._step_inputs],
               "MemInit": [m[2].name for m in self._memories],
               "X": ext}
        if self.lengths is not None:
            ins["Length"] = [self.lengths.name]
        helper.block.append_op(
            "static_rnn",
            inputs=ins,
            outputs={"Out": [o.name for o in outs],
                     "MemFinal": [m.name for m in mem_finals]},
            attrs={
                "sub_block": self._sub.idx,
                "step_input_names": [i.name for _, i in self._step_inputs],
                "memory_pairs": [[m[0].name, m[1].name]
                                 for m in self._memories],
                "out_names": [o.name for o in self._outputs],
                "x_names": ext,
            },
        )
        if self._step_inputs:
            for o in outs:
                propagate_length(self._step_inputs[0][0], o)
        self._result_vars = outs
        self._mem_finals = mem_finals

    def __call__(self, index=None):
        if index is not None:
            return self._result_vars[index]
        return (self._result_vars[0] if len(self._result_vars) == 1
                else self._result_vars)


class DynamicRNN(StaticRNN):
    """fluid control_flow.py:1231: a variable-length RNN.  StaticRNN's op
    with each memory held past its row's length and the outputs zero
    there (the static-shape form of LoDRankTable + shrink_rnn_memory)."""

    def __init__(self, name=None):
        super().__init__(name=name)

    def step_input(self, seq: Variable) -> Variable:
        if self.lengths is None:
            self.lengths = get_length_var(seq)
        return super().step_input(seq)

    block = StaticRNN.step  # fluid names the context manager `block()`


# --- ifelse ----------------------------------------------------------------


def ifelse(cond_scalar: Variable, true_fn_block, false_fn_block,
           out_shapes=None):
    """Differentiable two-branch conditional (IfElse :1130, cond_op.cc).

    true_fn_block/false_fn_block: callables that build ops (in fresh
    sub-blocks) and return a list of Variables; both return the same
    number of outputs.  The predicate is read on the host and only the
    taken branch runs; gradients reach that branch's externals."""
    helper = LayerHelper("cond")
    program = default_main_program()

    results = []
    sub_idxs = []
    for fn in (true_fn_block, false_fn_block):
        sub = program.create_block()
        outs = fn()
        outs = outs if isinstance(outs, (list, tuple)) else [outs]
        program.rollback()
        results.append([o.name for o in outs])
        sub_idxs.append(sub.idx)
    t_names, f_names = results
    if len(t_names) != len(f_names):
        raise ValueError(f"ifelse: the branches return {len(t_names)} and "
                         f"{len(f_names)} outputs")
    out_vars = [helper.create_tmp_variable("float32") for _ in t_names]
    # both branches bind the same names, through assign ops
    for sub_idx, names in zip(sub_idxs, results):
        sub = program.blocks[sub_idx]
        for local, out in zip(names, out_vars):
            sub.append_op("assign", inputs={"X": [local]},
                          outputs={"Out": [out.name + "@branch"]})
    out_names = [o.name + "@branch" for o in out_vars]
    ext = []
    for sub_idx in sub_idxs:
        for n in _externals(program, program.blocks[sub_idx], exclude=()):
            if n not in ext:
                ext.append(n)
    helper.block.append_op(
        "cond",
        inputs={"Cond": [cond_scalar.name], "X": ext},
        outputs={"Out": [o.name for o in out_vars]},
        attrs={"true_block": sub_idxs[0], "false_block": sub_idxs[1],
               "out_names": out_names, "x_names": ext},
    )
    return out_vars if len(out_vars) > 1 else out_vars[0]


@contextlib.contextmanager
def recompute():
    """Rematerialization scope: ops built inside run normally forward,
    but the backward recomputes the segment from its inputs instead of
    keeping its activations (``jax.checkpoint`` in the JAX package; here
    the ``recompute`` op's ``generic_grad`` runs the segment again under
    autograd).

        with fluid.layers.recompute():
            h = fluid.layers.fc(h, 1024, act="relu")
            h = fluid.layers.fc(h, 1024, act="relu")
    """
    program = default_main_program()
    sub = program.create_block()
    try:
        yield
    finally:
        program.rollback()
    parent = program.blocks[sub.parent_idx]
    # escaping values: everything the segment produces; later consumers
    # read them from the recompute op's outputs
    produced = []
    for op in sub.ops:
        for n in op.output_names():
            if n and n not in produced:
                produced.append(n)
    ext = _externals(program, sub, exclude=())
    # hoist the segment's vars into the parent and rebind their .block:
    # callers hold Variables returned by layers built inside the scope,
    # and what they do with them later (append_backward, minimize, fetch)
    # targets the parent.  A name that shadows an outer var stays in the
    # sub-block, so the sub-ops' lookups still find it.
    for n, v in list(sub.vars.items()):
        if n not in parent.vars:
            v.block = parent
            parent.vars[n] = v
            del sub.vars[n]
    parent.append_op(
        "recompute",
        inputs={"X": list(ext)},
        outputs={"Out": list(produced)},
        attrs={"sub_block": sub.idx, "x_names": list(ext),
               "out_names": list(produced)},
    )
