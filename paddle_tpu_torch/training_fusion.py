"""Training-graph fusion pass: BatchNorm(+residual)+ReLU -> 1x1/3x3-conv
prologue (Program -> Program, desc level), the port's copy of
``paddle_tpu/training_fusion.py``.

The pass rewrites every eligible

    conv2d_1x1(relu(batch_norm(X)))                    # interior
    conv2d_1x1(relu(batch_norm(X) + shortcut))         # block output
    conv2d_3x3(relu(batch_norm(X)[+shortcut]))         # basicblock/middle

into fused `bn_act_conv1x1` / `bn_act_conv3x3` ops reading the RAW conv
output X plus the batch statistics — the normalized activation never
materializes for that consumer (50 of ResNet-50's 53 convs fuse); the
port runs them on the hand-written kernels K11-K15
(ops/cuda_kernels/bn_matmul.py, bn_conv.py).  Nothing is removed: the
original bn/add/relu ops stay for any remaining consumers, so fetches keep
working and ineligible consumers are unaffected; the Executor skips the
ones nothing reads (XLA dead-code-eliminates them in the JAX package).

Gradients compose by chain rule: the pass flips the SavedMean/
SavedVariance vars to differentiable (batch_norm already registers them
as diffable outputs), so the fused op's dmean/dvar cotangents flow
through batch_norm's generic grad back into dX — the full BN training
gradient (held in float64 by tests/test_torch_resnet.py).
"""

from __future__ import annotations


def _pair(v):
    if isinstance(v, (list, tuple)):
        return [int(x) for x in v]
    return [int(v), int(v)]


def _conv_kind(op, block):
    """'1x1' / '3x3' when this conv2d matches a fusable form, else None.
    1x1: NHWC, pad 0, stride 1 or 2.  3x3: NHWC, pad 1, stride 1 or 2
    (bottleneck middle conv / basicblock convs; bn_conv.py's kernel
    contract)."""
    if op.type != "conv2d":
        return None
    if str(op.attrs.get("data_format", "NCHW")) != "NHWC":
        return None
    if int(op.attrs.get("groups", 1)) != 1:
        return None
    if _pair(op.attrs.get("dilations", [1, 1])) != [1, 1]:
        return None
    w = block._find_var_recursive(op.inputs["Filter"][0])
    if w is None or w.shape is None:
        return None
    hw = tuple(w.shape[2:])
    pads = _pair(op.attrs.get("paddings", [0, 0]))
    s = _pair(op.attrs.get("strides", [1, 1]))
    if hw == (1, 1) and pads == [0, 0] and s in ([1, 1], [2, 2]):
        return "1x1"
    if hw == (3, 3) and pads == [1, 1] and s in ([1, 1], [2, 2]):
        return "3x3"
    return None


def _trace_chain(t_name, producer, block):
    """Walk conv.Input back through [relu] -> [elementwise_add] ->
    batch_norm.  Returns (bn_op, act, residual_name) or None."""
    act = None
    op = producer.get(t_name)
    if op is not None and op.type == "relu":
        act = "relu"
        op = producer.get(op.inputs["X"][0])
    residual = None
    if op is not None and op.type == "elementwise_add":
        xn, yn = op.inputs["X"][0], op.inputs["Y"][0]
        xv = block._find_var_recursive(xn)
        yv = block._find_var_recursive(yn)
        if (xv is None or yv is None or xv.shape is None
                or tuple(xv.shape) != tuple(yv.shape or ())):
            return None  # broadcasting add (e.g. a bias): not this pattern
        px, py = producer.get(xn), producer.get(yn)
        if px is not None and px.type == "batch_norm":
            op, residual = px, yn
        elif py is not None and py.type == "batch_norm":
            op, residual = py, xn
        else:
            return None
    if op is None or op.type != "batch_norm":
        return None
    if bool(op.attrs.get("is_test", False)):
        return None  # inference BN folds via inference_transpiler instead
    layout = str(op.attrs.get("data_layout",
                              op.attrs.get("data_format", "NCHW")))
    if layout != "NHWC":
        return None
    return op, act, residual


def fuse_bn_matmul(program=None, block_id=None, limit=None) -> int:
    """Rewrite eligible convs to fused bn_act_conv* ops in place; returns
    how many were fused.  Run BEFORE optimizer.minimize so the backward
    pass differentiates the fused graph.

    Processes EVERY block by default (block_id=None): with remat on, the
    residual blocks live inside recompute sub-blocks, and a block-0-only
    pass would silently fuse nothing.  Chains never cross block
    boundaries — a conv whose producer lives in another block simply
    doesn't match.  `limit` applies across all blocks."""
    from .framework import core

    if program is None:
        program = core.default_main_program()
    blocks = (program.blocks if block_id is None
              else [program.blocks[block_id]])
    for block in blocks:
        for op in block.ops:
            if op.type.endswith("_grad") or op.type == "generic_grad":
                raise ValueError(
                    "fuse_bn_matmul must run before append_backward/"
                    f"minimize (found {op.type!r})")
    total = 0
    for block in blocks:
        n = None if limit is None else limit - total
        total += _fuse_block(block, n)
    return total


def _fuse_block(block, limit=None) -> int:
    from .framework.core import Operator

    producer = {}
    for op in block.ops:
        for names in op.outputs.values():
            for n in names:
                if n:
                    producer[n] = op

    fused = 0
    new_ops = []
    for op in block.ops:
        if limit is not None and fused >= limit:
            new_ops.append(op)
            continue
        kind = _conv_kind(op, block)
        if kind is None:
            new_ops.append(op)
            continue
        chain = _trace_chain(op.inputs["Input"][0], producer, block)
        if chain is None:
            new_ops.append(op)
            continue
        bn, act, residual = chain
        saved_m = bn.outputs["SavedMean"][0]
        saved_v = bn.outputs["SavedVariance"][0]
        # the saved-stats vars are created stop_gradient (nothing read
        # them before); the fused op's dmean/dvar cotangents must flow
        # through them into batch_norm's vjp
        for n in (saved_m, saved_v):
            v = block._find_var_recursive(n)
            if v is not None:
                v.stop_gradient = False
        ins = {"X": [bn.inputs["X"][0]],
               "Scale": [bn.inputs["Scale"][0]],
               "Bias": [bn.inputs["Bias"][0]],
               "SavedMean": [saved_m],
               "SavedVariance": [saved_v],
               "Filter": [op.inputs["Filter"][0]]}
        if residual is not None:
            ins["Residual"] = [residual]
        fused_attrs = {"epsilon": float(bn.attrs.get("epsilon", 1e-5)),
                       "act": act or "",
                       "strides": _pair(op.attrs.get("strides", [1, 1]))}
        fused_op = Operator(
            block, "bn_act_conv1x1" if kind == "1x1" else "bn_act_conv3x3",
            inputs=ins,
            outputs={"Output": [op.outputs["Output"][0]]},
            attrs=fused_attrs)
        fused_op.attrs.setdefault("__uid__", block.program._take_uid())
        new_ops.append(fused_op)
        fused += 1
    if fused:
        block.ops[:] = new_ops
        block.program._bump()
    return fused
