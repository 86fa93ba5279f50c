"""Inference-graph passes (Program -> Program), the port of
``paddle_tpu/inference_transpiler.py``: the BatchNorm fold.

Each inference-mode batch_norm whose input a convolution produced is
folded into that convolution's filter and a per-channel bias add:

    y = gamma * (conv(x, W) - mean) / sqrt(var + eps) + beta
      = conv(x, W * gamma/sqrt(var+eps)) + (beta - mean*gamma/sqrt(var+eps))

The conv keeps its op (W is rescaled in the scope) and the batch_norm op
becomes one elementwise_add of a folded [C] bias.  The fold computes in
float64 and writes the filter and the ``<Y>@bnfold_bias`` back in the
variable's own dtype, on the device of the filter it replaces.
"""

from __future__ import annotations

import numpy as np
import torch

from .framework.core import Operator, drop_orphaned_vars, torch_dtype

# the optimizer op types, as the JAX package's distribute transpiler
# lists them (not ported): a program holding one is a training program
OPTIMIZE_OP_TYPES = ("sgd", "momentum", "adagrad", "adam", "adamax",
                     "adadelta", "decayed_adagrad", "proximal_gd",
                     "proximal_adagrad", "ftrl", "rmsprop")


def _channel_axis(layout: str, ndim: int) -> int:
    return ndim - 1 if layout in ("NHWC", "NDHWC", "NLC") else 1


class InferenceTranspiler:
    """t = InferenceTranspiler(); t.transpile(program, scope)

    The program must be inference-only (a ``clone(for_test=True)`` result
    or a loaded inference model): the fold uses the RUNNING statistics,
    which is what batch_norm computes only in test mode."""

    FOLDABLE_PRODUCERS = ("conv2d", "depthwise_conv2d", "conv3d")

    def transpile(self, program, scope, block_id: int = 0,
                  fetch_names=()) -> int:
        """Fold conv+BN pairs in place; returns how many were folded.

        After a fold the conv-output var holds the gamma-rescaled conv
        result, not the raw convolution: a fold whose conv output is in
        `fetch_names`, is read by another op, is persistable, or whose
        filter another op shares is skipped."""
        block = program.blocks[block_id]
        for op in block.ops:
            if (op.type.endswith("_grad") or op.type == "generic_grad"
                    or op.type in OPTIMIZE_OP_TYPES):
                raise ValueError(
                    "fuse_batch_norm expects an inference-only program "
                    f"(found {op.type!r}); build it via "
                    "clone(for_test=True) or load_inference_model")
        return self._fuse_batch_norm(block, scope, set(fetch_names))

    def _fuse_batch_norm(self, block, scope, fetch_names=frozenset()) -> int:
        use_count: dict = {}
        producer: dict = {}
        for op in block.ops:
            for names in op.inputs.values():
                for n in names:
                    if n:
                        use_count[n] = use_count.get(n, 0) + 1
            for names in op.outputs.values():
                for n in names:
                    if n:
                        producer[n] = op

        folded = 0
        new_ops = []
        for op in block.ops:
            if op.type != "batch_norm":
                new_ops.append(op)
                continue
            x = op.inputs["X"][0]
            conv = producer.get(x)
            vals = self._gather(op, conv, scope, use_count, fetch_names,
                                block)
            if vals is None:
                new_ops.append(op)
                continue
            w, gamma, beta, mean, var = vals
            eps = float(op.attrs.get("epsilon", 1e-5))
            inv = gamma.astype(np.float64) / np.sqrt(
                var.astype(np.float64) + eps)
            # conv filters are OIHW in every layout: out-channel is axis 0
            w_new = (w.astype(np.float64)
                     * inv.reshape((-1,) + (1,) * (w.ndim - 1)))
            b_new = (beta.astype(np.float64)
                     - mean.astype(np.float64) * inv)

            filt = conv.inputs["Filter"][0]
            old = scope.find(filt)
            scope.set(filt, torch.tensor(w_new, dtype=old.dtype,
                                         device=old.device))

            y = op.outputs["Y"][0]
            yvar = block._find_var_recursive(y)
            xvar = block._find_var_recursive(x)
            act_dtype = (yvar.dtype or (xvar.dtype if xvar else None)
                         or "float32")
            bias_name = f"{y}@bnfold_bias"
            block.create_var(name=bias_name, shape=(len(b_new),),
                             dtype=str(act_dtype), persistable=True,
                             stop_gradient=True)
            # the bias carries the activation dtype, or the add would
            # promote Y to f32 mid-network
            scope.set(bias_name, torch.tensor(
                b_new, dtype=torch_dtype(str(act_dtype)),
                device=old.device))

            layout = str(op.attrs.get("data_layout",
                                      op.attrs.get("data_format", "NCHW")))
            xdim = len(xvar.shape) if xvar is not None and xvar.shape \
                else 4
            add = Operator(
                block, "elementwise_add",
                inputs={"X": [x], "Y": [bias_name]},
                outputs={"Out": [y]},
                attrs={"axis": _channel_axis(layout, xdim)})
            add.attrs.setdefault("__uid__", block.program._take_uid())
            new_ops.append(add)
            folded += 1
        if folded:
            block.ops[:] = new_ops
            # the removed batch_norm ops orphan their saved mean/var temps
            drop_orphaned_vars(block, keep=fetch_names)
            block.program._bump()
        return folded

    def _gather(self, bn_op, conv, scope, use_count, fetch_names=frozenset(),
                block=None):
        """The scope's values the fold needs (numpy), or None where the
        pair is ineligible."""
        if conv is None or conv.type not in self.FOLDABLE_PRODUCERS:
            return None
        x = bn_op.inputs["X"][0]
        if use_count.get(x, 0) != 1:
            return None  # someone else reads the un-normalized conv out
        if x in fetch_names:
            return None  # fetched post-fold it would be the rescaled conv
        if block is not None:
            xv = block._find_var_recursive(x)
            if xv is not None and xv.persistable:
                return None  # saved models must keep the raw conv value
        filt = conv.inputs["Filter"][0]
        if use_count.get(filt, 0) != 1:
            return None  # weight sharing: rescaling would corrupt the twin
        w = scope.find_np(filt)
        if w is None:
            return None
        parts = []
        for slot in ("Scale", "Bias", "Mean", "Variance"):
            names = bn_op.inputs.get(slot) or [None]
            v = scope.find_np(names[0]) if names[0] else None
            if v is None:
                return None
            parts.append(np.asarray(v))
        return (np.asarray(w), *parts)


def fuse_batch_norm(program, scope, block_id: int = 0,
                    fetch_names=()) -> int:
    """``InferenceTranspiler().transpile(...)``.  Pass the vars you will
    fetch as `fetch_names`: folds that would change a fetched conv
    output's value are skipped.  Under PADDLE_TPU_VERIFY=1 the fold runs
    inside its verified-in/verified-out contract
    (``analysis/contracts.checked_fuse_batch_norm``), which PROVES it
    preserved semantics: the folded program over the folded scope must
    reproduce the original program's fetches over a pre-fold scope
    snapshot on deterministic feeds (the differential oracle; divergence
    beyond the fold's float tolerance is PTV024)."""
    from .analysis import contracts

    if contracts.should_wrap():
        return contracts.checked_fuse_batch_norm(program, scope, block_id,
                                                 fetch_names=fetch_names)
    return InferenceTranspiler().transpile(program, scope, block_id,
                                           fetch_names=fetch_names)
