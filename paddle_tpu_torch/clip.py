"""Gradient clipping as ops on the gradients, the port of
``paddle_tpu/clip.py``: by value (``clip``), by each gradient's norm
(``clip_by_norm``) and by the global norm of all of them
(``squared_l2_norm`` each, ``sum``, ``sqrt``, then one scale
``clip_norm / max(norm, clip_norm)`` multiplied into every gradient).
Every step of the chain stays on the device.  ``ErrorClipByValue`` clips
a variable's gradient where ``append_backward`` materializes it.

Dtypes are the JAX package's: the global norm's partial sums are in each
gradient's dtype, and a bf16 gradient times the f32 scale is f32."""

from __future__ import annotations

from .framework import unique_name


def _clip_out(block, grad):
    return block.create_var(
        name=unique_name.generate(grad.name + "_clip"),
        shape=grad.shape, dtype=grad.dtype, stop_gradient=True)


def append_gradient_clip_by_value(block, params_grads, vmin, vmax):
    out = []
    for p, g in params_grads:
        c = _clip_out(block, g)
        block.append_op("clip", inputs={"X": [g.name]},
                        outputs={"Out": [c.name]},
                        attrs={"min": float(vmin), "max": float(vmax)})
        out.append((p, c))
    return out


def append_gradient_clip_by_norm(block, params_grads, max_norm):
    out = []
    for p, g in params_grads:
        c = _clip_out(block, g)
        block.append_op("clip_by_norm", inputs={"X": [g.name]},
                        outputs={"Out": [c.name]},
                        attrs={"max_norm": float(max_norm)})
        out.append((p, c))
    return out


def append_gradient_clip_by_global_norm(block, params_grads, clip_norm):
    """The sum of the squared norms of all gradients → one common scale
    factor, ``clip_norm / max(norm, clip_norm)``."""

    def scalar(name, dtype="float32"):
        return block.create_var(name=unique_name.generate(name), shape=(1,),
                                dtype=dtype, stop_gradient=True)

    sq_names = []
    for _, g in params_grads:
        sq = scalar(g.name + "_sq")
        block.append_op("squared_l2_norm", inputs={"X": [g.name]},
                        outputs={"Out": [sq.name]})
        sq_names.append(sq.name)
    total = scalar("global_norm_sq")
    block.append_op("sum", inputs={"X": sq_names},
                    outputs={"Out": [total.name]})
    norm = scalar("global_norm")
    block.append_op("sqrt", inputs={"X": [total.name]},
                    outputs={"Out": [norm.name]})
    denom = scalar("global_norm_max")
    cn = scalar("clip_norm_const")
    block.append_op("fill_constant", outputs={"Out": [cn.name]},
                    attrs={"shape": [1], "value": float(clip_norm),
                           "dtype": "float32"})
    block.append_op("elementwise_max", inputs={"X": [norm.name],
                                               "Y": [cn.name]},
                    outputs={"Out": [denom.name]}, attrs={"axis": -1})
    scale_v = scalar("global_clip_scale")
    block.append_op("elementwise_div", inputs={"X": [cn.name],
                                               "Y": [denom.name]},
                    outputs={"Out": [scale_v.name]}, attrs={"axis": -1})
    out = []
    for p, g in params_grads:
        c = _clip_out(block, g)
        block.append_op("elementwise_mul",
                        inputs={"X": [g.name], "Y": [scale_v.name]},
                        outputs={"Out": [c.name]}, attrs={"axis": -1})
        out.append((p, c))
    return out


class ErrorClipByValue:
    """Clip a variable's GRADIENT during the backward pass: set it as the
    variable's ``error_clip``, and ``append_backward`` clips the gradient
    in place where it materializes, before upstream grad ops read it."""

    def __init__(self, max, min=None):  # noqa: A002  (reference signature)
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def append_clip_op(self, block, grad_name):
        block.append_op("clip", inputs={"X": [grad_name]},
                        outputs={"Out": [grad_name]},
                        attrs={"min": self.min, "max": self.max})


def error_clip_callback(block, context):
    """``append_backward``'s callback: clip the gradients in
    ``context["grad_names"]`` whose variable asks for an error clip that
    the backward pass did not apply at materialization."""
    for grad_name in context.get("grad_names", ()):
        base = grad_name.replace("@GRAD", "")
        v = block._find_var_recursive(base)
        clip = getattr(v, "error_clip", None) if v is not None else None
        if clip is not None and not getattr(v, "_error_clip_applied", False):
            clip.append_clip_op(block, grad_name)


class GradientClipByValue:
    """``append_gradient_clip_by_value`` as an object, for a parameter's
    ``gradient_clip`` (``ParamAttr``) or ``append_gradient_clip_ops``."""

    def __init__(self, max, min=None):  # noqa: A002  (reference signature)
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def apply(self, block, params_grads):
        return append_gradient_clip_by_value(block, params_grads,
                                             self.min, self.max)


class GradientClipByNorm:
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def apply(self, block, params_grads):
        return append_gradient_clip_by_norm(block, params_grads,
                                            self.clip_norm)


class GradientClipByGlobalNorm:
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def apply(self, block, params_grads):
        return append_gradient_clip_by_global_norm(block, params_grads,
                                                   self.clip_norm)


def append_gradient_clip_ops(param_grad):
    """Apply each parameter's ``gradient_clip`` (set through ``ParamAttr``)
    to its gradient, in the gradient's block."""
    out = []
    for p, g in param_grad:
        clip = getattr(p, "gradient_clip_attr", None)
        if clip is None:
            out.append((p, g))
        else:
            out.extend(clip.apply(g.block, [(p, g)]))
    return out
