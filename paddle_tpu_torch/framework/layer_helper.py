"""LayerHelper: parameter creation + op appending for layer functions.

Each created parameter gets its init op written into the *startup*
program and its Parameter var registered in the *main* program — the
two-program contract of fluid."""

from __future__ import annotations

from . import unique_name
from .core import default_main_program, default_startup_program
from .initializer import ConstantInitializer, XavierInitializer


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name else unique_name.generate(layer_type)

    @property
    def main_program(self):
        return self.kwargs.get("main_program") or default_main_program()

    @property
    def startup_program(self):
        return self.kwargs.get("startup_program") or default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    def append_op(self, *a, **kw):
        return self.block.append_op(*a, **kw)

    def create_parameter(self, attr=None, shape=None, dtype="float32",
                         is_bias=False, default_initializer=None):
        attr = dict(attr or {})
        name = attr.get("name") or unique_name.generate(
            self.name + (".b" if is_bias else ".w")
        )
        init = attr.get("initializer") or default_initializer
        if init is None:
            init = ConstantInitializer(0.0) if is_bias else XavierInitializer()
        param = self.block.program.global_block().create_parameter(
            name=name,
            shape=shape,
            dtype=dtype,
            trainable=attr.get("trainable", True),
            regularizer=attr.get("regularizer"),
            gradient_clip_attr=attr.get("gradient_clip"),
            optimize_attr={"learning_rate": attr.get("learning_rate", 1.0)},
        )
        sblock = self.startup_program.global_block()
        if name not in sblock.vars:
            svar = sblock.create_parameter(
                name=name, shape=shape, dtype=dtype,
                trainable=attr.get("trainable", True))
            init(svar, sblock)
        return param

    def create_tmp_variable(self, dtype, shape=None, stop_gradient=False):
        return self.block.create_var(
            name=unique_name.generate(self.name + ".tmp"),
            shape=shape,
            dtype=dtype,
            stop_gradient=stop_gradient,
        )

    def append_activation(self, out_var):
        act = self.kwargs.get("act")
        if act is None:
            return out_var
        if isinstance(act, dict):
            act = act["type"]
        tmp = self.create_tmp_variable(out_var.dtype, shape=out_var.shape)
        self.append_op(act, inputs={"X": [out_var.name]},
                       outputs={"Out": [tmp.name]})
        return tmp

    def append_bias_op(self, input_var, dim_start=1):
        bias_attr = self.kwargs.get("bias_attr")
        if bias_attr is False:
            return input_var
        size = input_var.shape[dim_start:]
        b = self.create_parameter(
            attr=bias_attr if isinstance(bias_attr, dict) else {},
            shape=list(size), dtype=input_var.dtype, is_bias=True,
        )
        tmp = self.create_tmp_variable(input_var.dtype, shape=input_var.shape)
        self.append_op(
            "elementwise_add",
            inputs={"X": [input_var.name], "Y": [b.name]},
            outputs={"Out": [tmp.name]},
            attrs={"axis": dim_start},
        )
        return tmp
