"""reference python/paddle/trainer/config_parser.py:4345 parse_config.

Design shift: v1 configs built a ModelConfig protobuf for the C++
trainer; here building the config (calling the layer functions) IS the
parse — the Program is the config.  parse_config keeps the reference
entrypoint: it accepts a config callable (or module path) plus a
config_arg string, builds it, and returns an object exposing the same
`model_config` handle (the Program) and its serialized form.  The port of
``paddle_tpu/trainer/config_parser.py``; the serialized form is the port's
own ``framework/proto_io`` ProgramDef bytes, equal to the JAX package's."""

from __future__ import annotations

import importlib
import inspect
import runpy

from ..framework import proto_io
from ..framework.core import default_main_program


class ParsedConfig:
    def __init__(self, program):
        self.program = program
        #  reference returned TrainerConfig with .model_config inside
        self.model_config = program

    def SerializeToString(self):
        return proto_io.serialize_program(self.program)


def parse_config(config, config_arg_str=""):
    """config: callable building the net, or a module/script path whose
    import builds it (the reference's two forms).  config_arg_str becomes
    kwargs for callables taking them (reference passed it via
    get_config_arg)."""
    # one parser for 'a=1,b=x' strings; also installs the mapping that
    # get_config_arg reads inside script/module configs (code review r5:
    # only the CLI used to wire it, so parse_config("conf.py", "a=1")
    # silently served defaults)
    kwargs = set_config_args(config_arg_str)
    if callable(config):
        params = inspect.signature(config).parameters
        accepted = {k: v for k, v in kwargs.items() if k in params} \
            if not any(p.kind == inspect.Parameter.VAR_KEYWORD
                       for p in params.values()) else kwargs
        config(**accepted)
    elif isinstance(config, str):
        if config.endswith(".py"):
            runpy.run_path(config)
        else:
            importlib.import_module(config)
    else:
        raise TypeError("parse_config expects a callable or module path")
    return ParsedConfig(default_main_program())


def parse_config_and_serialize(config, config_arg_str=""):
    return parse_config(config, config_arg_str).SerializeToString()


# --- config args (reference config_parser.py:4257 get_config_arg) ----------

_config_args = {}


def set_config_args(args):
    """Install the --config_args mapping ('a=1,b=x' string or dict) that
    get_config_arg reads inside config scripts."""
    global _config_args
    if isinstance(args, str):
        args = dict(kv.split("=", 1) for kv in args.split(",") if "=" in kv)
    _config_args = dict(args or {})
    return _config_args


def get_config_arg(name, type=str, default=None):
    """Read one --config_args value with the reference's coercion rules
    (bool accepts True/1/true and False/0/false, loudly rejects others)."""
    s = _config_args.get(name)
    if s is None:
        return default
    if type == bool:
        if isinstance(s, bool):
            return s
        if s in ("True", "1", "true"):
            return True
        if s in ("False", "0", "false"):
            return False
        raise ValueError(f"Value of config_arg {name} is not boolean")
    return type(s)
