"""v2 Topology, the port of ``paddle_tpu/v2/topology.py`` (reference
python/paddle/v2/topology.py:28): the network
summary object v2 tooling passes around — layer outputs, their Program
("the proto"), the ordered data layers and their slot types, and
inference serialization.

Design shift: the reference pickled a ModelConfig protobuf; here the
Program IS the config, so proto() serializes the Program through the
framework's protobuf interchange (framework/proto_io.py) and data types
derive from the data Variables' dtype/shape/length metadata."""

from __future__ import annotations

from ..framework import proto_io
from ..v1.layers import LayerOutput
from . import data_type as dt

__all__ = ["Topology"]


def _slot_type(var):
    """Map a data Variable to its v2 InputType (data_type.py slots)."""
    seq = getattr(var, "_length_var_name", None) is not None
    width = 1
    if var.shape:
        dims = [d for d in var.shape if d and d > 0]
        for d in dims[-1:]:
            width = int(d)
    if var.dtype in ("int64", "int32"):
        return (dt.integer_value_sequence(width) if seq
                else dt.integer_value(width))
    return (dt.dense_vector_sequence(width) if seq
            else dt.dense_vector(width))


class Topology:
    def __init__(self, layers, extra_layers=None):
        if isinstance(layers, LayerOutput) or not isinstance(
                layers, (list, tuple)):
            layers = [layers]
        self.layers = list(layers)
        if extra_layers is not None:
            extra = (extra_layers if isinstance(extra_layers, (list, tuple))
                     else [extra_layers])
            self.layers.extend(extra)
        blocks = {getattr(lo, "var", lo).block for lo in self.layers}
        programs = {b.program for b in blocks}
        if len(programs) != 1:
            raise ValueError("Topology layers must come from one Program")
        self.program = next(iter(programs))

    def proto(self):
        """The serialized network config — the Program protobuf."""
        return proto_io.serialize_program(self.program)

    def get_layer(self, name):
        """Find an output LayerOutput by name (topology.py:98)."""
        for lo in self.layers:
            if getattr(lo, "name", None) == name:
                return lo
        raise ValueError(f"layer {name!r} is not an output of this topology")

    def data_layers(self):
        """Ordered {name: Variable} of the data (feed) layers
        (topology.py:106)."""
        out = {}
        for block in self.program.blocks:
            for v in block.vars.values():
                if getattr(v, "is_data", False) \
                        and not v.name.endswith("@LENGTH"):
                    out.setdefault(v.name, v)
        return out

    def data_type(self):
        """[(name, InputType)] in feed order (topology.py:118) — what
        DataFeeder/@provider slot declarations line up against."""
        return [(name, _slot_type(var))
                for name, var in self.data_layers().items()]

    def serialize_for_inference(self, stream):
        """topology.py:134: pickle {protobin, data_type} for the inference
        deployments."""
        import pickle

        pickle.dump({"protobin": self.proto(),
                     "data_type": self.data_type()}, stream)
