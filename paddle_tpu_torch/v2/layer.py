"""v2 layer API, the port of ``paddle_tpu/v2/layer.py`` (reference
python/paddle/v2/layer.py): the port's v1 layer
functions re-exposed under their v2 names (`fc_layer` -> `fc`,
`img_conv_layer` -> `img_conv`, ...), with `data(name, type=...)` taking a
`paddle_tpu_torch.v2.data_type` slot declaration — so the reference's book
examples (`paddle.layer.fc(input=..., act=paddle.activation.Softmax())`)
run as written.

The reference generated this module from config_parser metadata
(layer.py:263 parse_network); here the Program built by the v1 functions
IS the parsed network, so this is a naming shim plus the type-driven
`data` constructor."""

from __future__ import annotations

from ..v1 import layers as _v1
from ..v1.data_provider import (InputType, _Integer, _IntegerSeq,
                                _SparseBinary, _SparseFloat)

__all__ = ["data", "parse_network"]


def data(name, type, height=None, width=None, layer_attr=None, **kw):
    """v2 data layer: shape/sequence-ness come from the data_type slot
    (reference layer.py data + topology type inference)."""
    if kw:
        raise TypeError(f"layer.data got unexpected arguments {sorted(kw)}")
    if not isinstance(type, InputType):
        raise TypeError(
            f"layer.data type= expects a paddle_tpu_torch.v2.data_type slot, "
            f"got {type!r}")
    dtype = "int64" if isinstance(type, (_Integer, _IntegerSeq)) \
        else "float32"
    if height and width:
        return _v1.data_layer(name, size=type.dim, height=height,
                              width=width, dtype=dtype, seq=type.seq)
    return _v1.data_layer(name, size=type.dim, dtype=dtype, seq=type.seq)


parse_network = _v1.parse_network


def _strip(name: str) -> str:
    return name[:-len("_layer")] if name.endswith("_layer") else name


def _export_v1():
    skip = {"data_layer", "get_length_var", "to_param_attr",
            "act_name", "pool_name", "propagate_length"}
    for name in dir(_v1):
        if name.startswith("_") or name in skip:
            continue
        obj = getattr(_v1, name)
        # only functions DEFINED by v1.layers — not re-imported helpers,
        # typing aliases, or framework classes
        if not callable(obj) or \
                getattr(obj, "__module__", None) != _v1.__name__:
            continue
        v2_name = _strip(name)
        if v2_name not in globals():
            globals()[v2_name] = obj
            __all__.append(v2_name)


_export_v1()
