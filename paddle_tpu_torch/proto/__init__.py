"""`paddle.proto` namespace, the port of ``paddle_tpu/proto/__init__.py``
(reference proto/: ModelConfig, TrainerConfig, DataFormat, ParameterConfig
protobufs consumed by the v1 stack).

As in the JAX package, the four reference schemas collapse into the one
interchange schema, the Program protobuf (``framework/framework.proto``):
the Program holds the topology (ModelConfig), the optimizer ops
(TrainerConfig) and the parameter descs (ParameterConfig).  The JAX
package's ``framework_pb2`` is protoc's module; the port has no protobuf,
so ``framework_pb2`` here holds the six message classes over the port's
own codec (``framework/proto_io.py``): field attributes (an unset field
reads its default), repeated fields as lists (``add()`` on a repeated
message field appends a new message), the nested enums (``AttrValue.Kind``,
``VarDef.Kind``) with their values as class attributes, and
``SerializeToString``, ``ParseFromString`` and ``FromString``.  Their bytes are protobuf's, so bytes from the JAX
package's ``framework_pb2`` go through ``FromString(b).SerializeToString()``
unchanged (the codec drops fields the schema does not know, as no program
either package writes has any)."""

import types as _types

from ..framework import proto_io as _proto_io


class _Repeated(list):
    """A repeated message field: a list whose ``add()`` appends a new
    message."""

    def __init__(self, cls, items=()):
        super().__init__(items)
        self._cls = cls

    def add(self, **fields):
        msg = self._cls(**fields)
        self.append(msg)
        return msg


class _Message:
    """One message of ``framework.proto``: the set fields in ``_fields``
    (proto2 presence), as the codec's dict holds them."""

    _TYPE = ""

    def __init__(self, **fields):
        object.__setattr__(self, "_fields", {})
        for name, value in fields.items():
            setattr(self, name, value)

    @classmethod
    def _schema(cls):
        return {name: (kind, label)
                for _, name, kind, label in _proto_io._SCHEMA[cls._TYPE]}

    def __getattr__(self, name):
        fields = object.__getattribute__(self, "_fields")
        if name in fields:
            return fields[name]
        schema = type(self)._schema()
        if name not in schema:
            raise AttributeError(f"{self._TYPE} has no field {name!r}")
        kind, label = schema[name]
        if label in ("rep", "packed"):
            value = _Repeated(_CLASSES[kind]) if kind in _CLASSES else []
            fields[name] = value
            return value
        default = _proto_io.default(self._TYPE, {}, name)
        if default is not None:
            return default
        return {"string": "", "double": 0.0, "bool": False}.get(kind, 0)

    def __setattr__(self, name, value):
        schema = type(self)._schema()
        if name not in schema:
            raise AttributeError(f"{self._TYPE} has no field {name!r}")
        kind, label = schema[name]
        if label in ("rep", "packed"):
            value = _Repeated(_CLASSES[kind], value) if kind in _CLASSES \
                else list(value)
        self._fields[name] = value

    def HasField(self, name):
        return name in self._fields and not isinstance(
            self._fields[name], list)

    def _to_dict(self) -> dict:
        out = {}
        for name, value in self._fields.items():
            if isinstance(value, _Repeated):
                out[name] = [m._to_dict() for m in value]
            elif isinstance(value, list):
                out[name] = list(value)
            else:
                out[name] = value
        return out

    @classmethod
    def _from_dict(cls, message: dict):
        msg = cls()
        for name, value in message.items():
            kind = cls._schema()[name][0]
            if kind in _CLASSES and isinstance(value, list):
                value = [_CLASSES[kind]._from_dict(v) for v in value]
            setattr(msg, name, value)
        return msg

    def SerializeToString(self) -> bytes:
        return _proto_io.encode(self._TYPE, self._to_dict())

    def ParseFromString(self, data: bytes) -> int:
        parsed = self._from_dict(_proto_io.decode(self._TYPE, bytes(data)))
        object.__setattr__(self, "_fields", parsed._fields)
        return len(data)

    @classmethod
    def FromString(cls, data: bytes):
        msg = cls()
        msg.ParseFromString(data)
        return msg


class _Enum:
    """A nested enum: its values as attributes, ``Name`` and ``Value``."""

    def __init__(self, names):
        self._names = tuple(names)
        for i, n in enumerate(self._names):
            setattr(self, n, i)

    def Name(self, number):
        return self._names[number]

    def Value(self, name):
        return self._names.index(name)


def _message_class(name):
    attrs = {"_TYPE": name}
    for enum, values in _proto_io._ENUMS.items():
        owner, enum_name = enum.split(".")
        if owner == name:
            attrs[enum_name] = _Enum(values)
            attrs.update({v: i for i, v in enumerate(values)})
    return type(name, (_Message,), attrs)


_CLASSES = {name: _message_class(name) for name in _proto_io._SCHEMA}

framework_pb2 = _types.ModuleType(
    __name__ + ".framework_pb2",
    "The six messages of framework.proto over the port's codec.")
for _name, _cls in _CLASSES.items():
    setattr(framework_pb2, _name, _cls)
del _name, _cls

# reference module names -> the one interchange schema
ModelConfig_pb2 = framework_pb2
TrainerConfig_pb2 = framework_pb2
ParameterConfig_pb2 = framework_pb2
DataConfig_pb2 = framework_pb2
