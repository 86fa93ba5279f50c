"""Program <-> ProgramDef wire bytes, the port of
``paddle_tpu/framework/proto_io.py``.

The schema is ``framework.proto`` beside this file (the JAX package's,
copied).  The JAX package serializes through ``google.protobuf``; the
card's machine has no such package, so this module is a small proto2 codec
of its own for the six messages (``ProgramDef``, ``BlockDef``, ``VarDef``,
``OpDef``, ``Slot``, ``AttrValue``).  It writes what protobuf writes: the
set fields in field-number order, varints (negative int32/int64 as ten
bytes), doubles as 64-bit little-endian, strings and messages
length-delimited, ``int_list``, ``float_list`` and ``shape`` packed.  For
one program the bytes equal ``paddle_tpu.framework.proto_io
.serialize_program``'s, and either package parses the other's.

A message is a plain dict from field name to value, holding only the
fields that are set (proto2 presence): ``program_to_proto`` builds one,
``proto_to_program`` reads one, ``program_to_text`` prints one as
protobuf's text format does.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, List, Tuple

# (number, name, type, label) per message, in field-number order.  type:
# a scalar kind or another message's name; label: "opt", "req", "rep" or
# "packed".  These ARE framework.proto's numbers and types: change them
# together or the wire format forks.
_SCHEMA: Dict[str, List[Tuple[int, str, str, str]]] = {
    "AttrValue": [
        (1, "name", "string", "req"),
        (2, "kind", "enum:AttrValue.Kind", "req"),
        (3, "b", "bool", "opt"),
        (4, "i", "int64", "opt"),
        (5, "f", "double", "opt"),
        (6, "s", "string", "opt"),
        (7, "int_list", "int64", "packed"),
        (8, "float_list", "double", "packed"),
        (9, "string_list", "string", "rep"),
        (10, "bool_list", "bool", "rep"),
        (11, "block_idx", "int32", "opt"),
        (12, "value_json", "string", "opt"),
    ],
    "Slot": [
        (1, "name", "string", "req"),
        (2, "arguments", "string", "rep"),
    ],
    "OpDef": [
        (1, "type", "string", "req"),
        (2, "inputs", "Slot", "rep"),
        (3, "outputs", "Slot", "rep"),
        (4, "attrs", "AttrValue", "rep"),
    ],
    "VarDef": [
        (1, "name", "string", "req"),
        (2, "kind", "enum:VarDef.Kind", "opt"),
        (3, "dtype", "string", "opt"),
        (4, "shape", "int64", "packed"),
        (5, "persistable", "bool", "opt"),
        (6, "stop_gradient", "bool", "opt"),
        (7, "is_parameter", "bool", "opt"),
        (8, "trainable", "bool", "opt"),
        (9, "partition_spec", "string", "opt"),
        (10, "lod_level", "int32", "opt"),
        (11, "is_data", "bool", "opt"),
        (12, "accumulator_for", "string", "opt"),
    ],
    "BlockDef": [
        (1, "idx", "int32", "req"),
        (2, "parent_idx", "int32", "req"),
        (3, "vars", "VarDef", "rep"),
        (4, "ops", "OpDef", "rep"),
    ],
    "ProgramDef": [
        (1, "blocks", "BlockDef", "rep"),
        (2, "version", "int64", "opt"),
        (3, "random_seed", "int64", "opt"),
    ],
}

# the schema's defaults of the optional fields (read when a field is unset)
_DEFAULTS = {"VarDef": {"kind": 0, "persistable": False,
                        "stop_gradient": False, "is_parameter": False,
                        "trainable": True, "lod_level": 0, "is_data": False},
             "ProgramDef": {"version": 1, "random_seed": 0}}

_ENUMS = {
    "AttrValue.Kind": ("BOOL", "INT", "FLOAT", "STRING", "INT_LIST",
                       "FLOAT_LIST", "STRING_LIST", "BOOL_LIST", "BLOCK",
                       "JSON"),
    "VarDef.Kind": ("LOD_TENSOR", "SELECTED_ROWS", "FEED_MINIBATCH",
                    "FETCH_LIST", "STEP_SCOPES", "RANK_TABLE",
                    "TENSOR_ARRAY", "RAW"),
}
KIND = {n: i for i, n in enumerate(_ENUMS["AttrValue.Kind"])}


def proto_bindings_available() -> bool:
    """True: the codec needs no package (the JAX package's answer depends
    on ``google.protobuf``)."""
    return True


def default(msg_type: str, message: dict, field: str):
    """A field's value, or the schema's default when it is unset."""
    return message.get(field, _DEFAULTS.get(msg_type, {}).get(field))


# ---------------------------------------------------------------------------
# Wire encoding

def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # negative ints: 64-bit two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(number: int, wire: int) -> bytes:
    return _varint(number << 3 | wire)


def _scalar(kind: str, value) -> Tuple[int, bytes]:
    """(wire type, payload) of one scalar."""
    if kind == "string":
        data = value.encode("utf-8")
        return 2, _varint(len(data)) + data
    if kind == "double":
        return 1, struct.pack("<d", float(value))
    return 0, _varint(int(value))  # bool, int32, int64, enum


def encode(msg_type: str, message: dict) -> bytes:
    out = bytearray()
    for number, name, kind, label in _SCHEMA[msg_type]:
        if name not in message:
            if label == "req":
                raise ValueError(f"{msg_type}.{name} is required")
            continue
        value = message[name]
        if kind in _SCHEMA:
            for sub in (value if label == "rep" else [value]):
                data = encode(kind, sub)
                out += _key(number, 2) + _varint(len(data)) + data
        elif label == "packed":
            if value:
                data = b"".join(_scalar(kind, v)[1] for v in value)
                out += _key(number, 2) + _varint(len(data)) + data
        else:
            for v in (value if label == "rep" else [value]):
                wire, data = _scalar(kind, v)
                out += _key(number, wire) + data
    return bytes(out)


# ---------------------------------------------------------------------------
# Wire decoding

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    n = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        if shift >= 70:
            raise ValueError("varint longer than ten bytes")
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n & ((1 << 64) - 1), pos


def _signed(n: int, bits: int) -> int:
    n &= (1 << bits) - 1
    return n - (1 << bits) if n >> (bits - 1) else n


def _from_varint(kind: str, n: int):
    if kind == "bool":
        return n != 0
    if kind == "int32" or kind.startswith("enum:"):
        return _signed(n, 32)
    return _signed(n, 64)


def _fields(buf: bytes):
    """(number, wire type, value) per field: an int for wire types 0, 1
    and 5 (the raw bits), bytes for 2."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        number, wire = key >> 3, key & 7
        if number == 0:
            raise ValueError("field number 0")
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire in (1, 5):
            size = 8 if wire == 1 else 4
            if pos + size > len(buf):
                raise ValueError("truncated fixed-width field")
            value = int.from_bytes(buf[pos:pos + size], "little")
            pos += size
        elif wire == 2:
            size, pos = _read_varint(buf, pos)
            if pos + size > len(buf):
                raise ValueError("truncated length-delimited field")
            value = buf[pos:pos + size]
            pos += size
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield number, wire, value


def _decode_scalar(kind: str, wire: int, value):
    if kind == "string":
        if wire != 2:
            raise ValueError("string field with a non-length wire type")
        return bytes(value).decode("utf-8")
    if kind == "double":
        if wire != 1:
            raise ValueError("double field with a non-fixed64 wire type")
        return struct.unpack("<d", value.to_bytes(8, "little"))[0]
    if wire != 0:
        raise ValueError(f"{kind} field with wire type {wire}")
    return _from_varint(kind, value)


def _unpack(kind: str, data: bytes) -> list:
    out, pos = [], 0
    while pos < len(data):
        if kind == "double":
            if pos + 8 > len(data):
                raise ValueError("truncated packed double")
            out.append(struct.unpack_from("<d", data, pos)[0])
            pos += 8
        else:
            n, pos = _read_varint(data, pos)
            out.append(_from_varint(kind, n))
    return out


def decode(msg_type: str, buf: bytes) -> dict:
    by_number = {f[0]: f for f in _SCHEMA[msg_type]}
    message: dict = {}
    for number, wire, value in _fields(buf):
        if number not in by_number:
            continue  # unknown field: skipped, as protobuf keeps it aside
        _, name, kind, label = by_number[number]
        if kind in _SCHEMA:
            if wire != 2:
                raise ValueError(f"{msg_type}.{name}: message field with "
                                 f"wire type {wire}")
            sub = decode(kind, value)
            if label == "rep":
                message.setdefault(name, []).append(sub)
            else:
                message[name] = sub
        elif label in ("rep", "packed"):
            items = message.setdefault(name, [])
            if wire == 2 and kind != "string":
                items.extend(_unpack(kind, value))
            else:
                items.append(_decode_scalar(kind, wire, value))
        else:
            message[name] = _decode_scalar(kind, wire, value)
    missing = [name for _, name, _, label in _SCHEMA[msg_type]
               if label == "req" and name not in message]
    if missing:
        raise ValueError(f"{msg_type} is missing required fields {missing}")
    return message


# ---------------------------------------------------------------------------
# Text format (protobuf's MessageToString)

def _escape(s: str) -> str:
    """C-style escapes of the ASCII control characters, quotes and
    backslash; other characters print as they are (protobuf's text
    format with ``as_utf8``, its default)."""
    out = []
    for c in s:
        b = ord(c)
        if c in '"\'\\':
            out.append("\\" + c)
        elif c == "\n":
            out.append("\\n")
        elif c == "\r":
            out.append("\\r")
        elif c == "\t":
            out.append("\\t")
        elif b < 32 or b == 127:
            out.append("\\%03o" % b)
        else:
            out.append(c)
    return "".join(out)


def _text_scalar(kind: str, value) -> str:
    if kind == "string":
        return '"' + _escape(value) + '"'
    if kind == "bool":
        return "true" if value else "false"
    if kind.startswith("enum:"):
        names = _ENUMS[kind[5:]]
        return names[value] if 0 <= value < len(names) else str(value)
    return str(value)


def to_text(msg_type: str, message: dict, indent: int = 0) -> str:
    pad = " " * indent
    lines = []
    for _, name, kind, label in _SCHEMA[msg_type]:
        if name not in message:
            continue
        values = message[name] if label in ("rep", "packed") \
            else [message[name]]
        for v in values:
            if kind in _SCHEMA:
                lines.append(f"{pad}{name} {{\n"
                             f"{to_text(kind, v, indent + 2)}{pad}}}\n")
            else:
                lines.append(f"{pad}{name}: {_text_scalar(kind, v)}\n")
    return "".join(lines)


# ---------------------------------------------------------------------------
# Attribute encode/decode

# attr names that refer to nested blocks (while/static_rnn/recompute use
# sub_block; cond uses a block per branch)
_BLOCK_ATTRS = {"sub_block", "true_block", "false_block"}


def _encode_attr(name, value) -> dict:
    if name in _BLOCK_ATTRS and isinstance(value, int):
        return {"name": name, "kind": KIND["BLOCK"], "block_idx": value}
    if isinstance(value, bool):
        return {"name": name, "kind": KIND["BOOL"], "b": value}
    if isinstance(value, int):
        return {"name": name, "kind": KIND["INT"], "i": value}
    if isinstance(value, float):
        return {"name": name, "kind": KIND["FLOAT"], "f": value}
    if isinstance(value, str):
        return {"name": name, "kind": KIND["STRING"], "s": value}
    if isinstance(value, (list, tuple)):
        vals = list(value)
        if vals and all(isinstance(v, bool) for v in vals):
            return {"name": name, "kind": KIND["BOOL_LIST"],
                    "bool_list": vals}
        if vals and all(isinstance(v, int) and not isinstance(v, bool)
                        for v in vals):
            return {"name": name, "kind": KIND["INT_LIST"],
                    "int_list": vals}
        if vals and all(isinstance(v, float) for v in vals):
            return {"name": name, "kind": KIND["FLOAT_LIST"],
                    "float_list": vals}
        if all(isinstance(v, str) for v in vals):  # the empty list too
            return {"name": name, "kind": KIND["STRING_LIST"],
                    "string_list": vals}
    return {"name": name, "kind": KIND["JSON"],
            "value_json": json.dumps(value)}


def _decode_attr(a: dict):
    kind = a["kind"]
    if kind == KIND["BOOL"]:
        return bool(a.get("b", False))
    if kind == KIND["INT"]:
        return int(a.get("i", 0))
    if kind == KIND["FLOAT"]:
        return float(a.get("f", 0.0))
    if kind == KIND["STRING"]:
        return a.get("s", "")
    if kind == KIND["INT_LIST"]:
        return [int(v) for v in a.get("int_list", [])]
    if kind == KIND["FLOAT_LIST"]:
        return [float(v) for v in a.get("float_list", [])]
    if kind == KIND["STRING_LIST"]:
        return list(a.get("string_list", []))
    if kind == KIND["BOOL_LIST"]:
        return list(a.get("bool_list", []))
    if kind == KIND["BLOCK"]:
        return int(a.get("block_idx", 0))
    return json.loads(a.get("value_json", ""))


# VarType strings <-> VarDef.Kind
_KIND_TO_STR = {
    0: "lod_tensor", 1: "selected_rows", 2: "feed_minibatch",
    3: "fetch_list", 4: "step_scopes", 5: "lod_rank_table",
    6: "lod_tensor_array", 7: "raw",
}
_STR_TO_KIND = {v: k for k, v in _KIND_TO_STR.items()}


# ---------------------------------------------------------------------------
# Program conversion

def program_to_proto(program) -> dict:
    """The ProgramDef of a Program, as a dict of the set fields (the
    fields the JAX package's ``program_to_proto`` sets)."""
    blocks = []
    for block in program.blocks:
        vars_ = []
        for var in block.vars.values():
            d = var.to_dict()
            vdef = {"name": d["name"],
                    "kind": _STR_TO_KIND.get(d["type"], 0)}
            if d["dtype"] is not None:
                vdef["dtype"] = d["dtype"]
            if d["shape"] is not None:
                vdef["shape"] = [int(s) for s in d["shape"]]
            vdef["persistable"] = bool(d["persistable"])
            vdef["stop_gradient"] = bool(d["stop_gradient"])
            vdef["lod_level"] = int(d.get("lod_level", 0))
            vdef["is_data"] = bool(d.get("is_data", False))
            if d.get("is_parameter"):
                vdef["is_parameter"] = True
                vdef["trainable"] = bool(d.get("trainable", True))
            if d.get("accumulator_for"):
                vdef["accumulator_for"] = d["accumulator_for"]
            spec = getattr(var, "partition_spec", None)
            if spec is not None:
                vdef["partition_spec"] = json.dumps(spec)
            vars_.append(vdef)
        ops = [{"type": op.type,
                "inputs": [{"name": s, "arguments": list(a)}
                           for s, a in op.inputs.items()],
                "outputs": [{"name": s, "arguments": list(a)}
                            for s, a in op.outputs.items()],
                "attrs": [_encode_attr(n, op.attrs[n])
                          for n in sorted(op.attrs)]}
               for op in block.ops]
        blocks.append({"idx": block.idx, "parent_idx": block.parent_idx,
                       "vars": vars_, "ops": ops})
    return {"blocks": blocks,
            "random_seed": int(getattr(program, "random_seed", 0))}


def proto_to_program(pdef: dict):
    """Rebuild a Program from a ProgramDef dict."""
    from .core import Block, Operator, Program, Variable

    program = Program()
    program.random_seed = int(default("ProgramDef", pdef, "random_seed"))
    bdefs = pdef.get("blocks", [])
    for bdef in bdefs:  # block skeletons first (block 0 exists already)
        if bdef["idx"] != 0:
            program.blocks.append(Block(program, bdef["idx"],
                                        bdef["parent_idx"]))
    for bdef in bdefs:
        block = program.blocks[bdef["idx"]]
        for vdef in bdef.get("vars", []):
            def get(field):
                return default("VarDef", vdef, field)

            d = {"name": vdef["name"],
                 "shape": [int(s) for s in vdef["shape"]]
                 if vdef.get("shape") else None,
                 "dtype": vdef.get("dtype"),
                 "type": _KIND_TO_STR.get(get("kind"), "lod_tensor"),
                 "persistable": get("persistable"),
                 "stop_gradient": get("stop_gradient"),
                 "lod_level": get("lod_level"),
                 "is_data": get("is_data")}
            if get("is_parameter"):
                d["is_parameter"] = True
                d["trainable"] = get("trainable")
            if "accumulator_for" in vdef:
                d["accumulator_for"] = vdef["accumulator_for"]
            var = Variable.from_dict(block, d)
            if "partition_spec" in vdef:
                var.partition_spec = json.loads(vdef["partition_spec"])
            block.vars[var.name] = var
        for odef in bdef.get("ops", []):
            inputs = {s["name"]: list(s.get("arguments", []))
                      for s in odef.get("inputs", [])}
            outputs = {s["name"]: list(s.get("arguments", []))
                       for s in odef.get("outputs", [])}
            attrs = {a["name"]: _decode_attr(a)
                     for a in odef.get("attrs", [])}
            block.ops.append(Operator(block, odef["type"], inputs, outputs,
                                      attrs))
    program._recompute_next_uid()
    return program


def serialize_program(program) -> bytes:
    return encode("ProgramDef", program_to_proto(program))


def parse_program(data: bytes):
    """Wire bytes -> Program; truncated or malformed bytes raise
    ValueError."""
    return proto_to_program(decode("ProgramDef", bytes(data)))


def program_to_text(program) -> str:
    """Human-readable text-proto dump, as protobuf's ``MessageToString``
    prints the ProgramDef."""
    return to_text("ProgramDef", program_to_proto(program))
