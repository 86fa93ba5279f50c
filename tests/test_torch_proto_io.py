"""The port's ProgramDef codec (``paddle_tpu_torch/framework/proto_io.py``,
written by hand: the card's machine has no ``google.protobuf``) against
the JAX package's protobuf serialization, on the CPU: the same bytes for
the same program, each package parsing the other's bytes to an equal
``to_json``, the same text dump, and truncated bytes refused."""

import json

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.framework import proto_io as jproto
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu_torch.framework import proto_io as tproto
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models import transformer as ttransformer

# one attr of every AttrValue.Kind, and the edges of each
ATTRS = {
    "b_true": True, "b_false": False,
    "i_zero": 0, "i_neg": -7, "i_big": 2 ** 40, "i_min": -2 ** 63,
    "f": 0.1, "f_neg": -1e-300, "f_int": 3.0, "f_inf": float("inf"),
    "s": "relu", "s_empty": "", "s_utf8": "ünïcødé \"q\" \\ \n\t\x01\x7f",
    "ints": [1, -2, 3, 2 ** 35], "floats": [0.5, -2.25, 1e-7],
    "strs": ["a", "", "b"], "bools": [True, False, True],
    "empty": [], "json_dict": {"k": [1, 2], "z": None},
    "json_none": None, "json_mixed": [1, 2.5], "json_nested": [[1], [2]],
    "json_bools_ints": [True, 2], "tuple_ints": (4, 5),
}


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    jfluid.reset()
    yield


def _attr_program(fl):
    """Every attr kind on one op; a parameter, a data var, a var with no
    shape and no dtype, an accumulator, a sub-block with a block attr."""
    main = fl.default_main_program()
    main.random_seed = 1234
    blk = main.global_block()
    x = fl.layers.data("x", shape=[3])
    blk.create_parameter("w", shape=[3, 2], dtype="float32")
    v = blk.create_var(name="bare", shape=None, dtype=None)
    acc = blk.create_var(name="w_moment", shape=[3, 2], dtype="float32",
                         persistable=True)
    acc.accumulator_for = "w"
    blk.create_var(name="scalar", shape=(), dtype="bfloat16",
                   lod_level=2, stop_gradient=True)
    blk.append_op("attr_carrier", inputs={"X": [x.name], "Empty": []},
                  outputs={"Out": [v.name, ""]}, attrs=dict(ATTRS))
    sub = main.create_block()
    sub.create_var(name="inner", shape=[-1, 3], dtype="int64")
    sub.append_op("assign", inputs={"X": [x.name]},
                  outputs={"Out": ["inner"]})
    main.rollback()
    blk.append_op("recompute", inputs={"X": [x.name]},
                  outputs={"Out": ["inner"]},
                  attrs={"sub_block": sub.idx, "x_names": [x.name],
                         "out_names": ["inner"], "true_block": 0})
    return main


def _lm(fl, transformer):
    return transformer.build_lm_train_program(
        seq_len=8, vocab_size=32, dim=16, n_layers=2, n_heads=2,
        dtype="bfloat16", remat=True)


def _resnet(fl, resnet):
    return resnet.build_train_program(
        depth=18, class_dim=10, image_shape=(3, 16, 16), layout="NHWC",
        fuse_bn=True)


PROGRAMS = {"attrs": lambda fl, _m: _attr_program(fl),
            "gpt_remat_bf16": lambda fl, m: _lm(fl, m[0]),
            "resnet18_fused": lambda fl, m: _resnet(fl, m[1])}
MODELS = {"j": (jtransformer, jresnet), "t": (ttransformer, tresnet)}


def _both(name):
    PROGRAMS[name](jfluid, MODELS["j"])
    PROGRAMS[name](tfluid, MODELS["t"])
    return jfluid.default_main_program(), tfluid.default_main_program()


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_bytes_equal_jax(name):
    jmain, tmain = _both(name)
    assert tmain.to_json() == jmain.to_json()
    jb = jproto.serialize_program(jmain)
    assert tproto.serialize_program(tmain) == jb
    assert tmain.to_proto() == jb


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_each_parses_the_others_bytes(name):
    jmain, tmain = _both(name)
    jb, tb = jproto.serialize_program(jmain), tproto.serialize_program(tmain)
    want = jproto.parse_program(jb).to_json()
    assert tproto.parse_program(jb).to_json() == want
    assert jproto.parse_program(tb).to_json() == want
    assert tfluid.Program.from_proto(jb).to_json() == want


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_text_dump_equals_jax(name):
    jmain, tmain = _both(name)
    assert tproto.program_to_text(tmain) == jproto.program_to_text(jmain)


def test_attr_values_round_trip_as_jax():
    """Each attr decodes as the JAX package decodes it (tuples become
    lists, a float stays a float, JSON keeps None and dicts)."""
    jmain, tmain = _both("attrs")
    jops = jproto.parse_program(jproto.serialize_program(jmain)) \
        .global_block().ops
    tops = tproto.parse_program(tproto.serialize_program(tmain)) \
        .global_block().ops
    jattrs, tattrs = jops[0].attrs, tops[0].attrs
    assert json.dumps(tattrs, sort_keys=True) == \
        json.dumps(jattrs, sort_keys=True)
    assert tattrs["f_int"] == 3.0 and isinstance(tattrs["f_int"], float)
    assert tattrs["i_min"] == -2 ** 63 and tattrs["json_none"] is None
    assert tops[1].attrs == jops[1].attrs
    assert tops[1].attrs["true_block"] == 0
    assert tops[1].attrs["sub_block"] == 1
    kinds = {a["name"]: a["kind"] for a in tproto.program_to_proto(tmain)[
        "blocks"][0]["ops"][0]["attrs"]}
    assert set(kinds.values()) == set(range(10)) - {8}  # BLOCK: below
    assert kinds["empty"] == tproto.KIND["STRING_LIST"]
    assert kinds["json_mixed"] == tproto.KIND["JSON"]


def test_var_defaults_and_presence_as_jax():
    jmain, tmain = _both("attrs")
    back = tproto.parse_program(tproto.serialize_program(tmain))
    jback = jproto.parse_program(jproto.serialize_program(jmain))
    for name in ("w", "bare", "w_moment", "scalar", "x"):
        assert back.global_block().vars[name].to_dict() == \
            jback.global_block().vars[name].to_dict(), name
    # an empty shape is not written, so it parses back as None (JAX too)
    assert back.global_block().vars["scalar"].shape is None
    assert back.blocks[1].vars["inner"].shape == (-1, 3)
    assert back.random_seed == 1234 and back._next_uid == tmain._next_uid


def test_truncated_bytes_raise_where_jax_raises():
    """Every cut of the bytes: the port raises exactly where protobuf
    does, and where neither does the two parse to equal programs."""
    jmain, tmain = _both("attrs")
    data = tproto.serialize_program(tmain)
    raised = 0
    for cut in range(len(data)):
        try:
            want = jproto.parse_program(data[:cut]).to_json()
        except Exception:
            want = None
        if want is None:
            with pytest.raises(ValueError):
                tproto.parse_program(data[:cut])
            raised += 1
        else:
            assert tproto.parse_program(data[:cut]).to_json() == want, cut
    assert raised > len(data) // 2


def test_proto_bindings_are_always_available():
    assert tproto.proto_bindings_available() is True


def test_varint_edges():
    for n in (0, 1, 127, 128, 300, 2 ** 63 - 1):
        got, pos = tproto._read_varint(tproto._varint(n), 0)
        assert got == n
    assert len(tproto._varint(-1)) == 10
    assert tproto._from_varint("int64", tproto._read_varint(
        tproto._varint(-5), 0)[0]) == -5
    with pytest.raises(ValueError, match="longer"):
        tproto._read_varint(b"\xff" * 11, 0)
    msg = {"name": "x", "kind": 1, "i": -3}
    assert tproto.decode("AttrValue", tproto.encode("AttrValue", msg)) == msg
    with pytest.raises(ValueError, match="required"):
        tproto.encode("AttrValue", {"name": "x"})
    # an unknown field is skipped, as protobuf skips it
    extra = tproto.encode("Slot", {"name": "s"}) + tproto._key(9, 0) + b"\x01"
    assert tproto.decode("Slot", extra) == {"name": "s"}
    assert np.isfinite(tproto._unpack("double", b"\x00" * 8)[0])
