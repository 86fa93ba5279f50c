"""The port's native desc library (``paddle_tpu_torch/native/program_desc``:
its own proto2 codec, no protobuf) against the JAX package's (protoc's
classes and libprotobuf), on the same serialized programs: ``validate``,
``stats`` and ``text_dump`` give equal strings and ``prune`` equal bytes;
the port's save validates as the JAX save does; the port's ``proto``
namespace carries the JAX package's bytes unchanged."""

import os
import re

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import io as jio
from paddle_tpu.framework import proto_io as jproto
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.native import program_desc as jnpd
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import proto as tproto_ns
from paddle_tpu_torch.framework import proto_io as tproto
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.native import capi as tcapi
from paddle_tpu_torch.native import program_desc as tnpd

from test_torch_proto_io import _attr_program  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    jfluid.reset()
    yield


@pytest.fixture(scope="module", autouse=True)
def _libraries():
    """Both libraries built once for the module: the JAX one with protoc
    and libprotobuf, the port's with g++ alone."""
    assert jnpd.native_available(), "the JAX desc library does not build"
    tnpd.build_lib()


def _linear(fl):
    """test_proto_io's linear program, with a dropout at 0, a scale by 1
    and Adam (float attrs 0 and 1: DebugString's `f: 0`, `f: 1`)."""
    x = fl.layers.data(name="x", shape=[4], dtype="float32")
    y = fl.layers.data(name="y", shape=[1], dtype="float32")
    pred = fl.layers.fc(x, size=1)
    h = fl.layers.scale(fl.layers.dropout(pred, dropout_prob=0.0), scale=1.0)
    cost = fl.layers.mean(fl.layers.square_error_cost(h, y))
    fl.optimizer.Adam(learning_rate=1e-5).minimize(cost)
    return pred.name


def _gpt(fl, transformer=None):
    """A 2-layer GPT at d 32 with its loss and Adam; returns the logits'
    name."""
    transformer = transformer or (ttransformer if fl is tfluid
                                  else jtransformer)
    tokens = fl.layers.data("tokens", shape=[8, 1], dtype="int64")
    targets = fl.layers.data("targets", shape=[8, 1], dtype="int64")
    logits = transformer.decoder_lm(tokens, 64, 32, 2, 4, max_len=8,
                                    dtype="float32")
    loss = transformer.lm_loss(logits, targets, dtype="float32")
    fl.optimizer.Adam(learning_rate=3e-4).minimize(loss)
    return logits.name


def _while(fl):
    """test_proto_io's While with a sub-block that the prune drops."""
    x = fl.layers.data(name="x", shape=[4], dtype="float32")
    h = fl.layers.fc(x, size=4)
    i = fl.layers.fill_constant(shape=[1], dtype="float32", value=0)
    n = fl.layers.fill_constant(shape=[1], dtype="float32", value=2)
    dead = fl.layers.fill_constant(shape=[4], dtype="float32", value=0.0)
    cond = fl.layers.less_than(i, n)
    w = fl.layers.While(cond)
    with w.block():
        fl.layers.assign(fl.layers.elementwise_add(dead, h), dead)
        fl.layers.increment(i, 1.0)
        fl.layers.less_than(i, n, cond=cond)
    return h.name


def _ifelse(fl):
    """cond's true_block / false_block: the prune keeps both branches."""
    x = fl.layers.data(name="x", shape=[4], dtype="float32")
    flag = fl.layers.fill_constant(shape=[1], dtype="float32", value=1.0)
    zero = fl.layers.fill_constant(shape=[1], dtype="float32", value=0.0)
    pred = fl.layers.less_than(zero, flag)
    out = fl.layers.ifelse(pred, lambda: fl.layers.mean(x) * 2.0,
                           lambda: fl.layers.mean(x) * 3.0)
    return out.name


def _attrs(fl):
    """Every attr kind, escaped and non-ASCII strings, inf, 2**40."""
    _attr_program(fl)
    return "inner"


BUILDERS = {"linear": _linear, "gpt_d32": _gpt, "while": _while,
            "ifelse": _ifelse, "attrs": _attrs}


def _program(name):
    """(bytes, prune target) of one program, built by both packages: the
    bytes are the same, each library reads them."""
    tfluid.reset()
    jfluid.reset()
    jt = BUILDERS[name](jfluid)
    tt = BUILDERS[name](tfluid)
    jb = jproto.serialize_program(jfluid.default_main_program())
    tb = tproto.serialize_program(tfluid.default_main_program())
    assert tb == jb and tt == jt
    return tb, tt


def _pdef():
    """The linear program's ProgramDef dict, to corrupt."""
    tfluid.reset()
    _linear(tfluid)
    return tproto.program_to_proto(tfluid.default_main_program())


def _undeclared():
    pdef = _pdef()
    pdef["blocks"][0]["ops"][0]["inputs"][0]["arguments"].append(
        "no_such_var")
    return tproto.encode("ProgramDef", pdef)


def _cyclic():
    pdef = _pdef()
    pdef["blocks"] += [
        {"idx": 1, "parent_idx": 2, "ops": [
            {"type": "mean", "inputs": [
                {"name": "X", "arguments": ["undeclared_var"]}]}]},
        {"idx": 2, "parent_idx": 1}]
    return tproto.encode("ProgramDef", pdef)


def _unknown_fields():
    """The linear program with fields framework.proto does not declare, in
    a var, an op and the program (a varint, a string, fixed64 and fixed32,
    a nested message, a group), a known field on another wire type and an
    enum value outside its enum: kept aside as protobuf keeps them."""
    pdef = _pdef()
    var = tproto.encode("VarDef", pdef["blocks"][0]["vars"][0])
    var += bytes([0xa0, 0x01, 0x05])                          # 20: 5
    var += bytes([0xaa, 0x01, 0x03]) + b"a\xffz"               # 21: "a\377z"
    var += bytes([0x1d]) + b"abcd"                             # dtype, fixed32
    var += bytes([0x10, 0x2a])                                 # kind 42
    op = tproto.encode("OpDef", pdef["blocks"][0]["ops"][0])
    op += bytes([0xb1, 0x01]) + b"12345678"                    # 22: fixed64
    op += bytes([0xc2, 0x01, 0x02, 0x08, 0x07])                # 24 { 1: 7 }
    op += bytes([0xcb, 0x01, 0x08, 0x01, 0xcc, 0x01])          # group 25
    block = dict(pdef["blocks"][0])
    rest = {k: block.pop(k) for k in ("vars", "ops")}
    out = tproto.encode("BlockDef", block)
    out += b"".join(bytes([0x1a, len(v)]) + v if len(v) < 128 else
                    bytes([0x1a]) + tproto._varint(len(v)) + v
                    for v in [var] + [tproto.encode("VarDef", v)
                                      for v in rest["vars"][1:]])
    out += b"".join(bytes([0x22]) + tproto._varint(len(o)) + o
                    for o in [op] + [tproto.encode("OpDef", o)
                                     for o in rest["ops"][1:]])
    return (bytes([0x0a]) + tproto._varint(len(out)) + out
            + bytes([0xe8, 0x01, 0x09]))                       # 29: 9


CASES = {**{n: (lambda n=n: _program(n)[0]) for n in BUILDERS},
         "undeclared_input": _undeclared, "cyclic_parent": _cyclic,
         "unknown_fields": _unknown_fields,
         "truncated": lambda: _program("linear")[0][:-7],
         "half": lambda: _program("gpt_d32")[0][:1000],
         "empty": lambda: b""}


@pytest.mark.parametrize("case", sorted(CASES))
def test_validate_stats_text_equal_jax(case):
    data = CASES[case]()
    assert tnpd.validate(data) == jnpd.validate(data)
    jstats, jtext = jnpd.stats(data), jnpd.text_dump(data)
    if jstats is None:  # the JAX binding's answer to bytes that do not parse
        assert jtext is None
        with pytest.raises(ValueError, match="bad ProgramDef bytes"):
            tnpd.stats(data)
        with pytest.raises(ValueError, match="bad ProgramDef bytes"):
            tnpd.text_dump(data)
        return
    assert tnpd.stats(data) == jstats
    assert tnpd.text_dump(data) == jtext


def test_diagnostics_and_dump_details():
    ok, diag = tnpd.validate(_undeclared())
    assert not ok and "input 'no_such_var' is undeclared" in diag
    ok, diag = tnpd.validate(_cyclic())
    assert not ok and "undeclared_var" in diag
    assert tnpd.validate(_program("linear")[0][:-7]) == (
        False, "parse error: bad ProgramDef bytes")
    text = tnpd.text_dump(_program("linear")[0])
    assert re.search(r"^\s+f: 0$", text, re.M)      # not 0.0
    assert re.search(r"^\s+f: 1$", text, re.M)
    assert re.search(r"^\s+f: 1e-08$", text, re.M)  # Adam's epsilon
    assert "kind: FLOAT" in text
    text = tnpd.text_dump(_program("attrs")[0])
    # CEscape: octal for bytes outside the printable range, >= 0x80 too
    assert '\\303\\274n\\303\\257c\\303\\270d\\303\\251 \\"q\\" \\\\ ' \
           '\\n\\t\\001\\177"' in text
    assert "f: inf" in text and "i: 1099511627776" in text


@pytest.mark.parametrize("case", ["linear", "gpt_d32", "while", "ifelse",
                                  "attrs", "unknown_fields"])
def test_prune_bytes_equal_jax(case):
    if case == "unknown_fields":
        data, target = _unknown_fields(), _program("linear")[1]
    else:
        data, target = _program(case)
    got = tnpd.prune(data, [target])
    assert got == jnpd.prune(data, [target])
    if case == "unknown_fields":  # proto_io's codec refuses them
        return
    pruned = tproto.parse_program(got)
    if case == "while":  # the dead While and its sub-block go
        assert len(pruned.blocks) == 1
    if case == "ifelse":  # both branch blocks stay
        assert len(pruned.blocks) == 3
    if case in ("linear", "gpt_d32"):
        want = tio.prune(tfluid.default_main_program(), [target])
        assert [o.type for o in pruned.global_block().ops] == \
            [o.type for o in want.global_block().ops]


def test_sources_carry_no_protobuf():
    here = os.path.dirname(tnpd.__file__)
    for name in ("program_desc.cc", "capi.cc", "capi.h", "capi_demo.c"):
        with open(os.path.join(here, name)) as f:
            src = f.read()
        assert not re.search(r"#include\s*[<\"](google/protobuf|framework"
                             r"\.pb\.h)", src), name
    for flags in (tnpd.CXX_FLAGS, tcapi.CXX_FLAGS,
                  sum(tcapi.python_build_flags(), [])):
        assert not any("protobuf" in f for f in flags)
    assert "protobuf" not in os.path.basename(tnpd.library_path())


def test_save_refuses_an_undeclared_input_as_jax(tmp_path):
    """Both saves refuse the program with the library's diagnostics.  The
    port validates before it touches the directory; the JAX save has made
    the directory by then and leaves it behind, empty."""
    for fl, io in ((jfluid, jio), (tfluid, tio)):
        x = fl.layers.data(name="x", shape=[4], dtype="float32")
        pred = fl.layers.fc(x, size=2)
        out = fl.layers.scale(pred, scale=2.0)
        block = fl.default_main_program().global_block()
        block.ops[-1].inputs["X"].append("ghost")
        exe = fl.Executor(fl.CPUPlace())
        exe.run(fl.default_startup_program())
        d = str(tmp_path / fl.__name__)
        with pytest.raises(ValueError, match="input 'ghost' is undeclared"):
            io.save_inference_model(d, ["x"], [out], exe)
        if fl is jfluid:
            assert os.listdir(d) == []
        else:
            assert not os.path.exists(d)


def test_save_validates_and_loads(tmp_path):
    pred = _linear(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    d = str(tmp_path / "m")
    tio.save_inference_model(d, ["x"], [pred], exe)
    with open(os.path.join(d, "__model__"), "rb") as f:
        assert tnpd.validate(f.read()) == (True, "")
    prog, feeds, fetches = tio.load_inference_model(d, exe)
    out = exe.run(prog, feed={"x": np.ones((2, 4), np.float32)},
                  fetch_list=fetches)[0]
    assert out.shape == (2, 1)


def test_proto_namespace_carries_jax_bytes():
    _gpt(jfluid)
    jb = jfluid.default_main_program().to_proto()
    pb2 = tproto_ns.framework_pb2
    msg = pb2.ProgramDef.FromString(jb)
    assert msg.SerializeToString() == jb
    assert msg.blocks[0].idx == 0 and msg.blocks[0].parent_idx == -1
    assert msg.version == 1 and not msg.HasField("version")
    ops = [o.type for o in msg.blocks[0].ops]
    assert ops == [o.type for o in jproto.parse_program(jb)
                   .global_block().ops]
    kinds = {a.kind for o in msg.blocks[0].ops for a in o.attrs}
    assert pb2.AttrValue.Kind.FLOAT in kinds
    assert pb2.AttrValue.Kind.Name(pb2.AttrValue.FLOAT) == "FLOAT"
    # build one by hand, as the JAX tests do with protoc's classes
    jpb2 = jproto.framework_pb2()
    for mod in (pb2, jpb2):
        p = mod.ProgramDef()
        b = p.blocks.add()
        b.idx, b.parent_idx = 0, -1
        v = b.vars.add()
        v.name = "x"
        v.shape.extend([-1, 4])
        op = b.ops.add()
        op.type = "scale"
        a = op.attrs.add()
        a.name, a.kind, a.f = "scale", mod.AttrValue.FLOAT, 0.5
    assert pb2.ProgramDef.FromString(p.SerializeToString()) \
        .SerializeToString() == p.SerializeToString()
    assert [m.SerializeToString() for m in (p,)] == \
        [jpb2.ProgramDef.FromString(p.SerializeToString())
         .SerializeToString()]
    for alias in ("ModelConfig_pb2", "TrainerConfig_pb2",
                  "ParameterConfig_pb2", "DataConfig_pb2"):
        assert getattr(tproto_ns, alias) is pb2
    public = {n for n in dir(tproto_ns) if not n.startswith("_")}
    import paddle_tpu.proto as jproto_ns
    assert public <= {n for n in dir(jproto_ns) if not n.startswith("_")}


def test_v1_config_bytes_through_the_namespace():
    """tests/test_torch_v1_trainer.py's config: the port's
    ``SerializeToString`` equals JAX's and passes through the namespace
    unchanged."""
    from paddle_tpu.trainer import config_parser as jcp
    from paddle_tpu_torch.trainer import config_parser as tcp

    def config(hidden=4):
        import paddle_tpu_torch.v1 as tv1

        x = tv1.data_layer("x", size=6)
        tv1.outputs(tv1.fc_layer(tv1.fc_layer(x, size=int(hidden)), size=2))

    def j_config(hidden=4):
        import paddle_tpu.v1 as jv1

        x = jv1.data_layer("x", size=6)
        jv1.outputs(jv1.fc_layer(jv1.fc_layer(x, size=int(hidden)), size=2))

    tb = tcp.parse_config(config, "hidden=5").SerializeToString()
    assert tb == jcp.parse_config(j_config, "hidden=5").SerializeToString()
    assert tproto_ns.ModelConfig_pb2.ProgramDef.FromString(tb) \
        .SerializeToString() == tb
    assert tnpd.text_dump(tb) == jnpd.text_dump(tb)
