"""The port's deploy tools (``net_drawer``, ``utils/``, the CLI's
``dump_config``, ``stats``, ``validate``, ``show_pb`` and ``merge_model``)
against the JAX package's on the same saved model and the same inputs, on
the CPU: equal dot text, dumps, arrays, dataset files and CLI output."""

import io as _io
import os
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import cli as jcli
from paddle_tpu import net_drawer as jdraw
from paddle_tpu import utils as jutils
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu_torch import cli as tcli
from paddle_tpu_torch import net_drawer as tdraw
from paddle_tpu_torch import utils as tutils
from paddle_tpu_torch.models import transformer as ttransformer

CPU = tfluid.CPUPlace()


@pytest.fixture(autouse=True)
def _fresh():
    tfluid.reset()
    jfluid.reset()
    yield


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A 2-layer GPT forward at d 32 saved by the port (startup-initialised
    from a seed), and a bad desc file (an undeclared input)."""
    root = tmp_path_factory.mktemp("tools")
    tfluid.reset()
    tokens = tfluid.layers.data("tokens", shape=[8, 1], dtype="int64")
    logits = ttransformer.decoder_lm(tokens, 64, 32, 2, 4, max_len=8,
                                     dtype="float32")
    tfluid.default_startup_program().random_seed = 7
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    d = str(root / "gpt")
    tfluid.io.save_inference_model(d, ["tokens"], [logits], exe)
    from paddle_tpu_torch.framework import proto_io

    pdef = proto_io.program_to_proto(tfluid.default_main_program())
    pdef["blocks"][0]["ops"][-1]["inputs"][0]["arguments"].append("ghost")
    bad = root / "bad_model"
    bad.write_bytes(proto_io.encode("ProgramDef", pdef))
    tfluid.reset()
    return {"dir": d, "bad": str(bad), "root": root}


def test_draw_graph_equals_jax(saved):
    for path in (saved["dir"], os.path.join(saved["dir"], "__model__")):
        want = jutils.make_model_diagram.make_diagram(path)
        assert tutils.make_model_diagram.make_diagram(path) == want
        assert want.startswith('digraph "program" {')
    for fl, draw, transformer in ((jfluid, jdraw, jtransformer),
                                  (tfluid, tdraw, ttransformer)):
        tokens = fl.layers.data("tokens", shape=[8, 1], dtype="int64")
        transformer.decoder_lm(tokens, 64, 32, 1, 4, max_len=8,
                               dtype="float32")
    assert tdraw.draw_graph(title='a "b"') == jdraw.draw_graph(title='a "b"')


def test_dump_config_equals_jax(saved, tmp_path):
    want = jutils.dump_config.dump_config(saved["dir"],
                                          out=str(tmp_path / "j.txt"))
    got = tutils.dump_config.dump_config(saved["dir"],
                                         out=str(tmp_path / "t.txt"))
    assert got == want and "f: 1e-05" in got  # layer_norm's epsilon
    assert (tmp_path / "t.txt").read_text() == want
    # a directory saved with program.json only
    d = tmp_path / "json_only"
    d.mkdir()
    with open(os.path.join(saved["dir"], "program.json")) as f:
        (d / "program.json").write_text(f.read())
    assert tutils.dump_config.dump_config(str(d), out=str(tmp_path / "x")) \
        == jutils.dump_config.dump_config(str(d), out=str(tmp_path / "y"))
    with pytest.raises(FileNotFoundError):
        tutils.dump_config.dump_config(str(tmp_path / "nothing"))


def test_show_pb_equals_jax(saved):
    want, got = _io.StringIO(), _io.StringIO()
    path = os.path.join(saved["dir"], "__model__")
    jutils.show_pb.dump_program(path, out=want)
    prog = tutils.show_pb.dump_program(path, out=got)
    assert got.getvalue() == want.getvalue()
    assert "op layer_norm" in got.getvalue()
    assert len(prog.global_block().ops) > 10


def test_plotcurve_equals_jax():
    log = ("I Pass=0 Batch=10 AvgCost=2.5 Eval: err=0.5\n"
           "I Pass=1 Batch=20 AvgCost=1.25 Eval: err=0.25\n"
           "Test samples=100 AvgCost=1.5 err=0.3\n"
           "noise\n")
    for keys in (["AvgCost"], ["AvgCost", "err"], []):
        want = jutils.plotcurve.extract_curve(keys, _io.StringIO(log))
        got = tutils.plotcurve.extract_curve(keys, _io.StringIO(log))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_torch2paddle_writes_the_arrays_jax_writes():
    torch.manual_seed(0)
    lin, table, square = (torch.nn.Linear(4, 3), torch.nn.Embedding(7, 3),
                          torch.nn.Linear(3, 3))
    states = {}
    for fl, utils in ((jfluid, jutils), (tfluid, tutils)):
        x = fl.layers.data("t2px", shape=[4], dtype="float32")
        h = fl.layers.fc(x, size=3, param_attr={"name": "lin_w"},
                         bias_attr={"name": "lin_b"})
        fl.layers.fc(h, size=3, param_attr={"name": "sq_w"},
                     bias_attr=False)
        ids = fl.layers.data("t2pe", shape=[1], dtype="int64")
        fl.layers.embedding(ids, size=[7, 3], param_attr={"name": "emb"})
        fl.Executor(fl.CPUPlace()).run(fl.default_startup_program())
        names = []
        for sd, name_map in ((lin.state_dict(), {"weight": "lin_w",
                                                 "bias": "lin_b"}),
                             (table.state_dict(), {"weight": "emb"}),
                             (square.state_dict(), {"weight": "sq_w",
                                                    "bias": None})):
            names += utils.torch2paddle.torch_state_to_scope(
                sd, name_map=name_map)
        with pytest.raises(KeyError, match="not found in scope"):
            utils.torch2paddle.torch_state_to_scope({"nope": lin.weight})
        states[fl] = {n: fl.global_scope().find_np(n) for n in names}
    assert sorted(states[tfluid]) == sorted(states[jfluid]) == \
        ["emb", "lin_b", "lin_w", "sq_w"]
    for n, v in states[jfluid].items():
        np.testing.assert_array_equal(states[tfluid][n], v)
    np.testing.assert_array_equal(states[tfluid]["lin_w"],
                                  lin.weight.detach().numpy().T)
    np.testing.assert_array_equal(states[tfluid]["emb"],
                                  table.weight.detach().numpy())
    t = tfluid.global_scope().find("lin_w")
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float32


def test_preprocess_img_writes_the_files_jax_writes(tmp_path):
    from PIL import Image

    rng = np.random.RandomState(0)
    src = tmp_path / "imgs"
    for cls in ("cat", "dog"):
        os.makedirs(src / cls)
        for i in range(3):
            arr = (rng.rand(10, 12, 3) * 255).astype(np.uint8)
            Image.fromarray(arr).save(src / cls / f"{i}.jpg")
    metas = {}
    for tag, utils in (("j", jutils), ("t", tutils)):
        c = utils.preprocess_img.ImageClassificationDatasetCreater(
            str(src), target_size=8)
        metas[tag] = c.create_batches(str(tmp_path / tag), seed=1)
    j, t = metas["j"], metas["t"]
    assert t["label_set"] == j["label_set"] == {"cat": 0, "dog": 1}
    np.testing.assert_array_equal(t["mean"], j["mean"])
    for split in ("train", "test"):
        for jp, tp in zip(j["batches"][split], t["batches"][split]):
            assert os.path.basename(jp) == os.path.basename(tp)
            with open(jp, "rb") as f:
                jb = pickle.load(f)
            with open(tp, "rb") as f:
                tb = pickle.load(f)
            np.testing.assert_array_equal(tb["data"], jb["data"])
            np.testing.assert_array_equal(tb["labels"], jb["labels"])


def _cli(cli, argv, capsys):
    rc = cli.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("sub", ["dump_config", "stats", "validate",
                                 "show_pb"])
def test_cli_subcommand_equals_jax(sub, saved, capsys):
    for path in (saved["dir"], os.path.join(saved["dir"], "__model__")):
        want = _cli(jcli, [sub, path], capsys)
        got = _cli(tcli, [sub, path], capsys)
        assert got == want
        assert got[0] == 0 and got[1]
    if sub == "validate":
        assert got[1] == "OK\n"
        want = _cli(jcli, [sub, saved["bad"]], capsys)
        got = _cli(tcli, [sub, saved["bad"]], capsys)
        assert got == want and got[0] == 1
        assert "input 'ghost' is undeclared" in got[2]


def test_cli_merge_model_bundle_loads(saved, capsys):
    outs = {}
    for tag, cli in (("j", jcli), ("t", tcli)):
        out = str(saved["root"] / f"merged_{tag}.tar.gz")
        assert _cli(cli, ["merge_model", saved["dir"], out], capsys) == \
            (0, out + "\n", "")
        outs[tag] = out
    # utils.merge_model is the same operation
    again = str(saved["root"] / "merged_u.tar.gz")
    assert tutils.merge_model.merge_v2_model(saved["dir"],
                                             output_file=again) == again
    exe = tfluid.Executor(CPU)
    feed = {"tokens": np.random.RandomState(0).randint(
        0, 64, (2, 8, 1)).astype(np.int64)}

    def forward(load, path):
        scope = tfluid.Scope()
        prog, feeds, fetches = load(path, exe, scope=scope)
        assert feeds == ["tokens"]
        return exe.run(prog, feed=feed, fetch_list=fetches, scope=scope)[0]

    want = forward(tfluid.io.load_inference_model, saved["dir"])
    for path in (outs["j"], outs["t"], again):
        np.testing.assert_array_equal(
            forward(tfluid.io.load_merged_model, path), want)
