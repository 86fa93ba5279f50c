"""The legacy trainer path of the port (``v1/data_provider.py``,
``v1/trainer.py``, ``trainer/``, ``cli.py``) against the JAX package on
the CPU.

The config is ``chip_smoke``'s v1 form of the reference's RNN benchmark
(``V1_RNN_CONFIG``: ``data_layer`` → ``embedding_layer`` → 2 ×
``simple_lstm`` → ``last_seq`` → ``fc_layer(2, Softmax)`` →
``classification_cost``, Adam 2e-3) with its ``@provider`` of seeded
token sequences, written for each package into the test's directory, at
vocab 300, widths 32, batch 8 of ragged lengths up to 12.

- The provider gives the same batches as JAX's (data, LoD, every pass's
  seeded shuffle).
- ``V1Trainer(place=CPUPlace())`` from JAX's startup state: 3 passes whose
  per-pass losses equal JAX's within 1e-5 relative, then ``test()``.
- ``cli.main(["train", "--config", ..., "--place", "cpu"])`` prints the
  ``Pass i: cost=`` lines in the form JAX's CLI prints them (each package
  from its own random startup) and the ``--job time`` JSON; ``--config_args`` reaches ``get_config_arg`` with the
  reference's coercions; ``--save-dir`` writes ``pass-%05d`` directories
  that ``paddle_tpu.io`` loads into the JAX program, value for value.
- ``parse_config`` builds the same ProgramDef bytes in both packages.
- The CLI has ``train`` and ``version``; every other JAX subcommand exits
  non-zero naming its ROADMAP queue item; the trainer's default place is
  the card."""

import json
import textwrap

import numpy as np
import pytest

import chip_smoke as cs
import paddle_tpu as jfluid
import paddle_tpu.io as jio
import paddle_tpu_torch as tfluid
from paddle_tpu import cli as jcli
from paddle_tpu.trainer import config_parser as jcp
from paddle_tpu.v1 import data_provider as jdp
from paddle_tpu.v1.layers import declared_outputs as j_declared
from paddle_tpu.v1.trainer import V1Trainer as JTrainer
from paddle_tpu_torch import cli as tcli
from paddle_tpu_torch.trainer import config_parser as tcp
from paddle_tpu_torch.v1 import data_provider as tdp
from paddle_tpu_torch.v1.layers import declared_outputs as t_declared
from paddle_tpu_torch.v1.trainer import V1Trainer as TTrainer

SMALL = cs.V1_RNN_SMALL
ARGS = cs.v1_rnn_args(SMALL)
PKG = {"jax": (jfluid, jcp, j_declared, JTrainer, "paddle_tpu"),
       "port": (tfluid, tcp, t_declared, TTrainer, "paddle_tpu_torch")}


@pytest.fixture(autouse=True)
def _fresh():
    tfluid.reset()
    jfluid.reset()
    yield
    tcp.set_config_args({})
    jcp.set_config_args({})
    tfluid.reset()
    jfluid.reset()


@pytest.fixture
def confs(tmp_path):
    return {tag: cs.write_v1_rnn_config(str(tmp_path), pkg=pkg[4], tag=tag)
            for tag, pkg in PKG.items()}


def _read(tag, conf, args=ARGS):
    """The config read by package `tag` into fresh default programs, as
    ``train --config`` reads it; returns its declared cost."""
    fluid, cp, declared, _, _ = PKG[tag]
    fluid.reset()
    cp.set_config_args(args)
    import runpy

    runpy.run_path(conf, run_name="__config__")
    return declared()[0]


def _persistables(program):
    return [n for n, v in program.global_block().vars.items()
            if v.persistable]


def _trainers(confs):
    """Both trainers on the CPU, the port's from the JAX startup's
    values."""
    j_cost = _read("jax", confs["jax"])
    jt = JTrainer(j_cost, place=jfluid.CPUPlace())
    state = {n: np.array(jfluid.global_scope().find_np(n))
             for n in _persistables(jfluid.default_main_program())}
    t_cost = _read("port", confs["port"])
    tt = TTrainer(t_cost, place=tfluid.CPUPlace())
    assert tfluid.default_main_program().to_json() == \
        jfluid.default_main_program().to_json()
    tfluid.load_persistables(tfluid.default_main_program(), state)
    return tt, jt


def test_provider_gives_jax_batches(confs):
    got = {}
    for tag, dp in (("jax", jdp), ("port", tdp)):
        _read(tag, confs[tag])
        prov, files = dp.get_data_source("train")
        got[tag] = [list(prov.batches(files, SMALL["batch_size"], seed=s))
                    for s in range(3)]
        test_prov, test_files = dp.get_data_source("test")
        got[tag].append(list(test_prov.batches(test_files, 4, seed=0)))
    assert len(got["port"][0]) == SMALL["samples"] // SMALL["batch_size"]
    for t_pass, j_pass in zip(got["port"], got["jax"]):
        assert len(t_pass) == len(j_pass)
        for t, j in zip(t_pass, j_pass):
            assert sorted(t) == sorted(j) == ["label", "word"]
            np.testing.assert_array_equal(t["label"], j["label"])
            np.testing.assert_array_equal(t["word"].data, j["word"].data)
            assert t["word"].lod == j["word"].lod
    # the passes' shuffles differ from each other
    assert not np.array_equal(got["port"][0][0]["label"],
                              got["port"][1][0]["label"]) or \
        got["port"][0][0]["word"].lod != got["port"][1][0]["word"].lod


def test_small_rnn_config_trains_three_passes_as_jax(confs):
    tt, jt = _trainers(confs)
    t_passes, j_passes = tt.train(num_passes=3), jt.train(num_passes=3)
    assert len(t_passes) == 3
    for t, j in zip(t_passes, j_passes):
        assert abs(t - j) <= 1e-5 * abs(j), (t_passes, j_passes)
    t_test, j_test = tt.test(), jt.test()
    assert abs(t_test - j_test) <= 1e-5 * abs(j_test)


def test_trainer_time_job_returns_ms_and_loss(confs):
    tt, jt = _trainers(confs)
    ms, loss = tt.time(num_batches=2)
    j_ms, j_loss = jt.time(num_batches=2)
    assert ms > 0 and abs(loss - j_loss) <= 1e-5 * abs(j_loss)


def test_trainer_runs_on_the_card_by_default(confs):
    cost = _read("port", confs["port"])
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default place is usable")
    with pytest.raises(RuntimeError, match="CPUPlace"):
        TTrainer(cost)


def _cli(mod, argv, capsys):
    assert mod.main(argv) == 0
    return capsys.readouterr().out


def test_cli_train_prints_jax_pass_lines(confs, capsys):
    argv = ["train", "--config", None, "--num-passes", "2",
            "--config_args", ARGS]
    j_out = _cli(jcli, [a if a else confs["jax"] for a in argv], capsys)
    jfluid.reset()
    t_out = _cli(tcli, [a if a else confs["port"] for a in argv]
                 + ["--place", "cpu"], capsys)

    def costs(out):
        return [float(ln.split("cost=")[1]) for ln in out.splitlines()
                if ln.startswith("Pass ")]

    assert [ln.split(":")[0] for ln in t_out.splitlines()] == \
        ["Pass 0", "Pass 1"]
    # each package trains from its own random startup: the pass costs of
    # the same config land close, and both near ln 2 at these widths
    for t, j in zip(costs(t_out), costs(j_out)):
        assert abs(t - np.log(2)) < 0.1 and abs(j - np.log(2)) < 0.1


def test_cli_time_job_prints_the_json_line(confs, capsys):
    out = _cli(tcli, ["train", "--config", confs["port"], "--job", "time",
                      "--time-batches", "2", "--config_args", ARGS,
                      "--place", "cpu"], capsys)
    rec = json.loads(out.strip().splitlines()[-1])
    assert sorted(rec) == ["batch_size", "job", "last_loss", "ms_per_batch"]
    assert rec["job"] == "time" and rec["ms_per_batch"] > 0
    assert rec["batch_size"] == SMALL["batch_size"]
    assert np.isfinite(rec["last_loss"])


def _args_conf(tmp_path, pkg, tag):
    """The JAX CLI test's --config_args config, on package `pkg`."""
    rng = np.random.RandomState(0)
    data = tmp_path / f"d_{tag}.txt"
    with open(data, "w") as f:
        for _ in range(32):
            lab = rng.randint(0, 2)
            x = rng.rand(4) * 0.3 + lab * 0.5
            f.write(" ".join(f"{v:.4f}" for v in x) + f" {lab}\n")
    (tmp_path / f"ca_provider_{tag}.py").write_text(textwrap.dedent(f"""
        from {pkg}.v1.data_provider import (provider, dense_vector,
                                            integer_value)

        @provider(input_types={{"x": dense_vector(4),
                               "label": integer_value(2)}})
        def process(settings, file_name):
            for line in open(file_name):
                parts = line.split()
                yield {{"x": [float(v) for v in parts[:4]],
                       "label": int(parts[4])}}
    """))
    conf = tmp_path / f"ca_conf_{tag}.py"
    conf.write_text(textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(tmp_path)!r})
        from {pkg} import v1

        hidden = v1.get_config_arg("hidden", int, 8)
        use_bn = v1.get_config_arg("use_bn", bool, False)
        assert hidden == 12, hidden
        assert use_bn is True, use_bn
        v1.define_py_data_sources2({str(data)!r}, None,
                                   module="ca_provider_{tag}", obj="process")
        x = v1.data_layer(name="x", size=4)
        label = v1.data_layer(name="label", size=2, dtype="int64")
        h = v1.fc_layer(input=x, size=hidden, act=v1.TanhActivation())
        pred = v1.fc_layer(input=h, size=2, act=v1.SoftmaxActivation())
        cost = v1.classification_cost(input=pred, label=label)
        v1.settings(batch_size=16, learning_rate=0.3)
        v1.outputs(cost)
    """))
    return str(conf)


def test_cli_config_args_and_save_dir_load_into_jax(tmp_path, capsys):
    conf = _args_conf(tmp_path, "paddle_tpu_torch", "port")
    save = tmp_path / "ckpts"
    out = _cli(tcli, ["train", "--config", conf, "--config_args",
                      "hidden=12,use_bn=true", "--num-passes", "2",
                      "--save-dir", str(save), "--place", "cpu"], capsys)
    assert "Pass 1" in out and "saved pass 1" in out
    values = {n: tfluid.global_scope().find_np(n)
              for n in _persistables(tfluid.default_main_program())}
    # the JAX package's program of the same config loads the last pass
    j_conf = _args_conf(tmp_path, "paddle_tpu", "jax")
    jcp.set_config_args("hidden=12,use_bn=true")
    import runpy

    runpy.run_path(j_conf, run_name="__config__")
    JTrainer(j_declared()[0], place=jfluid.CPUPlace())
    for p in range(2):
        assert (save / f"pass-{p:05d}").is_dir()
    jio.load_persistables(jfluid.Executor(jfluid.CPUPlace()),
                          str(save / "pass-00001"),
                          jfluid.default_main_program())
    assert sorted(values) == sorted(
        _persistables(jfluid.default_main_program()))
    for n, v in values.items():
        np.testing.assert_array_equal(jfluid.global_scope().find_np(n), v)


def test_get_config_arg_coerces_as_jax():
    for cp in (tcp, jcp):
        cp.set_config_args("a=3,b=true,c=0,d=x,e=maybe")
        assert cp.get_config_arg("a", int, 1) == 3
        assert cp.get_config_arg("b", bool) is True
        assert cp.get_config_arg("c", bool) is False
        assert cp.get_config_arg("d", str) == "x"
        assert cp.get_config_arg("missing", int, 7) == 7
        with pytest.raises(ValueError, match="not boolean"):
            cp.get_config_arg("e", bool)
    assert tcp.set_config_args({"k": "v"}) == {"k": "v"}


def test_parse_config_serializes_as_jax():
    def config(hidden=4):
        import paddle_tpu_torch.v1 as tv1

        x = tv1.data_layer("x", size=6)
        tv1.outputs(tv1.fc_layer(tv1.fc_layer(x, size=int(hidden)), size=2))

    def j_config(hidden=4):
        import paddle_tpu.v1 as jv1

        x = jv1.data_layer("x", size=6)
        jv1.outputs(jv1.fc_layer(jv1.fc_layer(x, size=int(hidden)), size=2))

    t = tcp.parse_config(config, "hidden=5")
    t_bytes = t.SerializeToString()
    j = jcp.parse_config(j_config, "hidden=5")
    assert t.model_config is t.program
    assert t_bytes == j.SerializeToString()
    assert tcp.parse_config_and_serialize(config, "hidden=5") != b""


# the host services of Queue A item 11 and the deploy tools of item 12 are
# ported: they left UNPORTED and their cases now check that the subcommand
# parses
_PORTED_11 = ("cluster_train", "master", "pserver")
_PORTED_12 = ("dump_config", "merge_model", "show_pb", "stats", "validate")


@pytest.mark.parametrize("sub", sorted(set(tcli.UNPORTED) | set(_PORTED_11)
                                       | set(_PORTED_12)))
def test_unported_subcommands_exit_naming_the_roadmap(sub, capsys):
    if sub in _PORTED_11 + _PORTED_12:
        assert sub not in tcli.UNPORTED
        with pytest.raises(SystemExit) as e:
            tcli.main([sub, "--help"])
        assert e.value.code == 0
        assert "--" in capsys.readouterr().out
        return
    assert tcli.main([sub, "x"]) == 2
    err = capsys.readouterr().err
    assert "ROADMAP.md Queue A item" in err and sub in err
    assert tcli.UNPORTED[sub] in (9, 10, 11, 12)


def test_cli_version_and_script(tmp_path, capsys):
    out = _cli(tcli, ["version"], capsys)
    assert out.startswith(f"paddle_tpu_torch {tfluid.__version__}")
    assert "torch " in out
    script = tmp_path / "s.py"
    script.write_text("print('hello-from-port-train')\n")
    assert "hello-from-port-train" in _cli(
        tcli, ["train", "--script", str(script)], capsys)
